"""Linear-algebra ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/linalg_ops.py``, under the same
names and keywords. Where the reference's conventions and torch's differ:

* ``lu`` returns 0-based pivots (int32), as ``jax.scipy.linalg.lu_factor``
  does; ``torch.linalg.lu_factor``'s are 1-based;
* ``lstsq`` is the minimum-norm solution through the SVD, as
  ``jnp.linalg.lstsq`` computes it (singular values below
  eps·max(M, N)·σ_max dropped): ``torch.linalg.pinv``, on every device —
  ``torch.linalg.lstsq`` on the card solves with ``gels`` alone, which
  assumes full rank;
* ``triangular_solve`` and ``solve`` take a vector right-hand side as the
  reference does;
* ``qr`` and ``svd`` are free up to the signs of their factors: their specs
  hold the reconstruction, the orthogonality and the singular values, not
  the factors themselves.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import op


@op("cholesky")
def cholesky(x):
    """lower-triangular Cholesky factor (generic/linalg/cholesky.cpp)."""
    return torch.linalg.cholesky(x)


@op("qr")
def qr(x, *, full_matrices: bool = False):
    """QR decomposition → (Q, R) (generic/linalg/qr.cpp)."""
    return tuple(torch.linalg.qr(x, mode="complete" if full_matrices
                                 else "reduced"))


@op("svd")
def svd(x, *, full_matrices: bool = False, compute_uv: bool = True):
    """singular value decomposition (generic/linalg/svd.cpp): (U, S, Vh),
    or S alone."""
    if not compute_uv:
        return torch.linalg.svdvals(x)
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def _as_matrix(a, b):
    vec = b.ndim == a.ndim - 1
    return (b.unsqueeze(-1) if vec else b), vec


@op("solve")
def solve(a, b):
    """linear system solve Ax=b (generic/linalg/solve.cpp)."""
    return torch.linalg.solve(a, b)


@op("triangular_solve")
def triangular_solve(a, b, *, lower: bool = True, adjoint: bool = False):
    """triangular solve (generic/linalg/triangular_solve.cpp); ``adjoint``
    solves aᵀx = b."""
    bm, vec = _as_matrix(a, b)
    if adjoint:
        a, lower = a.transpose(-1, -2), not lower
    x = torch.linalg.solve_triangular(a, bm, upper=not lower)
    return x.squeeze(-1) if vec else x


@op("lstsq")
def lstsq(a, b):
    """least-squares solution (generic/linalg/lstsq.cpp): the minimum-norm
    solution through the SVD."""
    bm, vec = _as_matrix(a, b)
    x = torch.linalg.pinv(a) @ bm
    return x.squeeze(-1) if vec else x


@op("matrix_inverse")
def matrix_inverse(x):
    """matrix inverse (generic/linalg/matrix_inverse.cpp)."""
    return torch.linalg.inv(x)


@op("matrix_determinant")
def matrix_determinant(x):
    """determinant (generic/linalg/matrixDeterminant.cpp)."""
    return torch.linalg.det(x)


@op("log_matrix_determinant")
def log_matrix_determinant(x):
    """(sign, log|det|) (generic/linalg/logMatrixDeterminant analog)."""
    return tuple(torch.linalg.slogdet(x))


@op("lu")
def lu(x):
    """LU with partial pivoting → (lu_packed, pivots), the pivots 0-based
    int32 as ``lu_factor``'s (generic/linalg/lup.cpp)."""
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, (piv - 1).to(torch.int32)


@op("cross")
def cross(a, b):
    """3-vector cross product (generic/linalg/cross.cpp)."""
    return torch.linalg.cross(a, b, dim=-1)


@op("tensormmul")
def tensormmul(a, b, *, axes_a, axes_b):
    """tensordot (generic/linalg/tensormmul.cpp)."""
    return torch.tensordot(a, b, dims=(list(axes_a), list(axes_b)))


@op("matrix_set_diag")
def matrix_set_diag(x, diag_vals):
    """replace the main diagonal (generic/parity_ops/matrix_set_diag.cpp)."""
    n = min(x.shape[-2], x.shape[-1])
    return torch.diagonal_scatter(x, diag_vals[..., :n].to(x.dtype),
                                  dim1=-2, dim2=-1)


@op("einsum")
def einsum(*operands, equation: str):
    """General tensor contraction (TF/ONNX Einsum parity)."""
    return torch.einsum(equation, *operands)


# ---- validation specs -------------------------------------------------------


def _spd(r, n, batch=()):
    a = r.randn(*batch, n, n).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


def _x(*shape):
    return lambda r: [r.randn(*shape).astype(np.float32)]


def _check_qr(outs, spec, dtype):
    x = np.asarray(spec.draw()[0], np.float64)
    q, r = (np.asarray(o, np.float64) for o in outs)
    np.testing.assert_allclose(q @ r, x, rtol=1e-4, atol=1e-5)
    eye = np.broadcast_to(np.eye(q.shape[-1]),
                          q.shape[:-2] + (q.shape[-1],) * 2)
    np.testing.assert_allclose(np.swapaxes(q, -1, -2) @ q, eye, atol=1e-5)
    np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-6)


def _check_svd(outs, spec, dtype):
    x = np.asarray(spec.draw()[0], np.float64)
    want = np.linalg.svd(x, compute_uv=False)
    if len(outs) == 1:
        np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-5)
        return
    u, s, vh = (np.asarray(o, np.float64) for o in outs)
    np.testing.assert_allclose(s, want, rtol=1e-5, atol=1e-5)
    k = s.shape[-1]
    np.testing.assert_allclose((u[..., :, :k] * s[..., None, :])
                               @ vh[..., :k, :], x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.swapaxes(u, -1, -2) @ u,
                               np.eye(u.shape[-1]), atol=1e-5)
    np.testing.assert_allclose(vh @ np.swapaxes(vh, -1, -2),
                               np.eye(vh.shape[-2]), atol=1e-5)


V.case("cholesky", lambda r: [_spd(r, 4)], grad=True, rtol=1e-5, atol=1e-5)
V.case("cholesky", lambda r: [_spd(r, 3, (2,))], rtol=1e-5, atol=1e-5,
       label="batched")
for _full in (False, True):
    V.case("qr", _x(5, 3), kwargs={"full_matrices": _full}, check=_check_qr,
           label=f"full={_full}")
    V.case("svd", _x(4, 6), kwargs={"full_matrices": _full},
           check=_check_svd, label=f"full={_full}")
V.case("qr", _x(2, 3, 4), check=_check_qr, label="batched-wide")
V.case("svd", _x(5, 3), kwargs={"compute_uv": False}, check=_check_svd,
       label="values")
V.case("solve", lambda r: [_spd(r, 4), r.randn(4, 2).astype(np.float32)],
       grad=True, rtol=1e-5, atol=1e-5)
V.case("solve", lambda r: [_spd(r, 3, (2,)), r.randn(2, 3, 1).astype(
    np.float32)], rtol=1e-5, atol=1e-5, label="batched")
for _lower in (True, False):
    for _adj in (False, True):
        V.case("triangular_solve",
               lambda r: [(np.tril(r.randn(4, 4)) + 4 * np.eye(4)).astype(
                   np.float32), r.randn(4, 3).astype(np.float32)],
               kwargs={"lower": _lower, "adjoint": _adj}, grad=True,
               rtol=1e-5, atol=1e-5, label=f"lower={_lower},adj={_adj}")
V.case("triangular_solve",
       lambda r: [(np.tril(r.randn(3, 3)) + 3 * np.eye(3)).astype(
           np.float32), r.randn(3).astype(np.float32)],
       rtol=1e-5, atol=1e-5, label="vector")
V.case("lstsq", lambda r: [r.randn(6, 3).astype(np.float32),
                           r.randn(6, 2).astype(np.float32)],
       rtol=1e-4, atol=1e-5)


def _rank_deficient(r):
    a = r.randn(5, 2).astype(np.float32) @ r.randn(2, 4).astype(np.float32)
    return [a, r.randn(5).astype(np.float32)]


# rank 2 of 4: the minimum-norm solution (gels would assume full rank)
V.case("lstsq", _rank_deficient, rtol=1e-3, atol=1e-4, label="rank-2")
V.case("matrix_inverse", lambda r: [_spd(r, 4)], grad=True, rtol=1e-5,
       atol=1e-5)
V.case("matrix_determinant", _x(2, 3, 3), grad=True, rtol=1e-5, atol=1e-5)
V.case("log_matrix_determinant", _x(2, 4, 4), grad=True, rtol=1e-5,
       atol=1e-5)
V.case("lu", _x(4, 4), rtol=1e-5, atol=1e-5)
V.case("lu", _x(2, 3, 3), rtol=1e-5, atol=1e-5, label="batched")
V.case("cross", lambda r: [r.randn(4, 3).astype(np.float32),
                           r.randn(4, 3).astype(np.float32)],
       grad=True, rtol=1e-5, atol=1e-5)
V.case("tensormmul", lambda r: [r.randn(2, 3, 4).astype(np.float32),
                                r.randn(4, 3, 5).astype(np.float32)],
       kwargs={"axes_a": (1, 2), "axes_b": (1, 0)}, grad=True, rtol=1e-5,
       atol=1e-5)
V.case("matrix_set_diag", lambda r: [r.randn(2, 3, 4).astype(np.float32),
                                     r.randn(2, 3).astype(np.float32)],
       dtypes=V.HALF, grad=True)
V.case("einsum", lambda r: [r.randn(2, 3, 4).astype(np.float32),
                            r.randn(2, 4, 5).astype(np.float32)],
       kwargs={"equation": "bij,bjk->bik"}, grad=True, rtol=1e-5, atol=1e-5)
V.case("einsum", lambda r: [r.randn(3, 4).astype(np.float32)],
       kwargs={"equation": "ij->j"}, label="reduce")
