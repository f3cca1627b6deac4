"""The remaining declarable-op families of the port: top-k, CTC, sets and
histograms, norms and distances, special functions, sorting and friends.

Counterpart of ``deeplearning4j_tpu/ops/misc_ops.py``, under the same
names and keywords. What it takes care over:

* ``top_k`` gives the lower index first among equal values, as
  ``lax.top_k`` does: a stable descending sort (``torch.topk`` on the card
  does not promise the order of ties); ``sort`` and ``argsort`` are stable
  as jnp's are, indices int32;
* ``unique`` and ``listdiff`` keep the reference's static shapes: values
  padded to ``size`` with ``fill_value`` (``misc_ops.py:111``), computed on
  the device with no host read of the count;
* ``ctc_loss`` is the reference's log-semiring alpha recursion with its
  −1e30 floor (``misc_ops.py:59``): per-example losses, finite where
  ``F.ctc_loss`` would give ``inf``;
* torch has no ``betainc``: it is the continued fraction (modified Lentz,
  as Numerical Recipes' ``betacf``) in float64; ``igamma`` / ``igammac``
  are ``torch.special.gammainc`` / ``gammaincc``; ``polygamma`` takes a
  tensor order through the Hurwitz zeta.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.reductions import dims
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.ops.shape_ops import pad_mirror
from deeplearning4j_tpu_torch.ops.transforms import inexact

_NEG_INF = -1e30


def total_order_key(x):
    """An integer key of floating ``x`` that sorts as ``lax.top_k``
    compares: the IEEE total order, where −0.0 < +0.0 and NaNs sort by
    their bits. Integer tensors are their own key."""
    if not x.is_floating_point():
        return x
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    i = x.view(bits)
    return torch.where(i < 0, i ^ torch.iinfo(bits).max, i)


@op("top_k")
def top_k(x, *, k: int, sorted: bool = True):
    """top_k → (values, indices int32) along the last axis
    (generic/parity_ops/top_k.cpp): the IEEE total order, equal keys in
    index order, as ``lax.top_k``."""
    idx = torch.sort(total_order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


@op("in_top_k")
def in_top_k(predictions, targets, *, k: int):
    """whether targets[i] ranks in the top-k of predictions[i]
    (generic/parity_ops/in_top_k.cpp)."""
    target = torch.gather(predictions, 1,
                          targets.to(torch.int64)[:, None])[:, 0]
    rank = torch.sum(predictions > target[:, None], dim=1)
    return rank < k


@op("ctc_loss")
def ctc_loss(logits, labels, logit_lengths, label_lengths, *, blank: int = 0):
    """CTC negative log-likelihood (generic/nn/ctc_loss.cpp). logits:
    (B, T, C) unnormalized; labels: (B, S) int (padded); lengths: (B,).
    Returns the per-example loss (B,).

    The log-semiring alpha recursion over the blank-interleaved extended
    labels [blank, l1, blank, l2, ..., blank], batched, one step a frame;
    frames past an example's length leave its alphas as they are."""
    log_probs = torch.log_softmax(logits, dim=-1)
    b, t_max, _ = logits.shape
    s_max = labels.shape[1]
    dev = logits.device
    lab = labels.to(torch.int64)
    ext = torch.full((b, 2 * s_max + 1), blank, dtype=torch.int64,
                     device=dev)
    ext[:, 1::2] = lab
    n_ext = 2 * label_lengths.to(torch.int64) + 1
    can_skip = torch.zeros((b, 2 * s_max + 1), dtype=torch.bool, device=dev)
    if s_max > 1:
        can_skip[:, 3::2] = lab[:, 1:] != lab[:, :-1]
    neg = torch.full((), _NEG_INF, dtype=log_probs.dtype, device=dev)
    emit = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(b, t_max, ext.shape[1]))
    alpha = torch.full((b, 2 * s_max + 1), _NEG_INF, dtype=log_probs.dtype,
                       device=dev)
    alpha[:, 0] = log_probs[:, 0, blank]
    if s_max >= 1:
        alpha[:, 1] = emit[:, 0, 1]
    t_len = logit_lengths.to(torch.int64)
    for t in range(1, t_max):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG_INF)
        prev2 = F.pad(alpha[:, :-2], (2, 0), value=_NEG_INF)
        prev2 = torch.where(can_skip, prev2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = merged + emit[:, t]
        alpha = torch.where((t < t_len)[:, None], new, alpha)
    last = torch.gather(alpha, 1, (n_ext - 1)[:, None])[:, 0]
    second = torch.gather(alpha, 1, torch.clamp_min(n_ext - 2, 0)[:, None])
    second = torch.where(n_ext >= 2, second[:, 0], neg)
    return -torch.logaddexp(last, second)


@op("unique")
def unique(x, *, size: int = None, fill_value=0):
    """unique values (sorted) + inverse indices int32
    (generic/parity_ops/unique.cpp). Static shapes: the values are padded
    to ``size`` (default: the element count) with ``fill_value``."""
    flat = x.reshape(-1)
    n = flat.numel()
    size = n if size is None else int(size)
    s, perm = torch.sort(flat, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=x.device)
    first[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    vals = torch.full((size + 1,), fill_value, dtype=x.dtype, device=x.device)
    # groups beyond ``size`` land in the spare last cell, dropped below
    vals = vals.scatter(0, torch.where(first & (gid < size), gid, size), s)
    inv = torch.empty(n, dtype=torch.int64, device=x.device)
    inv[perm] = gid
    return vals[:size], inv.to(torch.int32).reshape(x.shape)


@op("listdiff")
def listdiff(x, y, *, size: int = None):
    """elements of x not in y (generic/parity_ops/listdiff.cpp): returns
    (values padded to ``size`` with 0, 0/1 validity mask int32)."""
    size = int(x.shape[0]) if size is None else int(size)
    keep = ~torch.isin(x, y)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    vals = x[order]
    mask = torch.arange(x.shape[0], device=x.device) < keep.sum()
    vals = torch.where(mask, vals, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    return vals[:size], mask.to(torch.int32)[:size]


@op("nth_element")
def nth_element(x, *, n: int, reverse: bool = False):
    """n-th order statistic along the last axis
    (generic/parity_ops/nth_element.cpp)."""
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, dims=(-1,))
    return s[..., n]


@op("confusion_matrix")
def confusion_matrix(labels, predictions, *, num_classes: int, weights=None):
    """confusion matrix (generic/parity_ops/confusion_matrix.cpp)."""
    idx = (labels.to(torch.int64) * num_classes
           + predictions.to(torch.int64)).reshape(-1)
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weights is None else weights.reshape(-1))
    flat = torch.zeros(num_classes * num_classes, dtype=w.dtype,
                       device=w.device).index_add(0, idx, w)
    return flat.reshape(num_classes, num_classes)


def _count_bins(bins, num_bins):
    flat = bins.reshape(-1).to(torch.int64)
    return torch.zeros(num_bins, dtype=torch.int32,
                       device=bins.device).index_add(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


@op("histogram")
def histogram(x, *, num_bins: int):
    """equal-width histogram over [min, max], int32 counts
    (generic/parity_ops/histogram.cpp)."""
    lo, hi = torch.amin(x), torch.amax(x)
    width = torch.clamp_min(hi - lo, 1e-12)
    bins = torch.clamp(((x - lo) / width * num_bins).to(torch.int32),
                       0, num_bins - 1)
    return _count_bins(bins, num_bins)


@op("histogram_fixed_width")
def histogram_fixed_width(x, *, range, num_bins: int = 100):
    """histogram over an explicit [lo, hi] range, int32 counts
    (generic/parity_ops/histogram_fixed_width.cpp)."""
    lo, hi = range
    width = (hi - lo) / num_bins
    bins = torch.clamp(((x - lo) / width).to(torch.int32), 0, num_bins - 1)
    return _count_bins(bins, num_bins)


@op("clip_by_global_norm")
def clip_by_global_norm(*xs, clip_norm: float):
    """scale a tensor list so the joint L2 norm <= clip_norm
    (generic/transforms/clip_by_global_norm analog)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(x)) for x in xs))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tuple(x * scale for x in xs)


@op("clip_by_avg_norm")
def clip_by_avg_norm(x, *, clip_norm: float):
    """clip by mean-normalized L2 norm (generic/transforms/clipbyavgnorm)."""
    avg = torch.linalg.vector_norm(x.reshape(-1)) / x.numel()
    scale = torch.clamp_max(clip_norm / torch.clamp_min(avg, 1e-12), 1.0)
    return x * scale


@op("l2_normalize")
def l2_normalize(x, *, axis=-1, eps: float = 1e-12):
    """x / ||x||_2 along axis (TF l2_normalize parity)."""
    return x / torch.sqrt(torch.clamp_min(
        torch.sum(torch.square(x), dim=dims(x, axis), keepdim=True), eps))


@op("lgamma")
def lgamma(x):
    """log-gamma (generic/parity_ops/lgamma.cpp)."""
    return torch.lgamma(inexact(x))


@op("digamma")
def digamma(x):
    """digamma ψ (generic/parity_ops/digamma.cpp)."""
    return torch.special.digamma(inexact(x))


@op("igamma")
def igamma(a, x):
    """regularized lower incomplete gamma (generic/parity_ops/igamma.cpp)."""
    return torch.special.gammainc(a, x)


@op("igammac")
def igammac(a, x):
    """regularized upper incomplete gamma (generic/parity_ops/igammac.cpp)."""
    return torch.special.gammaincc(a, x)


def _betacf(a, b, x, iters: int = 200):
    """The continued fraction of I_x(a, b) (modified Lentz), float64."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


@op("betainc")
def betainc(a, b, x):
    """regularized incomplete beta I_x(a, b) (generic/parity_ops/betainc.cpp):
    the continued fraction in float64, on the side of (a+1)/(a+b+2) where
    it converges fast (the symmetry I_x(a, b) = 1 − I_{1−x}(b, a))."""
    out_dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                    x.dtype)
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    lbeta = torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
    xc = torch.clamp(x, 1e-300, 1.0 - 1e-16)
    front = torch.exp(lbeta + a * torch.log(xc) + b * torch.log1p(-xc))
    direct = x < (a + 1.0) / (a + b + 2.0)
    aa = torch.where(direct, a, b)
    bb = torch.where(direct, b, a)
    xx = torch.where(direct, xc, 1.0 - xc)
    cf = _betacf(aa, bb, xx)
    val = torch.where(direct, front * cf / a, 1.0 - front * cf / b)
    val = torch.where(x <= 0, torch.zeros_like(val),
                      torch.where(x >= 1, torch.ones_like(val), val))
    bad = (a <= 0) | (b <= 0) | (x < 0) | (x > 1) | torch.isnan(x)
    return torch.where(bad, torch.full_like(val, float("nan")),
                       val).to(out_dtype)


@op("zeta")
def zeta(x, q):
    """Hurwitz zeta (generic/parity_ops/zeta.cpp)."""
    return torch.special.zeta(x, q)


@op("polygamma")
def polygamma(n, x):
    """polygamma ψ⁽ⁿ⁾ (generic/parity_ops/polygamma.cpp) for a tensor of
    orders: ψ for n = 0, (−1)ⁿ⁺¹ n! ζ(n + 1, x) above."""
    n = n.to(x.dtype)
    sign = torch.where(torch.remainder(n, 2) == 0, -1.0, 1.0).to(x.dtype)
    higher = sign * torch.exp(torch.lgamma(n + 1.0)) * \
        torch.special.zeta(n + 1.0, x)
    return torch.where(n == 0, torch.special.digamma(x), higher)


@op("sort")
def sort(x, *, axis: int = -1, descending: bool = False):
    """sort along axis (generic/parity_ops/sort.cpp). Descending is the
    stable ascending sort reversed, as jnp's: equal values come out in
    reverse index order (what their gradients see)."""
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, dims=(axis,)) if descending else out


@op("argsort")
def argsort(x, *, axis: int = -1, descending: bool = False):
    """argsort along axis (Nd4j.sortWithIndices role); stable for ties in
    both directions, int32."""
    return torch.sort(x, dim=axis, descending=descending,
                      stable=True).indices.to(torch.int32)


@op("roll")
def roll(x, *, shift, axis=None):
    """cyclic roll (generic/transforms/roll.cpp)."""
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, dims=axis)


@op("triu")
def triu(x, *, diag: int = 0):
    """upper triangle (generic/parity_ops/triu.cpp)."""
    return torch.triu(x, diagonal=diag)


@op("tril")
def tril(x, *, diag: int = 0):
    """lower triangle (generic/parity_ops analog of triu)."""
    return torch.tril(x, diagonal=diag)


@op("invert_permutation")
def invert_permutation(x):
    """inverse permutation vector (generic/parity_ops/invertPermutation)."""
    n = x.shape[0]
    return torch.zeros(n, dtype=x.dtype, device=x.device).scatter(
        0, x.to(torch.int64), torch.arange(n, dtype=x.dtype, device=x.device))


@op("meshgrid")
def meshgrid(*xs, indexing: str = "xy"):
    """meshgrid (generic/parity_ops/meshgrid.cpp)."""
    return tuple(torch.meshgrid(*xs, indexing=indexing))


@op("stop_gradient")
def stop_gradient(x):
    """gradient barrier (StopGradient op)."""
    return x.detach()


@op("identity_n")
def identity_n(*xs):
    """identity over a tensor list (generic/parity_ops/identity_n.cpp)."""
    return tuple(xs)


@op("mirror_pad")
def mirror_pad(x, *, paddings, mode: str = "reflect"):
    """mirror_pad (generic/parity_ops/mirror_pad.cpp): REFLECT|SYMMETRIC."""
    return pad_mirror(x, [tuple(int(v) for v in p) for p in paddings],
                      mode.lower())


@op("batch_gather")
def batch_gather(params, indices):
    """per-batch gather (TF batch_gather parity): gathers along axis
    ``indices.ndim - 1`` of params, broadcasting over params' trailing
    dims — params (B, N, ...) + indices (B, M) → (B, M, ...)."""
    idx = indices.to(torch.int64)
    axis = idx.ndim - 1
    idx = idx.reshape(tuple(idx.shape) + (1,) * (params.ndim - idx.ndim))
    shape = list(params.shape)
    shape[axis] = idx.shape[axis]
    return torch.gather(params, axis, idx.expand(shape))


@op("log_sigmoid")
def log_sigmoid(x):
    """log σ(x) (legacy transform)."""
    return F.logsigmoid(inexact(x))


@op("cosine_similarity")
def cosine_similarity(a, b, *, axis: int = -1, eps: float = 1e-12):
    """reduce3 cosine similarity (libnd4j reduce3/CosineSimilarity)."""
    num = torch.sum(a * b, dim=axis)
    den = torch.linalg.vector_norm(a, dim=axis) * \
        torch.linalg.vector_norm(b, dim=axis)
    return num / torch.clamp_min(den, eps)


@op("euclidean_distance")
def euclidean_distance(a, b, *, axis: int = -1):
    """reduce3 EuclideanDistance."""
    return torch.sqrt(torch.sum(torch.square(a - b), dim=axis))


@op("manhattan_distance")
def manhattan_distance(a, b, *, axis: int = -1):
    """reduce3 ManhattanDistance."""
    return torch.sum(torch.abs(a - b), dim=axis)


@op("hamming_distance")
def hamming_distance(a, b, *, axis: int = -1):
    """reduce3 HammingDistance (count of unequal entries), float32."""
    return torch.sum((a != b).to(torch.float32), dim=axis)


# ---- validation specs -------------------------------------------------------


def _r(*shape, scale=1.0):
    return lambda r: r.randn(*shape).astype(np.float32) * np.float32(scale)


def _args(*makers):
    return lambda r: [m(r) if callable(m) else m for m in makers]


def _x(*shape, scale=1.0):
    return lambda r: [_r(*shape, scale=scale)(r)]


def _ties(r):
    return [np.round(r.randn(4, 9) * 2).astype(np.float32)]


V.case("top_k", _ties, kwargs={"k": 4}, dtypes=V.HALF, grad=True)
V.case("in_top_k", _args(lambda r: _ties(r)[0],
                         np.asarray([0, 3, 8, 5], np.int32)),
       kwargs={"k": 3}, label="ties")
V.case("in_top_k", _args(_r(5, 7), np.asarray([0, 3, 6, 5, 1], np.int32)),
       kwargs={"k": 2}, dtypes=V.HALF)


def _ctc(r):
    logits = r.randn(3, 12, 5).astype(np.float32)
    labels = np.asarray([[1, 2, 2, 3], [4, 1, 0, 0], [2, 1, 3, 0]], np.int32)
    return [logits, labels, np.asarray([12, 9, 7], np.int32),
            np.asarray([4, 2, 3], np.int32)]


def _ctc_floor(r):
    logits, labels, t_len, s_len = _ctc(r)
    labels[2] = 2  # 4 repeated labels need 7 frames; it has 7 - 2
    return [logits, labels, t_len - np.asarray([0, 0, 2], np.int32),
            s_len + np.asarray([0, 0, 1], np.int32)]


V.case("ctc_loss", _ctc, grad=True, rtol=1e-5, atol=1e-4)
V.case("ctc_loss", _ctc, kwargs={"blank": 4}, rtol=1e-5, atol=1e-4,
       label="blank=4", seed=1)
# an example that cannot align: the −1e30 floor makes its loss 1e30, where
# F.ctc_loss gives inf (values only: its gradient is that of a floor,
# ties between −1e30 terms, and no measure of either implementation)
V.case("ctc_loss", _ctc_floor, rtol=1e-5, atol=1e-4, label="floor")
V.case("unique", lambda r: [r.randint(0, 5, (3, 4)).astype(np.int32)],
       kwargs={"size": 8, "fill_value": -1})
V.case("unique", lambda r: [np.round(r.randn(9)).astype(np.float32)],
       label="float")
V.case("listdiff", lambda r: [np.asarray([1, 2, 3, 4, 5, 6], np.int32),
                              np.asarray([2, 5, 9], np.int32)],
       kwargs={"size": 5})
V.case("listdiff", lambda r: [np.asarray([3.0, 1.0, 3.0, 2.0], np.float32),
                              np.asarray([1.0], np.float32)],
       label="float")
V.case("nth_element", _x(4, 7), kwargs={"n": 2}, dtypes=V.HALF, grad=True)
V.case("nth_element", _x(4, 7), kwargs={"n": 0, "reverse": True},
       label="reverse")
V.case("confusion_matrix", lambda r: [np.asarray([0, 1, 2, 2, 1], np.int32),
                                      np.asarray([0, 2, 2, 1, 1], np.int32)],
       kwargs={"num_classes": 3})
V.case("confusion_matrix", lambda r: [np.asarray([0, 1, 1], np.int32),
                                      np.asarray([1, 1, 0], np.int32)],
       kwargs={"num_classes": 2,
               "weights": np.asarray([0.5, 2.0, 1.5], np.float32)},
       label="weights")
V.case("histogram", _x(5, 8), kwargs={"num_bins": 6})
V.case("histogram_fixed_width", _x(40), kwargs={"range": (-1.5, 2.0),
                                                "num_bins": 7})
V.case("clip_by_global_norm", _args(_r(3, 4), _r(5)),
       kwargs={"clip_norm": 1.5}, dtypes=V.HALF, grad=True)
V.case("clip_by_global_norm", _args(_r(3, 4, scale=0.01)),
       kwargs={"clip_norm": 1.5}, label="under")
V.case("clip_by_avg_norm", _x(3, 4), kwargs={"clip_norm": 0.1},
       dtypes=V.HALF, grad=True)
V.case("l2_normalize", _x(3, 6), dtypes=V.HALF, grad=True)
V.case("l2_normalize", _x(3, 4, 2), kwargs={"axis": (1, 2)}, grad=True,
       label="axes")


def _pos(*shape, lo=0.2, hi=4.0):
    return lambda r: (lo + (hi - lo) * r.rand(*shape)).astype(np.float32)


V.case("lgamma", _args(_pos(4, 6, lo=0.1, hi=6.0)), grad=True)
V.case("digamma", _args(_pos(4, 6, lo=0.1, hi=6.0)), grad=True, rtol=1e-5,
       atol=1e-5)
V.case("igamma", _args(_pos(4, 5), _pos(4, 5, lo=0.0, hi=6.0)),
       rtol=2e-5, atol=1e-6)
V.case("igammac", _args(_pos(4, 5), _pos(4, 5, lo=0.0, hi=6.0)),
       rtol=2e-5, atol=1e-6)
# float32 JAX against the float64 fraction: a few float32 units
V.case("betainc", _args(_pos(4, 5, lo=0.3, hi=5.0), _pos(4, 5, lo=0.3,
                                                         hi=5.0),
                        _pos(4, 5, lo=0.0, hi=1.0)),
       rtol=1e-5, atol=1e-6)
V.case("zeta", _args(_pos(3, 4, lo=1.5, hi=5.0), _pos(3, 4, lo=0.5,
                                                      hi=3.0)),
       rtol=1e-5, atol=1e-6)
V.case("polygamma", _args(lambda r: r.randint(0, 4, (3, 4)).astype(
    np.float32), _pos(3, 4, lo=0.5, hi=4.0)), rtol=2e-5, atol=1e-5)
for _desc in (False, True):
    V.case("sort", _ties, kwargs={"descending": _desc}, dtypes=V.HALF,
           grad=True, label=f"descending={_desc}")
    V.case("argsort", _ties, kwargs={"descending": _desc}, dtypes=V.HALF,
           label=f"descending={_desc}")
V.case("sort", _x(4, 5), kwargs={"axis": 0}, label="axis=0")
V.case("roll", _x(3, 5), kwargs={"shift": 2, "axis": 1}, dtypes=V.HALF,
       grad=True)
V.case("roll", _x(3, 5), kwargs={"shift": -4}, label="flat")
V.case("roll", _x(3, 5), kwargs={"shift": (1, -2), "axis": (0, 1)},
       label="axes")
V.case("triu", _x(4, 5), kwargs={"diag": 1}, dtypes=V.HALF, grad=True)
V.case("tril", _x(2, 4, 5), kwargs={"diag": -1}, dtypes=V.HALF, grad=True)
V.case("invert_permutation",
       lambda r: [r.permutation(7).astype(np.int32)])
V.case("meshgrid", _args(_r(3), _r(4)), grad=True)
V.case("meshgrid", _args(_r(3), _r(4), _r(2)), kwargs={"indexing": "ij"},
       label="ij")
V.case("stop_gradient", _x(3, 4), dtypes=V.HALF, grad=True)
V.case("identity_n", _args(_r(3), _r(2, 2)), grad=True)
for _mode in ("reflect", "symmetric"):
    V.case("mirror_pad", _x(3, 5), kwargs={"paddings": ((1, 2), (2, 2)),
                                           "mode": _mode},
           dtypes=V.HALF, grad=True, label=_mode)
V.case("batch_gather", _args(_r(2, 5, 3), np.asarray([[0, 4], [2, 2]],
                                                     np.int32)),
       dtypes=V.HALF, grad=True)
V.case("batch_gather", _args(_r(2, 5), np.asarray([[4, 0, 1], [3, 3, 0]],
                                                  np.int32)),
       label="2d")
V.case("log_sigmoid", _x(4, 6), dtypes=V.HALF, grad=True)
V.case("cosine_similarity", _args(_r(3, 6), _r(3, 6)), dtypes=V.HALF,
       grad=True)
V.case("euclidean_distance", _args(_r(3, 6), _r(3, 6)), dtypes=V.HALF,
       grad=True)
V.case("manhattan_distance", _args(_r(3, 6), _r(3, 6)), kwargs={"axis": 0},
       dtypes=V.HALF, grad=True)
V.case("hamming_distance",
       lambda r: [r.randint(0, 3, (3, 6)).astype(np.int32),
                  r.randint(0, 3, (3, 6)).astype(np.int32)])
