"""The recurrent slice of the PyTorch port against the JAX package (CPU).

The sequential network's ops (``dropout``, ``embedding_lookup``,
``lstm_cell``, ``gru_cell``, ``simple_rnn_cell``, ``lstm_sequence``,
``gru_sequence``), the ``lstm_layer`` op's generic against the JAX
package's ``_lstm_scan``, and each recurrent layer (LSTM, GravesLSTM,
GRU, SimpleRnn, Bidirectional in its four modes and over GRU and
SimpleRnn, LastTimeStep) with no mask, a right-padded mask and an
interior mask. Inputs are drawn with numpy; parameters are drawn by the
JAX package and carried across as numpy, never re-seeded.

Tolerances: outputs 1e-5 relative + 1e-5 absolute and gradients 1e-4,
the same float32 math summed in other orders (products of up to 4·8
terms, ten steps of recurrence). ``dropout`` draws from a
``torch.Generator`` where the JAX package draws from a PRNG key, so it
is held to its semantics, not to the JAX bits.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import nn_ops as jops
from deeplearning4j_tpu_torch.models._tree import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn.layers import build_layer
from deeplearning4j_tpu_torch.ops import exec_op, registry
from deeplearning4j_tpu_torch.ops import nn_ops as tops
from deeplearning4j_tpu_torch.ops.cudnn_lstm import (
    lstm_layer, right_padded_lengths)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
N, T, I, H = 4, 10, 5, 6
# right padding (every row at least one step) and an interior mask
MASKS = {
    "none": None,
    "right": (np.arange(T)[None, :] < np.array([10, 7, 3, 1])[:, None]),
    "interior": np.array([[1, 1, 0, 1, 1, 1, 0, 0, 1, 1],
                          [0, 1, 1, 1, 0, 1, 1, 1, 1, 0],
                          [1, 0, 1, 0, 1, 0, 1, 0, 1, 0],
                          [1, 1, 1, 1, 1, 1, 1, 1, 1, 1]], bool),
}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _mask(name):
    m = MASKS[name]
    return None if m is None else m.astype(np.float32)


# ---------------------------------------------------------------------------
# the seven ops
# ---------------------------------------------------------------------------


def test_op_registry_holds_the_sequential_ops():
    reg = registry()
    for name in ("dropout", "embedding_lookup", "lstm_cell", "gru_cell",
                 "simple_rnn_cell", "lstm_sequence", "gru_sequence",
                 "lstm_layer"):
        assert name in reg
    # the JAX registry's 285 (the op catalog, tests/test_torch_op_catalog.py)
    # and the port's own fused_bn_matmul_stats and lstm_layer
    assert len(reg._ops) == 287
    assert reg.get("lstm_layer").platform_labels == {"cuda": "cudnn"}


def test_dropout_semantics():
    """Kept entries are x / (1 - rate), the rest 0, the kept share near
    1 - rate; the same generator seed gives the same draw; rate 0 and
    ``deterministic`` return x itself."""
    x = _t(_rand((200, 300), 0)) + 5.0
    draw = tops.dropout.fn(x, torch.Generator().manual_seed(3), rate=0.3)
    kept = draw != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(draw[kept], (x / 0.7)[kept], rtol=0, atol=0)
    again = exec_op("dropout", x, torch.Generator().manual_seed(3), rate=0.3)
    assert torch.equal(draw, again)
    other = tops.dropout.fn(x, torch.Generator().manual_seed(4), rate=0.3)
    assert not torch.equal(draw, other)
    assert tops.dropout.fn(x, None, rate=0.0) is x
    assert tops.dropout.fn(x, None, rate=0.3, deterministic=True) is x


def test_embedding_lookup_matches_jax_with_gradient():
    table = _rand((11, 7), 1)
    ids = np.array([[3, 0, 10], [3, 3, 1]], np.int32)
    w = _rand((2, 3, 7), 2)
    got = tops.embedding_lookup.fn(_t(table), torch.from_numpy(ids))
    np.testing.assert_allclose(
        got.numpy(), _np(jops.embedding_lookup.fn(jnp.asarray(table),
                                                  jnp.asarray(ids))), **FWD)
    tt = _t(table).requires_grad_(True)
    (tops.embedding_lookup.fn(tt, torch.from_numpy(ids)) * _t(w)).sum(
        ).backward()
    jg = jax.grad(lambda tb: jnp.sum(jops.embedding_lookup.fn(
        tb, jnp.asarray(ids)) * w))(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), _np(jg), **GRAD)


def _cell_args(kind):
    b, i, h = 3, 5, 4
    g = {"lstm": 4, "gru": 3, "simple": 1}[kind]
    args = [_rand((b, i), 10), _rand((b, h), 11)]
    if kind == "lstm":
        args.append(_rand((b, h), 12))
    args += [_rand((i, g * h), 13, 0.5), _rand((h, g * h), 14, 0.5),
             _rand((g * h,), 15, 0.1)]
    if kind == "gru":
        args.append(_rand((g * h,), 16, 0.1))
    return args


@pytest.mark.parametrize("kind,name", [("lstm", "lstm_cell"),
                                       ("gru", "gru_cell"),
                                       ("simple", "simple_rnn_cell")])
def test_cells_match_jax_with_gradients(kind, name):
    args = _cell_args(kind)
    tfn, jfn = getattr(tops, name).fn, getattr(jops, name).fn
    touts = tfn(*[_t(a) for a in args])
    jouts = jfn(*[jnp.asarray(a) for a in args])
    touts = touts if isinstance(touts, tuple) else (touts,)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a.numpy(), _np(b), **FWD)
    ws = [_rand(o.shape, 20 + k) for k, o in enumerate(touts)]
    targs = [_t(a).requires_grad_(True) for a in args]
    outs = tfn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(((o * _t(w)).sum() for o, w in zip(outs, ws))).backward()

    def jloss(*a):
        o = jfn(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(x * w) for x, w in zip(o, ws))

    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    for t_arg, g in zip(targs, jg):
        np.testing.assert_allclose(t_arg.grad.numpy(), _np(g), **GRAD)


@pytest.mark.parametrize("case", ["lstm", "lstm_state", "gru", "gru_onnx"])
def test_sequence_ops_match_jax_with_gradients(case):
    x = _rand((3, 6, 5), 30)
    if case.startswith("lstm"):
        args = [x, _rand((5, 16), 31, 0.5), _rand((4, 16), 32, 0.5),
                _rand((16,), 33, 0.1)]
        if case == "lstm_state":
            args += [_rand((3, 4), 34), _rand((3, 4), 35)]
        tfn, jfn, kw = tops.lstm_sequence.fn, jops.lstm_sequence.fn, {}
    else:
        args = [x, _rand((5, 12), 31, 0.5), _rand((4, 12), 32, 0.5),
                _rand((12,), 33, 0.1), _rand((12,), 34, 0.1)]
        tfn, jfn = tops.gru_sequence.fn, jops.gru_sequence.fn
        kw = {"linear_before_reset": case == "gru"}
    targs = [_t(a).requires_grad_(True) for a in args]
    touts = tfn(*targs, **kw)
    jouts = jfn(*[jnp.asarray(a) for a in args], **kw)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), **FWD)
    w = _rand(touts[0].shape, 36)
    (touts[0] * _t(w)).sum().backward()
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a, **kw)[0] * w),
                  argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    for t_arg, g in zip(targs, jg):
        np.testing.assert_allclose(t_arg.grad.numpy(), _np(g), **GRAD)


# ---------------------------------------------------------------------------
# the lstm_layer op against _lstm_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("gate", ["sigmoid", "hardsigmoid"])
def test_lstm_layer_generic_matches_lstm_scan(reverse, mask, gate):
    """Outputs at every position, the last h and c, from a carried-in
    state, and gradients of all seven inputs."""
    from deeplearning4j_tpu.ops.activations import get_activation

    args = [_rand((N, T, I), 40), _rand((I, 4 * H), 41, 0.5),
            _rand((H, 4 * H), 42, 0.5), _rand((4 * H,), 43, 0.1),
            _rand((N, H), 44), _rand((N, H), 45)]
    m = _mask(mask)
    targs = [_t(a).requires_grad_(True) for a in args]
    hs, h, c = lstm_layer.fn(*targs[:4], targs[4], targs[5],
                             None if m is None else _t(m),
                             gate_activation=gate, activation="tanh",
                             reverse=reverse)

    def jrun(x, w, rw, b, h0, c0):
        return jlayers._lstm_scan(
            {"W": w, "RW": rw, "b": b}, x, h0, c0,
            None if m is None else jnp.asarray(m),
            gate_act=get_activation(gate), cell_act=jnp.tanh,
            reverse=reverse)

    jargs = [jnp.asarray(a) for a in args]
    jhs, jh, jc = jrun(*jargs)
    for a, b in ((hs, jhs), (h, jh), (c, jc)):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), **FWD)
    ws = [_rand(hs.shape, 46), _rand(h.shape, 47), _rand(c.shape, 48)]
    sum((o * _t(w)).sum() for o, w in zip((hs, h, c), ws)).backward()
    jg = jax.grad(lambda *a: sum(jnp.sum(o * w) for o, w in zip(
        jrun(*a), ws)), argnums=tuple(range(6)))(*jargs)
    for t_arg, g in zip(targs, jg):
        np.testing.assert_allclose(t_arg.grad.numpy(), _np(g), **GRAD)


def test_right_padded_lengths_reads_the_mask():
    """Lengths for right padding; None for an interior gap or an empty
    row (the cuDNN gate's refusals)."""
    right = torch.from_numpy(_mask("right"))
    assert right_padded_lengths(right).tolist() == [10, 7, 3, 1]
    assert right_padded_lengths(torch.from_numpy(_mask("interior"))) is None
    empty = right.clone()
    empty[3] = 0
    assert right_padded_lengths(empty) is None
    right[1, 8] = 1.0   # in place: the kept answer must not be reused
    assert right_padded_lengths(right) is None


# ---------------------------------------------------------------------------
# the recurrent layers against the JAX package's
# ---------------------------------------------------------------------------


def _layer_confs():
    lstm = dict(n_in=I, n_out=H, activation="tanh")
    cases = {
        "lstm": jconf.LSTM(**lstm),
        "graves_lstm": jconf.GravesLSTM(**lstm),
        "lstm_hardsigmoid": jconf.LSTM(gate_activation="hardsigmoid",
                                       **lstm),
        "gru": jconf.GRU(n_in=I, n_out=H),
        "simple_rnn": jconf.SimpleRnn(n_in=I, n_out=H, activation="tanh"),
        "last_time_step": jconf.LastTimeStep.wrap(jconf.LSTM(**lstm)),
        "bidirectional_gru": jconf.Bidirectional.wrap(
            jconf.GRU(n_in=I, n_out=H), "concat"),
        "bidirectional_simple_rnn": jconf.Bidirectional.wrap(
            jconf.SimpleRnn(n_in=I, n_out=H, activation="tanh"), "average"),
        "bidirectional_last_gru": jconf.Bidirectional.wrap(
            jconf.LastTimeStep.wrap(jconf.GRU(n_in=I, n_out=H)), "add"),
    }
    for mode in ("concat", "add", "mul", "average"):
        cases[f"bidirectional_{mode}"] = jconf.Bidirectional.wrap(
            jconf.LSTM(**lstm), mode)
    return cases


LAYER_CONFS = _layer_confs()


def _pair_of_layers(jlc):
    """The JAX layer, its port twin from the same config's JSON, and the
    JAX parameters carried across."""
    itype = jconf.InputType.recurrent(I)
    jl = jlayers.build_layer(jconf.MultiLayerConfiguration(), jlc, itype)
    tlc = tconf.LayerConf.from_dict(jlc.to_dict())
    tl = build_layer(tconf.MultiLayerConfiguration(), tlc,
                     tconf.InputType.recurrent(I), CPU)
    jp = jl.init(jax.random.key(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jl, tl, jp, tp


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("case", sorted(LAYER_CONFS))
def test_recurrent_layer_matches_jax(case, mask):
    """Forward at every position (padded ones included), the returned
    mask, and the gradients of the parameters and the input."""
    jl, tl, jp, tp = _pair_of_layers(LAYER_CONFS[case])
    x = _rand((N, T, I), 50)
    m = _mask(mask)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else _t(m)
    jy, _, jmask = jl.apply(jp, jnp.asarray(x), {}, train=False, rng=None,
                            mask=jm)
    tx = _t(x).requires_grad_(True)
    tp = jax.tree.map(lambda v: v.requires_grad_(True), tp)
    ty, _, tmask = tl.apply(tp, tx, {}, train=False, rng=None, mask=tm)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **FWD)
    assert (tmask is None) == (jmask is None)
    w = _rand(ty.shape, 51)
    (ty * _t(w)).sum().backward()
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jl.apply(
        p, xx, {}, train=False, rng=None, mask=jm)[0] * w), argnums=(0, 1))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), **GRAD)
    flat_j = jax.tree_util.tree_leaves_with_path(jgp)
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, g in flat_j:
        leaf = tp
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf.grad.numpy(), _np(g), **GRAD,
                                   err_msg=str(path))


@pytest.mark.parametrize("case", ["lstm", "gru", "simple_rnn"])
def test_apply_with_state_carries_the_jax_state(case):
    """The stateful forward from a carried-in state: outputs and the last
    state equal the JAX layer's."""
    jl, tl, jp, tp = _pair_of_layers(LAYER_CONFS[case])
    x = _rand((N, T, I), 52)
    m = _mask("right")
    if case == "lstm":
        init = (_rand((N, H), 53), _rand((N, H), 54))
        jinit = tuple(jnp.asarray(a) for a in init)
        tinit = tuple(_t(a) for a in init)
    else:
        init = _rand((N, H), 53)
        jinit, tinit = jnp.asarray(init), _t(init)
    jy, jlast = jl.apply_with_state(jp, jnp.asarray(x), mask=jnp.asarray(m),
                                    initial=jinit)
    ty, tlast = tl.apply_with_state(tp, _t(x), mask=_t(m), initial=tinit)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **FWD)
    for a, b in zip(jax.tree.leaves(tlast), jax.tree.leaves(jlast)):
        np.testing.assert_allclose(np.asarray(a), _np(b), **FWD)


def test_lstm_init_sets_the_forget_gate_bias():
    tlc = tconf.LSTM(n_in=I, n_out=H, forget_gate_bias_init=2.5)
    tl = build_layer(tconf.MultiLayerConfiguration(), tlc,
                     tconf.InputType.recurrent(I), CPU)
    b = tl.init(torch.Generator().manual_seed(0))["b"]
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 2.5    # gate order i, f, o, g
    np.testing.assert_array_equal(b.numpy(), want)


def test_gru_refuses_an_explicit_activation():
    with pytest.raises(ValueError, match="fixed tanh/sigmoid"):
        build_layer(tconf.MultiLayerConfiguration(),
                    tconf.GRU(n_in=I, n_out=H, activation="relu"),
                    tconf.InputType.recurrent(I), CPU)


@pytest.mark.parametrize("mode", ["elementwise", "spatial", "alpha",
                                  "gaussian"])
def test_dropout_layer_modes(mode):
    """The four IDropout variants by their semantics; inference and rate 0
    pass x through."""
    tl = build_layer(tconf.MultiLayerConfiguration(),
                     tconf.DropoutLayer(rate=0.25, mode=mode),
                     tconf.InputType.recurrent(64), CPU)
    x = _t(_rand((16, 50, 64), 60)) + 3.0
    gen = torch.Generator().manual_seed(1)
    y, _, _ = tl.apply({}, x, {}, train=True, rng=gen, mask=None)
    keep = 0.75
    if mode == "elementwise":
        kept = y != 0
        assert abs(kept.float().mean().item() - keep) < 0.02
        torch.testing.assert_close(y[kept], (x / keep)[kept])
    elif mode == "spatial":
        kept = (y != 0).all(dim=1)                    # (N, C) maps
        assert ((y == 0).all(dim=1) | kept).all()    # whole maps only
        torch.testing.assert_close(y * kept[:, None], x / keep
                                   * kept[:, None])
    elif mode == "alpha":
        alpha_p = -1.7580993408473766
        a = (keep + alpha_p ** 2 * keep * 0.25) ** -0.5
        b = -a * 0.25 * alpha_p
        dropped = torch.isclose(y, torch.full_like(y, a * alpha_p + b))
        assert abs(dropped.float().mean().item() - 0.25) < 0.02
        torch.testing.assert_close(y[~dropped], (a * x + b)[~dropped])
    else:
        ratio = y / x
        assert abs(ratio.mean().item() - 1.0) < 0.01
        assert abs(ratio.std().item() - (0.25 / 0.75) ** 0.5) < 0.01
    y_eval, _, _ = tl.apply({}, x, {}, train=False, rng=gen, mask=None)
    assert y_eval is x


def test_layer_dropout_draws_in_training_only():
    """A layer's ``dropout`` rate applies to its input in training."""
    tl = build_layer(tconf.MultiLayerConfiguration(),
                     dataclasses.replace(tconf.LSTM(n_in=I, n_out=H,
                                                    activation="tanh"),
                                         dropout=0.5),
                     tconf.InputType.recurrent(I), CPU)
    p = tl.init(torch.Generator().manual_seed(0))
    x = _t(_rand((N, T, I), 61))
    eval_a, _, _ = tl.apply(p, x, {}, train=False, rng=None)
    eval_b, _, _ = tl.apply(p, x, {}, train=False, rng=None)
    assert torch.equal(eval_a, eval_b)
    train, _, _ = tl.apply(p, x, {}, train=True,
                           rng=torch.Generator().manual_seed(2))
    assert not torch.allclose(train, eval_a)
