"""ResNet bottleneck block as one layer, over the fused BN/matmul kernel.

Counterpart of ``deeplearning4j_tpu/nn/fused_blocks.py``: the canonical v1
bottleneck {1×1 → BN+relu → 3×3 → BN+relu → 1×1 → BN → (+shortcut) →
relu}, arranged so the two 1×1 convs (and the projection) run through
``fused_matmul_bn`` — the previous BN's affine+relu folded into the
matmul's operand read, this conv's BN statistics into its output write.
On the card with bfloat16 activations that is the hand-written
``csrc/bn_matmul_stats.cu``; elsewhere its plain version.

The same math as the composed layers: one-pass moments shifted by the
running mean (the shift carries no gradient), unbiased running variance,
``decay`` semantics. The running statistics stay float32 whatever the
policy.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers import Layer
from deeplearning4j_tpu_torch.ops import nn_ops
from deeplearning4j_tpu_torch.ops.cuda_convbn import fused_matmul_bn

_F32 = torch.float32


def _affine(gamma, beta, mean, var, eps):
    """Fold BN (stats, γ, β) into per-channel float32 scale/shift."""
    inv = torch.rsqrt(var.to(_F32) + eps)
    sc = inv if gamma is None else inv * gamma.to(_F32)
    sh = -mean.to(_F32) * sc
    if beta is not None:
        sh = sh + beta.to(_F32)
    return sc, sh


def _shifted_stats(z, stat_shift):
    """One-pass running-mean-shifted batch moments over all but the
    channel axis."""
    sf = stat_shift.detach().to(_F32)
    axes = tuple(range(z.ndim - 1))
    c = z.to(_F32) - sf
    m1 = torch.mean(c, dim=axes)
    m2 = torch.mean(torch.square(c), dim=axes)
    return m1 + sf, torch.clamp_min(m2 - torch.square(m1), 0.0)


class FusedBottleneckImpl(Layer):
    """Runtime twin of conf.FusedBottleneck."""

    def init(self, gen):
        lc = self.lc
        c_in, f = lc.n_in, lc.filters
        p = {
            "W1": self._weights(gen, (1, 1, c_in, f)),
            "g1": self._ones(f), "b1": self._zeros(f),
            "W2": self._weights(gen, (3, 3, f, f)),
            "g2": self._ones(f), "b2": self._zeros(f),
            "W3": self._weights(gen, (1, 1, f, 4 * f)),
            "g3": self._ones(4 * f), "b3": self._zeros(4 * f),
        }
        if lc.project:
            p["Wsc"] = self._weights(gen, (1, 1, c_in, 4 * f))
            p["gsc"] = self._ones(4 * f)
            p["bsc"] = self._zeros(4 * f)
        return p

    def init_state(self):
        f = self.lc.filters

        def vec(n, v):
            return torch.full((n,), v, dtype=_F32, device=self.device)

        s = {"m1": vec(f, 0.0), "v1": vec(f, 1.0),
             "m2": vec(f, 0.0), "v2": vec(f, 1.0),
             "m3": vec(4 * f, 0.0), "v3": vec(4 * f, 1.0)}
        if self.lc.project:
            s["msc"] = vec(4 * f, 0.0)
            s["vsc"] = vec(4 * f, 1.0)
        return s

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        s = lc.stride
        xs = x[:, ::s, ::s, :] if s != 1 else x
        n, h, w_, c_in = xs.shape
        m = n * h * w_
        x2 = xs.reshape(m, c_in)
        if not train:
            return self._apply_eval(params, x, x2, n, h, w_, state), state, mask
        eps, decay = lc.eps, lc.decay
        f = lc.filters
        ones1 = torch.ones((c_in,), dtype=_F32, device=x.device)
        zeros1 = torch.zeros((c_in,), dtype=_F32, device=x.device)

        # c1 (1×1, stride folded into the slice) + bn1 stats in-epilogue
        z1, mean1, var1 = fused_matmul_bn(
            x2, ones1, zeros1, params["W1"].reshape(c_in, f), state["m1"],
            False, False)
        sc1, sh1 = _affine(params["g1"], params["b1"], mean1, var1, eps)
        # normalize+relu materializes for the 3×3 conv
        y1 = torch.clamp_min(z1.to(_F32) * sc1 + sh1, 0.0).to(z1.dtype)
        z2 = nn_ops.conv2d.fn(y1.reshape(n, h, w_, f), params["W2"], None,
                              stride=(1, 1), padding="same")
        # bn2 stats in their own pass; bn2's affine is c3's prologue
        mean2, var2 = _shifted_stats(z2, state["m2"])
        sc2, sh2 = _affine(params["g2"], params["b2"], mean2, var2, eps)
        z3, mean3, var3 = fused_matmul_bn(
            z2.reshape(m, f), sc2, sh2, params["W3"].reshape(f, 4 * f),
            state["m3"], True, True)
        sc3, sh3 = _affine(params["g3"], params["b3"], mean3, var3, eps)

        new_state = dict(state)
        if lc.project:
            zsc, meansc, varsc = fused_matmul_bn(
                x2, ones1, zeros1, params["Wsc"].reshape(c_in, 4 * f),
                state["msc"], False, False)
            scsc, shsc = _affine(params["gsc"], params["bsc"], meansc, varsc,
                                 eps)
            shortcut = zsc.to(_F32) * scsc + shsc
            self._update_running(new_state, "sc", meansc, varsc, m, decay)
        else:
            shortcut = x2.to(_F32)
        out = torch.clamp_min(z3.to(_F32) * sc3 + sh3 + shortcut, 0.0)
        out = out.to(x.dtype).reshape(n, h, w_, 4 * f)
        for tag, mu, var in (("1", mean1, var1), ("2", mean2, var2),
                             ("3", mean3, var3)):
            self._update_running(new_state, tag, mu, var, m, decay)
        return out, new_state, mask

    @staticmethod
    def _update_running(state, tag, mean, var, count, decay):
        unbiased = var.detach() * count / max(count - 1, 1)
        state["m" + tag] = (decay * state["m" + tag]
                            + (1 - decay) * mean.detach())
        state["v" + tag] = decay * state["v" + tag] + (1 - decay) * unbiased

    def _apply_eval(self, params, x, x2, n, h, w_, state):
        lc = self.lc
        eps = lc.eps
        c_in = x2.shape[1]
        f = lc.filters
        dt = x.dtype

        def bn(z, tag):
            sc, sh = _affine(params["g" + tag], params["b" + tag],
                             state["m" + tag], state["v" + tag], eps)
            return z.to(_F32) * sc + sh

        y1 = torch.clamp_min(bn(x2 @ params["W1"].reshape(c_in, f), "1"), 0.0)
        z2 = nn_ops.conv2d.fn(y1.to(dt).reshape(n, h, w_, f), params["W2"],
                              None, stride=(1, 1), padding="same")
        y2 = torch.clamp_min(bn(z2, "2"), 0.0).to(dt)
        z3 = bn(y2.reshape(-1, f) @ params["W3"].reshape(f, 4 * f), "3")
        if lc.project:
            shortcut = bn(x2 @ params["Wsc"].reshape(c_in, 4 * f), "sc")
        else:
            shortcut = x2.to(_F32)
        out = torch.clamp_min(z3 + shortcut, 0.0)
        return out.to(dt).reshape(n, h, w_, 4 * f)
