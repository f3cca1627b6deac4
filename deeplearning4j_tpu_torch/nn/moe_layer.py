"""Mixture-of-experts FFN layer: the runtime twin of ``conf.MoELayer``.

Counterpart of ``deeplearning4j_tpu/nn/moe_layer.py`` (``MoELayerImpl``):
GShard / Switch routing written as dense products over an explicit
expert axis. Top-k assignment with capacity C = ceil(cf·S·k/E) a expert,
slots given in token order (earlier choices first); an assignment past
capacity is dropped, a token whose every assignment is dropped passes
through as identity, and the combine weights are renormalized over the
surviving assignments. The layer state carries ``_aux_loss`` (the Switch
load-balance loss E·Σ f_e·P_e times ``aux_weight``, zero outside
training; the networks add it to the training loss) and
``_dropped_frac`` (the share of assignments dropped, no gradient).

What GSPMD does for the JAX layer over a mesh, this one does through the
step context (``ops/collectives.py``), and only where one is active:

* S is the token count of the **global** batch, and slot positions follow
  global token order: each rank takes the exclusive prefix of the earlier
  data ranks' per-expert counts — one all-gather of the (k, E) counts
  (and the rank's token count) gives it, and gives every rank the global
  kept count for ``_dropped_frac``;
* f_e (top-1 shares) comes from those counts and P_e (mean gate) from an
  all-reduce of the gate sums, so the aux loss is the global one;
* with its expert leaves sharded over the context's expert axis
  (``moe_ep_rules``), the rank holds E/n experts. The ranks of an expert
  group hold the same tokens: each dispatches its 1/n of them, an
  all-to-all takes every slot to its expert's rank, the rank's experts
  run, a second all-to-all brings every expert's slots back, the rank
  combines its tokens and an all-gather rebuilds the group's rows.

Routing reads nothing on the host (no ``F.one_hot``, no ``.item()``): a
step holding the layer captures on the card.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.layers import Layer
from deeplearning4j_tpu_torch.ops import collectives

_F32 = torch.float32


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row (``jax.nn.one_hot``)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(_F32)


class MoELayerImpl(Layer):
    def init(self, gen) -> dict:
        lc = self.lc
        d, h, e = lc.n_in, lc.d_hidden, lc.n_experts
        return {
            "Weg": self._weights(gen, (d, e)),
            "We1": self._weights(gen, (e, d, h)),
            "be1": torch.zeros((e, h), dtype=self.dtype, device=self.device),
            "We2": self._weights(gen, (e, h, d)),
            "be2": torch.zeros((e, d), dtype=self.dtype, device=self.device),
        }

    def init_state(self) -> dict:
        return {"_aux_loss": torch.zeros((), dtype=_F32, device=self.device),
                "_dropped_frac": torch.zeros((), dtype=_F32,
                                             device=self.device)}

    def _route(self, gates: torch.Tensor, ctx):
        """The top-k choices of the rank's tokens: (onehots, weights, global
        token count, the global per-choice expert counts (k, E), this
        rank's offsets (k, E) — the earlier data ranks' counts)."""
        e, k = self.lc.n_experts, int(self.lc.top_k)
        remaining = gates
        onehots, weights = [], []
        for _ in range(k):
            idx = torch.argmax(remaining, dim=-1)
            onehot = _onehot(idx, e)
            onehots.append(onehot)
            weights.append(torch.sum(gates * onehot, dim=-1))
            remaining = remaining * (1.0 - onehot)
        local = torch.stack([o.sum(dim=0) for o in onehots])       # (k, E)
        s_local = gates.shape[0]
        if ctx is None or not ctx.data_axes():
            return (onehots, weights, s_local, local,
                    torch.zeros_like(local))
        mine = torch.cat([local.reshape(-1),
                          torch.full((1,), float(s_local), dtype=_F32,
                                     device=gates.device)])
        every = ctx.data_gather(mine)                            # (D, kE+1)
        counts = every[:, :-1].reshape(-1, k, e)
        rank = ctx.groups.index(ctx.data_axes())
        s = int(sum(int(n) for n in every[:, -1].tolist()))
        return (onehots, weights, s, counts.sum(dim=0),
                counts[:rank].sum(dim=0))

    def apply(self, params, x, state, *, train, rng, mask=None):
        lc = self.lc
        e, k = lc.n_experts, int(lc.top_k)
        ctx = collectives.active()
        orig_shape = x.shape
        d = orig_shape[-1]
        xt = x.reshape(-1, d)                                     # (S, d)
        logits = (xt @ params["Weg"]).to(_F32)
        gates = torch.softmax(logits, dim=-1)
        onehots, weights, s, global_counts, offsets = self._route(gates, ctx)
        cap = max(1, int(math.ceil(lc.capacity_factor * s * k / e)))

        # slots in global token order: the rank's exclusive cumsum, the
        # earlier data ranks' assignments, the earlier choices' kept ones
        dispatch = xt.new_zeros((xt.shape[0], e, cap), dtype=_F32)
        combine = torch.zeros_like(dispatch)
        placed = torch.zeros(e, dtype=_F32, device=xt.device)
        kept = torch.zeros((), dtype=_F32, device=xt.device)
        for j, (onehot, w) in enumerate(zip(onehots, weights)):
            pos = torch.cumsum(onehot, dim=0) - onehot + offsets[j] + placed
            pos_t = torch.sum(pos * onehot, dim=-1)
            sel = onehot * (pos_t < cap).to(_F32)[:, None]
            posh = _onehot(pos_t.to(torch.int64), cap)
            slot = sel[:, :, None] * posh[:, None, :]
            dispatch = dispatch + slot
            combine = combine + w[:, None, None] * slot
            # every rank's kept count of this choice, from the global counts
            took = torch.minimum(global_counts[j],
                                 torch.clamp_min(cap - placed, 0.0))
            kept = kept + took.sum()
            placed = placed + took
        denom = torch.sum(combine, dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp_min(denom, 1e-9)

        cd = x.dtype
        y = self._experts(params, xt, dispatch.to(cd), combine.to(cd), ctx)
        kept_tok = torch.sum(dispatch, dim=(1, 2))
        y = y + torch.clamp(1.0 - kept_tok, 0.0, 1.0).to(cd)[:, None] * xt

        f_e = global_counts[0] / s
        p_e = collectives.data_sum(gates.sum(dim=0)) / s \
            if ctx is not None else gates.mean(dim=0)
        aux = lc.aux_weight * e * torch.sum(f_e * p_e)
        dropped = 1.0 - kept / (s * k)
        new_state = {"_aux_loss": aux if train else torch.zeros(
                         (), dtype=_F32, device=xt.device),
                     "_dropped_frac": dropped.detach()}
        return y.reshape(orig_shape), new_state, mask

    def _ffn(self, params, xin):
        hdn = torch.einsum("ecd,edh->ech", xin, params["We1"])
        hdn = self.activation(hdn + params["be1"][:, None, :])
        out = torch.einsum("ech,ehd->ecd", hdn, params["We2"])
        return out + params["be2"][:, None, :]

    def _experts(self, params, xt, dispatch, combine, ctx):
        """The expert MLPs on the dispatched slots, combined back to the
        tokens: (S, d)."""
        e = self.lc.n_experts
        local_e = params["We1"].shape[0]
        if local_e == e:
            xin = torch.einsum("sec,sd->ecd", dispatch, xt)
            return torch.einsum("sec,ecd->sd", combine,
                                self._ffn(params, xin))
        axis = ctx.expert_axis if ctx is not None else None
        n = 1 if axis is None else ctx.groups.size(axis)
        if n * local_e != e:
            raise ValueError(
                f"MoELayer holds {local_e} of {e} experts, but the expert "
                f"axis {axis!r} has {n} ranks")
        # the group's tokens split n ways: this rank dispatches its part
        sizes = collectives.split_rows(xt.shape[0], n)
        me = ctx.groups.index(axis)
        lo = sum(sizes[:me])
        part = slice(lo, lo + sizes[me])
        xin = torch.einsum("sec,sd->ecd", dispatch[part], xt[part])
        c, d = xin.shape[1], xin.shape[2]
        got = collectives.all_to_all(xin.reshape(n, local_e, c, d),
                                     ctx.groups, axis)
        out = self._ffn(params, got.sum(dim=0))            # (E/n, C, d)
        back = collectives.all_to_all(
            out.unsqueeze(0).expand(n, -1, -1, -1), ctx.groups, axis)
        y = torch.einsum("sec,ecd->sd", combine[part], back.reshape(e, c, d))
        most = max(sizes)
        if y.shape[0] < most:
            y = torch.cat([y, y.new_zeros((most - y.shape[0], d))])
        rows = collectives.all_gather(y, ctx.groups, axis)
        return torch.cat([rows[i * most:i * most + sizes[i]]
                          for i in range(n)])
