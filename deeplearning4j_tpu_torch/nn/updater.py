"""Updaters (optimizer math) and learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/nn/updater.py``: the 11 updater kinds
of ``UPDATERS`` and the 7 ISchedule kinds, with the same constructor
fields, the same ``to_dict``/``from_dict`` JSON and the same order of
operations, so a trajectory agrees with the JAX package's to float
rounding. An updater is ``(grad, state, lr, step) -> (update, new_state)``
on one leaf; the train step applies ``param - update``.

Scalars: ``lr`` and every quantity that depends only on ``lr``/``step``
(Adam's bias-corrected ``alpha``, Nadam's bias corrections) are float32
0-d tensors on the CPU, computed once per leaf. They enter the tensor math
as scalars, so the CUDA kernel of ``fused_updater_step``
(:mod:`deeplearning4j_tpu_torch.ops.cuda_updater`) receives the very same
float32 values by value (:meth:`Updater.coefficients`) and repeats the
elementwise operations in the same order and rounding.

:meth:`Updater.apply_fused` routes a leaf through the
``fused_updater_step`` registry op, whose ``"cuda"`` helper is the
one-pass kernel; :meth:`Updater.apply_fused_many`, the train steps'
entry, resolves every leaf the same way and updates the leaves that take
the kernel in one multi-tensor launch. There is no environment switch;
``helper_mode`` decides.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Schedules (ISchedule analog): float32 0-d CPU tensors of the iteration
# ---------------------------------------------------------------------------


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base schedule: fixed value (the no-schedule default)."""

    value: float = 1e-3

    def __call__(self, iteration, epoch=None):
        return _f32(self.value)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["Schedule"]:
        if d is None:
            return None
        d = dict(d)
        cls = _SCHEDULES[d.pop("@type")]
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    """value * decay^floor(iter / step) — reference StepSchedule.java."""

    decay_rate: float = 0.1
    step: float = 1000.0

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        return self.value * self.decay_rate ** torch.floor(it / self.step)


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    """value * gamma^iter — reference ExponentialSchedule.java."""

    gamma: float = 0.99

    def __call__(self, iteration, epoch=None):
        return self.value * self.gamma ** _f32(iteration)


@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    """value / (1 + gamma*iter)^power — reference InverseSchedule.java."""

    gamma: float = 0.01
    power: float = 1.0

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        return self.value / (1.0 + self.gamma * it) ** self.power


@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    """value * (1 - iter/maxIter)^power — reference PolySchedule.java."""

    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        frac = torch.clamp(it / float(self.max_iter), 0.0, 1.0)
        return self.value * (1.0 - frac) ** self.power


@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    """value / (1 + exp(-gamma*(iter-stepSize))) — reference SigmoidSchedule."""

    gamma: float = 0.01
    step_size: int = 1000

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        return self.value / (1.0 + torch.exp(-self.gamma
                                             * (it - self.step_size)))


@dataclasses.dataclass(frozen=True)
class CycleSchedule(Schedule):
    """1cycle policy (reference CycleSchedule.java): ramp up then anneal."""

    initial_lr: float = 1e-4
    max_lr: float = 1e-2
    cycle_length: int = 1000
    annealing_length: int = 100
    annealing_decay: float = 0.1

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        pos = torch.remainder(it, float(self.cycle_length))
        up = float(self.cycle_length - self.annealing_length) / 2.0
        lr_up = self.initial_lr + (self.max_lr - self.initial_lr) * (pos / up)
        lr_down = self.max_lr - (self.max_lr - self.initial_lr) * (
            (pos - up) / up)
        ann_pos = (pos - (self.cycle_length - self.annealing_length)) / float(
            self.annealing_length)
        lr_ann = self.initial_lr * (
            1.0 + ann_pos * (self.annealing_decay - 1.0))
        return torch.where(pos < up, lr_up,
                           torch.where(pos < 2 * up, lr_down, lr_ann))


@dataclasses.dataclass(frozen=True)
class MapSchedule(Schedule):
    """Piecewise-constant from an {iteration: lr} map — reference MapSchedule."""

    values: Tuple[Tuple[int, float], ...] = ()

    def __call__(self, iteration, epoch=None):
        it = _f32(iteration)
        lr = _f32(self.value)
        for start, v in sorted(self.values):
            lr = torch.where(it >= start, _f32(v), lr)
        return lr

    def to_dict(self) -> Dict[str, Any]:
        return {"@type": "MapSchedule", "value": self.value,
                "values": [list(p) for p in self.values]}

    @staticmethod
    def _from(value, values):
        return MapSchedule(value=value, values=tuple(
            (int(a), float(b)) for a, b in values))


_SCHEDULES = {c.__name__: c for c in [
    Schedule, StepSchedule, ExponentialSchedule, InverseSchedule,
    PolySchedule, SigmoidSchedule, CycleSchedule]}
_SCHEDULES["MapSchedule"] = MapSchedule._from  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# Updaters (GradientUpdater analog): leaf-wise transforms
# ---------------------------------------------------------------------------


def _t(step) -> torch.Tensor:
    """Bias-correction exponent t = step + 1, float32 (as the JAX package
    computes it from the int32 iteration)."""
    return _f32(step) + 1.0


def _recip(x: torch.Tensor) -> float:
    """float32 1/x of a 0-d float32 tensor: what torch's CUDA division by a
    host scalar multiplies with."""
    return float(np.float32(1.0) / np.float32(float(x)))


@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config. Subclasses define the reference math.

    ``learning_rate`` may be a float or a :class:`Schedule`.
    :meth:`coefficients` lists, in the CUDA kernel's order, the float32
    scalars the kernel takes by value for this ``(lr, step)``."""

    learning_rate: Any = 1e-3

    def lr(self, iteration, epoch=None) -> torch.Tensor:
        if isinstance(self.learning_rate, Schedule):
            return self.learning_rate(iteration, epoch)
        return _f32(self.learning_rate)

    def init_state(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, grad, state, lr, step):
        """Return (update, new_state); params -= update downstream."""
        raise NotImplementedError

    def coefficients(self, lr, step) -> Tuple[float, ...]:
        raise NotImplementedError

    # -- fused step (ops/cuda_updater.py) -----------------------------------
    def _fusable(self) -> bool:
        """Only the exact catalog classes route through the registry op: a
        user subclass overriding ``apply`` keeps its override."""
        return UPDATERS.get(type(self).__name__) is type(self)

    def fused_hyper(self) -> Dict[str, float]:
        """Constructor fields as keyword arguments of the fused op
        (``learning_rate`` excluded: the scheduled ``lr`` is passed)."""
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.name != "learning_rate"}

    def apply_fused(self, param, grad, state, lr, step):
        """One optimizer step for one leaf: ``(new_param, new_state)``,
        through the ``fused_updater_step`` registry op (the CUDA kernel on
        the card, the plain version — this class's own :meth:`apply` —
        elsewhere). Out of place: new tensors are returned."""
        if self._fusable():
            from deeplearning4j_tpu_torch.ops.registry import registry

            keys = sorted(state)
            out = registry().get("fused_updater_step")(
                param, grad, lr, step, *(state[k] for k in keys),
                kind=type(self).__name__, **self.fused_hyper())
            return out[0], dict(zip(keys, out[1:]))
        u, new_state = self.apply(grad, state, lr, step)
        return param - u, new_state

    def apply_fused_many(self, params, grads, states, lr, step):
        """:meth:`apply_fused` over many leaves at one ``(lr, step)``:
        ``(new_params, new_states)``, lists in input order. Each leaf is
        resolved through the ``fused_updater_step`` registry op as
        :meth:`apply_fused` resolves it (``helper_mode``, the gate and the
        dispatch counter, leaf by leaf); the leaves that resolve to the
        CUDA helper are updated by one multi-tensor launch per dtype
        (``cuda_updater.fused_updater_multi``), the rest by the resolved
        function, one leaf at a time."""
        if not self._fusable():
            outs = [self.apply(g, s, lr, step)
                    for g, s in zip(grads, states)]
            return ([p - u for p, (u, _) in zip(params, outs)],
                    [s for _, s in outs])
        from deeplearning4j_tpu_torch.ops import cuda_updater as cu
        from deeplearning4j_tpu_torch.ops.registry import registry

        desc = registry().get("fused_updater_step")
        kind, hyper = type(self).__name__, self.fused_hyper()
        keys = [sorted(s) for s in states]
        new_p, new_s = [None] * len(params), [None] * len(params)
        groups: Dict[Any, list] = {}
        for i, (p, g, s) in enumerate(zip(params, grads, states)):
            st = [s[k] for k in keys[i]]
            fn = desc.resolve(p, g, lr, step, *st, kind=kind, **hyper)
            if fn is cu.fused_updater:
                groups.setdefault((p.dtype, p.device), []).append(i)
                continue
            out = fn(p, g, lr, step, *st, kind=kind, **hyper)
            new_p[i], new_s[i] = out[0], dict(zip(keys[i], out[1:]))
        for idx in groups.values():
            outs = cu.fused_updater_multi(
                [params[i] for i in idx], [grads[i] for i in idx],
                [tuple(states[i][k] for k in keys[i]) for i in idx], lr,
                step, kind=kind, **hyper)
            for i, out in zip(idx, outs):
                new_p[i], new_s[i] = out[0], dict(zip(keys[i], out[1:]))
        return new_p, new_s

    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Schedule):
                v = {"__schedule__": v.to_dict()}
            d[f.name] = v
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Updater":
        d = dict(d)
        cls = UPDATERS[d.pop("@type")]
        for k, v in list(d.items()):
            if isinstance(v, dict) and "__schedule__" in v:
                d[k] = Schedule.from_dict(v["__schedule__"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    """SgdUpdater: update = lr * g."""

    learning_rate: Any = 1e-1

    def apply(self, grad, state, lr, step):
        return lr * grad, state

    def coefficients(self, lr, step):
        return (float(lr),)


@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """NoOpUpdater: passes the raw gradient through (update = g)."""

    def apply(self, grad, state, lr, step):
        return grad, state

    def coefficients(self, lr, step):
        return ()


@dataclasses.dataclass(frozen=True)
class Frozen(Updater):
    """The FrozenLayer effect at the updater level: the update is zero."""

    learning_rate: Any = 0.0

    def apply(self, grad, state, lr, step):
        return torch.zeros_like(grad), state

    def coefficients(self, lr, step):
        return ()


@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """NesterovsUpdater: v = mu*vPrev - lr*g; update = mu*vPrev - (1+mu)*v
    (params -= update, the Sutskever form)."""

    learning_rate: Any = 1e-1
    momentum: float = 0.9

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def apply(self, grad, state, lr, step):
        mu = self.momentum
        v_prev = state["v"]
        v = mu * v_prev - lr * grad
        update = mu * v_prev - (1 + mu) * v
        return update, {"v": v}

    def coefficients(self, lr, step):
        return (self.momentum, float(lr), 1 + self.momentum)


@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    """AdaGradUpdater: h += g²; update = lr * g / (sqrt(h) + eps)."""

    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def init_state(self, param):
        return {"h": torch.full_like(param, self.epsilon)}

    def apply(self, grad, state, lr, step):
        h = state["h"] + grad * grad
        update = lr * grad / (torch.sqrt(h) + self.epsilon)
        return update, {"h": h}

    def coefficients(self, lr, step):
        return (float(lr), self.epsilon)


@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    """RmsPropUpdater: g2 = d*g2 + (1-d)*g²; update = lr*g/sqrt(g2+eps)."""

    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"g2": torch.full_like(param, self.epsilon)}

    def apply(self, grad, state, lr, step):
        g2 = self.rms_decay * state["g2"] + (1 - self.rms_decay) * grad * grad
        update = grad * lr / torch.sqrt(g2 + self.epsilon)
        return update, {"g2": g2}

    def coefficients(self, lr, step):
        return (self.rms_decay, 1 - self.rms_decay, float(lr), self.epsilon)


@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """AdaDeltaUpdater: rho-averaged g² and Δ² ratio; lr-free."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, param):
        return {"msg": torch.zeros_like(param),
                "msdx": torch.zeros_like(param)}

    def apply(self, grad, state, lr, step):
        msg = self.rho * state["msg"] + (1 - self.rho) * grad * grad
        dx = (torch.sqrt(state["msdx"] + self.epsilon)
              / torch.sqrt(msg + self.epsilon)) * grad
        msdx = self.rho * state["msdx"] + (1 - self.rho) * dx * dx
        return dx, {"msg": msg, "msdx": msdx}

    def coefficients(self, lr, step):
        return (self.rho, 1 - self.rho, self.epsilon)


@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    """AdamUpdater — reference math incl. bias correction:
    alpha_t = lr * sqrt(1-b2^t)/(1-b1^t); update = alpha_t*m/(sqrt(v)+eps)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def _alpha(self, lr, step):
        t = _t(step)
        return lr * torch.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def apply(self, grad, state, lr, step):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        update = self._alpha(lr, step) * m / (torch.sqrt(v) + self.epsilon)
        return update, {"m": m, "v": v}

    def coefficients(self, lr, step):
        return (self.beta1, 1 - self.beta1, self.beta2, 1 - self.beta2,
                float(self._alpha(lr, step)), self.epsilon)


@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    """AdaMaxUpdater: u = max(b2*u, |g|); update = lr/(1-b1^t) * m/u."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    def _scale(self, lr, step):
        return lr / (1 - self.beta1 ** _t(step))

    def apply(self, grad, state, lr, step):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        u = torch.maximum(self.beta2 * state["u"], torch.abs(grad))
        update = self._scale(lr, step) * m / (u + self.epsilon)
        return update, {"m": m, "u": u}

    def coefficients(self, lr, step):
        return (self.beta1, 1 - self.beta1, self.beta2,
                float(self._scale(lr, step)), self.epsilon)


@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    """NadamUpdater: Nesterov-accelerated Adam (reference math)."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def _corrections(self, step):
        t = _t(step)
        return 1 - self.beta1 ** t, 1 - self.beta2 ** t

    def apply(self, grad, state, lr, step):
        bc1, bc2 = self._corrections(step)
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        m_hat = m / bc1
        v_hat = v / bc2
        update = (lr * (self.beta1 * m_hat + (1 - self.beta1) * grad / bc1)
                  / (torch.sqrt(v_hat) + self.epsilon))
        return update, {"m": m, "v": v}

    def coefficients(self, lr, step):
        bc1, bc2 = self._corrections(step)
        return (self.beta1, 1 - self.beta1, self.beta2, 1 - self.beta2,
                float(lr), _recip(bc1), _recip(bc2), self.epsilon)


@dataclasses.dataclass(frozen=True)
class AmsGrad(Updater):
    """AMSGradUpdater: Adam with a max-tracked second moment."""

    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "vhat": torch.zeros_like(param)}

    def _alpha(self, lr, step):
        t = _t(step)
        return lr * torch.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def apply(self, grad, state, lr, step):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        vhat = torch.maximum(state["vhat"], v)
        update = self._alpha(lr, step) * m / (torch.sqrt(vhat) + self.epsilon)
        return update, {"m": m, "v": v, "vhat": vhat}

    def coefficients(self, lr, step):
        return (self.beta1, 1 - self.beta1, self.beta2, 1 - self.beta2,
                float(self._alpha(lr, step)), self.epsilon)


# the order is the CUDA kernel's kind code (csrc/fused_updater.cu)
UPDATERS = {c.__name__: c for c in [
    Sgd, NoOp, Frozen, Nesterovs, AdaGrad, RmsProp, AdaDelta, Adam, AdaMax,
    Nadam, AmsGrad]}


def get_updater(spec) -> Updater:
    """Resolve an updater from an Updater, name, or dict."""
    if isinstance(spec, Updater):
        return spec
    if isinstance(spec, str):
        return UPDATERS[spec]()
    if isinstance(spec, dict):
        return Updater.from_dict(spec)
    raise TypeError(f"cannot resolve updater from {spec!r}")
