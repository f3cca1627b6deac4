"""ComputationGraph — DAG networks, trained eagerly with autograd.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``GraphBuilder`` /
``graph_builder()``, ``ComputationGraphConfiguration`` with the JSON the
JAX package writes (``to_json``/``from_json``), every vertex of the
reference (``graph.py:78-307``), the runtime — ``init``, ``output``,
``fit`` with its listener calls, data cursor (``batch_in_epoch``) and
preemption poll, its truncated-BPTT dispatch, ``fit_tbptt``,
``fit_multi``, the stateful ``rnn_time_step``, ``score``, ``evaluate``,
the train step of ``graph.py:734-748``, the flat parameter view — and
the JAX names of the zips, ``save_graph`` / ``restore_graph``
(``graph.py:1133``, ``:1152``), over ``nn/serde.py``'s one writer and
reader.

What the train step does in place of ``jax.value_and_grad`` + ``jit``:
each parameter leaf is taken as an autograd leaf (``detach()`` +
``requires_grad_``, no copy), the forward and loss run,
``torch.autograd.grad`` gives the gradients, and the update tail
(``apply_layer_updates``: regularization, gradient normalization, the
fused updater op per leaf, weight decay) runs under ``torch.no_grad()``.
The step is a training unit (``nn/compiled.py``), as the sequential
network's is: on the card a CUDA-graph capture per batch signature (keys
``train``, ``train_tbptt`` and ``fit_scanned``) that writes ``params``,
``opt_state``, ``net_state`` and the device iteration in place; eager on
the CPU and under ``disable_capture()``, and out of place on the CPU (new
tensors, rebound), as the JAX step returns new arrays there.
``fit_scanned`` runs many steps with one host read a chunk, feeding
every input and output of a multi-IO graph by name.

Dtype policy: under ``"mixed"`` the float32 master parameters and the
inputs are cast to bfloat16 once at the top of ``_forward``; gradients
flow back through that cast to the float32 leaves, and the network
outputs are cast back to float32 for the loss. Under ``"float32"`` the
forward and backward run in :func:`~deeplearning4j_tpu_torch.nn.dtype.
precision_scope` (no TF32).

Recurrent state: ``output`` and a standard ``fit`` run each recurrent
layer from a zero state, as the JAX graph does; ``rnn_time_step`` carries
each recurrent node's state across calls, and ``fit_tbptt`` carries it
from one segment to the next (detached: gradients stop at the segment
boundary). In ``fit``'s tBPTT dispatch ``_tbptt_mid_batch`` is set while
a batch's segments run, so a listener that declares ``defers_mid_tbptt``
(the checkpoint listener) is called once, at the batch boundary.

The network lives on one device: ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.autodiff.samediff import canonical
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import dtype as DT
from deeplearning4j_tpu_torch.nn.compiled import (
    TrainUnits, commit, donates, flatten_rnn, mask_routing, tensors_of,
    unflatten_rnn)
from deeplearning4j_tpu_torch.nn.layers import (
    BidirectionalImpl, Layer, build_layer)
from deeplearning4j_tpu_torch.nn.listeners import (
    TrainingListener, notify_fit_done, notify_iteration, notify_preemption)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _detached, _tree, apply_layer_updates, autograd_leaves, aux_losses,
    evaluate_batches, flatten_trees, grad_tree, init_opt_state, reg_penalty,
    unflatten_trees)
from deeplearning4j_tpu_torch.nn.updater import Adam, Updater, get_updater
from deeplearning4j_tpu_torch.ops.losses import get_loss

# ---------------------------------------------------------------------------
# Vertices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """Base non-layer vertex."""

    def apply(self, inputs: List[torch.Tensor]):
        raise NotImplementedError

    def output_type(self, itypes: List[C.InputType]) -> C.InputType:
        return itypes[0]

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        name = d.pop("@type")
        cls = VERTEX_TYPES.get(name)
        if cls is None:
            raise ValueError(
                f"vertex type {name!r} is not ported to "
                f"deeplearning4j_tpu_torch yet; ported: {sorted(VERTEX_TYPES)}")
        for k, v in list(d.items()):
            if isinstance(v, list):
                d[k] = tuple(v)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """ElementWiseVertex.java: Add | Subtract | Product | Average | Max |
    Min."""

    op: str = "add"

    def apply(self, inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if op == "min":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        raise ValueError(f"unknown ElementWiseVertex op {self.op}")


@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """MergeVertex.java: concatenation along the trailing (channel /
    feature) axis of the NHWC or (N, T, F) activations."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=-1)

    def output_type(self, itypes):
        t0 = itypes[0]
        if t0.kind == "convolutional":
            return C.InputType.convolutional(t0.height, t0.width,
                                             sum(t.channels for t in itypes))
        if t0.kind == "recurrent":
            return C.InputType.recurrent(sum(t.size for t in itypes),
                                         t0.timesteps)
        return C.InputType.feed_forward(sum(t.flat_size() for t in itypes))


@dataclasses.dataclass(frozen=True)
class DotProductVertex(GraphVertex):
    """Keras Dot merge: a per-example contraction of two inputs along
    ``axes`` (negative allowed), L2-normalized first with ``normalize``
    (cosine proximity); a vector dot keeps a trailing axis of 1."""

    axes: int = -1
    normalize: bool = False

    def apply(self, inputs):
        a, b = inputs
        ax = self.axes
        if self.normalize:
            a = a / torch.clamp_min(torch.linalg.vector_norm(
                a, dim=ax, keepdim=True), 1e-12)
            b = b / torch.clamp_min(torch.linalg.vector_norm(
                b, dim=ax, keepdim=True), 1e-12)
        a2 = a.movedim(ax % a.ndim, -1)
        b2 = b.movedim(ax % b.ndim, -1)
        n, k = a2.shape[0], a2.shape[-1]
        out = torch.bmm(a2.reshape(n, -1, k), b2.reshape(n, -1, k)
                        .transpose(1, 2))
        out = out.reshape((n,) + tuple(a2.shape[1:-1])
                          + tuple(b2.shape[1:-1]))
        return out[:, None] if out.ndim == 1 else out

    def output_type(self, itypes):
        a, b = itypes
        if a.kind == "feedforward":
            return C.InputType.feed_forward(1)
        if a.kind == "recurrent" and self.axes in (-1, 2):
            return C.InputType.recurrent(
                b.timesteps if b.timesteps else -1, a.timesteps)
        raise NotImplementedError(
            f"DotProductVertex shape inference for {a.kind} inputs with "
            f"axes={self.axes}")


@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """SubsetVertex.java: trailing-axis slice [from, to], inclusive."""

    from_idx: int = 0
    to_idx: int = 0

    def apply(self, inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, itypes):
        n = self.to_idx - self.from_idx + 1
        t = itypes[0]
        if t.kind == "recurrent":
            return C.InputType.recurrent(n, t.timesteps)
        return C.InputType.feed_forward(n)


@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    """ScaleVertex.java: multiply by a constant."""

    scale: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale


@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    """ShiftVertex.java: add a constant."""

    shift: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift


@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """L2NormalizeVertex.java: x / sqrt(Σ x² + eps) along the trailing
    axis."""

    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                              + self.eps)


@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """StackVertex.java: concatenation along the batch axis."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)


@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """ReshapeVertex.java: reshape to ``shape`` (batch axis included)."""

    shape: Tuple[int, ...] = ()

    def apply(self, inputs):
        return inputs[0].reshape(self.shape)


@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """UnstackVertex.java: the ``from_idx``-th of ``stack_size`` equal
    batch-axis slices (StackVertex's inverse)."""

    from_idx: int = 0
    stack_size: int = 1

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]


@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """DuplicateToTimeSeriesVertex.java: inputs (value (N, F), time
    reference (N, T, ·)) → value repeated over the T steps."""

    def apply(self, inputs):
        val, ref = inputs
        return val[:, None, :].expand(val.shape[0], ref.shape[1],
                                      val.shape[1])

    def output_type(self, itypes):
        return C.InputType.recurrent(itypes[0].flat_size(),
                                     itypes[1].timesteps)


@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """LastTimeStepVertex.java: (N, T, F) → (N, F), the last step. As in
    the JAX package, vertices see no masks: masked sequences take the
    LastTimeStep layer wrapper."""

    def apply(self, inputs):
        return inputs[0][:, -1]

    def output_type(self, itypes):
        return C.InputType.feed_forward(itypes[0].size)


@dataclasses.dataclass(frozen=True)
class FlattenVertex(GraphVertex):
    """Batch-preserving flatten in the activations' own (NHWC) order."""

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape(x.shape[0], -1)

    def output_type(self, itypes):
        return C.InputType.feed_forward(itypes[0].flat_size())


VERTEX_TYPES = {c.__name__: c for c in [
    MergeVertex, ElementWiseVertex, SubsetVertex, ScaleVertex, ShiftVertex,
    L2NormalizeVertex, StackVertex, ReshapeVertex, FlattenVertex,
    UnstackVertex, DuplicateToTimeSeriesVertex, LastTimeStepVertex,
    DotProductVertex]}


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _GraphNode:
    name: str
    kind: str  # 'layer' | 'vertex'
    layer: Optional[C.LayerConf] = None
    vertex: Optional[GraphVertex] = None
    inputs: List[str] = dataclasses.field(default_factory=list)
    flatten_input: bool = False


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """ComputationGraphConfiguration.java analog; its JSON is the JAX
    package's."""

    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    nodes: List[_GraphNode] = dataclasses.field(default_factory=list)
    input_types: Dict[str, C.InputType] = dataclasses.field(
        default_factory=dict)
    seed: int = 0
    updater: Any = None
    activation: str = "identity"
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dtype: str = "float32"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    # truncated BPTT, set on the configuration (not in its JSON), as in
    # the JAX package
    tbptt_fwd_length: int = -1
    tbptt_back_length: int = -1
    backprop_type: str = "standard"

    layer_activation = C.MultiLayerConfiguration.layer_activation
    layer_weight_init = C.MultiLayerConfiguration.layer_weight_init
    layer_updater = C.MultiLayerConfiguration.layer_updater
    layer_l1 = C.MultiLayerConfiguration.layer_l1
    layer_l2 = C.MultiLayerConfiguration.layer_l2
    layer_weight_decay = C.MultiLayerConfiguration.layer_weight_decay

    def __post_init__(self):
        if self.updater is None:
            self.updater = Adam()

    def to_json(self) -> str:
        return json.dumps({
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "nodes": [
                {"name": n.name, "kind": n.kind,
                 "layer": n.layer.to_dict() if n.layer else None,
                 "vertex": n.vertex.to_dict() if n.vertex else None,
                 "inputs": n.inputs}
                for n in self.nodes
            ],
            "input_types": {k: v.to_dict()
                            for k, v in self.input_types.items()},
            "seed": self.seed,
            "updater": {"__updater__": get_updater(self.updater).to_dict()},
            "activation": self.activation,
            "weight_init": self.weight_init,
            "l1": self.l1, "l2": self.l2, "weight_decay": self.weight_decay,
            "dtype": self.dtype,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        return ComputationGraphConfiguration(
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            nodes=[
                _GraphNode(
                    name=nd["name"], kind=nd["kind"],
                    layer=(C.LayerConf.from_dict(nd["layer"])
                           if nd["layer"] else None),
                    vertex=(GraphVertex.from_dict(nd["vertex"])
                            if nd["vertex"] else None),
                    inputs=list(nd["inputs"]))
                for nd in d["nodes"]
            ],
            input_types={k: C.InputType.from_dict(v)
                         for k, v in d["input_types"].items()},
            seed=d.get("seed", 0),
            updater=Updater.from_dict(d["updater"]["__updater__"]),
            activation=d.get("activation", "identity"),
            weight_init=d.get("weight_init", "xavier"),
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            weight_decay=d.get("weight_decay", 0.0),
            dtype=d.get("dtype", "float32"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
        )


class GraphBuilder:
    """ComputationGraphConfiguration.GraphBuilder analog (fluent)."""

    def __init__(self) -> None:
        self._conf = ComputationGraphConfiguration()

    def _set(self, **kw):
        for k, v in kw.items():
            setattr(self._conf, k, v)
        return self

    def seed(self, s: int):
        return self._set(seed=s)

    def updater(self, u):
        return self._set(updater=u)

    def activation(self, a: str):
        return self._set(activation=a)

    def weight_init(self, w: str):
        return self._set(weight_init=w)

    def l1(self, v: float):
        return self._set(l1=v)

    def l2(self, v: float):
        return self._set(l2=v)

    def weight_decay(self, v: float):
        return self._set(weight_decay=v)

    def dtype(self, d: str):
        return self._set(dtype=d)

    def gradient_normalization(self, kind: str, threshold: float = 1.0):
        return self._set(gradient_normalization=kind,
                         gradient_normalization_threshold=threshold)

    def graph_builder(self):
        return self

    def add_inputs(self, *names: str):
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, **types: C.InputType):
        self._conf.input_types.update(types)
        return self

    def add_layer(self, name: str, layer: C.LayerConf, *inputs: str):
        self._conf.nodes.append(_GraphNode(name=name, kind="layer",
                                           layer=layer, inputs=list(inputs)))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        if isinstance(vertex, C.LayerConf):
            return self.add_layer(name, vertex, *inputs)
        self._conf.nodes.append(_GraphNode(name=name, kind="vertex",
                                           vertex=vertex, inputs=list(inputs)))
        return self

    def set_outputs(self, *names: str):
        self._conf.network_outputs.extend(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        return self._conf


def graph_builder() -> GraphBuilder:
    return GraphBuilder()


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


class ComputationGraph:
    """DAG network runtime (ComputationGraph.java analog)."""

    def __init__(self, conf: ComputationGraphConfiguration, *, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._order = self._toposort()
        self._itypes: Dict[str, C.InputType] = {}
        self.layers: Dict[str, Layer] = {}
        self._net_conf_view = C.MultiLayerConfiguration(
            seed=conf.seed, updater=conf.updater,
            activation=conf.activation, weight_init=conf.weight_init,
            l1=conf.l1, l2=conf.l2, weight_decay=conf.weight_decay,
            dtype=conf.dtype,
            gradient_normalization=conf.gradient_normalization,
            gradient_normalization_threshold=(
                conf.gradient_normalization_threshold))
        for name in conf.network_inputs:
            it = conf.input_types.get(name, C.InputType.feed_forward(0))
            if it.kind == "convolutionalflat":
                it = C.InputType.convolutional(it.height, it.width,
                                               it.channels)
            self._itypes[name] = it
        for node in self._order:
            in_types = [self._itypes[i] for i in node.inputs]
            if node.kind == "vertex":
                self._itypes[node.name] = node.vertex.output_type(in_types)
                continue
            itype = in_types[0]
            if (itype.kind in ("convolutional", "convolutional3d")
                    and isinstance(node.layer, (C.DenseLayer,
                                                C.EmbeddingLayer))):
                # conv -> dense: NHWC / NDHWC flattened channel-major at
                # run time
                itype = C.InputType.feed_forward(itype.flat_size())
                node.flatten_input = True
            itype, node.layer = C.infer_layer(itype, node.layer)
            layer = build_layer(self._net_conf_view, node.layer, itype,
                                self.device)
            self.layers[node.name] = layer
            self._itypes[node.name] = layer.otype
        self._layer_names = [n.name for n in self._order
                             if n.kind == "layer"]
        self._output_layers = [
            n for n in conf.network_outputs
            if getattr(self._node(n).layer, "loss", None) is not None]
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.net_state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.batch_in_epoch = 0  # the data cursor a checkpoint carries
        self.last_batch_size = 0
        self.listeners: List[TrainingListener] = []
        self._score: Optional[torch.Tensor] = None
        self._tbptt_scores: List[torch.Tensor] = []
        self._tbptt_mid_batch = False
        self._rnn_states: Optional[Dict[str, Any]] = None
        # dropout's draws in training
        self._gen = torch.Generator(device=self.device).manual_seed(conf.seed)
        # the compiled training steps and the device iteration
        self._steps = TrainUnits(self.device, "graph", [self._gen])

    def _node(self, name: str) -> _GraphNode:
        for n in self.conf.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def _toposort(self) -> List[_GraphNode]:
        done = set(self.conf.network_inputs)
        remaining = list(self.conf.nodes)
        order = []
        while remaining:
            progress = False
            for n in list(remaining):
                if all(i in done for i in n.inputs):
                    order.append(n)
                    done.add(n.name)
                    remaining.remove(n)
                    progress = True
            if not progress:
                raise ValueError(f"graph has a cycle or missing inputs: "
                                 f"{[n.name for n in remaining]}")
        return order

    # ------------------------------------------------------------------ init
    def init(self, params=None) -> "ComputationGraph":
        """Parameters from ``params`` (name -> leaf -> numpy array, as the
        JAX package's ``jax.tree.map(np.asarray, net.params)`` gives them,
        or tensor; copied to the network's device) or drawn from
        ``conf.seed``; fresh layer state and updater state."""
        if params is not None:
            self.params = _tree().params_from_numpy(dict(params),
                                                    self.device)
        else:
            gen = torch.Generator().manual_seed(self.conf.seed)
            self.params = {n: self.layers[n].init(gen)
                           for n in self._layer_names}
        self.net_state = {n: l.init_state() for n, l in self.layers.items()}
        self.opt_state = {}
        for n, l in self.layers.items():
            upd = self.conf.layer_updater(l.lc)
            self.opt_state[n] = init_opt_state(upd, self.params[n])
        return self

    def set_listeners(self, *ls: TrainingListener) -> None:
        self.listeners = list(ls)

    def add_listeners(self, *ls: TrainingListener) -> None:
        self.listeners.extend(ls)

    # --------------------------------------------------------------- forward
    def _forward(self, params, net_state, inputs: Dict[str, Any], masks, *,
                 train: bool, rng=None, rnn_states=None):
        """(activations by node name, new layer state); with
        ``rnn_states`` (node name → carried state, None for the other
        nodes) (activations, new layer state, new rnn states): the tBPTT /
        ``rnn_time_step`` path, each recurrent node starting from its
        carried state."""
        if DT.needs_cast(self.conf.dtype):
            # mixed policy: the ONE cast of params and inputs to bf16
            cd = DT.compute_dtype(self.conf.dtype)
            params = DT.cast_floats(params, cd)
            inputs = DT.cast_floats(inputs, cd)
            if rnn_states is not None:
                rnn_states = DT.cast_floats(rnn_states, cd)
        # "bfloat16" / "float16": the parameters are stored 16-bit and the
        # inputs keep their dtype; each layer op promotes its operands as
        # jnp does (nn.dtype.promote), so float32 inputs compute and come
        # out in float32, as in the JAX package
        acts: Dict[str, Any] = dict(inputs)
        act_masks: Dict[str, Any] = dict(masks or {})
        new_state: Dict[str, Any] = {}
        new_rnn = {} if rnn_states is not None else None
        for node in self._order:
            xs = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[node.name] = node.vertex.apply(xs)
                ms = [act_masks.get(i) for i in node.inputs]
                act_masks[node.name] = next(
                    (m for m in ms if m is not None), None)
                continue
            layer = self.layers[node.name]
            if rnn_states is not None and hasattr(layer, "apply_with_state"):
                mask = act_masks.get(node.inputs[0])
                x0 = layer._maybe_dropout(xs[0], train=train, rng=rng)
                acts[node.name], new_rnn[node.name] = layer.apply_with_state(
                    params[node.name], x0, mask=mask,
                    initial=rnn_states.get(node.name))
                act_masks[node.name] = mask
                new_state[node.name] = net_state[node.name]
                continue
            if new_rnn is not None:
                new_rnn[node.name] = None
            if hasattr(layer, "apply_multi"):
                # a multi-input layer (the AttentionVertex role) gets every
                # wired input; the mask that matters is the keys input's
                # (the last wired one): it gates the attended positions
                kmask = (act_masks.get(node.inputs[-1])
                         if len(node.inputs) > 1
                         else act_masks.get(node.inputs[0]))
                y, st, m2 = layer.apply_multi(
                    params[node.name], xs, net_state[node.name],
                    train=train, rng=rng, mask=kmask)
                acts[node.name] = y
                act_masks[node.name] = m2
                new_state[node.name] = st
                continue
            x = xs[0]
            if node.flatten_input and x.ndim == 4:
                # NHWC -> the reference's channel-major flat order
                x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
            elif node.flatten_input and x.ndim == 5:
                # NDHWC -> channel-major (the reference's NCDHW order)
                x = x.permute(0, 4, 1, 2, 3).reshape(x.shape[0], -1)
            y, st, m2 = layer.apply(
                params[node.name], x, net_state[node.name], train=train,
                rng=rng, mask=act_masks.get(node.inputs[0]))
            acts[node.name] = y
            act_masks[node.name] = m2
            new_state[node.name] = st
        if DT.needs_cast(self.conf.dtype):
            for o in self.conf.network_outputs:  # loss/eval math in f32
                acts[o] = DT.cast_floats(acts[o], torch.float32)
        if new_rnn is not None:
            return acts, new_state, new_rnn
        return acts, new_state

    def _feed(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        # in the dtypes the JAX package computes in (64-bit types off:
        # float64 → float32, int64 → int32)
        return {k: canonical(v, self.device) for k, v in arrays.items()}

    def output(self, *inputs, masks=None) -> List[np.ndarray]:
        """graph.output(inputs...) — the output nodes' activations
        (inference mode), as numpy arrays."""
        feed = self._feed(dict(zip(self.conf.network_inputs, inputs)))
        m = None if masks is None else self._feed(masks)
        with torch.no_grad(), DT.precision_scope(self.conf.dtype):
            acts, _ = self._forward(self.params, self.net_state, feed, m,
                                    train=False)
        return [DT.host_array(acts[o])
                for o in self.conf.network_outputs]

    def output_single(self, x, masks=None) -> np.ndarray:
        return self.output(x, masks=masks)[0]

    # ------------------------------------------------------ stateful RNN API
    def rnn_time_step(self, *inputs, masks=None):
        """Stateful streaming inference (ComputationGraph.rnnTimeStep):
        each recurrent node's state carries across calls. Inputs (N, T, F)
        a network input, or (N, F) for one step. Returns the network
        outputs (a list, or the one array)."""
        squeeze = False
        feeds = {}
        for name, x in zip(self.conf.network_inputs, inputs):
            x = np.asarray(x)
            if x.ndim == 2:
                x = x[:, None, :]
                squeeze = True
            feeds[name] = x
        feeds = self._feed(feeds)
        if self._rnn_states is None:
            batch = next(iter(feeds.values())).shape[0]
            self._rnn_states = self._zero_rnn_states(batch)
        m = None if masks is None else self._feed(masks)
        with torch.no_grad(), DT.precision_scope(self.conf.dtype):
            acts, _, self._rnn_states = self._forward(
                self.params, self.net_state, feeds, m, train=False,
                rnn_states=self._rnn_states)
        outs = [DT.host_array(acts[o])
                for o in self.conf.network_outputs]
        if squeeze:
            outs = [o[:, -1] if o.ndim == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        self._rnn_states = None

    def _zero_rnn_states(self, batch: int) -> Dict[str, Any]:
        states: Dict[str, Any] = {}
        for name, layer in self.layers.items():
            if isinstance(layer, BidirectionalImpl):
                # the reference refuses them too: the backward direction
                # needs the future
                raise ValueError(
                    "stateful RNN state (rnn_time_step / tBPTT) is not "
                    "supported with Bidirectional layers")
            states[name] = (layer.zero_state(batch)
                            if hasattr(layer, "zero_state") else None)
        return states

    # ------------------------------------------------------------ train step
    def _losses(self, acts, labels: Dict[str, Any], lmasks):
        total = torch.zeros((), device=self.device)
        for name in self._output_layers:
            loss_fn = get_loss(self._node(name).layer.loss)
            lm = None if lmasks is None else lmasks.get(name)
            total = total + loss_fn(acts[name], labels[name], lm)
        return total

    def _donated(self) -> list:
        """The tensors a training step writes in place: parameters,
        updater state, layer state and the device iteration."""
        return tensors_of(self.params, self.opt_state, self.net_state) + [
            self._steps.iteration.tensor]

    def _step(self, feeds, labels, fmasks, lmasks, rnn_states=None):
        """The step's body: loss and gradients by autograd, then the update
        tail under no_grad and the iteration advanced on the device.
        Returns the score (loss + regularization penalty of the parameters
        before the update), a 0-d tensor on the device; with
        ``rnn_states`` also the carried states, detached (gradients stop
        at the segment boundary), flattened after it."""
        names = self._layer_names
        step = self._steps.iteration.tensor
        donate = donates(self.device)
        with DT.precision_scope(self.conf.dtype):
            with torch.enable_grad():
                params = {n: autograd_leaves(self.params[n]) for n in names}
                res = self._forward(params, self.net_state, feeds, fmasks,
                                    train=True, rng=self._gen,
                                    rnn_states=rnn_states)
                acts, new_state = res[0], res[1]
                loss = self._losses(acts, labels, lmasks)
                if rnn_states is None:  # the JAX tBPTT loss has no aux
                    loss = loss + aux_losses(new_state, self.device)
                g = grad_tree(loss, params)
            with torch.no_grad():
                score = loss.detach() + reg_penalty(
                    self.conf, ((self.params[n], self.layers[n].lc)
                                for n in names), self.device)
                updated = apply_layer_updates(
                    self.conf,
                    ((self.params[n], g[n], self.opt_state[n],
                      self.conf.layer_updater(self.layers[n].lc),
                      self.layers[n].lc) for n in names),
                    step, inplace=donate)
                new_state = {n: {k: v.detach() for k, v in st.items()}
                             for n, st in new_state.items()}
                if donate:
                    self.net_state = commit(self.net_state, new_state)
                else:
                    self.params = {n: p for n, (p, _) in zip(names, updated)}
                    self.opt_state = {n: s for n, (_, s) in zip(names,
                                                                updated)}
                    self.net_state = new_state
                step.add_(1)
        if rnn_states is None:
            return score
        return (score,) + tuple(flatten_rnn(
            {n: _detached(st) for n, st in res[2].items()})[0])

    def _train_step(self, feeds, labels, fmasks, lmasks, rnn_states=None):
        """One step (one tBPTT segment with ``rnn_states``) as the training
        unit ``train`` / ``train_tbptt`` (module docstring): the score, a
        0-d tensor on the device; with ``rnn_states`` also the carried
        states."""
        self._steps.iteration.at(self.iteration_count)
        groups = [feeds, labels, fmasks or {}, lmasks or {}]
        names = tuple(tuple(sorted(d)) for d in groups)
        args = [d[k] for d, ks in zip(groups, names) for k in ks]
        rnn_flat, rnn_spec = ([], None) if rnn_states is None else (
            flatten_rnn(rnn_states))
        counts = [len(ks) for ks in names]

        def body(*tensors):
            parts, i = [], 0
            for ks, c in zip(names, counts):
                parts.append(dict(zip(ks, tensors[i:i + c])))
                i += c
            carried = None if rnn_spec is None else unflatten_rnn(
                rnn_spec, tensors[i:])
            return self._step(parts[0], parts[1], parts[2] or None,
                              parts[3] or None, carried)

        out = self._steps.run(
            "train" if rnn_states is None else "train_tbptt", body,
            args + rnn_flat, layout=(names, rnn_spec),
            state=self._donated(),
            signature=observe.signature_of(
                **{f"x.{k}": v for k, v in feeds.items()},
                **{f"y.{k}": v for k, v in labels.items()},
                **{f"fm.{k}": v for k, v in (fmasks or {}).items()},
                **{f"lm.{k}": v for k, v in (lmasks or {}).items()}),
            eager_reason=mask_routing(self.layers.values(),
                                      (fmasks or {}).values()))
        self._steps.iteration.advanced()
        if rnn_states is None:
            return out
        return out[0], unflatten_rnn(rnn_spec, out[1:])

    def fit_tbptt(self, features, labels, masks=None, lmasks=None) -> float:
        """One truncated-BPTT pass over a time-series batch
        (ComputationGraph.doTruncatedBPTT): the time axis cut into
        ``conf.tbptt_fwd_length`` segments, one update a segment, the RNN
        state carried from one to the next. Arrays feed the first input /
        output; name-keyed dicts feed several. Listeners are called after
        every segment; returns the last segment's score."""
        fwd = self.conf.tbptt_fwd_length
        if fwd <= 0:
            raise ValueError("set tbptt lengths on the configuration first")

        def by_name(v, names):
            return v if v is None or isinstance(v, dict) else {names[0]: v}

        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        features, masks = by_name(features, ins), by_name(masks, ins)
        labels, lmasks = by_name(labels, outs), by_name(lmasks, outs)
        for k, v in labels.items():
            if np.ndim(v) < 3:
                raise ValueError(
                    "tBPTT requires 3-D time-series labels (N, T, C); got "
                    f"shape {np.shape(v)} for output '{k}'")
        feeds, labs = self._feed(features), self._feed(labels)
        fm = None if masks is None else self._feed(masks)
        lm = None if lmasks is None else self._feed(lmasks)
        first = next(iter(feeds.values()))
        t = first.shape[1]
        rnn_states = self._zero_rnn_states(first.shape[0])
        segments = list(range(0, t, fwd))
        self._tbptt_scores = []

        def cut(d, sl):
            return None if d is None else {k: v[:, sl] for k, v in d.items()}

        for i, t0 in enumerate(segments):
            sl = slice(t0, min(t0 + fwd, t))
            score, rnn_states = self._train_step(
                cut(feeds, sl), cut(labs, sl), cut(fm, sl), cut(lm, sl),
                rnn_states)
            self._score = score
            self._tbptt_scores.append(score)
            # the iteration advances once a segment; the last segment's
            # advance comes after the listeners, as in the JAX graph
            if i < len(segments) - 1:
                self.iteration_count += 1
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.epoch_count, score)
        self.iteration_count += 1
        return float(score)

    def tbptt_scores(self) -> List[float]:
        """The scores of the last tBPTT batch's segments, in order."""
        return [float(s) for s in self._tbptt_scores]

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1,
            batch_size: int = 32) -> None:
        """fit over a DataSet / iterator, or (features, labels) arrays cut
        into ``batch_size`` batches. Single input and single output: the
        features feed the first input, the labels the first output (several
        go through :meth:`fit_multi`). With ``backprop_type="tbptt"`` each
        batch is one :meth:`fit_tbptt` pass.

        Each batch first polls the ``preemption`` fault point (a hard
        kill: it raises) and the graceful-preemption flag
        (``notify_preemption``, then return); a fit resumed mid-epoch
        skips the ``batch_in_epoch`` batches the interrupted one
        trained."""
        if labels is not None:
            data = ListDataSetIterator(DataSet(data, labels),
                                       batch_size=batch_size)
        elif isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size=batch_size)
        if (self.conf.backprop_type == "tbptt"
                and self.conf.tbptt_fwd_length > 0):
            self._fit_tbptt_epochs(data, epochs)
            return
        in_name = self.conf.network_inputs[0]
        out_name = self.conf.network_outputs[0]
        m = observe.metrics()
        steps_c = m.counter("dl4j_tpu_train_steps_total", model="graph")
        ex_c = m.counter("dl4j_tpu_train_examples_total", model="graph")
        step_h = m.histogram("dl4j_tpu_train_step_seconds", model="graph")
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self)
            t_prev = time.perf_counter()
            n_steps = 0
            skip = self.batch_in_epoch  # nonzero only on a resume
            for bi, ds in enumerate(data):
                if bi < skip:
                    continue
                faults.maybe_fail("preemption")
                if faults.preemption_requested():
                    notify_preemption(self, self.listeners)
                    return
                self.last_batch_size = ds.num_examples()
                feeds = self._feed({in_name: ds.features})
                labs = self._feed({out_name: ds.labels})
                fmasks = (None if ds.features_mask is None
                          else self._feed({in_name: ds.features_mask}))
                lmasks = (None if ds.labels_mask is None
                          else self._feed({out_name: ds.labels_mask}))
                self._score = self._train_step(feeds, labs, fmasks, lmasks)
                self.iteration_count += 1
                self.batch_in_epoch = bi + 1  # before listeners save
                now = time.perf_counter()
                step_h.observe(now - t_prev)
                t_prev = now
                n_steps += 1
                steps_c.inc()
                ex_c.inc(ds.num_examples())
                # the loss as a device tensor: no host sync unless a
                # listener reads it
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count,
                                       self.epoch_count, self._score)
            self.batch_in_epoch = 0
            self.epoch_count += 1
            observe.log_event("train_epoch", model="graph",
                              epoch=self.epoch_count, steps=n_steps)
            for lst in self.listeners:
                lst.on_epoch_end(self)
        notify_fit_done(self, self.listeners)

    def _fit_tbptt_epochs(self, data, epochs: int) -> None:
        """``fit``'s truncated-BPTT dispatch: one :meth:`fit_tbptt` pass a
        batch, with the JAX graph's cursor and preemption poll. Listeners
        that declare ``defers_mid_tbptt`` skip the per-segment calls
        (``_tbptt_mid_batch``) and get one call at the batch boundary,
        after the cursor moved: a snapshot mid-batch (a live RNN carry the
        state does not hold, a stale cursor) could never resume
        exactly."""
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self)
            skip = self.batch_in_epoch
            for bi, ds in enumerate(data):
                if bi < skip:
                    continue
                faults.maybe_fail("preemption")
                if faults.preemption_requested():
                    notify_preemption(self, self.listeners)
                    return
                self.last_batch_size = ds.num_examples()
                self._tbptt_mid_batch = True
                try:
                    loss = self.fit_tbptt(ds.features, ds.labels,
                                          masks=ds.features_mask,
                                          lmasks=ds.labels_mask)
                finally:
                    self._tbptt_mid_batch = False
                self.batch_in_epoch = bi + 1
                for lst in self.listeners:
                    if getattr(lst, "defers_mid_tbptt", False):
                        lst.iteration_done(self, self.iteration_count,
                                           self.epoch_count, loss)
            self.batch_in_epoch = 0
            self.epoch_count += 1
            for lst in self.listeners:
                lst.on_epoch_end(self)
        notify_fit_done(self, self.listeners)

    def fit_multi(self, inputs, labels) -> float:
        """One training step over several inputs and outputs
        (ComputationGraph.fit(MultiDataSet)): lists in
        ``network_inputs`` / ``network_outputs`` order, or name-keyed
        dicts. Returns the step's score."""
        if not isinstance(inputs, dict):
            inputs = dict(zip(self.conf.network_inputs, inputs))
        if not isinstance(labels, dict):
            labels = dict(zip(self.conf.network_outputs, labels))
        feeds, labs = self._feed(inputs), self._feed(labels)
        self.last_batch_size = next(iter(feeds.values())).shape[0]
        self._score = self._train_step(feeds, labs, None, None)
        self.iteration_count += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration_count, self.epoch_count,
                               self._score)
        return float(self._score)

    def fit_scanned(self, features, labels, steps: Optional[int] = None
                    ) -> np.ndarray:
        """Many train steps with no host read between them — the training
        unit ``fit_scanned`` replayed once a step (the JAX package's
        ``lax.scan`` over the train step; see
        ``MultiLayerNetwork.fit_scanned``, same two modes). ``features`` /
        ``labels``: single-input/-output arrays, or dicts keyed by input /
        output name for multi-IO graphs (with ``steps`` None each carries
        the leading [steps, batch, ...] axis). Listeners fire after the
        chunk with the steps' iteration numbers and losses. Returns the
        per-step losses (float32 numpy)."""
        if not isinstance(features, dict):
            features = {self.conf.network_inputs[0]: features}
        if not isinstance(labels, dict):
            labels = {self.conf.network_outputs[0]: labels}
        feeds, labs = self._feed(features), self._feed(labels)
        per_step = steps is None
        first = next(iter(feeds.values()))
        n_steps = int(first.shape[0]) if per_step else int(steps)
        fk, lk = tuple(sorted(feeds)), tuple(sorted(labs))
        start = self.iteration_count
        self.last_batch_size = int(first.shape[1] if per_step
                                   else first.shape[0])

        def step(*batch):
            return self._step(dict(zip(fk, batch[:len(fk)])),
                              dict(zip(lk, batch[len(fk):])), None, None)

        def advance(losses):
            self.iteration_count = start + n_steps
            self._score = losses[-1]

        return self._steps.scan(
            "fit_scanned", step, [feeds[k] for k in fk] + [labs[k]
                                                           for k in lk],
            n_steps, per_step=per_step, state=self._donated,
            signature=observe.signature_of(
                **{f"x.{k}": v for k, v in feeds.items()},
                **{f"y.{k}": v for k, v in labs.items()}),
            start=start, batch_size=self.last_batch_size, advance=advance,
            notify=functools.partial(notify_iteration, self), layout=(fk, lk))

    def score(self) -> float:
        return float("nan") if self._score is None else float(self._score)

    def evaluate(self, iterator, evaluation=None):
        """evaluate(DataSetIterator | DataSet) → the ``evaluation``
        accumulator (an ``Evaluation`` unless one is given) over the first
        output of every batch."""
        in_name = self.conf.network_inputs[0]
        return evaluate_batches(iterator, evaluation, lambda ds: (
            self.output_single(ds.features, masks=None
                               if ds.features_mask is None
                               else {in_name: ds.features_mask})))

    # ---------------------------------------------------- flat params / serde
    def _by_name(self, trees) -> list:
        """The layers' trees in sorted layer-name order (the JAX flat
        order: ``for name in sorted(self.params)``)."""
        return [trees[n] for n in sorted(trees)]

    def params_flat(self) -> np.ndarray:
        """One flat float32 vector: layers by sorted name, then sorted
        keys within a layer."""
        return flatten_trees(self._by_name(self.params))

    def set_params_flat(self, flat) -> None:
        names = sorted(self.params)
        trees, offset = unflatten_trees(self._by_name(self.params), flat,
                                        self.device)
        if offset != np.asarray(flat).size:
            raise ValueError(f"param vector length {np.asarray(flat).size} "
                             f"!= model size {offset}")
        self.params = dict(zip(names, trees))

    def updater_state_flat(self) -> np.ndarray:
        return flatten_trees(self._by_name(self.opt_state))

    def set_updater_state_flat(self, flat) -> None:
        names = sorted(self.opt_state)
        trees, _ = unflatten_trees(self._by_name(self.opt_state), flat,
                                   self.device)
        self.opt_state = dict(zip(names, trees))

    def num_params(self) -> int:
        return sum(leaf.numel() for p in self.params.values()
                   for _, leaf in _tree().leaf_paths(p))


def save_graph(net: ComputationGraph, path: str,
               save_updater: bool = True) -> None:
    """ModelSerializer.writeModel for a ComputationGraph, under the JAX
    package's name: :func:`~deeplearning4j_tpu_torch.nn.serde.save_model`."""
    from deeplearning4j_tpu_torch.nn.serde import save_model

    save_model(net, path, save_updater)


def restore_graph(path: str, load_updater: bool = True,
                  device=None) -> ComputationGraph:
    """ModelSerializer.restoreComputationGraph, under the JAX package's
    name: :func:`~deeplearning4j_tpu_torch.nn.serde.restore_model`."""
    from deeplearning4j_tpu_torch.nn.serde import restore_model

    net = restore_model(path, load_updater, device)
    if not isinstance(net, ComputationGraph):
        raise ValueError(f"{path} holds a {type(net).__name__}, not a "
                         f"ComputationGraph")
    return net
