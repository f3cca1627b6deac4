"""Persistent export cache: trace once, restore in every later process.

Counterpart of ``deeplearning4j_tpu/autodiff/export.py``, on
``torch.export`` instead of ``jax.export``:

* **Export** — a computation (a SameDiff whole-graph exec, a
  MultiLayerNetwork train step, a serving engine step's core) is traced by
  ``torch.export`` into an ``ExportedProgram``: the aten operators and the
  port's kernels as ``torch.library`` operators (``ops/library.py``), with
  the dispatch decisions of the registry, the helper mode and the tuning
  table of the exporting process frozen into it. Batch axes are exported
  as ``Dim.AUTO``: export settles the range of batch sizes the program
  serves (a gate that reads the batch, such as the fused matmul's
  ``pallas_min_m`` crossover, narrows it), and the entry's ``meta`` keeps
  that range. A fresh batch size inside it is served without a new trace,
  and the recompile ledger records it as ``cache_hit``, not
  ``new_shape``; a batch outside it takes the recorded fallback (a plain
  step, the markers cleared), as the JAX wrapper falls back.
* **Cache** — :class:`ExportCache` keeps one JSON document an entry under
  ``$DL4J_TPU_COMPILE_CACHE``: atomic tmp + ``os.replace`` writes, a
  corrupt, stale or undeserializable entry warns once and misses. The
  digest pins the fingerprint, the key, the device kind
  (``torch.cuda.get_device_name()``, or ``"cpu"``), the torch version and
  the schemas of the registered ``dl4j_tpu_torch`` operators; the payload
  is the bytes of ``torch.export.save``.
* **Restore** — :func:`restore_callable` loads an entry back into
  ``torch.export.load(...).module()`` and marks it for the recompile
  ledger (``cache_hit``).

What is cached is the traced program, not its execution: on the card each
process still captures its own CUDA graphs around the restored program
(``ops/capture.py``), as the non-exported path does — a CUDA graph cannot
be serialized. The port has no backend binary to cache beside the
program, so the JAX module's ``_arm_xla_cache`` / ``disarm_xla_cache``
have no counterpart and :func:`reset_export_cache` only forgets the
warn-once state.

Random draws stay outside an exported program: ``torch.export`` cannot
take a ``torch.Generator``. The serving steps sample from the engine's
generator after their exported core, inside the same captured unit
(``serving/aot.py``); a train step whose layers draw (dropout) is not
exported — :func:`export_train_step` raises, naming the layer.

Consumers: ``serving/aot.py`` (the engine's warm boot),
:func:`warm_boot_net` (``TrainingSupervisor.resume``) and
:func:`install_exec` (``SameDiff.output``).
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.ops import library

logger = logging.getLogger(__name__)

SCHEMA = "dl4j_tpu_torch_aot_v1"
ENV_DIR = "DL4J_TPU_COMPILE_CACHE"

# warn-once set for corrupt/stale entries (tuning-table discipline): the
# first bad load of a path logs a warning, later loads stay silent misses
_WARNED_PATHS: set = set()


def reset_export_cache() -> None:
    """Test seam: forget the warn-once state (``tuning.reset_tables``'s
    counterpart). The JAX module also disarms the XLA persistent cache
    here; the port has none."""
    _WARNED_PATHS.clear()


def current_device_kind() -> str:
    """``torch.cuda.get_device_name()`` of the current card, ``"cpu"``
    without one."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def _dir_name(kind: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in kind)


def _warn_once(path: str, msg: str, *args) -> None:
    if path not in _WARNED_PATHS:
        _WARNED_PATHS.add(path)
        logger.warning(msg, path, *args)


class ExportCache:
    """Persistent on-disk cache of ``torch.export`` programs.

    One JSON document per entry at ``<root>/<device_kind>/<digest>.json``:
    ``{schema, key, fingerprint, torch_version, ops_schema, device_kind,
    created, meta, payload}`` with the bytes of ``torch.export.save``
    base64-encoded in ``payload``. The digest already hashes (fingerprint,
    key, device kind, torch version, operator schemas); the stored fields
    are checked again at load, so a hand-copied or stale file never
    restores under the wrong toolchain — it degrades to a miss."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.device_kind = current_device_kind()
        self.ops_schema = library.schema_digest()
        m = observe.metrics()
        self._hits = m.counter("dl4j_tpu_aot_cache_hits")
        self._misses = m.counter("dl4j_tpu_aot_cache_misses")
        self._export_h = m.histogram("dl4j_tpu_aot_export_seconds")

    @classmethod
    def from_env(cls) -> Optional["ExportCache"]:
        """The cache configured by ``$DL4J_TPU_COMPILE_CACHE``, or None —
        the whole export layer is inert unless the variable opts in."""
        root = os.environ.get(ENV_DIR)
        return cls(root) if root else None

    # ------------------------------------------------------------------ keys
    def digest(self, fingerprint: str, key: str) -> str:
        raw = "|".join((SCHEMA, fingerprint, key, self.device_kind,
                        torch.__version__, self.ops_schema))
        return hashlib.sha256(raw.encode()).hexdigest()

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, _dir_name(self.device_kind),
                            digest + ".json")

    # ------------------------------------------------------------------- i/o
    def store(self, fingerprint: str, key: str, exported,
              meta: Optional[Dict[str, Any]] = None) -> str:
        """Atomically persist one exported program. Returns the entry
        path."""
        # the example inputs export keeps would be saved with the program:
        # the parameters, the KV cache — gigabytes the program never reads
        exported.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        path = self._path(self.digest(fingerprint, key))
        doc = {
            "schema": SCHEMA,
            "key": key,
            "fingerprint": fingerprint,
            "torch_version": torch.__version__,
            "ops_schema": self.ops_schema,
            "device_kind": self.device_kind,
            "created": time.time(),
            "meta": dict(meta or {}),
            "payload": base64.b64encode(buf.getvalue()).decode("ascii"),
        }
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)  # atomic: readers never see a torn entry
        return path

    def _load_doc(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") != SCHEMA:
                raise ValueError(f"schema {doc.get('schema')!r} != {SCHEMA}")
            return doc
        except FileNotFoundError:
            return None
        except (ValueError, TypeError, KeyError, OSError) as e:
            _warn_once(path, "ignoring corrupt export cache entry %s (%r) — "
                       "falling back to a fresh trace", e)
            return None

    def _current(self, doc: Dict[str, Any]) -> bool:
        return (doc.get("torch_version") == torch.__version__
                and doc.get("device_kind") == self.device_kind
                and doc.get("ops_schema") == self.ops_schema)

    def load_entry(self, fingerprint: str, key: str
                   ) -> Optional[Tuple[Any, Dict[str, Any]]]:
        """``(ExportedProgram, meta)`` for (fingerprint, key), or None on a
        miss, a corrupt, stale or undeserializable entry — every non-hit
        degrades to a fresh trace."""
        path = self._path(self.digest(fingerprint, key))
        doc = self._load_doc(path)
        if doc is not None and not self._current(doc):
            # the digest already pins these, but a renamed or hand-copied
            # file must still never restore across toolchains
            _warn_once(path, "ignoring stale export cache entry %s (torch "
                       "%s/%s, device %s/%s)", doc.get("torch_version"),
                       torch.__version__, doc.get("device_kind"),
                       self.device_kind)
            doc = None
        if doc is None:
            self._misses.inc()
            return None
        try:
            library.ops()  # the operators the program calls, registered
            exported = torch.export.load(io.BytesIO(
                base64.b64decode(doc["payload"])))
        except Exception as e:
            _warn_once(path, "ignoring undeserializable export cache entry "
                       "%s (%r) — falling back to a fresh trace", e)
            self._misses.inc()
            return None
        self._hits.inc()
        return exported, dict(doc.get("meta") or {})

    def load(self, fingerprint: str, key: str):
        """The ``ExportedProgram`` for (fingerprint, key), or None."""
        got = self.load_entry(fingerprint, key)
        return None if got is None else got[0]

    def entries(self) -> Iterator[Dict[str, Any]]:
        """Metadata of every readable, current entry for this device kind
        (payload omitted) — the scan :func:`warm_boot_net` uses."""
        d = os.path.join(self.root, _dir_name(self.device_kind))
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            doc = self._load_doc(os.path.join(d, name))
            if doc is not None and self._current(doc):
                yield {k: doc[k] for k in
                       ("key", "fingerprint", "meta", "created")}

    def observe_export_seconds(self, seconds: float) -> None:
        """Feed the ``dl4j_tpu_aot_export_seconds`` histogram."""
        self._export_h.observe(seconds)


# ---------------------------------------------------------------------------
# export and restore
# ---------------------------------------------------------------------------


class _Fn(torch.nn.Module):
    """A plain function as the module ``torch.export`` traces (held
    outside the module's parameters)."""

    def __init__(self, fn):
        super().__init__()
        self.__dict__["_fn"] = fn

    def forward(self, *args):
        return self._fn(*args)


def export_fn(fn, args: Sequence[Any], dynamic_shapes=None):
    """``torch.export`` of ``fn(*args)`` (args: tensors and pytrees of
    tensors), traced under ``no_grad``."""
    with torch.no_grad():
        return torch.export.export(
            _Fn(fn), tuple(args),
            dynamic_shapes=(None if dynamic_shapes is None
                            else {"args": tuple(dynamic_shapes)}))


def export_grad_fn(fn, args: Sequence[Any], dynamic_shapes,
                   batch_index: int):
    """``torch.export`` of a function that calls ``torch.autograd.grad``
    (a train step), in two stages. ``torch.export`` traces above autograd,
    where the tensors an operator saves for its backward come back as
    untracked copies (it stops on "a fake tensor in the exported program
    constant's list"); so ``make_fx`` first traces ``fn`` with autograd
    run (every dim symbolic: the backward's aten operators and the
    kernels' operators recorded, in-place updates kept), and
    ``torch.export`` then exports that graph. Returns ``(program, batch
    range)``: the range of the leading axis of flattened argument
    ``batch_index`` that both stages allow (the first stage's guards on
    it, such as a crossover gate's, narrow its range)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat, spec = pytree.tree_flatten(tuple(args))

    def flat_fn(*leaves):
        return fn(*pytree.tree_unflatten(list(leaves), spec))

    with torch.enable_grad():
        gm = make_fx(flat_fn, tracing_mode="symbolic")(*flat)
    node = [n for n in gm.graph.nodes if n.op == "placeholder"][batch_index]
    first = _dim_range(node.meta["val"].shape[0], gm.shape_env.var_to_range)

    def traced(*a):
        return gm(*pytree.tree_leaves(a))

    exported = export_fn(traced, args, dynamic_shapes)
    second = leading_range(exported, batch_index)
    his = [h for h in (first[1], second[1]) if h is not None]
    return exported, [max(first[0], second[0]), min(his) if his else None]


class Restored:
    """A restored (or freshly exported) program, callable as the function
    it was exported from, and marked for the recompile ledger:
    ``_aot_restored`` (restored from a populated cache: every event a
    ``cache_hit``) and ``_aot_polymorphic`` (a symbolic batch: a fresh
    signature is a ``cache_hit``)."""

    def __init__(self, exported, *, restored: bool, polymorphic: bool,
                 meta: Optional[Dict[str, Any]] = None):
        self.exported = exported
        self.module = exported.module()
        self.meta = dict(meta or {})
        self._aot_restored = bool(restored)
        self._aot_polymorphic = bool(polymorphic)

    def __call__(self, *args):
        return self.module(*args)


def restore_callable(exported, *, graph: str, key: str, hit: bool,
                     polymorphic: bool = False,
                     signature: Optional[str] = None,
                     meta: Optional[Dict[str, Any]] = None) -> Restored:
    """Wrap an exported (or loaded) program back into a callable and mark
    it for the recompile ledger.

    ``hit=True`` (restored from a populated cache) records a restore event
    at once — ``cache_hit``, attributed here — and marks the callable so
    every later registration also records ``cache_hit``: the warm leg's
    ledger shows no fresh trace. ``hit=False`` (the exporting process
    installs the program it just traced, so that both legs run one
    program) leaves the first dispatch to record ``first_compile``.
    ``polymorphic=True`` marks a symbolic-batch export."""
    fn = Restored(exported, restored=hit, polymorphic=polymorphic,
                  meta=meta)
    if hit:
        observe.note_jit_signature(fn, graph=graph, key=key,
                                   signature=signature or f"aot[{key}]")
    return fn


def spec_of(tree, batch: bool = False):
    """The ``dynamic_shapes`` entry mirroring ``tree``: with ``batch``,
    every tensor leaf of rank >= 1 takes ``Dim.AUTO`` on its leading axis
    (export settles the batch range), else every leaf is static."""
    from torch.export import Dim

    def one(a):
        if batch and isinstance(a, torch.Tensor) and a.ndim:
            return {0: Dim.AUTO}
        return None

    return pytree.tree_map(one, tree)


def leading_range(exported, flat_index: int) -> List[Optional[int]]:
    """``[low, high]`` of the leading axis of user input ``flat_index``
    (in the flattened argument order) that export settled on; high is None
    when unbounded."""
    names = list(exported.graph_signature.user_inputs)
    node = next(n for n in exported.graph.nodes
                if n.op == "placeholder" and n.name == names[flat_index])
    return _dim_range(node.meta["val"].shape[0],
                      exported.range_constraints)


def _dim_range(dim, ranges) -> List[Optional[int]]:
    """``[low, high]`` of a traced dim: an int or a SymInt specialized to
    a number is that number; a symbol, its range in ``ranges``."""
    expr = dim if isinstance(dim, int) else dim.node.expr
    if isinstance(expr, int) or getattr(expr, "is_number", False):
        return [int(expr), int(expr)]
    vr = ranges.get(expr)
    if vr is None:
        return [0, None]
    return [int(vr.lower), _upper(vr.upper)]


def _upper(bound) -> Optional[int]:
    if getattr(bound, "is_finite", True) is False or not getattr(
            bound, "is_integer", True):
        return None  # unbounded (int_oo)
    try:
        return int(bound)
    except (TypeError, ValueError, OverflowError, AttributeError):
        return None


def _in_range(n: int, rng) -> bool:
    lo, hi = rng
    return n >= lo and (hi is None or n <= hi)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def fingerprint_tokens(*tokens) -> str:
    """sha256 over a flat token tuple — config-identity fingerprints for
    consumers without a GraphPlan (engine configs, net configs)."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(repr(t).encode())
        h.update(b"|")
    return h.hexdigest()


def _tree_spec_tokens(tree) -> List[Tuple[str, Tuple[int, ...], str]]:
    leaves = pytree.tree_flatten_with_path(tree)[0]
    return [(pytree.keystr(path), tuple(getattr(a, "shape", ())),
             str(getattr(a, "dtype", type(a).__name__)))
            for path, a in leaves]


def dispatch_tokens(device) -> Tuple[Any, ...]:
    """What a program freezes besides its structure: the device type, the
    helper mode and the tuning table the registry dispatched by."""
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.ops import tuning

    table = json.dumps(tuning.active_table().to_dict(), sort_keys=True,
                       default=str)
    return (torch.device(device).type, environment().helper_mode,
            hashlib.sha256(table.encode()).hexdigest())


def net_fingerprint(net) -> str:
    """Identity of a MultiLayerNetwork for cache keying: the layer
    configuration, the parameter, updater-state and layer-state trees
    (shapes and dtypes) and :func:`dispatch_tokens`. Weight values are
    left out: the program is a function of structure, and the parameters
    are its arguments."""
    conf = getattr(net, "conf", None)
    try:
        conf_token = conf.to_json()
    except AttributeError:
        conf_token = repr(conf)
    return fingerprint_tokens(
        "mln", conf_token, _tree_spec_tokens(net.params),
        _tree_spec_tokens(net.opt_state), _tree_spec_tokens(net.net_state),
        dispatch_tokens(net.device))


# ---------------------------------------------------------------------------
# MultiLayerNetwork train step (TrainingSupervisor.resume's consumer)
# ---------------------------------------------------------------------------


def _drawing_layers(net) -> List[str]:
    return [f"layer {i} ({type(lc).__name__}, dropout {lc.dropout})"
            for i, lc in enumerate(net.conf.layers)
            if getattr(lc, "dropout", 0)]


def _mln_raw_step(net):
    """The train step as a function of its tensors alone: ``(params,
    opt_state, net_state, step, x, y) -> score``, the network's own
    ``_step`` run on the given trees. On every device the new parameters,
    updater state and layer state land in the given tensors and the step
    adds one to ``step`` (in place: the JAX step's donated buffers), so
    the traced program mutates its inputs; it switches no grad mode (it is
    traced with autograd on)."""
    from deeplearning4j_tpu_torch.nn.compiled import commit, donates

    def raw_step(params, opt_state, net_state, step, x, y):
        saved = (net.params, net.opt_state, net.net_state,
                 net._steps.iteration.tensor)
        net.params, net.opt_state, net.net_state = (list(params),
                                                    list(opt_state),
                                                    list(net_state))
        net._steps.iteration.tensor = step
        try:
            score = net._step(x, y, None, None, grad_scopes=False)
            if not donates(net.device):
                commit(list(params), net.params)
                commit(list(opt_state), net.opt_state)
                commit(list(net_state), net.net_state)
        finally:
            (net.params, net.opt_state, net.net_state,
             net._steps.iteration.tensor) = saved
        return score

    return raw_step


def _sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order (the same tensors):
    a program is called with its arguments' keys in the order it was
    exported with, and a restore may rebuild a dict in another."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


def _state_args(net) -> tuple:
    """The train step's state arguments: parameters, updater state, layer
    state and the device iteration."""
    return (_sorted_tree(net.params), _sorted_tree(net.opt_state),
            _sorted_tree(net.net_state), net._steps.iteration.tensor)


class _MLNStep:
    """The network's ``_jit_cache["train_step"]``: the restored program
    run as the body of the ``train`` unit (a CUDA-graph capture on the
    card, as the plain step is). The export covered one signature (no
    masks, the exported trailing dims and dtypes, a batch in the settled
    range); a batch outside it permanently falls back to the network's
    plain step, clearing the ledger markers so later events report
    honestly (the JAX ``_mln_wrapper``)."""

    def __init__(self, net, restored: Restored, meta: Dict[str, Any]):
        self.net = net
        self.restored = restored
        self.meta = meta
        self.plain = False
        self._aot_restored = restored._aot_restored
        self._aot_polymorphic = True
        self._obs_sigs = set(getattr(restored, "_obs_sigs", ()))

    def fits(self, x, y, fmask, lmask) -> bool:
        m = self.meta
        ok = (not self.plain and fmask is None and lmask is None
              and list(x.shape[1:]) == m["feature_dims"]
              and list(y.shape[1:]) == m["label_dims"]
              and str(x.dtype) == m["feature_dtype"]
              and str(y.dtype) == m["label_dtype"]
              and x.shape[0] == y.shape[0]
              and _in_range(x.shape[0], m["batch_range"]))
        if not ok and not self.plain:
            self.plain = True
            self._aot_restored = self._aot_polymorphic = False
            observe.log_event("aot_fallback", consumer="mln",
                              batch=int(x.shape[0]),
                              batch_range=m["batch_range"])
        return ok

    def __call__(self, x, y):
        net = self.net
        return self.restored(*_state_args(net), x, y)


def export_train_step(net, features, labels,
                      cache: Optional[ExportCache] = None
                      ) -> Optional[str]:
    """Export ``net``'s train step with a symbolic batch and persist it;
    install the same program as the network's live step
    (``net._jit_cache["train_step"]``) so this (populating) process and
    every warm restore run one program. Returns the entry path, or None
    when no cache is configured. A network whose layers draw from its
    generator (dropout) raises ``NotImplementedError``: the draws cannot
    enter an exported program."""
    cache = cache or ExportCache.from_env()
    if cache is None:
        return None
    drawing = _drawing_layers(net)
    if drawing:
        raise NotImplementedError(
            f"export_train_step: the step draws from the network's "
            f"generator ({', '.join(drawing)}); torch.export takes no "
            f"torch.Generator")
    x, y = net._feed(features), net._feed(labels)
    net._steps.iteration.at(net.iteration_count)
    args = _state_args(net) + (x, y)
    ds = tuple(spec_of(a) for a in args[:4]) + (spec_of(x, True),
                                                spec_of(y, True))
    t0 = time.perf_counter()
    exported, batch_range = export_grad_fn(
        _mln_raw_step(net), args, ds,
        batch_index=len(pytree.tree_leaves(args[:4])))
    cache.observe_export_seconds(time.perf_counter() - t0)
    meta = {"graph": "mln", "feature_dims": list(x.shape[1:]),
            "label_dims": list(y.shape[1:]), "feature_dtype": str(x.dtype),
            "label_dtype": str(y.dtype), "batch_range": batch_range}
    path = cache.store(net_fingerprint(net), "train_step", exported,
                       meta=meta)
    restored = restore_callable(exported, graph="mln", key="train_step",
                                hit=False, polymorphic=True, meta=meta)
    net._jit_cache["train_step"] = _MLNStep(net, restored, meta)
    return path


def warm_boot_net(net, cache: Optional[ExportCache] = None) -> int:
    """Restore every cached step for this network's fingerprint into its
    ``_jit_cache`` — the training half of a cold-start restore, called by
    ``TrainingSupervisor.resume`` in a fresh process. The first ``fit``
    batch runs the restored program and the ledger records only
    ``cache_hit``. Returns the number of steps restored (0 without a
    cache or a match)."""
    cache = cache or ExportCache.from_env()
    if cache is None or not hasattr(net, "_jit_cache"):
        return 0
    fp = net_fingerprint(net)
    restored = 0
    for entry in cache.entries():
        if entry["fingerprint"] != fp or entry["key"] in net._jit_cache:
            continue
        got = cache.load_entry(fp, entry["key"])
        if got is None:
            continue
        exported, meta = got
        fn = restore_callable(exported, graph=meta.get("graph", "mln"),
                              key=entry["key"], hit=True, polymorphic=True,
                              meta=meta)
        net._jit_cache[entry["key"]] = _MLNStep(net, fn, meta)
        restored += 1
    if restored:
        observe.log_event("aot_warm_boot", consumer="mln", restored=restored)
    return restored


def maybe_warm_boot_net(net) -> int:
    """Env-gated :func:`warm_boot_net` — inert without the cache dir."""
    if not os.environ.get(ENV_DIR):
        return 0
    return warm_boot_net(net)


# ---------------------------------------------------------------------------
# SameDiff whole-graph exec
# ---------------------------------------------------------------------------


def samediff_fingerprint(sd, outputs: Tuple[str, ...]) -> str:
    """Plan identity of a SameDiff output set: the optimized
    ``GraphPlan.fingerprint`` when the optimizer is on, else the recording's
    node structure; joined with the variables' specs (name, shape, dtype)
    and :func:`dispatch_tokens`."""
    plan = sd._graph_plan(tuple(outputs))
    if plan is not None:
        plan_token = plan.fingerprint()
    else:
        plan_token = fingerprint_tokens(
            [(n.op, tuple(n.inputs),
              sorted((k, repr(v)) for k, v in n.kwargs.items()),
              tuple(n.outputs)) for n in sd._needed_nodes(tuple(outputs))],
            tuple(outputs))
    var_specs = sorted(
        (n, tuple(a.shape), str(a.dtype))
        for n, a in sd._arrays.items()
        if sd._vars[n].vtype != "CONSTANT")
    return fingerprint_tokens("samediff", plan_token, var_specs,
                              dispatch_tokens(sd.device))


def _sorted(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: d[k] for k in sorted(d)}


def export_exec(sd, feeds: Dict[str, Any], outputs,
                cache: Optional[ExportCache] = None) -> Optional[str]:
    """Export a SameDiff output set's whole-graph exec (a symbolic batch
    over the feeds; ``CompiledGraph.export``) and persist it; install the
    exported program as the live exec (see :func:`export_train_step` for
    why). Returns the entry path, or None without a cache."""
    from deeplearning4j_tpu_torch.autodiff.samediff import canonical

    outputs = tuple([outputs] if isinstance(outputs, str) else outputs)
    cache = cache or ExportCache.from_env()
    if cache is None:
        return None
    fn = sd._compiled_fn(outputs)
    var_arrays = _sorted(sd._var_arrays(fn._const_names))
    feed_arrays = _sorted({k: canonical(v, sd.device)
                           for k, v in feeds.items()})
    t0 = time.perf_counter()
    exported = fn.export(var_arrays, feed_arrays)
    cache.observe_export_seconds(time.perf_counter() - t0)
    ranges = {k: leading_range(exported, len(var_arrays) + i)
              for i, (k, v) in enumerate(feed_arrays.items()) if v.ndim}
    meta = {"graph": "samediff", "outputs": list(outputs),
            "feeds": {k: [list(v.shape[1:]), str(v.dtype)]
                      for k, v in feed_arrays.items()},
            "batch_ranges": ranges}
    path = cache.store(samediff_fingerprint(sd, outputs), "exec", exported,
                       meta=meta)
    install_exec(sd, exported, outputs, hit=False, meta=meta)
    return path


def _restored_run(sd, outputs, restored: Restored, meta: Dict[str, Any],
                  shim):
    """The runner the installed ``CompiledGraph`` calls: the restored
    program on feeds its export covers (names, trailing dims, dtypes and
    the settled batch ranges), else — permanently — the plain runner, the
    ledger markers cleared."""
    plain_run, _ = sd._exec_fn(outputs)
    const_env = plain_run.const_env
    state = {"plain": False}

    def covers(feeds) -> bool:
        """Whether the restored program serves ``feeds``; the first feed
        set it does not serve switches to the plain runner for good."""
        if state["plain"]:
            return False
        want = meta["feeds"]
        ok = set(feeds) == set(want)
        for k, v in feeds.items() if ok else ():
            dims, dtype = want[k]
            rng = meta["batch_ranges"].get(k)
            ok = ok and list(v.shape[1:]) == dims and str(v.dtype) == dtype \
                and (rng is None or _in_range(v.shape[0], rng))
        if not ok:
            state["plain"] = True
            shim._aot_restored = shim._aot_polymorphic = False
            observe.log_event("aot_fallback", consumer="samediff",
                              feeds={k: list(v.shape)
                                     for k, v in feeds.items()})
        return ok

    def run(var_arrays, feeds, consts=None):
        if covers(feeds):
            consts = consts if consts is not None else {
                k: v for k, v in const_env.items()
                if isinstance(v, torch.Tensor)}
            return restored(_sorted(var_arrays), _sorted(feeds),
                            _sorted(consts))
        return plain_run(var_arrays, feeds, consts)

    run.const_env = const_env
    run.covers = covers
    return run


def install_exec(sd, exported, outputs, *, hit: bool = True,
                 meta: Optional[Dict[str, Any]] = None):
    """Install an exported exec into ``sd._jit_cache`` so ``output()``
    runs it (on the card as a CUDA-graph capture, as the plain exec).
    Returns the installed ``CompiledGraph``."""
    from deeplearning4j_tpu_torch.autodiff.optimize import CompiledGraph

    outputs = tuple([outputs] if isinstance(outputs, str) else outputs)
    meta = dict(meta or {})
    plain = sd._compiled_fn(outputs)
    restored = restore_callable(exported, graph="samediff", key="exec",
                                hit=hit, polymorphic=True, meta=meta)
    shim = CompiledGraph(lambda *a: None, plain.stats, device=sd.device)
    shim._run = _restored_run(sd, outputs, restored, meta, shim)
    shim.aot_covers = shim._run.covers
    shim._const_names = plain._const_names
    shim.eager_reason = plain.eager_reason
    shim._aot_restored = restored._aot_restored
    shim._aot_polymorphic = True
    shim._obs_sigs = set(getattr(restored, "_obs_sigs", ()))
    shim.restored = restored
    sd._jit_cache[("compiled", outputs, bool(sd.optimize),
                   sd._effective_passes())] = shim
    return shim


def warm_boot_samediff(sd, outputs,
                       cache: Optional[ExportCache] = None) -> bool:
    """Restore a cached exec for ``(sd, outputs)`` if present. True on a
    restore — the next ``output()`` runs the restored program with only
    ``cache_hit`` ledger events."""
    outputs = tuple([outputs] if isinstance(outputs, str) else outputs)
    cache = cache or ExportCache.from_env()
    if cache is None:
        return False
    got = cache.load_entry(samediff_fingerprint(sd, outputs), "exec")
    if got is None:
        return False
    install_exec(sd, got[0], outputs, hit=True, meta=got[1])
    observe.log_event("aot_warm_boot", consumer="samediff",
                      outputs=list(outputs))
    return True

