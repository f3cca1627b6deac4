"""Measured dispatch: the tuning table and the autotuner of the port.

Counterpart of ``deeplearning4j_tpu/ops/tuning.py``. The registry picks a
kernel by the tensors' platform behind each op's ``usable`` gate
(``ops/registry.py``); the right unit for the choice between a kernel and
its generic is *(device kind, op, shape)*. This module owns

* the **tuning table**: a JSON document keyed on device kind holding, per
  op, kernel-vs-generic crossover thresholds and per-shape-bucket block
  sizes, in the JAX package's schema and bucket labels, so a table reads
  alike in both packages (and one the JAX package wrote loads here). The
  checked-in ``ops/tuning_tables/default.json`` holds no TPU figure: its
  crossovers are 0, every call a gate passes takes the kernel. A table
  for one card, written by :func:`autotune` on it and checked in as
  ``ops/tuning_tables/<device kind>.json``, overlays it on that card, and
  a measured table in the cache directory (``DL4J_TPU_TUNING_DIR``,
  default ``build/tuning/`` of the checkout) overlays both.
* the **autotuner** (:func:`autotune`): times each op's CUDA kernel
  against the op's registered generic at a ladder of shapes — device time
  from CUDA events around replays of a CUDA graph that holds the calls
  (:func:`aot_time`) — and writes the crossover (:func:`_crossover`).
* the **dispatch feed**: the gates of ``cuda_attention`` (``flash_min_t``,
  ``min_pages``), ``cuda_matmul`` and ``cuda_quantized``
  (``pallas_min_m``), ``cuda_layernorm`` (``min_rows``) and
  ``cuda_updater`` (``min_size``) read :func:`tuned`; the convbn kernel
  reads its tile width with :func:`tuned_block`. A call a crossover sends
  to the generic makes its gate return :data:`CROSSOVER` (falsy), which
  the registry counts in ``dl4j_tpu_helper_dispatch_total`` under the
  reason ``"crossover"``: a measured dispatch, not a fallback.

Schema (one document per device kind; ``measured_on`` is the port's, read
by nothing and ignored by the JAX package)::

    {"schema": "dl4j_tpu_tuning_v1",
     "device_kind": "nvidia_h100_80gb_hbm3",
     "measured_on": {"nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W", ...},
     "entries": {
       "dot_product_attention": {"flash_min_t": 16},
       "fused_bn_matmul_stats": {
         "blocks": {"m4096_k256_n256": {"block_n": 128}}},
       ...}}
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

SCHEMA = "dl4j_tpu_tuning_v1"
ENV_DIR = "DL4J_TPU_TUNING_DIR"

_PACKAGE_TABLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tuning_tables")
# the checkout's build/ (where ops/_build.py puts the kernels)
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "tuning")

# memoized per-device-kind merged tables, device kinds per CUDA device
# index, once-only warnings for corrupt files; reset_tables() drops them
_ACTIVE: Dict[str, "TuningTable"] = {}
_KINDS: Dict[int, str] = {}
_WARNED_PATHS: set = set()
_RESET_CALLBACKS: List[Callable[[], None]] = []


class _Crossover:
    """A gate's verdict for a call its kernel could take but a measured
    crossover sends to the generic: falsy, counted by the registry under
    the reason ``"crossover"``."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "CROSSOVER"


CROSSOVER = _Crossover()


# ---------------------------------------------------------------------------
# keys: device kinds and shape buckets
# ---------------------------------------------------------------------------


def normalize_device_kind(kind: str) -> str:
    """``'NVIDIA H100 80GB HBM3'`` -> ``'nvidia_h100_80gb_hbm3'`` —
    filesystem- and JSON-safe."""
    return re.sub(r"[^a-z0-9]+", "_", str(kind).strip().lower()).strip("_") \
        or "unknown"


def current_device_kind() -> str:
    """Device kind of the current CUDA device
    (``torch.cuda.get_device_name``), memoized per device index; ``"cpu"``
    on a host without one. The gates read the table only for CUDA
    tensors, so on the card this is the card's kind."""
    if not torch.cuda.is_available():
        return "cpu"
    index = torch.cuda.current_device()
    kind = _KINDS.get(index)
    if kind is None:
        kind = _KINDS[index] = normalize_device_kind(
            torch.cuda.get_device_name(index))
    return kind


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1) — the shape-bucket unit."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    return p


def bucket_t(t: int) -> str:
    """Sequence-length bucket for attention-shaped ops."""
    return f"t{pow2_bucket(t)}"


def bucket_mkn(m: int, k: int, n: int) -> str:
    """(M, K, N) bucket for matmul-shaped ops."""
    return f"m{pow2_bucket(m)}_k{pow2_bucket(k)}_n{pow2_bucket(n)}"


def bucket_rows(rows: int) -> str:
    """Row-count bucket for row-parallel kernels (LayerNorm, the updater)."""
    return f"r{pow2_bucket(rows)}"


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuningTable:
    """One device kind's measured dispatch configuration."""

    device_kind: str
    entries: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    source: str = ""
    # where the table was measured (card name and power limit); written
    # only when set
    measured_on: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- reads ---------------------------------------------------------------
    def get(self, op: str, key: str, default: Any = None) -> Any:
        return self.entries.get(op, {}).get(key, default)

    def get_block(self, op: str, bucket: str, key: str,
                  default: Any = None) -> Any:
        return self.entries.get(op, {}).get("blocks", {}) \
            .get(bucket, {}).get(key, default)

    # -- writes --------------------------------------------------------------
    def set(self, op: str, key: str, value: Any) -> None:
        self.entries.setdefault(op, {})[key] = value

    def set_block(self, op: str, bucket: str, key: str, value: Any) -> None:
        self.entries.setdefault(op, {}).setdefault("blocks", {}) \
            .setdefault(bucket, {})[key] = value

    def merge(self, other: "TuningTable") -> None:
        """Overlay ``other`` onto this table (other wins; blocks deep-merge
        per bucket)."""
        for op, entry in other.entries.items():
            mine = self.entries.setdefault(op, {})
            for key, val in entry.items():
                if key == "blocks":
                    blocks = mine.setdefault("blocks", {})
                    for bucket, cfg in val.items():
                        blocks.setdefault(bucket, {}).update(cfg)
                else:
                    mine[key] = val
        if other.measured_on:
            self.measured_on = dict(other.measured_on)

    # -- serde ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {"schema": SCHEMA, "device_kind": self.device_kind,
             "entries": self.entries}
        if self.measured_on:
            d["measured_on"] = self.measured_on
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TuningTable":
        if not isinstance(d, dict) or d.get("schema") != SCHEMA:
            raise ValueError(
                f"not a {SCHEMA} document (schema={d.get('schema') if isinstance(d, dict) else type(d).__name__!r})")
        entries = d.get("entries")
        if not isinstance(entries, dict) or not all(
                isinstance(v, dict) for v in entries.values()):
            raise ValueError("tuning table 'entries' must map op -> dict")
        for op_name, entry in entries.items():
            # a malformed blocks value is refused here, so it lands in the
            # corrupt-table warn-once path instead of failing every read
            if "blocks" in entry:
                blocks = entry["blocks"]
                if not isinstance(blocks, dict) or not all(
                        isinstance(cfg, dict) for cfg in blocks.values()):
                    raise ValueError(
                        f"tuning table entry '{op_name}': 'blocks' must "
                        f"map bucket -> dict")
        measured_on = d.get("measured_on") or {}
        if not isinstance(measured_on, dict):
            raise ValueError("tuning table 'measured_on' must be a dict")
        return TuningTable(device_kind=str(d.get("device_kind", "unknown")),
                           entries=entries, measured_on=measured_on)

    @staticmethod
    def load(path: str) -> "TuningTable":
        with open(path) as f:
            table = TuningTable.from_dict(json.load(f))
        table.source = path
        return table

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: a concurrent reader never sees half
        return path


# ---------------------------------------------------------------------------
# loading: checked-in tables, then the measured cache overlay
# ---------------------------------------------------------------------------


def tuning_dir() -> str:
    return os.environ.get(ENV_DIR) or _DEFAULT_CACHE_DIR


def cache_path(device_kind: Optional[str] = None) -> str:
    kind = device_kind or current_device_kind()
    return os.path.join(tuning_dir(), f"{kind}.json")


def default_table_paths(device_kind: str) -> List[str]:
    """Checked-in tables: ``default.json`` always, the device kind's own
    on top when one was measured on such a card and committed."""
    paths = [os.path.join(_PACKAGE_TABLE_DIR, "default.json")]
    per_kind = os.path.join(_PACKAGE_TABLE_DIR, f"{device_kind}.json")
    if os.path.exists(per_kind):
        paths.append(per_kind)
    return paths


def _load_or_warn(table: TuningTable, path: str) -> None:
    if not os.path.exists(path):
        return
    try:
        table.merge(TuningTable.load(path))
    except (ValueError, TypeError, AttributeError, OSError,
            json.JSONDecodeError) as e:
        # a corrupt measured table: the checked-in ones stand, dispatch
        # stays deterministic. Warn once per path.
        if path not in _WARNED_PATHS:
            _WARNED_PATHS.add(path)
            logger.warning("ignoring corrupt tuning table %s: %s", path, e)


def active_table(device_kind: Optional[str] = None) -> TuningTable:
    """The merged (checked-in ⊕ measured) table for a device kind,
    memoized."""
    kind = device_kind or current_device_kind()
    cached = _ACTIVE.get(kind)
    if cached is not None:
        return cached
    table = TuningTable(device_kind=kind)
    for path in default_table_paths(kind):
        _load_or_warn(table, path)
    _load_or_warn(table, cache_path(kind))
    _ACTIVE[kind] = table
    return table


def tuned(op: str, key: str, default: Any = None,
          bucket: Optional[str] = None) -> Any:
    """One measured value: the shape-bucket entry when present, else the
    op-level entry, else ``default``. The read every gate uses."""
    table = active_table()
    if bucket is not None:
        v = table.get_block(op, bucket, key)
        if v is not None:
            return v
    return table.get(op, key, default)


def tuned_block(op: str, key: str, size: int, bucket: str,
                fallback: Callable[[int], int]) -> int:
    """A measured block size, validated against the actual dimension — a
    tuned block that does not divide ``size`` falls back (tables describe
    buckets; a ragged real shape inside the bucket may not divide)."""
    v = tuned(op, key, None, bucket=bucket)
    if v:
        v = int(v)
        if size % v == 0:
            return v
    return fallback(size)


def crossover(op: str, key: str, size: int):
    """The verdict of a gate whose other checks passed: :data:`CROSSOVER`
    where ``size`` lies under the op's measured crossover ``key``
    (default 0: nothing does), else True."""
    return CROSSOVER if size < int(tuned(op, key, 0)) else True


def on_reset(cb: Callable[[], None]) -> None:
    """Register a cache-invalidation hook run by :func:`reset_tables`."""
    _RESET_CALLBACKS.append(cb)


def reset_tables() -> None:
    """Drop memoized tables (test seam; called after autotune() saves)."""
    _ACTIVE.clear()
    _KINDS.clear()
    _WARNED_PATHS.clear()
    for cb in _RESET_CALLBACKS:
        cb()


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _on_card(fn: Callable, args: Sequence[Any], iters: int):
    """``fn(*args)`` three times on a side stream (the warm-up, off the
    capture), then ``iters`` calls captured in one CUDA graph, replayed
    once: the graph."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize(dev)
    return graph


def _replay_seconds(graph, calls: int, reps: int) -> float:
    """Seconds per call of ``reps`` replays of ``graph`` (``calls``
    calls each) between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / (calls * reps)


def _is_card(args: Sequence[Any]) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


def aot_time(fn: Callable, args: Sequence[Any], iters: int = 20,
             reps: int = 5) -> float:
    """Seconds per call of ``fn(*args)``.

    On the card: three warm-up calls on a side stream, ``iters`` calls
    captured in one CUDA graph, the graph replayed ``reps`` times between
    two CUDA events, the mean per call — the kernels' device time, with no
    Python or allocation between launches (the JAX package times an AOT
    compile; chip_smoke times kernels this way). On the CPU, where a
    caller asked for it, the host clock around one call after a warm one:
    a run of the code path, not a device measurement."""
    with torch.no_grad():
        if not _is_card(args):
            fn(*args)
            t0 = time.perf_counter()
            fn(*args)
            return time.perf_counter() - t0
        graph = _on_card(fn, args, iters)
        sec = _replay_seconds(graph, iters, reps)
        del graph
        return sec


def _crossover(ladder: Sequence[int], kernel_s: Dict[int, float],
               generic_s: Dict[int, float],
               spread_s: Optional[Dict[int, float]] = None) -> int:
    """Smallest ladder point where the kernel wins; points are scanned in
    order and the first win is sticky. If the kernel never wins, the
    threshold lands at 2× the largest measured point.

    ``spread_s``: each point's spread of repeated readings. The generic
    wins a point only by more than its spread; a tie keeps the kernel,
    the route every eligible call takes without a table, so a reading
    inside the noise moves no call."""
    for t in sorted(ladder):
        spread = spread_s[t] if spread_s else 0.0
        if kernel_s[t] <= generic_s[t] + spread:
            return t
    return 2 * max(ladder)


@dataclasses.dataclass
class TuneReport:
    """What one autotune() pass measured. ``timings``: op -> shape label
    -> {"kernel_ms", "generic_ms", "spread_ms", "readings"} for every
    point timed (also the shapes the table cannot route, ROADMAP Queue 1
    item 12): the medians of ``readings`` interleaved readings of each
    and the larger of the two readings' ranges."""

    device_kind: str
    ops: List[str] = dataclasses.field(default_factory=list)
    measurements: int = 0
    seconds: float = 0.0
    table_path: Optional[str] = None
    timings: Dict[str, Dict[str, Dict[str, float]]] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _span(op: str):
    from deeplearning4j_tpu_torch import observe

    observe.metrics().counter("dl4j_tpu_tuning_runs_total", op=op).inc()
    return observe.tracer().span(f"tuning_{op}", category="tuning")


READINGS = 7  # readings of each function at each point (medians, spread)


class _Timer:
    """Times functions at one point, each ``READINGS`` times with the
    readings interleaved (a clock or power drift falls on every function
    alike), and records the medians and the spread in the report."""

    def __init__(self, report: TuneReport, op: str):
        self.report, self.op = report, op
        self.n = 0

    def readings(self, fns: Sequence[Callable], args: Sequence[Any],
                 iters: int = 20, reps: int = 5) -> List[List[float]]:
        """Seconds per call, ``READINGS`` readings of each of ``fns``."""
        out: List[List[float]] = [[] for _ in fns]
        with torch.no_grad():
            if not _is_card(args):
                for _ in range(READINGS):
                    for i, fn in enumerate(fns):
                        out[i].append(aot_time(fn, args))
                return out
            graphs = [_on_card(fn, args, iters) for fn in fns]
            for _ in range(READINGS):
                for i, g in enumerate(graphs):
                    out[i].append(_replay_seconds(g, iters, reps))
            del graphs
        return out

    def record(self, label: str, **times: List[float]) -> Dict[str, float]:
        """Medians (``<name>_ms``) and the larger of the ranges
        (``spread_ms``) of ``times``' readings, kept in the report."""
        entry = {f"{k}_ms": float(np.median(v)) * 1e3
                 for k, v in times.items()}
        entry["spread_ms"] = max(max(v) - min(v)
                                 for v in times.values()) * 1e3
        entry["readings"] = READINGS
        self.n += len(times)
        self.report.timings.setdefault(self.op, {})[label] = entry
        return entry

    def pair(self, label: str, kernel: Callable, generic: Callable,
             args: Sequence[Any]) -> Tuple[float, float, float]:
        """(kernel, generic, spread) seconds at one point."""
        k, g = self.readings((kernel, generic), args)
        e = self.record(label, kernel=k, generic=g)
        return (e["kernel_ms"] / 1e3, e["generic_ms"] / 1e3,
                e["spread_ms"] / 1e3)


def _rand(r: np.random.RandomState, shape, dev, scale: float = 1.0,
          dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32)) \
        .to(device=dev, dtype=dtype)


def _generic(op: str) -> Callable:
    from deeplearning4j_tpu_torch.ops.registry import registry

    return registry().get(op).fn


# -- per-op tuners -----------------------------------------------------------


def _tune_attention(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca

    op = "dot_product_attention"
    generic = _generic(op)
    ladder = (32, 64) if smoke else (16, 32, 64, 128, 256, 512, 1024, 2048)
    b, h, d = (1, 2, 8) if smoke else (8, 12, 64)
    r = np.random.RandomState(0)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}
    with _span(op):
        for t in ladder:
            q = _rand(r, (b, h, t, d), dev)
            k_s[t], g_s[t], sp[t] = timer.pair(
                f"b{b}_h{h}_t{t}_d{d}", lambda q: ca.flash_dpa(q, q, q),
                lambda q: generic(q, q, q), (q,))
        table.set(op, "flash_min_t", _crossover(ladder, k_s, g_s, sp))
        if not smoke:
            # float32 at a head dim the tensor-core forward refuses (the
            # CUDA-core kernel): timed, not routable by flash_min_t
            q = _rand(r, (32, 12, 128, 192), dev)
            timer.pair("b32_h12_t128_d192", lambda q: ca.flash_dpa(q, q, q),
                       lambda q: generic(q, q, q), (q,))
    return timer.n


def _tune_fused_matmul(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm

    op = "fused_matmul_bias_act"
    generic = _generic(op)
    ladder = (16, 32) if smoke else (16, 64, 256, 1024, 4096)
    k_dim, n_dim = (64, 64) if smoke else (768, 768)
    r = np.random.RandomState(1)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}

    def kern(x, w, b):
        return cm.fused_matmul(x, w, b, activation="gelu")

    def gen(x, w, b):
        return generic(x, w, b, activation="gelu")

    with _span(op):
        w = _rand(r, (k_dim, n_dim), dev, k_dim ** -0.5)
        b = _rand(r, (n_dim,), dev)
        for m in ladder:
            x = _rand(r, (m, k_dim), dev)
            k_s[m], g_s[m], sp[m] = timer.pair(
                f"m{m}_k{k_dim}_n{n_dim}", kern, gen, (x, w, b))
        table.set(op, "pallas_min_m", _crossover(ladder, k_s, g_s, sp))
        if not smoke:
            # K % 4 != 0 (the CUDA-core SGEMM) and bfloat16 (the sm90
            # kernel autocast reaches, over the same M ladder and at
            # BERT's other two shapes): timed, not routable by M — the
            # float32 pallas_min_m governs 16-bit calls too
            x = _rand(r, (4096, 770), dev)
            w770 = _rand(r, (770, 768), dev, 770 ** -0.5)
            timer.pair("m4096_k770_n768", kern, gen, (x, w770, b))
            shapes = [(m, 768, 768) for m in ladder] + [
                (4096, 768, 3072), (4096, 3072, 768)]
            for m, kk, nn in shapes:
                x = _rand(r, (m, kk), dev, dtype=torch.bfloat16)
                wb = _rand(r, (kk, nn), dev, kk ** -0.5, torch.bfloat16)
                timer.pair(f"m{m}_k{kk}_n{nn}_bfloat16", kern, gen,
                           (x, wb, _rand(r, (nn,), dev)))
    return timer.n


def _tune_layernorm(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl

    op = "fused_layer_norm"
    generic = _generic(op)
    ladder = (16, 32) if smoke else (16, 64, 256, 1024, 4096)
    d = 128 if smoke else 768
    r = np.random.RandomState(2)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}
    with _span(op):
        g = torch.from_numpy(r.rand(d).astype(np.float32) + 0.5).to(dev)
        b = _rand(r, (d,), dev)
        for rows in ladder:
            x = _rand(r, (rows, d), dev)
            k_s[rows], g_s[rows], sp[rows] = timer.pair(
                f"r{rows}_d{d}",
                lambda x, g, b: cl.fused_layer_norm_kernel(
                    x, g, b, activation="gelu"),
                lambda x, g, b: generic(x, g, b, activation="gelu"),
                (x, g, b))
        table.set(op, "min_rows", _crossover(ladder, k_s, g_s, sp))
    return timer.n


def _tune_updater(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    op = "fused_updater_step"
    generic = _generic(op)
    ladder = (1024,) if smoke else (1, 1 << 10, 1 << 16, 1 << 20)
    r = np.random.RandomState(3)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}
    with _span(op):
        lr = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        step = torch.full((), 1.0, dtype=torch.float32, device=dev)
        for size in ladder:
            p = _rand(r, (size,), dev)
            g = _rand(r, (size,), dev, 0.01)
            z = torch.zeros((size,), dtype=torch.float32, device=dev)
            k_s[size], g_s[size], sp[size] = timer.pair(
                f"n{size}_adam",
                lambda *a: cu.fused_updater(*a, kind="Adam"),
                lambda *a: generic(*a, kind="Adam"), (p, g, lr, step, z, z))
        table.set(op, "min_size", _crossover(ladder, k_s, g_s, sp))
    return timer.n


def _tune_int8(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops.registry import registry

    op = "matmul_int8"
    generic = _generic(op)
    quantize = registry().get("quantize_int8").fn
    ladder = (32, 64) if smoke else (16, 64, 256, 1024, 4096)
    k_dim, n_dim = (128, 128) if smoke else (768, 768)
    r = np.random.RandomState(4)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}
    with _span(op):
        wq, ws = quantize(_rand(r, (k_dim, n_dim), dev, k_dim ** -0.5),
                          axis=0)
        for m in ladder:
            x = _rand(r, (m, k_dim), dev)
            k_s[m], g_s[m], sp[m] = timer.pair(f"m{m}_k{k_dim}_n{n_dim}",
                                        cq.matmul_int8, generic, (x, wq, ws))
        table.set(op, "pallas_min_m", _crossover(ladder, k_s, g_s, sp))
    return timer.n


def _tune_paged_decode(table: TuningTable, smoke: bool, dev, report) -> int:
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca

    op = "paged_decode_attention"
    generic = _generic(op)
    ladder = (2, 4) if smoke else (1, 4, 16, 64)
    s_n, h, d, page = (2, 2, 8, 8) if smoke else (8, 12, 64, 16)
    r = np.random.RandomState(5)
    timer = _Timer(report, op)
    k_s: Dict[int, float] = {}
    g_s: Dict[int, float] = {}
    sp: Dict[int, float] = {}
    with _span(op):
        for max_pages in ladder:
            n_pages = max_pages * s_n + 1
            q = _rand(r, (s_n, h, d), dev)
            kp = _rand(r, (n_pages, page, h, d), dev)
            pt = torch.from_numpy(r.randint(0, n_pages, (s_n, max_pages))
                                  .astype(np.int32)).to(dev)
            sl = torch.full((s_n,), max_pages * page, dtype=torch.int32,
                            device=dev)
            k_s[max_pages], g_s[max_pages], sp[max_pages] = timer.pair(
                f"s{s_n}_pages{max_pages}_page{page}_h{h}_d{d}",
                ca.paged_decode_attention, generic, (q, kp, kp, pt, sl))
        table.set(op, "min_pages", _crossover(ladder, k_s, g_s, sp))
    return timer.n


def _tune_convbn(table: TuningTable, smoke: bool, dev, report) -> int:
    """The convbn kernel's tile width ``block_n`` (64 or 128) per (M, K, N)
    bucket; there is no crossover to measure (the JAX package's tuner
    writes only blocks here)."""
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc

    op = "fused_bn_matmul_stats"
    # ResNet-50's 1x1 convolutions at batch 128 (train_fused): stages 1-4
    shapes = ((128, 64, 128),) if smoke else \
        ((401408, 64, 256), (100352, 512, 128), (25088, 1024, 256),
         (6272, 2048, 512))
    r = np.random.RandomState(6)
    timer = _Timer(report, op)
    sms = cc.sm_count(dev.index or 0) if dev.type == "cuda" else 132
    with _span(op):
        for m, k, n in shapes:
            x = _rand(r, (m, k), dev, dtype=torch.bfloat16)
            sc = torch.from_numpy(r.rand(k).astype(np.float32) + 0.5).to(dev)
            sh = _rand(r, (k,), dev, 0.1)
            w = _rand(r, (k, n), dev, k ** -0.5, torch.bfloat16)
            ss = _rand(r, (n,), dev, 0.1)
            widths = [bn for bn in cc.TILE_N if n % bn == 0]
            if not widths:
                continue
            readings = timer.readings(
                [lambda *a, _bn=bn: cc.bn_matmul_stats(*a, block_n=_bn)
                 for bn in widths], (x, sc, sh, w, ss))
            e = timer.record(f"m{m}_k{k}_n{n}", **{
                f"bn{bn}": v for bn, v in zip(widths, readings)})
            # the fastest width, where it beats the width picked without
            # a table by more than the spread; else that pick
            best = min(widths, key=lambda bn: e[f"bn{bn}_ms"])
            pick = cc.convbn_tile_n(m, n, sms)
            if pick in widths and (e[f"bn{pick}_ms"] - e[f"bn{best}_ms"]
                                   <= e["spread_ms"]):
                best = pick
            table.set_block(op, bucket_mkn(m, k, n), "block_n", best)
    return timer.n


_TUNERS: Tuple[Tuple[str, Callable[..., int]], ...] = (
    ("dot_product_attention", _tune_attention),
    ("fused_matmul_bias_act", _tune_fused_matmul),
    ("fused_layer_norm", _tune_layernorm),
    ("fused_updater_step", _tune_updater),
    ("matmul_int8", _tune_int8),
    ("paged_decode_attention", _tune_paged_decode),
    ("fused_bn_matmul_stats", _tune_convbn),
)


def card_name_and_power() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card (the
    line the port writes beside every measurement), None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def autotune(ops: Optional[Sequence[str]] = None, smoke: bool = False,
             save: bool = True, device_kind: Optional[str] = None,
             device=None) -> Tuple[TuningTable, TuneReport]:
    """Time each op's kernel against its generic and build a tuning table.

    ``device``: where to measure (the card unless the caller asks for the
    CPU, where each wrapper runs its plain version: a run of the code
    path, not a measurement). ``smoke`` shrinks every ladder to tiny
    shapes. ``save`` merges the table onto the cache directory's table
    for the device kind (an ``ops`` subset refreshes only what it
    measured) and invalidates the memoized readers, so the measurement is
    live in the same process. The card's name and power limit are kept
    in ``measured_on``."""
    from deeplearning4j_tpu_torch.environment import resolve_device
    from deeplearning4j_tpu_torch.ops import _build

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kind = device_kind or current_device_kind()
        measured_on = {"device_name": torch.cuda.get_device_name(dev),
                       "nvidia_smi": card_name_and_power(),
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda, "smoke": smoke}
        _build.build()
    else:
        kind = device_kind or "cpu"
        measured_on = {"device_name": "cpu", "smoke": smoke}
    table = TuningTable(device_kind=kind, measured_on=measured_on)
    report = TuneReport(device_kind=kind)
    t0 = time.perf_counter()
    wanted = set(ops) if ops else None
    for name, tuner in _TUNERS:
        if wanted is not None and name not in wanted:
            continue
        report.measurements += tuner(table, smoke, dev, report)
        report.ops.append(name)
    report.seconds = round(time.perf_counter() - t0, 3)
    if save:
        merged = TuningTable(device_kind=kind)
        _load_or_warn(merged, cache_path(kind))
        merged.merge(table)
        report.table_path = merged.save(cache_path(kind))
        reset_tables()
    return table, report

