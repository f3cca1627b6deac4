"""Engine warm boot from the persistent export cache.

Counterpart of ``deeplearning4j_tpu/serving/aot.py``. The serving engine's
steps (``prefill`` / ``write_prompt`` / ``decode`` and, when configured,
``suffix_prefill`` / ``verify`` plus the draft's ``draft_prefill`` /
``draft_decode``) have signatures that depend only on the engine's
configuration, so one export per (engine fingerprint, device kind, torch
version, operator schemas) serves every process with that configuration.
:func:`warm_boot` fills each unbuilt step slot before the first request:

* **hit** — the entry loads into a ``CapturedUnit`` around the restored
  program; the ledger records ``cache_hit``, the process traces nothing.
* **miss** — the step's core is exported through ``torch.export``, the
  entry stored, and the engine runs the program it just exported: the
  populating leg and every warm restore run one program.

What is exported is each step's *core* (``GenerativeEngine._prefill_core``
and its siblings): a function of the parameters, the cache and the staged
device buffer. Sampling draws from the engine's ``torch.Generator``, which
cannot enter an exported program: the draw stays in the unit, after the
core (the counterpart of the JAX raw-key adapters), so the token stream is
the non-exported engine's. Each process still captures its own CUDA graph
around the program on the card (``ops/capture.py``); the first call of a
unit captures, as without the cache.

The JAX table's ``copy_page`` slot has no counterpart: the port's cache
copies a prefix's partially filled tail page with one eager tensor copy
in ``PagedKVCache.cow_page``, outside any compiled step.

Activation: ``$DL4J_TPU_COMPILE_CACHE`` (:func:`maybe_warm_boot`, called
from ``GenerativeEngine.__init__`` and ``_recover``), or an explicit
:class:`~deeplearning4j_tpu_torch.autodiff.export.ExportCache` passed to
:func:`warm_boot` (tests).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.autodiff.export import (
    ENV_DIR, ExportCache, _tree_spec_tokens, dispatch_tokens, export_fn,
    fingerprint_tokens, restore_callable)


def engine_fingerprint(engine) -> str:
    """Identity of an engine's step family: the model configuration, the
    parameter tree's structure, the whole serving geometry (prompt and
    suffix buckets, page geometry, the prefix and speculative arms) and
    :func:`~deeplearning4j_tpu_torch.autodiff.export.dispatch_tokens`.
    Weight values are left out: the programs take the parameters as
    arguments."""
    cache = engine.cache
    toks: List[Any] = [
        "serving", repr(engine.cfg), _tree_spec_tokens(engine.model.params),
        engine.max_prompt, engine.suffix_bucket,
        cache.page_size, cache.num_pages, cache.max_slots,
        cache.max_pages_per_seq, tuple(cache.kv.shape),
        str(cache.kv.dtype), engine.prefix is not None,
        dispatch_tokens(engine.device),
    ]
    if engine.spec is not None:
        spec = engine.spec
        toks += ["spec", repr(spec.draft.cfg),
                 _tree_spec_tokens(spec.draft.params), spec.k,
                 tuple(spec.kv.shape), str(spec.kv.dtype)]
    return fingerprint_tokens(*toks)


def _fn_table(engine) -> List[Dict[str, Any]]:
    """One descriptor a warm-bootable step: the cache key, the live slot
    (owner and attribute), the core, the unit builder taking a core, and
    the core's example arguments — the live tensors themselves (shapes and
    dtypes are what export reads; the values are not touched)."""
    cfg, cache = engine.cfg, engine.cache
    params = engine.model.params
    kv_prompt = torch.empty(
        (cfg.layers, 2, engine.max_prompt, cfg.heads,
         cfg.hidden // cfg.heads), dtype=cache.kv.dtype, device=engine.device)
    table = [
        dict(key="prefill", owner=engine, attr="_prefill_fn",
             core=engine._prefill_core, build=engine._build_prefill,
             args=(params, engine._adm_dev)),
        dict(key="write_prompt", owner=engine, attr="_write_fn",
             core=engine._write_core, build=engine._build_write,
             args=(cache.kv, kv_prompt, engine._adm_dev)),
        dict(key="decode", owner=engine, attr="_decode_fn",
             core=engine._decode_core, build=engine._build_decode,
             args=(params, cache.kv, engine._dec_dev)),
    ]
    if engine.prefix is not None:
        table.append(dict(key="suffix_prefill", owner=engine,
                          attr="_suffix_fn", core=engine._suffix_core,
                          build=engine._build_suffix,
                          args=(params, cache.kv, engine._suf_dev)))
    if engine.spec is not None:
        spec = engine.spec
        table += [
            dict(key="verify", owner=engine, attr="_verify_fn",
                 core=engine._verify_core, build=engine._build_verify,
                 args=(params, cache.kv, engine._ver_dev)),
            dict(key="draft_prefill", owner=spec, attr="_prefill_fn",
                 core=spec._prefill_core, build=spec._build_prefill,
                 args=(spec.draft.params, spec.kv, spec._pre_dev)),
            dict(key="draft_decode", owner=spec, attr="_propose_fn",
                 core=spec._propose_core, build=spec._build_propose,
                 args=(spec.draft.params, spec.kv, spec._prop_dev)),
        ]
    return table


def warm_boot(engine, cache: Optional[ExportCache] = None) -> Dict[str, Any]:
    """Fill every unbuilt step slot from the export cache (hit) or by
    exporting and storing its core (miss). Slots already holding a unit
    are left alone — an in-process ``_recover`` keeps its units. Returns
    ``{"restored": [...], "exported": [...], "fingerprint": ...,
    "seconds": {key: export or load seconds}, "bytes": {key: entry
    size}}``."""
    cache = cache or ExportCache.from_env()
    out: Dict[str, Any] = {"restored": [], "exported": [],
                           "fingerprint": None, "seconds": {}, "bytes": {}}
    if cache is None:
        return out
    fp = out["fingerprint"] = engine_fingerprint(engine)
    for d in _fn_table(engine):
        if getattr(d["owner"], d["attr"]) is not None:
            continue
        t0 = time.perf_counter()
        exported = cache.load(fp, d["key"])
        hit = exported is not None
        if not hit:
            exported = export_fn(d["core"], d["args"])
            cache.observe_export_seconds(time.perf_counter() - t0)
            cache.store(fp, d["key"], exported, meta={"graph": "serving"})
        out["bytes"][d["key"]] = os.path.getsize(
            cache._path(cache.digest(fp, d["key"])))
        # the populating leg runs the program it just exported: it and
        # every warm restore run one program
        fn = restore_callable(exported, graph="serving", key=d["key"],
                              hit=hit)
        unit = d["build"](core=fn)
        unit._aot_restored = hit
        out["seconds"][d["key"]] = time.perf_counter() - t0
        setattr(d["owner"], d["attr"], unit)
        out["restored" if hit else "exported"].append(d["key"])
    if out["restored"] or out["exported"]:
        observe.log_event("aot_warm_boot", consumer="serving",
                          restored=out["restored"],
                          exported=out["exported"])
    return out


def maybe_warm_boot(engine) -> Dict[str, Any]:
    """Env-gated :func:`warm_boot` — inert unless
    ``$DL4J_TPU_COMPILE_CACHE`` is set, so default construction (tests,
    unconfigured deployments) pays nothing."""
    if not os.environ.get(ENV_DIR):
        return {"restored": [], "exported": [], "fingerprint": None,
                "seconds": {}, "bytes": {}}
    return warm_boot(engine)
