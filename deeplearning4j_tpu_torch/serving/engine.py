"""Generative serving engine — prefill/decode dispatch over the paged cache.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` without its
``key_trail`` audit. With ``$DL4J_TPU_COMPILE_CACHE`` set, the
constructor and ``_recover`` warm-boot the steps from the export cache
(``serving/aot.py``). Three compiled step functions — the JAX engine jits
them, the port runs each as a
:class:`~deeplearning4j_tpu_torch.ops.capture.CapturedUnit`, a CUDA-graph
capture on the card (eager on the CPU, and under ``disable_capture()``):

* **prefill** — the whole prompt, bucketed at ``max_prompt``, through one
  causal ``gpt_prefill`` pass (the CUDA flash kernel on the card), the last
  prompt position's logits gathered by index, and first-token sampling.
  TTFT is measured across it.
* **write-prompt** — scatter the prefill K/V into the slot's pages, in
  place; prompt-pad positions land on the trash page.
* **decode** — one token for EVERY slot (inactive slots ride along masked:
  they write to the trash page and their outputs are ignored), paged
  attention through the registry's ``paged_decode_attention`` (the CUDA
  paged kernel on the card), then the temperature/top-k/top-p sampler.

With ``prefix_pages > 0`` a fourth joins them — **suffix-prefill**: on a
radix-prefix-cache hit (``serving/prefix.py``) the shared pages are mapped
into the slot's page-table row by reference (the partially filled tail
page copied first) and only the prompt's uncached tail, padded to the
static ``suffix_bucket``, is prefilled against the cached prefix K/V
(:func:`~deeplearning4j_tpu_torch.models.gpt.gpt_prefill_suffix`).

With ``spec_k > 0`` and a ``draft_model`` a fifth joins — **verify**
(:func:`~deeplearning4j_tpu_torch.models.gpt.gpt_verify`): each step,
greedy slots run K draft decode steps (``serving/speculative.py``, one
captured ``draft_decode`` unit over a dense per-slot draft cache) to
propose K tokens, then ONE target forward over the ``K + 1``-token window
scores them; the agreed prefix plus the target's correction or bonus token
commits — 1..K+1 tokens a step, the plain greedy stream as long as verify
and decode agree on the argmax. A rejection REWINDS the slot's cached
length (and the draft's) instead of freeing pages. Sampling slots and
``spec_disabled`` requests take the plain decode step. Suffix-prefill and
verify attend under a dense mask the flash gate refuses by shape, as the
JAX gate does: the registry's generic attention runs them on the card.

Their signatures depend only on the engine's configuration (slots, page
geometry, prompt and suffix buckets, ``spec_k``), so the recompile ledger
records one ``first_compile`` each (graph ``"serving"``, keys
``"prefill"``, ``"write_prompt"``, ``"decode"``, ``"suffix_prefill"``,
``"verify"``, ``"draft_prefill"``, ``"draft_decode"``) and no ``new_shape``
across admissions, evictions, rollbacks and restarts. Each is captured at
its first use. The host state a step reads — the prompt, its length and
sampling knobs, the slot's page-table row; for decode the page table,
lengths, fed tokens, active flags and knobs of every slot — is packed into one pinned host buffer and copied to
the device in one transfer into the static buffers the graphs read. The
cache is one preallocated tensor written in place (never reallocated: the
graphs address it), as are the model's parameters: change those in place.
The engine's ``torch.Generator`` is registered with the prefill,
suffix-prefill and decode graphs.

**Supervision** (``supervise=True``, the default, as in the JAX
package): an exception in a step, or the worker thread's death, does not
kill the engine. :meth:`GenerativeEngine._recover` frees every slot,
puts the requests with retries left back at the front of the queue
(their original submit time: deadlines keep counting), finishes the
others as ``error``, zeroes the KV pool in place
(:meth:`PagedKVCache.reset_kv`: the captured steps keep their buffers, so
a restart captures nothing again and the ledger records no
``new_shape``), backs off (doubling from ``restart_backoff_s``, capped at
``max_backoff_s``) and hands the loop to a replacement thread, up to
``max_restarts`` times. Past that budget, or with ``supervise=False``, an
exception fails every outstanding request and leaves the engine dead
(the unsupervised path). Recovery also drops the prefix tree (its pages
were zeroed) and the draft state. Recovery handles host-side exceptions; a
real CUDA fault leaves the context unusable and cannot be recovered in the
process. Inside a :class:`~deeplearning4j_tpu_torch.serving.cluster.
ClusterRouter` an engine that dies for good (``engine_death``, or the
restart budget spent) first hands its requests to the router's
``on_unrecoverable`` hook, which migrates them to a survivor
(:meth:`GenerativeEngine.adopt_requests`). The fault points
``decode_step_error``, ``slow_decode``, ``worker_death``, ``engine_death``
and the cache's ``page_oom`` exercise these paths. Per-request deadlines, the bounded queue (``max_queue`` sheds
as ``shed``), capacity evictions (``overflow``/``oom``) and priority
admission are kept.

Observability: admitted/evicted/generated-token counters, restart and
retry counters, slot-occupancy and stopped-cleanly gauges, decode-step,
TTFT and inter-token histograms, the ``serving_prefill``/``serving_decode``
spans, the ledger notes and the ``engine_restart``, ``engine_dead`` and
``serving_terminal`` events.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.models.gpt import (
    GptModel, gpt_decode_step, gpt_prefill, gpt_prefill_suffix, gpt_verify)
from deeplearning4j_tpu_torch.ops.capture import CapturedUnit
from deeplearning4j_tpu_torch.serving.cache import PagedKVCache
from deeplearning4j_tpu_torch.serving.prefix import (
    PrefixMatch, RadixPrefixCache)
from deeplearning4j_tpu_torch.serving.sampling import sample_tokens
from deeplearning4j_tpu_torch.serving.speculative import SpeculativeDecoder
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationRequest, GenerationResult, SlotScheduler, count_terminal)

logger = logging.getLogger(__name__)


class GenerativeEngine:
    """Continuous-batching text generation over a ``GptModel``.

    Synchronous use (tests, batch jobs)::

        eng = GenerativeEngine(model, max_slots=4)
        results = eng.generate([prompt1, prompt2], max_new_tokens=32)

    Serving use::

        eng.start()
        fut = eng.submit(prompt, temperature=0.8, top_p=0.95)
        result = fut.result()
        eng.stop()

    ``device`` (default: the environment's, ``"cuda"``) must be where the
    model's parameters live; a host without a GPU raises unless the caller
    asks for ``"cpu"``.
    """

    def __init__(self, model: GptModel, *, max_slots: int = 4,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_pages_per_seq: int = 8, max_prompt: int = 32,
                 seed: int = 0, supervise: bool = True,
                 max_restarts: int = 3, restart_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 prefix_pages: int = 0,
                 suffix_bucket: Optional[int] = None,
                 prefix_min_match: Optional[int] = None,
                 spec_k: int = 0,
                 draft_model: Optional[GptModel] = None,
                 engine_id: int = 0,
                 device: Union[str, torch.device, None] = None):
        cfg = model.cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model parameters live on {model.device}, the "
                             f"engine runs on {self.device}")
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must be divisible by heads")
        if max_prompt > cfg.max_position:
            raise ValueError(
                f"max_prompt={max_prompt} exceeds the model's "
                f"max_position={cfg.max_position}")
        self.model = model
        self.cfg = cfg
        self.max_prompt = int(max_prompt)
        if num_pages is None:
            # full reservation; a prefix cache gets its page budget on top
            # so the tree never starves the slot bank by default
            num_pages = max_slots * max_pages_per_seq + max(0, prefix_pages)
        self.cache = PagedKVCache(
            layers=cfg.layers, heads=cfg.heads,
            head_dim=cfg.hidden // cfg.heads, page_size=page_size,
            num_pages=num_pages, max_slots=max_slots,
            max_pages_per_seq=max_pages_per_seq, dtype=model.dtype,
            device=self.device)
        if self.max_prompt + 1 > self.cache.max_context():
            raise ValueError(
                f"max_prompt={max_prompt} + 1 exceeds per-slot context "
                f"{self.cache.max_context()} (page_size*max_pages_per_seq)")
        self.scheduler = SlotScheduler(max_slots)
        # radix prefix cache: suffix_bucket is the captured suffix-prefill
        # width — a hit whose uncached tail exceeds it takes the full
        # prefill (static shapes: no new_shape)
        self.prefix: Optional[RadixPrefixCache] = None
        self.suffix_bucket = min(self.max_prompt,
                                 int(suffix_bucket) if suffix_bucket
                                 else 2 * self.cache.page_size)
        if prefix_pages:
            self.prefix = RadixPrefixCache(
                self.cache, max_pages=int(prefix_pages),
                min_match=prefix_min_match)
        # speculative decoding: greedy slots propose K draft tokens a step
        # and commit 1..K+1 after one verify pass; off by default
        self.spec: Optional[SpeculativeDecoder] = None
        self._spec_slots: set = set()
        self._spec_limit = 0
        if spec_k:
            if draft_model is None:
                raise ValueError("spec_k > 0 requires a draft_model "
                                 "(models.GPT(...).init_draft() builds the "
                                 "paired one)")
            dcfg = draft_model.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size={dcfg.vocab_size} != target "
                    f"vocab_size={cfg.vocab_size}")
            if dcfg.eos_token != cfg.eos_token:
                raise ValueError(
                    f"draft eos_token={dcfg.eos_token} != target "
                    f"eos_token={cfg.eos_token}")
            if draft_model.device != self.device:
                raise ValueError(f"draft parameters live on "
                                 f"{draft_model.device}, the engine runs on "
                                 f"{self.device}")
            self.spec = SpeculativeDecoder(
                draft_model, k=int(spec_k), max_slots=max_slots,
                max_ctx=self.cache.max_context(),
                max_prompt=self.max_prompt)
            self._spec_limit = min(cfg.max_position, dcfg.max_position)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._stage()
        self._prefill_fn: Optional[CapturedUnit] = None
        self._write_fn: Optional[CapturedUnit] = None
        self._decode_fn: Optional[CapturedUnit] = None
        self._suffix_fn: Optional[CapturedUnit] = None
        self._verify_fn: Optional[CapturedUnit] = None
        # the prefix match staged between _admit_pages and _prefill_into,
        # set (or cleared) on every admission
        self._slot_match: dict = {}
        self.supervise = bool(supervise)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.default_deadline_s = default_deadline_s
        self.restarts = 0            # crash recoveries so far (<= the cap)
        self._worker: Optional[threading.Thread] = None
        self._stop_flag = False
        self._error: Optional[Exception] = None
        self._lifecycle = threading.Lock()  # guards _worker hand-off
        self.stopped_cleanly = True
        # cluster membership (serving/cluster.py): engine_id names this
        # engine in a ClusterRouter; on_unrecoverable, when set, runs once
        # on the dying worker after the restart budget is spent, and
        # migrates this scheduler's requests before fail_all retires the
        # rest
        self.engine_id = int(engine_id)
        self.on_unrecoverable: Optional[Callable[[Exception], None]] = None
        m = observe.metrics()
        self._obs = {
            "admitted": m.counter("dl4j_tpu_serving_admitted_total"),
            "generated": m.counter("dl4j_tpu_serving_generated_tokens_total"),
            "occupancy": m.gauge("dl4j_tpu_serving_slot_occupancy"),
            "decode_h": m.histogram("dl4j_tpu_serving_decode_step_seconds"),
            "ttft_h": m.histogram("dl4j_tpu_serving_ttft_seconds"),
            "itl_h": m.histogram("dl4j_tpu_serving_intertoken_seconds"),
            "restarts": m.counter("dl4j_tpu_serving_engine_restarts_total"),
            "retries": m.counter("dl4j_tpu_serving_retries_total"),
            # written only by stop(): the gauge is process-wide, and a
            # write here would hide an earlier engine's hung stop
            "stopped_g": m.gauge("dl4j_tpu_serving_stopped_cleanly"),
        }
        # warm boot from the export cache when $DL4J_TPU_COMPILE_CACHE is
        # set (serving/aot.py): every step restored, or exported and
        # stored, before the first request; inert otherwise
        from deeplearning4j_tpu_torch.serving import aot as _aot

        self.aot_boot = _aot.maybe_warm_boot(self)

    # ---------------------------------------------------------- staging
    def _stage(self) -> None:
        """The static device buffers the step graphs read, and their pinned
        host twins. Admission: the bucketed prompt ids, its length and
        top-k, temperature and top-p (float32 bits), the slot's page-table
        row. Decode: the page table, lengths, fed tokens, active flags,
        temperatures, top-k and top-p of every slot. Suffix prefill: the
        bucketed suffix ids, the prefix and suffix lengths, the knobs and
        the slot's row. Verify: the fed tokens, lengths, page table and
        active flags of every slot. Each buffer is int32 (the float32
        knobs are views of its bits) and crosses in one copy."""
        s_n, p_n = self.cache.max_slots, self.cache.max_pages_per_seq
        t, b = self.max_prompt, self.suffix_bucket
        pin = self.device.type == "cuda"

        def pair(n):
            host = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
            return host, host.numpy(), torch.zeros(n, dtype=torch.int32,
                                                   device=self.device)

        self._adm_host, self._adm_np, adm = pair(t + 4 + p_n)
        self._adm_dev = adm
        self._adm = self._adm_views(adm)
        self._dec_host, self._dec_np, dec = pair(s_n * p_n + 6 * s_n)
        self._dec_dev = dec
        self._dec = self._dec_views(dec)
        if self.prefix is not None:
            self._suf_host, self._suf_np, suf = pair(b + 5 + p_n)
            self._suf_dev = suf
            self._suf = self._suf_views(suf)
        if self.spec is not None:
            w = self.spec.k + 1
            self._ver_host, self._ver_np, ver = pair(s_n * (w + p_n + 2))
            self._ver_dev = ver
            self._ver = self._ver_views(ver)

    # the staged buffers' fields, as views of a buffer: the live one, or
    # the argument of an exported core (which reads no sampling knob: the
    # float32 ones, views of the int32 bits, only with ``knobs``)
    def _adm_views(self, adm, knobs: bool = True) -> dict:
        t = self.max_prompt
        out = {"ids": adm[:t].view(1, t), "p_len": adm[t],
               "top_k": adm[t + 1:t + 2], "pt_row": adm[t + 4:]}
        if knobs:
            out.update(temp=adm[t + 2:t + 3].view(torch.float32),
                       top_p=adm[t + 3:t + 4].view(torch.float32))
        return out

    def _dec_views(self, dec, knobs: bool = True) -> dict:
        s_n, p_n = self.cache.max_slots, self.cache.max_pages_per_seq
        o = s_n * p_n
        out = {"page_table": dec[:o].view(s_n, p_n),
               **{k: dec[o + i * s_n:o + (i + 1) * s_n]
                  for i, k in enumerate(("seq_lens", "tokens", "active",
                                         "top_k"))}}
        if knobs:
            out.update(
                temp=dec[o + 4 * s_n:o + 5 * s_n].view(torch.float32),
                top_p=dec[o + 5 * s_n:].view(torch.float32))
        return out

    def _suf_views(self, suf, knobs: bool = True) -> dict:
        b = self.suffix_bucket
        out = {"ids": suf[:b].view(1, b), "prefix_len": suf[b],
               "suffix_len": suf[b + 1], "top_k": suf[b + 2:b + 3],
               "pt_row": suf[b + 5:]}
        if knobs:
            out.update(temp=suf[b + 3:b + 4].view(torch.float32),
                       top_p=suf[b + 4:b + 5].view(torch.float32))
        return out

    def _ver_views(self, ver) -> dict:
        s_n, p_n = self.cache.max_slots, self.cache.max_pages_per_seq
        w = self.spec.k + 1
        o = s_n * w
        return {"tokens": ver[:o].view(s_n, w),
                "page_table": ver[o:o + s_n * p_n].view(s_n, p_n),
                "seq_lens": ver[o + s_n * p_n:o + s_n * (p_n + 1)],
                "active": ver[o + s_n * (p_n + 1):]}

    # ------------------------------------------------------ the step cores
    # Each step is a core — a function of its tensors alone (parameters,
    # cache, the staged device buffer), what the export cache exports
    # (serving/aot.py) — run inside its captured unit, followed, where the
    # step samples, by the draw from the engine's generator, which stays
    # outside any exported program.

    def _prefill_core(self, params, adm):
        """The prompt through one causal prefill: ``(kv (L, 2, T, H, Dh),
        the last prompt position's logits (1, V))``."""
        a, t = self._adm_views(adm, knobs=False), self.max_prompt
        pos = torch.arange(t, device=adm.device)
        mask = (pos < a["p_len"])[None].to(torch.int32)
        logits, kv = gpt_prefill(params, a["ids"], self.cfg, mask=mask)
        last = logits[0].index_select(
            0, (a["p_len"] - 1).reshape(1).long())  # (1, V)
        return kv[:, :, 0], last

    def _build_prefill(self, core=None) -> CapturedUnit:
        core = core or self._prefill_core
        params, adm, a = self.model.params, self._adm_dev, self._adm

        def prefill():
            kv, last = core(params, adm)
            tok = sample_tokens(last, self._gen, a["temp"], a["top_k"],
                                a["top_p"])
            return kv, tok  # (L, 2, T, H, Dh), (1,)

        return CapturedUnit(prefill, device=self.device,
                            generators=(self._gen,), name="prefill")

    def _write_core(self, kv, kv_prompt, adm):
        """Scatter the prefill K/V into the slot's pages of ``kv``, in
        place; prompt-pad positions land on the trash page."""
        a, t = self._adm_views(adm, knobs=False), self.max_prompt
        page, trash = self.cache.page_size, self.cache.trash_page
        pos = torch.arange(t, device=adm.device)
        page_idx = torch.where(pos < a["p_len"], a["pt_row"][pos // page],
                               trash)
        kv[:, :, page_idx, pos % page] = kv_prompt

    def _build_write(self, core=None) -> CapturedUnit:
        core = core or self._write_core
        kv, adm = self.cache.kv, self._adm_dev

        def write_prompt(kv_prompt):
            core(kv, kv_prompt, adm)

        # kv_prompt is the prefill graph's own output buffer: read in place
        return CapturedUnit(write_prompt, device=self.device,
                            owned_inputs=True, name="write_prompt")

    def _suffix_core(self, params, kv, suf):
        """Suffix-only prefill for prefix-cache hits: gather the cached
        prefix K/V out of the slot's pages (``max_prompt`` positions through
        its page-table row), run the bucketed suffix through
        :func:`gpt_prefill_suffix`, scatter the suffix K/V into the pages
        in place (pad positions land on the trash page); returns the last
        suffix position's logits (1, V)."""
        a = self._suf_views(suf, knobs=False)
        cache = self.cache
        page, trash = cache.page_size, cache.trash_page
        p_n, t_pre, b = cache.max_pages_per_seq, self.max_prompt, \
            self.suffix_bucket
        row = a["pt_row"].long()
        pos = torch.arange(t_pre, device=suf.device)
        prefix_kv = kv[:, :, row[pos // page], pos % page]
        logits, kv_suf = gpt_prefill_suffix(
            params, a["ids"], prefix_kv, a["prefix_len"], a["suffix_len"],
            self.cfg)
        last = logits[0].index_select(
            0, (a["suffix_len"] - 1).reshape(1).long())  # (1, V)
        ar = torch.arange(b, device=suf.device)
        apos = a["prefix_len"] + ar
        wpage = torch.where(ar < a["suffix_len"],
                            row[(apos // page).clamp(0, p_n - 1)], trash)
        kv[:, :, wpage, (apos % page).long()] = kv_suf.to(kv.dtype)
        return last

    def _build_suffix(self, core=None) -> CapturedUnit:
        """The suffix prefill (:meth:`_suffix_core`) and the first token
        sampled from its last position."""
        core = core or self._suffix_core
        params, kv, suf, a = (self.model.params, self.cache.kv,
                              self._suf_dev, self._suf)

        def suffix_prefill():
            last = core(params, kv, suf)
            return sample_tokens(last, self._gen, a["temp"], a["top_k"],
                                 a["top_p"])

        return CapturedUnit(suffix_prefill, device=self.device,
                            generators=(self._gen,), name="suffix_prefill")

    def _verify_core(self, params, kv, ver):
        """Speculative verification: ONE target forward over each slot's
        ``spec_k + 1`` fed tokens (the last committed and the K proposals)
        against the paged cache, the target's greedy argmax at every fed
        position out. Inactive and non-speculating slots ride along
        masked: their writes land on the trash page."""
        v, cache = self._ver_views(ver), self.cache
        page, trash = cache.page_size, cache.trash_page
        p_n, s_n, w = cache.max_pages_per_seq, cache.max_slots, \
            self.spec.k + 1
        seq_lens, table = v["seq_lens"], v["page_table"]
        pos = seq_lens.long()[:, None] + torch.arange(
            w, device=ver.device)[None, :]
        row = (pos // page).clamp(0, p_n - 1)
        wpage = torch.where(
            (v["active"] > 0)[:, None],
            table.long()[torch.arange(s_n, device=ver.device)[:, None], row],
            trash)
        _, greedy = gpt_verify(params, kv, v["tokens"], seq_lens, table,
                               wpage, pos % page, self.cfg, page_size=page)
        return greedy

    def _build_verify(self, core=None) -> CapturedUnit:
        core = core or self._verify_core
        params, kv, ver = self.model.params, self.cache.kv, self._ver_dev
        return CapturedUnit(lambda: core(params, kv, ver),
                            device=self.device, name="verify")

    def _decode_core(self, params, kv, dec):
        """One token's forward for every slot against the paged cache (its
        K/V written in place): the logits (S, V)."""
        d, cache = self._dec_views(dec, knobs=False), self.cache
        page, trash = cache.page_size, cache.trash_page
        s_n, p_n = cache.max_slots, cache.max_pages_per_seq
        seq_lens = d["seq_lens"]
        on = d["active"] > 0
        row = (seq_lens // page).clamp(max=p_n - 1)
        write_page = torch.where(
            on, d["page_table"][torch.arange(s_n, device=dec.device),
                                row.long()], trash).to(torch.int32)
        seq_incl = seq_lens + on.to(torch.int32)
        _, logits = gpt_decode_step(
            params, kv, d["tokens"], seq_lens, d["page_table"], seq_incl,
            write_page, seq_lens % page, self.cfg)
        return logits

    def _build_decode(self, core=None) -> CapturedUnit:
        core = core or self._decode_core
        params, kv, dec, d = (self.model.params, self.cache.kv,
                              self._dec_dev, self._dec)

        def decode():
            logits = core(params, kv, dec)
            toks = sample_tokens(logits, self._gen, d["temp"], d["top_k"],
                                 d["top_p"])
            return toks, logits

        return CapturedUnit(decode, device=self.device,
                            generators=(self._gen,), name="decode")

    # ------------------------------------------------------------------- api
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token: Optional[int] = None,
               deadline_s: Optional[float] = None, max_retries: int = 1,
               priority: int = 1, slo_class: str = "standard"
               ) -> "Future[GenerationResult]":
        """Queue one generation; returns a Future (thread-safe).
        ``max_retries`` is the request's budget of re-admissions after an
        engine crash; ``priority`` orders the pending queue (lower admits
        first) and ``slo_class`` labels the request for the SLO frontend.
        When the pending queue is at ``max_queue`` the request is SHED: its
        future completes at once with the terminal reason ``"shed"``."""
        eos = self.cfg.eos_token if eos_token is None else eos_token
        req = GenerationRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos,
            deadline_s=deadline_s, max_retries=max_retries,
            priority=priority, slo_class=slo_class)
        return self.submit_request(req)

    def validate_request(self, req: GenerationRequest) -> None:
        """Raise on a request this engine can never serve. Runs before any
        launch: CUDA indexing asserts on out-of-range ids where a JAX
        gather would clamp them."""
        if req.prompt.size > self.max_prompt:
            raise ValueError(
                f"prompt length {req.prompt.size} exceeds the engine's "
                f"prefill bucket max_prompt={self.max_prompt}")
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size}), "
                f"got range [{lo}, {hi}]")

    def submit_request(self, req: GenerationRequest
                       ) -> "Future[GenerationResult]":
        """Queue a pre-built :class:`GenerationRequest` (the SLO frontend's
        and the cluster router's entry point)."""
        if self._error is not None:
            raise RuntimeError("engine loop died") from self._error
        if self._stop_flag:
            raise RuntimeError("engine stopped — submit rejected")
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        self.validate_request(req)
        if (self.max_queue is not None
                and len(self.scheduler.pending) >= self.max_queue):
            fut: "Future[GenerationResult]" = Future()
            self._finish_unslotted(req, fut, "shed")
            return fut
        fut = self.scheduler.submit(req)
        if self._error is not None:
            # the loop died between the checks above and our enqueue
            self.scheduler.fail_all(RuntimeError("engine loop died"))
        elif self._stop_flag:
            self.scheduler.fail_pending(RuntimeError("engine stopped"))
        return fut

    def generate(self, prompts: Sequence, **kw) -> List[GenerationResult]:
        """Synchronous batch generation: submit everything, run the
        scheduler loop inline until drained. A step that dies inside the
        restart budget is recovered and the loop goes on; past it (or
        unsupervised) every outstanding request fails and the exception
        propagates."""
        if self._worker is not None:
            raise RuntimeError("generate() is the inline mode — the engine "
                               "is already running a serving loop; use "
                               "submit()")
        futs = [self.submit(p, **kw) for p in prompts]
        while self.scheduler.has_work():
            try:
                self.step()
            except Exception as e:
                if not self._recover(e):
                    self._die(e)
                    raise
        return [f.result() for f in futs]

    def start(self) -> "GenerativeEngine":
        with self._lifecycle:
            if self._worker is not None:
                return self
            self._stop_flag = False
            self._worker = threading.Thread(target=self._serve_loop,
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the serving loop. In-flight sequences retire with their
        partial output and the ``"stopped"`` reason; queued requests fail.
        A worker that does not join within ``timeout`` is reported
        (``stopped_cleanly`` False, the ``dl4j_tpu_serving_stopped_cleanly``
        gauge 0, an ``engine_stop_hung`` event) and keeps its active
        slots; the engine is left stopping, not restartable."""
        self._stop_flag = True
        while True:
            with self._lifecycle:
                w = self._worker
            if w is None or w is threading.current_thread():
                break
            w.join(timeout=timeout)
            if w.is_alive():
                # _worker stays set: a restart would race the stuck thread
                # over the same cache and scheduler
                self.stopped_cleanly = False
                self._obs["stopped_g"].set(0.0)
                logger.error("serving loop still running after %.0fs; "
                             "failing queued requests only", timeout)
                observe.log_event("engine_stop_hung", timeout_s=timeout)
                self.scheduler.fail_pending(
                    RuntimeError("GenerativeEngine stop timed out with the "
                                 "worker hung; queued request failed"),
                    reason="stopped")
                return
            with self._lifecycle:
                if self._worker is w:
                    self._worker = None
                    break
                # a recovery handed the loop to a replacement thread
                # before the flag was seen: join that one too
        self.stopped_cleanly = True
        self._obs["stopped_g"].set(1.0)
        for slot in self.scheduler.active_slots():
            self._retire(slot, "stopped")
        self.scheduler.fail_all(
            RuntimeError("GenerativeEngine stopped before this request "
                         "completed"), reason="stopped")

    def _serve_loop(self) -> None:
        while not self._stop_flag:
            if not self.scheduler.has_work():
                time.sleep(1e-3)
                continue
            try:
                if faults.should_fire("engine_death"):
                    # an unrestartable kill: the budget is spent first, so
                    # _recover cannot revive the worker
                    self.restarts = self.max_restarts
                    raise faults.InjectedFault("engine_death")
                faults.maybe_fail("worker_death")
                self.step()
            except Exception as e:  # the loop's boundary
                if self._recover(e):
                    # this thread retires; a replacement owns the loop
                    # (unless stop() raced us: it joins this thread)
                    with self._lifecycle:
                        if self._stop_flag:
                            return
                        self._worker = threading.Thread(
                            target=self._serve_loop, daemon=True)
                        self._worker.start()
                    return
                logger.exception("serving loop died (unrecoverable)")
                self._die(e)
                return

    def _die(self, exc: Exception) -> None:
        """Mark the engine dead, give a cluster router's
        ``on_unrecoverable`` hook one call to migrate this scheduler's
        requests (on the dying worker, after its last step: nothing races
        it), then fail whatever the hook left."""
        self._error = exc
        observe.log_event("engine_dead", engine=self.engine_id,
                          restarts=self.restarts, error=repr(exc))
        hook = self.on_unrecoverable
        if hook is not None:
            try:
                hook(exc)
            except Exception:
                logger.exception("on_unrecoverable hook failed; failing "
                                 "the remaining requests terminally")
        self.scheduler.fail_all(exc)

    def adopt_requests(self, items: Sequence[tuple]) -> None:
        """Put migrated ``(request, future, submit_t)`` tuples — a dead
        sibling's in-flight and queued work, handed over by the cluster
        router — at the FRONT of the pending queue, in their order. They
        keep their futures, submit times and priorities, so deadlines keep
        counting across the migration. An engine that died or stopped
        meanwhile fails them, as :meth:`submit_request` does."""
        items = list(items)
        if not items:
            return
        sched = self.scheduler
        with sched._plock:
            for item in reversed(items):
                sched.pending.appendleft(item)
        if self._error is not None:
            sched.fail_all(RuntimeError("engine loop died"))
        elif self._stop_flag:
            sched.fail_pending(RuntimeError("engine stopped"))

    def _recover(self, exc: Exception) -> bool:
        """Crash recovery: free every slot, put the requests with retries
        left back at the front of the queue with their original submit
        time, finish the others as ``error``, zero the KV pool in place
        and back off. False when unsupervised or past ``max_restarts``
        (the caller fails everything). Host-side exceptions only: a CUDA
        fault leaves the context unusable."""
        if not self.supervise or self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        self._obs["restarts"].inc()
        logger.warning("engine worker died (%r): restart %d/%d", exc,
                       self.restarts, self.max_restarts)
        sched, cache = self.scheduler, self.cache
        # reversed: appendleft re-queues the last one first, and slots are
        # taken lowest first, so the queue front gets the arrival order
        for slot in reversed(sched.active_slots()):
            st = sched.slots.pop(slot)
            cache.free_slot(slot)
            req = st.request
            if req.retries_used < req.max_retries:
                req.retries_used += 1
                self._obs["retries"].inc()
                with sched._plock:
                    sched.pending.appendleft((req, st.future, st.submit_t))
            else:
                self._finish_unslotted(req, st.future, "error")
        if self.prefix is not None:
            # reset_kv zeroes the pages: every cached prefix is garbage.
            # The tree drops whole; pin intents survive and re-pin
            self.prefix.clear()
        if self.spec is not None:
            # retried requests restart from the prompt and re-prefill
            # their draft rows
            self._spec_slots.clear()
            self.spec.reset()
        # the same buffer, zeroed: the captured steps keep their addresses
        cache.reset_kv()
        # a step never built before the crash comes from the export cache
        # (units already built are kept)
        from deeplearning4j_tpu_torch.serving import aot as _aot

        _aot.maybe_warm_boot(self)
        observe.log_event("engine_restart", restart=self.restarts,
                          error=repr(exc))
        delay = min(self.max_backoff_s,
                    self.restart_backoff_s * (2 ** (self.restarts - 1)))
        if delay > 0:
            time.sleep(delay)
        return True

    def _finish_unslotted(self, req, fut, reason: str) -> None:
        """Complete a future that holds no slot (shed, deadline in the
        queue, error past the retry budget) with a terminal result."""
        if not fut.done():
            fut.set_result(GenerationResult(
                tokens=np.zeros((0,), np.int32), finish_reason=reason,
                prompt_len=int(req.prompt.size), ttft_s=None,
                intertoken_s=[], slo_class=req.slo_class,
                degraded=req.degraded, spec_disabled=req.spec_disabled))
        count_terminal(reason)
        observe.log_event("serving_terminal", reason=reason,
                          slo_class=req.slo_class)

    # ---------------------------------------------------------- prefix cache
    def _match_prefix(self, req: GenerationRequest) -> Optional[PrefixMatch]:
        """Longest usable cached prefix for an arrival: at least
        ``min_match`` tokens, with an uncached tail that fits the captured
        suffix bucket. Lookups are counted in :meth:`_admit_pages`, once an
        admission."""
        if self.prefix is None:
            return None
        return self.prefix.match(req.prompt, max_suffix=self.suffix_bucket)

    def _admit_pages(self, slot: int, req: GenerationRequest,
                     match: Optional[PrefixMatch]) -> tuple:
        """Build ``slot``'s page run for ``req`` (``prompt + 1`` tokens).
        Without a match this is plain ``ensure_capacity``. With one: map
        the shared full pages (taking references), copy-on-write the
        partially filled tail page the prompt diverges in, then allocate
        the rest fresh — evicting unpinned tree leaves first when the free
        list cannot cover it. Any failure (an injected ``page_oom``
        mid-match too) unwinds the slot and returns a terminal status.
        Returns ``(status, prefix_hit_tokens)``."""
        cache = self.cache
        p_len = int(req.prompt.size)
        if self.prefix is not None:
            self.prefix.note_lookup()
        if match is None:
            return cache.ensure_capacity(slot, p_len + 1), 0
        full = match.matched // cache.page_size
        tail_len = match.matched % cache.page_size
        for page in match.pages[:full]:
            cache.map_shared(slot, page)
        if faults.should_fire("page_oom"):
            # injected pool pressure mid-match: drop the shared mappings
            # (the tree keeps its pages) and report the real arm's oom
            cache.free_slot(slot)
            return "oom", 0
        guard = None
        try:
            if tail_len:
                # guard the CoW source first: the eviction below may drop
                # the tree's only reference on it before the copy
                guard = match.pages[full]
                cache.retain(guard)
            need_rest = cache.pages_for(p_len + 1) - full
            if need_rest > cache.free_pages:
                self.prefix.evict_to_free(need_rest - cache.free_pages)
            if tail_len:
                if cache.cow_page(slot, guard) is None:
                    cache.free_slot(slot)
                    return "oom", 0
                self.prefix.note_cow()
            status = cache.ensure_capacity(slot, p_len + 1)
        finally:
            if guard is not None:
                cache.release(guard)
        if status != "ok":
            cache.free_slot(slot)
            return status, 0
        self.prefix.note_hit(match)
        return "ok", match.matched

    def prewarm_prefix(self, prompt, *, pin: bool = True):
        """Run ``prompt`` through one 1-token generation so its KV pages
        land in the prefix tree, then (by default) PIN them: pre-warmed
        per-class system prompts are never evicted (the SLO frontend's
        ``ClassPolicy.shared_prefix`` calls this). Inline on an idle
        engine, through the queue on a running one."""
        if self.prefix is None:
            raise RuntimeError("prefix cache disabled — construct the "
                               "engine with prefix_pages > 0")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < self.prefix.min_match:
            logger.warning(
                "shared prefix of %d tokens is below the prefix cache's "
                "min_match=%d — it will never produce a hit", prompt.size,
                self.prefix.min_match)
        if self._worker is None:
            res = self.generate([prompt], max_new_tokens=1, eos_token=-1)[0]
        else:
            res = self.submit(prompt, max_new_tokens=1,
                              eos_token=-1).result(timeout=600)
        if res.finish_reason not in ("eos", "length"):
            logger.warning("prefix pre-warm retired as %r — prefix not "
                           "cached", res.finish_reason)
            return res
        if pin:
            self.prefix.pin(prompt)
        return res

    def check_invariants(self) -> None:
        """Allocator and prefix-tree soundness with exact refcount
        accounting, and draft/target length agreement when speculation is
        on (test hook)."""
        if self.prefix is not None:
            self.prefix.check_invariants()
            self.cache.check_invariants(tree_refs=self.prefix.page_refs())
        else:
            self.cache.check_invariants()
        if self.spec is not None:
            assert self._spec_slots <= set(self.scheduler.slots), (
                f"speculating slots {self._spec_slots} outside the active "
                f"bank {sorted(self.scheduler.slots)}")
            self.spec.check_invariants(self._spec_slots, self.cache.seq_lens)

    # ------------------------------------------------------------ scheduling
    def _retire(self, slot: int, reason: str) -> None:
        if self.prefix is not None and reason in ("eos", "length"):
            # a completed sequence donates its prompt's pages to the radix
            # tree (insert or LRU refresh) before the slot lets go
            st = self.scheduler.slots.get(slot)
            if st is not None:
                n = self.cache.pages_for(st.prompt_len)
                self.prefix.insert(st.request.prompt,
                                   list(self.cache.owned[slot][:n]))
        self.scheduler.retire(slot, reason)
        self.cache.free_slot(slot)
        if self.spec is not None:
            self._spec_slots.discard(slot)
            self.spec.free(slot)
        count_terminal(reason)

    def step(self) -> int:
        """ONE scheduler iteration: retire finished, expire deadlines,
        capacity-evict, admit, then one decode step for the whole slot
        bank. Returns the number of tokens decoded (0 when idle)."""
        cache, sched = self.cache, self.scheduler

        # 1. retire sequences completed by the previous iteration first
        for slot in sched.active_slots():
            reason = sched.should_finish(slot)
            if reason:
                self._retire(slot, reason)

        # 1b. deadlines — after completion, so a finished sequence keeps
        #     its eos/length reason
        now = time.perf_counter()
        for slot in sched.active_slots():
            dl = sched.slots[slot].request.deadline_s
            if dl is not None and now - sched.slots[slot].submit_t > dl:
                self._retire(slot, "deadline")
        expired = []
        with sched._plock:
            for _ in range(len(sched.pending)):
                item = sched.pending.popleft()
                if (item[0].deadline_s is not None
                        and now - item[2] > item[0].deadline_s):
                    expired.append(item)
                else:
                    sched.pending.append(item)
        for req, fut, _t in expired:  # complete outside the queue lock
            self._finish_unslotted(req, fut, "deadline")

        # 2. capacity: every surviving slot needs room for one more token
        for slot in sched.active_slots():
            need = int(cache.seq_lens[slot]) + 1
            if need > self.cfg.max_position:
                self._retire(slot, "overflow")
                continue
            status = cache.ensure_capacity(slot, need)
            if status != "ok":
                self._retire(slot, status)

        # 3. admissions into free slots, highest priority first (FIFO
        #    within a priority)
        while True:
            free = sched.free_slot_ids()
            if not free:
                break
            item = sched.peek_best_pending()
            if item is None:
                break
            req, fut, t_sub = item
            p_len = int(req.prompt.size)
            # p_len + 1: the same iteration's decode writes the first
            # generated token's K/V at position p_len. A prefix match
            # discounts its shared full pages (the CoW tail still costs a
            # fresh page), and the tree's unpinned pages count as supply
            match = self._match_prefix(req)
            need_new = cache.pages_for(p_len + 1) - (
                match.matched // cache.page_size if match else 0)
            if need_new > cache.free_pages:
                # pages eviction would really free: not slot-held, and not
                # the match's own (those are being used, not freed)
                reclaimable = (self.prefix.reclaimable_pages(
                    exclude=match.pages if match else ())
                    if self.prefix is not None else 0)
                if need_new > cache.free_pages + reclaimable:
                    if not sched.slots:
                        # nothing active will ever free pages
                        if sched.remove_pending(item) and not fut.done():
                            fut.set_exception(RuntimeError(
                                f"prompt needs {need_new} free pages but "
                                f"the pool only has {cache.num_pages} "
                                f"({reclaimable} reclaimable from the "
                                f"prefix tree)"))
                            count_terminal("error")
                        continue
                    break  # pool pressure: wait for evictions
            if not sched.remove_pending(item):
                continue  # a frontend steal raced us: select again
            slot = free[0]
            try:
                status, hit_tokens = self._admit_pages(slot, req, match)
            except BaseException:
                # admission may have mapped shared pages before dying:
                # release them and put the request back at the front
                cache.free_slot(slot)
                with sched._plock:
                    sched.pending.appendleft(item)
                raise
            if status != "ok":
                self._finish_unslotted(req, fut, status)
                continue
            self._slot_match[slot] = match if hit_tokens else None
            try:
                first_tok = self._prefill_into(slot, req)
            except BaseException:
                # back to the queue front with its pages released, so the
                # failure path below fails it instead of stranding it
                cache.free_slot(slot)
                with sched._plock:
                    sched.pending.appendleft(item)
                raise
            cache.seq_lens[slot] = p_len
            now = time.perf_counter()
            sched.admit(slot, req, fut, t_sub, first_tok, now,
                        prefix_hit_tokens=hit_tokens)
            self._obs["admitted"].inc()
            self._obs["generated"].inc()
            self._obs["ttft_h"].observe(now - t_sub)
            if (self.spec is not None and req.temperature <= 0.0
                    and not req.spec_disabled):
                # greedy slots speculate: the draft prefills the same
                # prompt in full (its cache has no prefix tree), so draft
                # and target agree on a cached length of p_len. A crash
                # here finds the request in its slot: _recover re-queues it
                self.spec.prefill(slot, req.prompt)
                self._spec_slots.add(slot)

        # 4. a just-admitted sequence can already be done
        for slot in sched.active_slots():
            reason = sched.should_finish(slot)
            if reason:
                self._retire(slot, reason)

        self._obs["occupancy"].set(sched.occupancy())
        active = sched.active_slots()
        if not active:
            return 0

        # 5. one decode iteration over the whole bank. With speculation on
        #    the bank splits: slots that can take a spec_k + 1 verify
        #    window this step go draft + verify; the rest (sampling slots,
        #    spec-disabled requests, sequences near their context or
        #    position limit) take the plain one-token decode
        spec_now: List[int] = []
        plain: List[int] = []
        for slot in active:
            if self.spec is not None and slot in self._spec_slots:
                need = int(cache.seq_lens[slot]) + self.spec.k + 1
                if (need <= self._spec_limit
                        and cache.pages_for(need) <= cache.max_pages_per_seq
                        and cache.ensure_capacity(slot, need) == "ok"):
                    spec_now.append(slot)
                    continue
                # a slot that cannot host the verify window finishes its
                # sequence non-speculatively: a plain step would advance
                # the target past the draft, so the draft row is dropped
                self._spec_slots.discard(slot)
                self.spec.free(slot)
            plain.append(slot)

        # fault hooks before any dispatch: a crash never leaves a step
        # half run (_step_speculative arms a second one between draft and
        # verify)
        faults.maybe_fail("decode_step_error")
        faults.maybe_sleep("slow_decode", 0.05)
        produced = 0
        if plain:
            produced += self._step_decode(plain)
        if spec_now:
            produced += self._step_speculative(spec_now)
        return produced

    @torch.no_grad()
    def _step_decode(self, active: List[int]) -> int:
        """One decode token for every active slot."""
        cache, sched = self.cache, self.scheduler
        s_n, p_n = cache.max_slots, cache.max_pages_per_seq
        tokens = np.zeros((s_n,), np.int32)
        act = np.zeros((s_n,), np.int32)
        temp = np.zeros((s_n,), np.float32)
        top_k = np.zeros((s_n,), np.int32)
        top_p = np.ones((s_n,), np.float32)
        for slot in active:
            st = sched.slots[slot]
            tokens[slot] = st.tokens[-1]
            act[slot] = 1
            temp[slot] = st.request.temperature
            top_k[slot] = st.request.top_k
            top_p[slot] = st.request.top_p
        if self._decode_fn is None:
            self._decode_fn = self._build_decode()
        observe.note_jit_signature(
            self._decode_fn, graph="serving", key="decode",
            signature=observe.signature_of(
                page_table=cache.page_table, seq_lens=cache.seq_lens,
                tokens=tokens, active=act))
        h, o = self._dec_np, s_n * p_n
        h[:o] = cache.page_table.reshape(-1)
        for i, arr in enumerate((cache.seq_lens, tokens, act, top_k)):
            h[o + i * s_n:o + (i + 1) * s_n] = arr
        h[o + 4 * s_n:].view(np.float32)[:] = np.concatenate([temp, top_p])
        t0 = time.perf_counter()
        with observe.tracer().span("serving_decode", category="serving",
                                   slots=len(active)):
            # the last step read its tokens back, so the previous copy out
            # of the pinned buffer is done
            self._dec_dev.copy_(self._dec_host, non_blocking=True)
            next_toks, _logits = self._decode_fn()
            next_toks = next_toks.cpu().numpy()
        dt = time.perf_counter() - t0
        self._obs["decode_h"].observe(dt)
        now = time.perf_counter()
        for slot in active:
            cache.seq_lens[slot] += 1  # the fed token is cached now
            st = sched.slots[slot]
            if st.last_token_t is not None:
                self._obs["itl_h"].observe(now - st.last_token_t)
            sched.on_decode_token(slot, int(next_toks[slot]), now)
        self._obs["generated"].inc(len(active))
        return len(active)

    @torch.no_grad()
    def _step_speculative(self, spec_now: List[int]) -> int:
        """One speculative iteration for ``spec_now``: K draft proposals a
        slot (one captured unit), ONE target verify pass over the K+1-token
        window, then greedy exact-match acceptance on the host — commit the
        agreed draft prefix plus the target's correction or bonus token,
        and REWIND the cached lengths past it (rejected positions become
        garbage beyond the length, overwritten by the next pass). The
        caller reserved capacity for the whole window.

        Latency is accounted per committed token: a step that lands m
        tokens adds m observations of step/m to the decode and inter-token
        histograms, so speculative percentiles price a token, as plain
        decode's do."""
        spec, cache, sched = self.spec, self.cache, self.scheduler
        s_n, p_n = cache.max_slots, cache.max_pages_per_seq
        w = spec.k + 1
        pend = np.zeros((s_n,), np.int32)
        act = np.zeros((s_n,), np.int32)
        for slot in spec_now:
            pend[slot] = sched.slots[slot].tokens[-1]
            act[slot] = 1
        t0 = time.perf_counter()
        props = spec.propose(pend, act)          # (S, K) — the draft phase
        # the second decode_step_error arm, mid-speculation: the draft
        # advanced, nothing committed — the state spec.reset() exists for
        faults.maybe_fail("decode_step_error")
        vtokens = np.zeros((s_n, w), np.int32)
        vtokens[:, 0] = pend
        vtokens[:, 1:] = props
        if self._verify_fn is None:
            self._verify_fn = self._build_verify()
        observe.note_jit_signature(
            self._verify_fn, graph="serving", key="verify",
            signature=observe.signature_of(
                tokens=vtokens, seq_lens=cache.seq_lens,
                page_table=cache.page_table, active=act))
        h, o = self._ver_np, s_n * w
        h[:o] = vtokens.reshape(-1)
        h[o:o + s_n * p_n] = cache.page_table.reshape(-1)
        h[o + s_n * p_n:o + s_n * (p_n + 1)] = cache.seq_lens
        h[o + s_n * (p_n + 1):] = act
        with observe.tracer().span("serving_verify", category="serving",
                                   slots=len(spec_now)):
            self._ver_dev.copy_(self._ver_host, non_blocking=True)
            greedy = self._verify_fn().cpu().numpy()  # (S, K+1) argmax
        dt = time.perf_counter() - t0
        now = time.perf_counter()
        committed_total = accepted_total = 0
        for slot in spec_now:
            st = sched.slots[slot]
            # proposal i is accepted iff it equals the target's argmax
            # after the previous token
            j = 0
            while j < spec.k and props[slot, j] == greedy[slot, j]:
                j += 1
            toks = [int(t) for t in props[slot, :j]]
            toks.append(int(greedy[slot, j]))    # correction / bonus
            # never past the request's budget, never past an eos (retire
            # trims the eos itself)
            rem = st.request.max_new_tokens - len(st.tokens)
            toks = toks[:max(1, rem)]
            eos = st.request.eos_token
            for i, t in enumerate(toks):
                if t == eos:
                    toks = toks[:i + 1]
                    break
            m = len(toks)
            # the rewind: the fed token and the first m-1 commits are
            # cached; the last commit is the next step's feed
            cache.seq_lens[slot] += m
            spec.commit(slot, m)
            from_draft = min(j, m)               # drafts that landed
            spec.note_outcome(spec.k, j, from_draft)
            gap = sched.on_spec_tokens(slot, toks, now, spec.k, from_draft)
            per_tok = dt / m
            for _ in range(m):
                self._obs["decode_h"].observe(per_tok)
                if gap is not None:
                    self._obs["itl_h"].observe(gap)
            committed_total += m
            accepted_total += from_draft
        self._obs["generated"].inc(committed_total)
        observe.log_event(
            "serving_spec", slots=len(spec_now),
            proposed=spec.k * len(spec_now), accepted=accepted_total,
            committed=committed_total, step_seconds=round(dt, 6))
        return committed_total

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: GenerationRequest) -> int:
        """Run the (bucketed) prefill, scatter K/V into the slot's pages,
        return the first sampled token. With a prefix match staged for the
        slot the shared pages are mapped already and only the suffix
        runs."""
        match = self._slot_match.pop(slot, None)
        if match is not None:
            return self._prefill_suffix_into(slot, req, match)
        cache = self.cache
        t = self.max_prompt
        p_len = int(req.prompt.size)
        ids = np.zeros((1, t), np.int32)
        ids[0, :p_len] = req.prompt
        if self._prefill_fn is None:
            self._prefill_fn = self._build_prefill()
        if self._write_fn is None:
            self._write_fn = self._build_write()
        observe.note_jit_signature(
            self._prefill_fn, graph="serving", key="prefill",
            signature=observe.signature_of(ids=ids))
        observe.note_jit_signature(
            self._write_fn, graph="serving", key="write_prompt",
            signature=observe.signature_of(ids=ids))
        h = self._adm_np
        h[:t] = ids[0]
        h[t:t + 2] = (p_len, req.top_k)
        h[t + 2:t + 4].view(np.float32)[:] = (req.temperature, req.top_p)
        h[t + 4:] = cache.page_table[slot]
        with observe.tracer().span("serving_prefill", category="serving",
                                   prompt_len=p_len):
            self._adm_dev.copy_(self._adm_host, non_blocking=True)
            kv_prompt, tok = self._prefill_fn()
            self._write_fn(kv_prompt)
            tok = int(tok[0])
        return tok

    @torch.no_grad()
    def _prefill_suffix_into(self, slot: int, req: GenerationRequest,
                             match: PrefixMatch) -> int:
        """Prefix-hit admission: prefill only the uncached suffix against
        the cached prefix pages already mapped into the slot's row."""
        cache = self.cache
        b = self.suffix_bucket
        p_len = int(req.prompt.size)
        suffix = req.prompt[match.matched:]
        ids = np.zeros((1, b), np.int32)
        ids[0, :suffix.size] = suffix
        if self._suffix_fn is None:
            self._suffix_fn = self._build_suffix()
        observe.note_jit_signature(
            self._suffix_fn, graph="serving", key="suffix_prefill",
            signature=observe.signature_of(ids=ids))
        h = self._suf_np
        h[:b] = ids[0]
        h[b:b + 3] = (match.matched, suffix.size, req.top_k)
        h[b + 3:b + 5].view(np.float32)[:] = (req.temperature, req.top_p)
        h[b + 5:] = cache.page_table[slot]
        with observe.tracer().span("serving_prefill", category="serving",
                                   prompt_len=p_len,
                                   prefix_hit=match.matched):
            self._suf_dev.copy_(self._suf_host, non_blocking=True)
            tok = int(self._suffix_fn()[0])
        return tok
