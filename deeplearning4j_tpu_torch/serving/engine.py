"""Generative serving engine — prefill/decode dispatch over the paged cache.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` on the path without
prefix cache, speculation or AOT export. Three compiled step
functions — the JAX engine jits them, the port runs each as a
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

Their signatures depend only on the engine's configuration (slots, page
geometry, prompt bucket), so the recompile ledger records one
``first_compile`` each (graph ``"serving"``, keys ``"prefill"``,
``"write_prompt"``, ``"decode"``) and no ``new_shape`` across admissions
and evictions. Each is captured at its first use. The host state a step
reads — the prompt, its length and sampling knobs, the slot's page-table
row; for decode the page table, lengths, fed tokens, active flags and
knobs of every slot — is packed into one pinned host buffer and copied to
the device in one transfer into the static buffers the graphs read. The
cache is one preallocated tensor written in place (never reallocated: the
graphs address it), as are the model's parameters: change those in place.
The engine's ``torch.Generator`` is registered with the prefill and decode
graphs.

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
(the unsupervised path). Recovery handles host-side exceptions; a real
CUDA fault leaves the context unusable and cannot be recovered in the
process. The fault points ``decode_step_error``, ``slow_decode``,
``worker_death``, ``engine_death`` and the cache's ``page_oom`` exercise
these paths. Per-request deadlines, the bounded queue (``max_queue`` sheds
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
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.models.gpt import (
    GptModel, gpt_decode_step, gpt_prefill)
from deeplearning4j_tpu_torch.ops.capture import CapturedUnit
from deeplearning4j_tpu_torch.serving.cache import PagedKVCache
from deeplearning4j_tpu_torch.serving.sampling import sample_tokens
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
            num_pages = max_slots * max_pages_per_seq  # full reservation
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
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._stage()
        self._prefill_fn: Optional[CapturedUnit] = None
        self._write_fn: Optional[CapturedUnit] = None
        self._decode_fn: Optional[CapturedUnit] = None
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

    # ---------------------------------------------------------- staging
    def _stage(self) -> None:
        """The static device buffers the step graphs read, and their pinned
        host twins. Admission: the bucketed prompt ids, its length and
        top-k, temperature and top-p (float32 bits), the slot's page-table
        row. Decode: the page table, lengths, fed tokens, active flags,
        temperatures, top-k and top-p of every slot. Each buffer is int32
        (the float32 knobs are views of its bits) and crosses in one
        copy."""
        s_n, p_n = self.cache.max_slots, self.cache.max_pages_per_seq
        t = self.max_prompt
        pin = self.device.type == "cuda"

        def pair(n):
            host = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
            return host, host.numpy(), torch.zeros(n, dtype=torch.int32,
                                                   device=self.device)

        self._adm_host, self._adm_np, adm = pair(t + 4 + p_n)
        self._adm_dev = adm
        self._adm = {"ids": adm[:t].view(1, t), "p_len": adm[t],
                     "top_k": adm[t + 1:t + 2],
                     "temp": adm[t + 2:t + 3].view(torch.float32),
                     "top_p": adm[t + 3:t + 4].view(torch.float32),
                     "pt_row": adm[t + 4:]}
        self._dec_host, self._dec_np, dec = pair(s_n * p_n + 6 * s_n)
        self._dec_dev = dec
        o = s_n * p_n
        self._dec = {"page_table": dec[:o].view(s_n, p_n),
                     **{k: dec[o + i * s_n:o + (i + 1) * s_n]
                        for i, k in enumerate(("seq_lens", "tokens",
                                               "active", "top_k"))},
                     "temp": dec[o + 4 * s_n:o + 5 * s_n].view(torch.float32),
                     "top_p": dec[o + 5 * s_n:].view(torch.float32)}

    def _build_prefill(self) -> CapturedUnit:
        cfg, params, a = self.cfg, self.model.params, self._adm
        t = self.max_prompt

        def prefill():
            pos = torch.arange(t, device=self.device)
            mask = (pos < a["p_len"])[None].to(torch.int32)
            logits, kv = gpt_prefill(params, a["ids"], cfg, mask=mask)
            last = logits[0].index_select(
                0, (a["p_len"] - 1).reshape(1).long())  # (1, V)
            tok = sample_tokens(last, self._gen, a["temp"], a["top_k"],
                                a["top_p"])
            return kv[:, :, 0], tok  # (L, 2, T, H, Dh), (1,)

        return CapturedUnit(prefill, device=self.device,
                            generators=(self._gen,), name="prefill")

    def _build_write(self) -> CapturedUnit:
        cache, a = self.cache, self._adm
        page, trash, t = cache.page_size, cache.trash_page, self.max_prompt

        def write_prompt(kv_prompt):
            pos = torch.arange(t, device=self.device)
            page_idx = torch.where(pos < a["p_len"],
                                   a["pt_row"][pos // page], trash)
            cache.kv[:, :, page_idx, pos % page] = kv_prompt

        # kv_prompt is the prefill graph's own output buffer: read in place
        return CapturedUnit(write_prompt, device=self.device,
                            owned_inputs=True, name="write_prompt")

    def _build_decode(self) -> CapturedUnit:
        cfg, cache, params, d = self.cfg, self.cache, self.model.params, \
            self._dec
        page, trash = cache.page_size, cache.trash_page
        s_n, p_n = cache.max_slots, cache.max_pages_per_seq

        def decode():
            seq_lens = d["seq_lens"]
            on = d["active"] > 0
            row = (seq_lens // page).clamp(max=p_n - 1)
            write_page = torch.where(
                on, d["page_table"][torch.arange(s_n, device=self.device),
                                    row.long()], trash).to(torch.int32)
            seq_incl = seq_lens + on.to(torch.int32)
            _, logits = gpt_decode_step(
                params, cache.kv, d["tokens"], seq_lens, d["page_table"],
                seq_incl, write_page, seq_lens % page, cfg)
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
               priority: int = 1) -> "Future[GenerationResult]":
        """Queue one generation; returns a Future (thread-safe).
        ``max_retries`` is the request's budget of re-admissions after an
        engine crash. When the pending queue is at ``max_queue`` the
        request is SHED: its future completes at once with the terminal
        reason ``"shed"``."""
        eos = self.cfg.eos_token if eos_token is None else eos_token
        req = GenerationRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos,
            deadline_s=deadline_s, max_retries=max_retries,
            priority=priority)
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
        """Queue a pre-built :class:`GenerationRequest`."""
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
        """Mark the engine dead and fail every outstanding request."""
        self._error = exc
        observe.log_event("engine_dead", restarts=self.restarts,
                          error=repr(exc))
        self.scheduler.fail_all(exc)

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
        # the same buffer, zeroed: the captured steps keep their addresses
        cache.reset_kv()
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
                intertoken_s=[]))
        count_terminal(reason)
        observe.log_event("serving_terminal", reason=reason)

    def check_invariants(self) -> None:
        """Allocator soundness (test hook)."""
        self.cache.check_invariants()

    # ------------------------------------------------------------ scheduling
    def _retire(self, slot: int, reason: str) -> None:
        self.scheduler.retire(slot, reason)
        self.cache.free_slot(slot)
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
            # generated token's K/V at position p_len
            need_new = cache.pages_for(p_len + 1)
            if need_new > cache.free_pages:
                if not sched.slots:
                    # nothing active will ever free pages
                    if sched.remove_pending(item) and not fut.done():
                        fut.set_exception(RuntimeError(
                            f"prompt needs {need_new} free pages but the "
                            f"pool only has {cache.num_pages}"))
                        count_terminal("error")
                    continue
                break  # pool pressure: wait for evictions
            if not sched.remove_pending(item):
                continue
            slot = free[0]
            status = cache.ensure_capacity(slot, p_len + 1)
            if status != "ok":
                cache.free_slot(slot)
                self._finish_unslotted(req, fut, status)
                continue
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
            sched.admit(slot, req, fut, t_sub, first_tok, now)
            self._obs["admitted"].inc()
            self._obs["generated"].inc()
            self._obs["ttft_h"].observe(now - t_sub)

        # 4. a just-admitted sequence can already be done
        for slot in sched.active_slots():
            reason = sched.should_finish(slot)
            if reason:
                self._retire(slot, reason)

        self._obs["occupancy"].set(sched.occupancy())
        active = sched.active_slots()
        if not active:
            return 0
        # fault hooks before the dispatch: a crash never leaves a step
        # half run
        faults.maybe_fail("decode_step_error")
        faults.maybe_sleep("slow_decode", 0.05)
        return self._step_decode(active)

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
    def _prefill_into(self, slot: int, req: GenerationRequest) -> int:
        """Run the (bucketed) prefill, scatter K/V into the slot's pages,
        return the first sampled token."""
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
