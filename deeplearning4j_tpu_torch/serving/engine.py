"""Generative serving engine — prefill/decode dispatch over the paged cache.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` on the path without
prefix cache, speculation, AOT export or supervision. Three step functions
run eagerly on the engine's device:

* **prefill** — the whole (padded) prompt through one causal
  ``gpt_prefill`` pass (the CUDA flash kernel on the card) and first-token
  sampling. TTFT is measured across it.
* **write-prompt** — scatter the prefill K/V into the slot's pages, in
  place; prompt-pad positions land on the trash page.
* **decode** — one token for EVERY slot (inactive slots ride along masked:
  they write to the trash page and their outputs are ignored), paged
  attention through the registry's ``paged_decode_attention`` (the CUDA
  paged kernel on the card), then the temperature/top-k/top-p sampler.

The JAX engine jits these and donates the cache array; here the cache is
one preallocated tensor written in place.

Without supervision, an exception in a step fails every outstanding
request and leaves the engine dead (the unsupervised JAX path). Per-request
deadlines, the bounded queue (``max_queue`` sheds as ``shed``), capacity
evictions (``overflow``/``oom``) and priority admission are kept.

Observability: admitted/evicted/generated-token counters, slot-occupancy
gauge, decode-step, TTFT and inter-token histograms, and the
``serving_prefill``/``serving_decode`` spans.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.models.gpt import (
    GptModel, gpt_decode_step, gpt_prefill)
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
                 seed: int = 0, max_queue: Optional[int] = None,
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
        self.max_queue = None if max_queue is None else int(max_queue)
        self.default_deadline_s = default_deadline_s
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
        }

    def _tensor(self, arr) -> torch.Tensor:
        """A device copy of host state (never a view of the numpy array,
        which the scheduler keeps mutating)."""
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------------------- api
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token: Optional[int] = None,
               deadline_s: Optional[float] = None, priority: int = 1
               ) -> "Future[GenerationResult]":
        """Queue one generation; returns a Future (thread-safe). When the
        pending queue is at ``max_queue`` the request is SHED: its future
        completes at once with the terminal reason ``"shed"``."""
        eos = self.cfg.eos_token if eos_token is None else eos_token
        req = GenerationRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos,
            deadline_s=deadline_s, priority=priority)
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
        scheduler loop inline until drained. A step failure fails every
        outstanding request and propagates."""
        if self._worker is not None:
            raise RuntimeError("generate() is the inline mode — the engine "
                               "is already running a serving loop; use "
                               "submit()")
        futs = [self.submit(p, **kw) for p in prompts]
        while self.scheduler.has_work():
            try:
                self.step()
            except Exception as e:
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
        (``stopped_cleanly`` False) and keeps its active slots."""
        self._stop_flag = True
        with self._lifecycle:
            w = self._worker
        if w is not None and w is not threading.current_thread():
            w.join(timeout=timeout)
            if w.is_alive():
                self.stopped_cleanly = False
                logger.error("serving loop still running after %.0fs; "
                             "failing queued requests only", timeout)
                self.scheduler.fail_pending(
                    RuntimeError("GenerativeEngine stop timed out with the "
                                 "worker hung; queued request failed"),
                    reason="stopped")
                return
            with self._lifecycle:
                self._worker = None
        self.stopped_cleanly = True
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
                self.step()
            except Exception as e:  # the loop's boundary: report, fail all
                logger.exception("serving loop died")
                self._die(e)
                return

    def _die(self, exc: Exception) -> None:
        """Mark the engine dead and fail every outstanding request."""
        self._error = exc
        self.scheduler.fail_all(exc)

    def _finish_unslotted(self, req, fut, reason: str) -> None:
        """Complete a future that never held a slot (shed, or deadline in
        the queue) with a terminal result."""
        if not fut.done():
            fut.set_result(GenerationResult(
                tokens=np.zeros((0,), np.int32), finish_reason=reason,
                prompt_len=int(req.prompt.size), ttft_s=None,
                intertoken_s=[]))
        count_terminal(reason)

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
        return self._step_decode(active)

    @torch.no_grad()
    def _step_decode(self, active: List[int]) -> int:
        """One decode token for every active slot."""
        cache, sched = self.cache, self.scheduler
        s_n = cache.max_slots
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
        t0 = time.perf_counter()
        with observe.tracer().span("serving_decode", category="serving",
                                   slots=len(active)):
            page = cache.page_size
            page_table = self._tensor(cache.page_table)
            seq_lens = self._tensor(cache.seq_lens)
            on = self._tensor(act) > 0
            row = (seq_lens // page).clamp(max=cache.max_pages_per_seq - 1)
            write_page = torch.where(
                on, page_table[torch.arange(s_n, device=self.device),
                               row.long()],
                cache.trash_page).to(torch.int32)
            write_off = seq_lens % page
            seq_incl = seq_lens + on.to(torch.int32)
            _, logits = gpt_decode_step(
                self.model.params, cache.kv, self._tensor(tokens), seq_lens,
                page_table, seq_incl, write_page, write_off, self.cfg)
            next_toks = sample_tokens(
                logits, self._gen, self._tensor(temp), self._tensor(top_k),
                self._tensor(top_p)).cpu().numpy()
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
        p_len = int(req.prompt.size)
        ids = np.zeros((1, self.max_prompt), np.int32)
        ids[0, :p_len] = req.prompt
        with observe.tracer().span("serving_prefill", category="serving",
                                   prompt_len=p_len):
            pos = torch.arange(self.max_prompt, device=self.device)
            valid = pos < p_len
            logits, kv = gpt_prefill(self.model.params, self._tensor(ids),
                                     self.cfg,
                                     mask=valid[None].to(torch.int32))
            tok = sample_tokens(
                logits[0, p_len - 1][None], self._gen,
                torch.tensor([req.temperature], device=self.device),
                torch.tensor([req.top_k], device=self.device),
                torch.tensor([req.top_p], device=self.device))[0]
            # write-prompt: the prompt's K/V into the slot's pages, in
            # place; pad positions go to the trash page
            pt_row = self._tensor(cache.page_table[slot])
            page_idx = torch.where(valid, pt_row[pos // cache.page_size],
                                   cache.trash_page)
            cache.kv[:, :, page_idx, pos % cache.page_size] = kv[:, :, 0]
            tok = int(tok)
        return tok
