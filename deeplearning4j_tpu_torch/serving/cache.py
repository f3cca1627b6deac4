"""Block-paged KV cache — the PagedAttention memory model (SOSP '23).

Counterpart of ``deeplearning4j_tpu/serving/cache.py``, the same layout and
the same refcounted allocator:

* KV storage is ONE preallocated tensor of fixed-size pages
  ``(layers, 2, num_pages + 1, page_size, heads, head_dim)`` on the
  engine's device. Prefill and decode write into it IN PLACE (the JAX
  engine donates the array to each compiled step and gets a new one back;
  PyTorch updates the one buffer), so serving never reallocates it.
* Each sequence owns an ordered list of pages recorded in a page-table row
  ``(max_slots, max_pages_per_seq)``; token position ``t`` lives at
  ``(page_table[slot, t // page_size], t % page_size)``.
* A host-side free list hands out pages and takes them back; pages are
  refcounted, so a page may be held by several slots (shared prefixes),
  returning to the free list when its last holder releases it.
* Crash recovery zeroes the pool in place (:meth:`reset_kv`): the JAX
  engine reallocates it, but the port's captured steps hold its address.

The LAST page (index ``num_pages``) is the trash page: inactive slots'
decode writes and unallocated page-table entries point at it.

Invariants (:meth:`check_invariants`):
  * every page is either in the free list XOR has ``refcount >= 1``;
  * ``refcount(p) >= (#slot rows mapping p)`` (``==`` with no other
    holders);
  * a freed slot's page-table row points wholly at the trash page.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch.environment import resolve_device


class PagedKVCache:
    """Fixed-pool paged KV storage + refcounted free-list allocator
    (host-side bookkeeping, device-side ``kv`` tensor updated in place)."""

    def __init__(self, *, layers: int, heads: int, head_dim: int,
                 page_size: int = 16, num_pages: int = 64,
                 max_slots: int = 4, max_pages_per_seq: int = 8,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        # the entry points' device rule: "cuda" unless the caller names
        # another, and an error on a host without a GPU
        device = resolve_device(device)
        if page_size <= 0 or num_pages <= 0:
            raise ValueError("page_size and num_pages must be positive")
        self.layers = layers
        self.heads = heads
        self.head_dim = head_dim
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_slots = int(max_slots)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.trash_page = self.num_pages
        # +1: the trash page — see module docstring
        self.kv = torch.zeros((layers, 2, self.num_pages + 1, self.page_size,
                               heads, head_dim), dtype=dtype, device=device)
        self.free: List[int] = list(range(self.num_pages))
        self.refcount: List[int] = [0] * self.num_pages
        self.page_table = np.full((self.max_slots, self.max_pages_per_seq),
                                  self.trash_page, np.int32)
        self.seq_lens = np.zeros((self.max_slots,), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(self.max_slots)]

    # ----------------------------------------------------------- accounting
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens."""
        return -(-int(n_tokens) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self.free)

    def used_pages(self) -> int:
        """Page references the slots hold (a page shared by two slots
        counts twice)."""
        return sum(len(o) for o in self.owned)

    def max_context(self) -> int:
        """Longest sequence one slot can hold."""
        return self.max_pages_per_seq * self.page_size

    # ------------------------------------------------------------- refcounts
    def alloc_page(self) -> Optional[int]:
        """Pop a page off the free list with ``refcount == 1``; None when
        the pool is exhausted."""
        if not self.free:
            return None
        page = self.free.pop()
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> None:
        """Add one reference to a LIVE page."""
        if self.refcount[page] <= 0:
            raise AssertionError(
                f"retain of page {page} with refcount "
                f"{self.refcount[page]} (page is on the free list)")
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at zero."""
        if self.refcount[page] <= 0:
            raise AssertionError(
                f"release of page {page} with refcount "
                f"{self.refcount[page]} (double free)")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.free.append(page)

    def map_shared(self, slot: int, page: int) -> None:
        """Map an already-live page into ``slot``'s next page-table
        position, taking a reference. The slot must never WRITE into a
        shared page — copy it first (:meth:`cow_page`)."""
        self.retain(page)
        idx = len(self.owned[slot])
        self.owned[slot].append(page)
        self.page_table[slot, idx] = page

    def cow_page(self, slot: int, src: int) -> Optional[int]:
        """Copy-on-write: allocate a fresh page, copy ``src`` into it on
        the device, map it into ``slot``'s next position. None when the
        pool is exhausted."""
        dst = self.alloc_page()
        if dst is None:
            return None
        idx = len(self.owned[slot])
        self.owned[slot].append(dst)
        self.page_table[slot, idx] = dst
        self.kv[:, :, dst] = self.kv[:, :, src]
        return dst

    # ----------------------------------------------------------- allocation
    def ensure_capacity(self, slot: int, n_tokens: int) -> str:
        """Grow ``slot``'s page list to cover ``n_tokens`` tokens.

        Returns ``"ok"``, ``"overflow"`` (beyond the page-table row) or
        ``"oom"`` (free list exhausted). Partial growth never happens."""
        need = self.pages_for(n_tokens)
        have = len(self.owned[slot])
        if need <= have:
            return "ok"
        if faults.should_fire("page_oom"):
            # injected pool pressure: the real oom's contract, the slot's
            # pages untouched
            return "oom"
        if need > self.max_pages_per_seq:
            return "overflow"
        if need - have > len(self.free):
            return "oom"
        for i in range(have, need):
            page = self.alloc_page()
            self.owned[slot].append(page)
            self.page_table[slot, i] = page
        return "ok"

    def free_slot(self, slot: int) -> int:
        """Release ``slot``'s references and reset its row to the trash
        page. Returns the number of page references released."""
        released = len(self.owned[slot])
        for page in self.owned[slot]:
            self.release(page)
        self.owned[slot] = []
        self.page_table[slot, :] = self.trash_page
        self.seq_lens[slot] = 0
        return released

    def reset_kv(self) -> None:
        """Zero the page pool in place (supervised crash recovery). The
        JAX engine reallocates it, since a step that died may have
        consumed its donated buffer; here the captured steps hold the
        buffer's address, so it stays the same tensor and no step is
        captured again. Host-side page accounting is untouched: the
        caller frees and retries the slots."""
        self.kv.zero_()

    def check_invariants(self, tree_refs=None) -> None:
        """Allocator soundness (test hook): free XOR live partition of the
        pool, table/owned agreement, and — with ``tree_refs`` (other
        holders' per-page counts) — exact refcount accounting. Raises
        AssertionError on violation."""
        live = [p for p in range(self.num_pages) if self.refcount[p] > 0]
        assert sorted(self.free + live) == list(range(self.num_pages)), (
            f"page pool corrupt: free={sorted(self.free)} "
            f"live={live} owned={self.owned}")
        holders = {}
        for slot, pages in enumerate(self.owned):
            row = self.page_table[slot]
            assert list(row[:len(pages)]) == pages, (
                f"slot {slot} page-table row {row} disagrees with owned "
                f"{pages}")
            assert all(int(p) == self.trash_page
                       for p in row[len(pages):]), (
                f"slot {slot} has stale table entries past its pages: {row}")
            assert self.seq_lens[slot] <= len(pages) * self.page_size
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        for p in range(self.num_pages):
            assert self.refcount[p] >= holders.get(p, 0), (
                f"page {p}: refcount {self.refcount[p]} below its "
                f"{holders.get(p, 0)} slot holders")
        if tree_refs is not None:
            for p in range(self.num_pages):
                want = holders.get(p, 0) + int(tree_refs.get(p, 0))
                assert self.refcount[p] == want, (
                    f"page {p}: refcount {self.refcount[p]} != "
                    f"{holders.get(p, 0)} slot holders + "
                    f"{tree_refs.get(p, 0)} other refs")
