"""Radix prefix cache — shared-prompt KV reuse across requests.

Counterpart of ``deeplearning4j_tpu/serving/prefix.py``, the same host
code over numpy (it touches no device memory: the engine copies pages).
Shared system prompts and few-shot prefixes dominate chat traffic, and
SGLang's RadixAttention named the fix: a radix tree over token sequences
whose nodes map to KV **pages** of the paged cache (``serving/cache.py``),
refcounted so one physical page serves every request sharing the prefix.

Layout:

* Interior structure is a **per-page trie**: each node holds exactly ONE
  page and is keyed by that page's ``page_size`` token ids, so a cached
  prefix of ``n`` tokens is a path of ``n // page_size`` full-page nodes.
* A node may additionally hold **partial children** — leaf nodes keyed by
  1..page_size-1 tokens whose page is only partially valid (the tail a
  donor prompt ended in). Sharing a partial page with a slot that will
  write into it is forbidden; the engine **copies it first**
  (:meth:`PagedKVCache.cow_page` — the copy-on-write rule). A FULL node
  can also serve as a CoW tail when a new prompt diverges mid-page: the
  match counts the common tokens and the engine CoWs the page.
* Every node's page carries one tree reference in the cache's refcounts
  (``retain`` at insert, ``release`` at evict/clear), so a page shared by
  the tree and N slots returns to the free list only when the last holder
  lets go.

Policy:

* **Insert / LRU-refresh** happens when a sequence retires complete
  (``eos``/``length``): the engine hands the pages covering its PROMPT to
  :meth:`insert`. Existing nodes are refreshed (and deduplicate — the
  slot's duplicate page is simply released with the slot), new nodes
  retain the slot's pages.
* **Eviction** walks unpinned LEAVES, least-recently-used first, under a
  configurable page budget (``max_pages``) — and on demand
  (:meth:`evict_to_free`) when admission needs pages the free list cannot
  supply. Pinned nodes (pre-warmed per-class system prompts — the
  ``ClassPolicy.shared_prefix`` knob) are never evicted.
* **Clear** (supervisor crash recovery): ``reset_kv`` zeroes the device
  pages, so every cached prefix is garbage — the tree drops wholesale and
  rebuilds from live traffic. Pin INTENTS survive a clear: the next
  insert covering a pinned token sequence re-pins it automatically.

Thread model: the engine's scheduler loop is the only writer
(match/insert/evict/clear); :meth:`pin` may arrive from a frontend
thread. One lock guards all of it — operations are O(prompt) dict walks,
never device work.

Observability: ``dl4j_tpu_prefix_{lookups,hits,hit_tokens,inserted_pages,
evicted_pages,cow_copies}_total`` counters and
``dl4j_tpu_prefix_{tree_pages,pinned_pages}`` gauges;
``prefix_evict``/``prefix_clear`` JSONL events.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.serving.cache import PagedKVCache


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached prefix for a prompt: ``matched`` tokens covered by
    ``pages`` (``matched // page_size`` full pages, plus — when
    ``matched % page_size != 0`` — one tail page the engine must CoW
    before the slot writes into it)."""

    matched: int
    pages: List[int]


class _Node:
    __slots__ = ("tokens", "page", "parent", "children", "partials",
                 "last_used", "pinned", "partial")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], partial: bool):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.partials: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self.pinned = False
        self.partial = partial


def _common_prefix_len(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixPrefixCache:
    """Refcounted radix/trie over token sequences -> KV page runs, layered
    on one :class:`PagedKVCache` (module docstring has the full design)."""

    def __init__(self, cache: PagedKVCache, *, max_pages: int,
                 min_match: Optional[int] = None):
        if max_pages <= 0:
            raise ValueError("max_pages must be positive (0 pages would "
                             "make every insert evict itself — construct "
                             "no prefix cache instead)")
        self.cache = cache
        self.page_size = cache.page_size
        self.max_pages = int(max_pages)
        # a hit below one full page saves almost nothing and costs a CoW
        self.min_match = int(min_match) if min_match else cache.page_size
        self._root = _Node((), -1, None, partial=False)
        self._n_nodes = 0
        self._n_pinned = 0
        self._ticks = 0
        self._pin_intents: set = set()
        self._lock = threading.Lock()
        m = observe.metrics()
        self._c_lookups = m.counter("dl4j_tpu_prefix_lookups_total")
        self._c_hits = m.counter("dl4j_tpu_prefix_hits_total")
        self._c_hit_tokens = m.counter("dl4j_tpu_prefix_hit_tokens_total")
        self._c_inserted = m.counter("dl4j_tpu_prefix_inserted_pages_total")
        self._c_evicted = m.counter("dl4j_tpu_prefix_evicted_pages_total")
        self._c_cow = m.counter("dl4j_tpu_prefix_cow_copies_total")
        self._g_pages = m.gauge("dl4j_tpu_prefix_tree_pages")
        self._g_pinned = m.gauge("dl4j_tpu_prefix_pinned_pages")
        self._g_pages.set(0.0)
        self._g_pinned.set(0.0)

    # -------------------------------------------------------------- internals
    def _tick(self) -> int:
        self._ticks += 1
        return self._ticks

    def _update_gauges(self) -> None:
        self._g_pages.set(float(self._n_nodes))
        self._g_pinned.set(float(self._n_pinned))

    def _all_nodes(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values()) + list(n.partials.values())
            out.extend(kids)
            stack.extend(kids)
        return out

    # ----------------------------------------------------------------- match
    def match(self, prompt,
              max_suffix: Optional[int] = None) -> Optional[PrefixMatch]:
        """Longest cached prefix of ``prompt``, capped at ``len - 1``
        tokens (at least one suffix token always re-prefills, so the
        first-token logits are always computed fresh). Returns None on a
        miss, a match below ``min_match``, or — with ``max_suffix`` (the
        engine's compiled suffix bucket) — a match whose uncached tail
        could not be suffix-prefilled anyway. LRU stamps refresh ONLY on
        a usable match: a path that can never serve hits must not stay
        artificially hot and crowd serving entries out of the budget.
        Counting (lookups/hits) is the ENGINE's job — a match is only a
        hit once admission actually lands."""
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        p = self.page_size
        with self._lock:
            node, path, pages, i = self._root, [], [], 0
            while len(toks) - i >= p:
                child = node.children.get(toks[i:i + p])
                if child is None:
                    break
                path.append(child)
                pages.append(child.page)
                node, i = child, i + p
            matched = i
            # divergence tail: the best partially-matching page at this
            # node — a stored partial tail, or a full child the prompt
            # diverges from mid-page. The engine CoWs it before writing.
            rem = toks[i:]
            best, best_common = None, 0
            for cand in list(node.partials.values()) + \
                    list(node.children.values()):
                common = _common_prefix_len(cand.tokens, rem)
                if common > best_common:
                    best_common, best = common, cand
            if best is not None:
                path.append(best)
                pages.append(best.page)
                matched += best_common
            if matched >= len(toks):  # always leave >= 1 suffix token
                matched = len(toks) - 1
            pages = pages[:-(-matched // p)] if matched else []
            path = path[:len(pages)]  # a trimmed-out tail page serves no
            #                           hit — don't keep its node hot
            if matched < self.min_match:
                return None
            if max_suffix is not None and len(toks) - matched > max_suffix:
                # unusable: a shorter match only grows the suffix, so no
                # usable match exists for this prompt
                return None
            tick = self._tick()
            for n in path:
                n.last_used = tick
            return PrefixMatch(matched=matched, pages=pages)

    # ---------------------------------------------------------------- insert
    def insert(self, prompt, pages: List[int]) -> int:
        """Record a completed prompt's prefix: walk/create nodes for its
        full pages and (if it ends mid-page) one partial tail. ``pages``
        is the slot's page run covering the prompt, position-ordered; the
        tree RETAINS the pages it keeps (the caller's ``free_slot``
        release then leaves them alive), existing nodes deduplicate (the
        slot's copy is simply released with the slot). Returns the number
        of pages newly retained; enforces the page budget by LRU-evicting
        unpinned leaves afterwards."""
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        p = self.page_size
        with self._lock:
            tick = self._tick()
            node, i, pi, inserted = self._root, 0, 0, 0
            while len(toks) - i >= p:
                key = toks[i:i + p]
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, pages[pi], node, partial=False)
                    self.cache.retain(pages[pi])
                    node.children[key] = child
                    self._n_nodes += 1
                    inserted += 1
                child.last_used = tick
                node, i, pi = child, i + p, pi + 1
            rem = toks[i:]
            if rem:
                tail = node.partials.get(rem)
                if tail is None:
                    tail = _Node(rem, pages[pi], node, partial=True)
                    self.cache.retain(pages[pi])
                    node.partials[rem] = tail
                    self._n_nodes += 1
                    inserted += 1
                tail.last_used = tick
            if inserted:
                self._c_inserted.inc(inserted)
            for intent in self._pin_intents:
                if toks[:len(intent)] == intent:
                    self._pin_locked(intent)
            self._evict_over_budget_locked()
            self._update_gauges()
            return inserted

    def note_hit(self, match: PrefixMatch) -> None:
        """Count a match that actually admitted (engine calls this once
        the slot's pages are mapped and the suffix prefill is committed)."""
        self._c_hits.inc()
        self._c_hit_tokens.inc(match.matched)

    def note_lookup(self) -> None:
        self._c_lookups.inc()

    def note_cow(self) -> None:
        self._c_cow.inc()

    # -------------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[_Node]:
        return [n for n in self._all_nodes()
                if not n.children and not n.partials and not n.pinned]

    def _remove_leaf_locked(self, victim: _Node) -> None:
        parent = victim.parent
        if victim.partial:
            del parent.partials[victim.tokens]
        else:
            del parent.children[victim.tokens]
        self.cache.release(victim.page)
        self._n_nodes -= 1
        self._c_evicted.inc()

    def _evict_one_locked(self) -> bool:
        leaves = self._evictable_leaves()
        if not leaves:
            return False
        self._remove_leaf_locked(min(leaves, key=lambda n: n.last_used))
        return True

    def _evict_over_budget_locked(self) -> int:
        evicted = 0
        while self._n_nodes > self.max_pages:
            if not self._evict_one_locked():
                break  # everything left is pinned (or an ancestor of one)
            evicted += 1
        if evicted:
            observe.log_event("prefix_evict", pages=evicted,
                              cause="budget", tree_pages=self._n_nodes)
        return evicted

    def _tree_page_refs_locked(self) -> Dict[int, int]:
        refs: Dict[int, int] = {}
        for n in self._all_nodes():
            refs[n.page] = refs.get(n.page, 0) + 1
        return refs

    def evict_to_free(self, n_pages: int) -> int:
        """Pool-pressure reclaim: evict unpinned LRU leaves until
        ``n_pages`` pages actually reached the free list or nothing
        evictable remains. Leaves whose page the tree alone holds are
        preferred (they free NOW); a leaf an active slot still maps is
        evicted only as a fallback — it frees nothing immediately, but
        it releases the tree's reference (the page frees at slot retire)
        and unblocks freeable ancestors behind it. Returns pages freed.
        The per-evict leaf scans are O(tree); the tree is bounded by
        ``max_pages``, so a whole reclaim batch is budget², not
        pool-sized."""
        with self._lock:
            before = self.cache.free_pages
            refs = self._tree_page_refs_locked()
            while self.cache.free_pages - before < n_pages:
                leaves = self._evictable_leaves()
                if not leaves:
                    break
                freeable = [n for n in leaves
                            if self.cache.refcount[n.page] == refs[n.page]]
                victim = min(freeable or leaves,
                             key=lambda n: n.last_used)
                refs[victim.page] -= 1
                if not refs[victim.page]:
                    del refs[victim.page]
                self._remove_leaf_locked(victim)
            freed = self.cache.free_pages - before
            if freed:
                observe.log_event("prefix_evict", pages=freed,
                                  cause="pool_pressure",
                                  tree_pages=self._n_nodes)
            self._update_gauges()
            return freed

    def reclaimable_pages(self, exclude=()) -> int:
        """Pages pool-pressure eviction could ACTUALLY free right now:
        unpinned nodes in fully-unpinned subtrees (a pinned descendant
        keeps every ancestor resident) whose page has no holder besides
        the tree (a slot-shared page would not reach the free list when
        the tree lets go). ``exclude`` removes pages the caller is about
        to USE — a matched prefix's own pages are supply being consumed,
        not supply eviction can produce; counting them would admit a
        request whose reclaim then frees nothing (and wipes the match as
        collateral) instead of waiting out the pool pressure."""
        excl = set(exclude)
        with self._lock:
            refs = self._tree_page_refs_locked()

            def walk(n: _Node) -> Tuple[int, bool]:
                cnt, fully = 0, True
                for c in list(n.children.values()) + list(n.partials.values()):
                    c_cnt, c_fully = walk(c)
                    cnt += c_cnt
                    fully = fully and c_fully
                if n is self._root:
                    return cnt, fully
                if fully and not n.pinned:
                    freeable = (n.page not in excl
                                and self.cache.refcount[n.page]
                                == refs[n.page])
                    return cnt + (1 if freeable else 0), True
                return cnt, False

            return walk(self._root)[0]

    # ---------------------------------------------------------------- pinning
    def pin(self, prompt, record: bool = True) -> int:
        """Pin the cached path covering ``prompt`` (pre-warmed per-class
        system prompts — never evicted). With ``record``, the intent
        survives :meth:`clear`: the next insert covering these tokens
        re-pins automatically. Returns the number of nodes pinned."""
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        with self._lock:
            if record:
                self._pin_intents.add(toks)
            n = self._pin_locked(toks)
            self._update_gauges()
            return n

    def _pin_locked(self, toks: Tuple[int, ...]) -> int:
        p, node, i, pinned = self.page_size, self._root, 0, 0
        while len(toks) - i >= p:
            child = node.children.get(toks[i:i + p])
            if child is None:
                return pinned
            if not child.pinned:
                child.pinned = True
                self._n_pinned += 1
                pinned += 1
            node, i = child, i + p
        rem = toks[i:]
        if rem:
            # the intent's mid-page remainder: pin the exact tail when
            # present, else ONE node COVERING rem (its tokens extend it —
            # after a clear() the tree rebuilds from traffic, whose
            # divergence tails embed the system prompt's remainder but
            # never equal it). One covering pin suffices to keep the
            # mid-page KV resident and matchable; pinning every covering
            # tail would grow pins without bound.
            cands = [t for key, t in list(node.partials.items())
                     + list(node.children.items())
                     if key[:len(rem)] == rem]
            exact = node.partials.get(rem)
            if exact is not None:
                cands = [exact] + cands
            if cands and not any(t.pinned for t in cands):
                cands[0].pinned = True
                self._n_pinned += 1
                pinned += 1
        return pinned

    # ------------------------------------------------------------------ clear
    def clear(self) -> int:
        """Drop the whole tree, releasing every tree reference (supervisor
        crash recovery: ``reset_kv`` zeroed the device pages, so every
        cached prefix is garbage). Pin INTENTS survive — re-inserted
        pinned prefixes re-pin. Returns pages released."""
        with self._lock:
            nodes = self._all_nodes()
            for n in nodes:
                self.cache.release(n.page)
            self._root.children.clear()
            self._root.partials.clear()
            released = len(nodes)
            self._n_nodes = 0
            self._n_pinned = 0
            self._update_gauges()
            if released:
                observe.log_event("prefix_clear", pages=released)
            return released

    # ------------------------------------------------------------ inspection
    def page_refs(self) -> Dict[int, int]:
        """Per-page tree reference counts (for
        :meth:`PagedKVCache.check_invariants` exact accounting)."""
        with self._lock:
            return self._tree_page_refs_locked()

    @property
    def tree_pages(self) -> int:
        return self._n_nodes

    @property
    def pinned_pages(self) -> int:
        return self._n_pinned

    def check_invariants(self) -> None:
        """Tree soundness (test hook): node/page accounting agrees, every
        tree page is live in the cache (never on the free list), keys
        match node tokens, partial tails are real partials."""
        with self._lock:
            nodes = self._all_nodes()
            assert len(nodes) == self._n_nodes, (
                f"node count drifted: counted {len(nodes)} "
                f"tracked {self._n_nodes}")
            assert sum(1 for n in nodes if n.pinned) == self._n_pinned
            free = set(self.cache.free)
            for n in nodes:
                assert self.cache.refcount[n.page] >= 1, (
                    f"tree node {n.tokens} holds dead page {n.page}")
                assert n.page not in free, (
                    f"tree node {n.tokens} holds FREE page {n.page}")
                if n.partial:
                    assert 0 < len(n.tokens) < self.page_size
                    assert not n.children and not n.partials, (
                        "partial tails must be leaves")
                else:
                    assert len(n.tokens) == self.page_size
                for key, c in list(n.children.items()) + \
                        list(n.partials.items()):
                    assert key == c.tokens and c.parent is n
