"""Relational Tensor Cache (RTC) — §4.3, Table 1.

Unifies caching and memory management for one FLOWSERVE engine:
  * block table / page allocation        (AllocBlocks, AppendBlock, Free)
  * prefix-token radix index             (MatchByPrefixToken)
  * explicit-ID index                    (MatchByID — context-caching endpoint)
  * tiered storage NPU ↔ DRAM            (Copy, Populate, QueryPopulate)
  * a populate cost model: reuse cached KV only when fetching it is
    cheaper than recomputing the prefill (§4.2's "cost model" step)
  * SSM/hybrid archs: prefix entries are recurrent-state checkpoints
    (DESIGN.md §4) rather than per-token pages.

Master/executor split: this class is the master-side index + decision
maker; the data plane is the executor side (the port's torch
``PagedKVPool``). Own copy of ``repro/engine/rtc.py``; only the cost
model's defaults differ (GPU host link and tensor rate).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.engine.kv_cache import OutOfPagesError, PagedKVPool, pages_needed
from repro_torch.engine.radix_tree import RadixTree

_populate_ids = itertools.count()


@dataclass
class CacheEntry:
    """Payload of a radix-tree / ID-index node."""
    n_tokens: int
    location: str                       # "npu" | "dram"
    pages: Optional[List[int]] = None   # when on NPU (attention archs)
    dram_handle: Optional[int] = None   # when swapped out
    state: Any = None                   # SSM state checkpoint (host copy)
    node: Any = None                    # back-pointer to radix node


@dataclass
class MatchResult:
    matched_tokens: int
    entry: Optional[CacheEntry]
    location: str                       # "none" | "npu" | "dram"


@dataclass
class PopulateTicket:
    ticket: int
    entry: CacheEntry
    pages: List[int]
    done: bool = False


@dataclass
class RTCCostModel:
    """Reuse-vs-recompute decision (§4.2). Times in seconds; defaults are
    assumptions for an H100 host (not measurements): half of a PCIe Gen5
    x16 link's 50 GB/s for the DRAM fetch, half of the 989 TFLOP/s bf16
    tensor peak for prefill compute."""
    fetch_bw_bytes: float = 25e9        # DRAM->device populate bandwidth
    prefill_flops_rate: float = 494e12  # achievable prefill FLOP/s (≈50% peak)
    flops_per_token: float = 2e9        # 2·N_active per token; set per model

    def fetch_time(self, n_bytes: int) -> float:
        return n_bytes / self.fetch_bw_bytes

    def recompute_time(self, n_tokens: int) -> float:
        return n_tokens * self.flops_per_token / self.prefill_flops_rate

    def should_fetch(self, n_bytes: int, n_tokens: int) -> bool:
        return self.fetch_time(n_bytes) < self.recompute_time(n_tokens)


class RelationalTensorCache:
    def __init__(self, pool: PagedKVPool, cost_model: Optional[RTCCostModel] = None,
                 state_based: bool = False):
        self.pool = pool
        self.tree = RadixTree()
        self.by_id: Dict[str, CacheEntry] = {}
        self.cost = cost_model or RTCCostModel()
        self.state_based = state_based
        self._pending: Dict[int, PopulateTicket] = {}
        self.stats = {"hits": 0, "misses": 0, "populates": 0, "evictions": 0,
                      "tokens_reused": 0}

    # ----------------------------------------------------------- matching
    def match_by_prefix_token(self, tokens) -> MatchResult:
        matched, path = self.tree.match_prefix(tokens)
        # deepest node on the path with a payload in its subtree; the first
        # `matched` tokens of any such entry equal the query's prefix
        for node in reversed(path):
            entry: Optional[CacheEntry] = node.payload or self.tree.any_payload(node)
            if entry is not None:
                self.stats["hits"] += 1
                return MatchResult(min(matched, entry.n_tokens), entry,
                                   entry.location)
        self.stats["misses"] += 1
        return MatchResult(0, None, "none")

    def match_by_id(self, ctx_id: str) -> MatchResult:
        entry = self.by_id.get(ctx_id)
        if entry is None:
            self.stats["misses"] += 1
            return MatchResult(0, None, "none")
        self.stats["hits"] += 1
        return MatchResult(entry.n_tokens, entry, entry.location)

    # ----------------------------------------------------------- alloc
    def alloc_blocks(self, n_tokens: int) -> List[int]:
        """AllocBlocks — pages for a prefill of n_tokens. Evicts cached
        pages (LRU) on pressure."""
        need = pages_needed(n_tokens, self.pool.page_size)
        self._ensure_free(need)
        return self.pool.alloc(need)

    def append_block(self) -> int:
        """AppendBlock — one page for decode growth."""
        self._ensure_free(1)
        return self.pool.alloc(1)[0]

    def free(self, pages: List[int], keep_cached: bool = False) -> None:
        self.pool.release(pages, keep_cached=keep_cached)

    def _ensure_free(self, need: int) -> None:
        if self.pool.free_page_count() >= need:
            return
        # LRU-evict cached prefix entries until we have room
        for leaf in self.tree.leaves_by_lru():
            if self.pool.free_page_count() >= need:
                break
            entry: CacheEntry = leaf.payload
            if entry.location == "npu" and entry.pages is not None:
                self.pool.release(entry.pages, keep_cached=True)
                self.pool.evict_cached(entry.pages)
                self.stats["evictions"] += 1
                entry.location = "evicted"
                entry.pages = None
                self.tree.remove(leaf)
        if self.pool.free_page_count() < need:
            raise OutOfPagesError(
                f"need {need}, free {self.pool.free_page_count()} after eviction")

    # ----------------------------------------------------------- preserve
    def preserve_prefix(self, tokens, pages: List[int],
                        ctx_id: Optional[str] = None,
                        state: Any = None) -> CacheEntry:
        """Pin a prefill's KV (or SSM state checkpoint) for reuse."""
        entry = CacheEntry(n_tokens=len(tokens), location="npu",
                           pages=list(pages) if pages else None, state=state)
        if pages:
            self.pool.retain(pages)
        node = self.tree.insert(tokens, entry)
        entry.node = node
        if ctx_id is not None:
            self.by_id[ctx_id] = entry
        return entry

    def copy_to_dram(self, entry: CacheEntry) -> None:
        """RTC Copy: swap an NPU-resident entry to the DRAM tier."""
        if entry.location != "npu" or not entry.pages:
            return
        entry.dram_handle = self.pool.copy_to_dram(entry.pages)
        self.pool.release(entry.pages, keep_cached=True)
        self.pool.evict_cached(entry.pages)
        entry.pages = None
        entry.location = "dram"

    # ----------------------------------------------------------- populate
    def populate(self, entry: CacheEntry) -> Optional[PopulateTicket]:
        """Async fetch of a DRAM-tier entry into fresh NPU pages. Returns a
        ticket (completion is pumped by the master loop via
        ``pump_populates``), or None if the cost model rejects the fetch."""
        if entry.location != "dram" or entry.dram_handle is None:
            return None
        n_bytes = self.pool.dram_bytes(entry.dram_handle)
        if not self.cost.should_fetch(n_bytes, entry.n_tokens):
            return None
        need = pages_needed(entry.n_tokens, self.pool.page_size)
        self._ensure_free(need)
        pages = self.pool.alloc(need)
        ticket = PopulateTicket(next(_populate_ids), entry, pages)
        self._pending[ticket.ticket] = ticket
        self.stats["populates"] += 1
        return ticket

    def query_populate(self, ticket: int) -> bool:
        t = self._pending.get(ticket)
        return bool(t and t.done)

    def pump_populates(self) -> List[PopulateTicket]:
        """Master-loop tick: complete pending transfers (the data plane —
        on hardware this is DistFlow DMA finishing asynchronously)."""
        done = []
        for t in list(self._pending.values()):
            if not t.done:
                self.pool.populate_from_dram(t.entry.dram_handle, t.pages)
                t.entry.pages = t.pages
                t.entry.location = "npu"
                self.pool.retain(t.pages)
                self.pool.release(t.pages)  # net: pinned once by the entry
                t.done = True
                done.append(t)
                del self._pending[t.ticket]
        return done

    def reuse(self, entry: CacheEntry, upto_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Pin an NPU-resident entry for a new request; returns
        (#reusable tokens, page run). For state-based archs the reusable
        token count snaps to the entry's checkpoint boundary."""
        if entry.location != "npu":
            return 0, []
        n = entry.n_tokens if upto_tokens is None else min(entry.n_tokens, upto_tokens)
        if self.state_based:
            pass  # state entries are exact-boundary by construction
        if entry.pages:
            # only whole pages up to n tokens are reusable
            ps = self.pool.page_size
            usable_pages = n // ps
            pages = entry.pages[:usable_pages]
            self.pool.retain(pages)
            self.stats["tokens_reused"] += usable_pages * ps
            return usable_pages * ps, pages
        self.stats["tokens_reused"] += n
        return n, []
