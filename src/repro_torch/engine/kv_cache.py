"""Paged KV cache with tiered storage (RTC's data plane), torch port of
``repro/engine/kv_cache.py``.

The device tier is a global page pool: k/v tensors of shape
(L, n_pages, page_size, Hkv, hd) stacked over attention layers. The runner
writes it IN PLACE (``index_put_``) where the JAX package donates the pool
to each jit and gets a new one back. The DRAM tier holds swapped-out page
runs as pinned host tensors (plain host tensors when the pool lives on the
CPU). Page runs (``gather``, ``gather_device``, ``scatter_run``) carry a
sequence's KV between TEs for PD disaggregation: a run has the pool's
rank, (L, NP_run, P, Hkv, hd), and stays on the device end to end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.hotloop import to_device


class OutOfPagesError(RuntimeError):
    pass


@dataclass
class PageRef:
    """ref_count>0 pages are pinned (shared via prefix cache); cached pages
    are retained for reuse after release and reclaimed under pressure."""
    page_id: int
    ref_count: int = 0
    cached: bool = False


class PagedKVPool:
    """Global device-tier KV pool for the attention layers of one engine."""

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int,
                 dtype: torch.dtype, device: torch.device):
        self.cfg = cfg
        self.n_layers = sum(1 for k in cfg.layer_kinds()
                            if k.startswith("attn"))
        self.page_size = page_size
        self.n_pages = n_pages
        self.device = torch.device(device)
        shape = (max(self.n_layers, 1), n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        # zeros, not empty: the kernels read whole pages and mask the tail
        # by select, so every slot must hold a finite value
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(n_pages))
        self._refs: Dict[int, PageRef] = {}
        # DRAM tier: handle -> (k, v) host tensors (L, NP_run, P, Hkv, hd)
        self.dram: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._dram_next = 0
        # the padding sink (DESIGN.md §8): bucket-padding rows and tokens
        # write their KV here and nothing reads it. Pinned at construction
        # so every later step can rely on it.
        self._scratch = self.alloc(1)[0]

    # ------------------------------------------------------------- alloc
    def free_page_count(self) -> int:
        return len(self._free)

    def scratch_page(self) -> int:
        """The permanently pinned sink page for padding writes."""
        return self._scratch

    def alloc(self, n: int) -> List[int]:
        if len(self._free) < n:
            raise OutOfPagesError(f"need {n} pages, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = PageRef(p, ref_count=1)
        return pages

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            self._refs[p].ref_count += 1

    def release(self, pages: List[int], keep_cached: bool = False) -> List[int]:
        """Drop a reference; zero-ref pages are kept cached (evictable) or
        returned to the free list. Returns freed page ids."""
        freed = []
        for p in pages:
            ref = self._refs[p]
            ref.ref_count -= 1
            if ref.ref_count <= 0:
                if keep_cached:
                    ref.cached = True
                    ref.ref_count = 0
                else:
                    del self._refs[p]
                    self._free.append(p)
                    freed.append(p)
        return freed

    def evict_cached(self, pages: List[int]) -> None:
        for p in pages:
            ref = self._refs.get(p)
            if ref is not None and ref.cached and ref.ref_count == 0:
                del self._refs[p]
                self._free.append(p)

    def reclaimable(self) -> List[int]:
        return [p for p, r in self._refs.items() if r.cached and r.ref_count == 0]

    # ------------------------------------------------------------- runs
    def _run_index(self, pages: List[int]) -> torch.Tensor:
        """A page list as a device index, uploaded without draining the
        stream."""
        return to_device(np.asarray(pages, np.int64), self.device)

    def gather(self, pages: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The page run of ``pages`` copied to host memory (the v1 host
        round trip of a migration)."""
        k, v = self.gather_device(pages)
        return k.cpu(), v.cpu()

    def gather_device(self, pages: List[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The page run of ``pages`` as new device tensors (L, NP_run, P,
        Hkv, hd): one ``index_select`` per pool, enqueued on the current
        stream, so a later write to those pages (their next owner's) runs
        after the gather has read them."""
        idx = self._run_index(pages)
        return self.k.index_select(1, idx), self.v.index_select(1, idx)

    def scatter_run(self, pages: List[int], k_run: torch.Tensor,
                    v_run: torch.Tensor, layer_start: int = 0) -> None:
        """Write a page run into ``pages`` in place: layers [layer_start,
        layer_start + L_run) of the pool (a layer chunk of a migration)."""
        if not pages:
            return
        idx = self._run_index(pages)
        l1 = layer_start + k_run.shape[0]
        self.k[layer_start:l1].index_copy_(1, idx, k_run.to(self.k.dtype))
        self.v[layer_start:l1].index_copy_(1, idx, v_run.to(self.v.dtype))

    def run_sharding(self) -> torch.device:
        """Where a page run bound for this pool must land: the pool's
        device (one device per TE, so a run carries no sharding)."""
        return self.device

    # ------------------------------------------------------------- tiers
    def _index(self, pages: List[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.long, device=self.device)

    def copy_to_dram(self, pages: List[int]) -> int:
        """RTC `Copy`: device → DRAM. Returns a DRAM handle."""
        idx = self._index(pages)
        pin = self.device.type == "cuda"
        out = []
        for pool in (self.k, self.v):
            run = pool[:, idx]
            host = torch.empty(run.shape, dtype=run.dtype, pin_memory=pin)
            host.copy_(run)
            out.append(host)
        handle = self._dram_next
        self._dram_next += 1
        self.dram[handle] = (out[0], out[1])
        return handle

    def populate_from_dram(self, handle: int, pages: List[int]) -> None:
        """RTC `Populate` data plane: DRAM → device into allocated pages."""
        k_host, v_host = self.dram[handle]
        idx = self._index(pages)
        n = len(pages)
        self.k[:, idx] = k_host[:, :n].to(self.device, non_blocking=True)
        self.v[:, idx] = v_host[:, :n].to(self.device, non_blocking=True)

    def dram_bytes(self, handle: int) -> int:
        k_host, v_host = self.dram[handle]
        return (k_host.numel() * k_host.element_size()
                + v_host.numel() * v_host.element_size())

    def drop_dram(self, handle: int) -> None:
        self.dram.pop(handle, None)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return (n_tokens + page_size - 1) // page_size
