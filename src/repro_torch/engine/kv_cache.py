"""Paged KV cache with tiered storage (RTC's data plane), torch port of
``repro/engine/kv_cache.py``.

The device tier is a global page pool stacked over attention layers,
held per rank of the TE's mesh (``launch/mesh.py``): ``k[r]`` / ``v[r]``
are rank r's (L, n_pages, page_size, Hkv/tp, hd) tensors on its device,
holding KV heads [r Hkv/tp, (r+1) Hkv/tp) when attention shards (tp 1:
one rank, every head). When attention replicates (its heads do not
divide tp) the replicated attention runs once, on rank 0, and so the pool
is stored once, on rank 0's device, every rank referring to it. The page
allocator is single: every rank uses the same page ids.

The runner writes the pool IN PLACE (``index_put_``) where the JAX package
donates the pool to each jit and gets a new one back. The DRAM tier holds
swapped-out page runs as pinned host tensors (plain host tensors when the
pool lives on the CPU). Page runs (``gather``, ``gather_device``,
``scatter_run``) carry a sequence's KV between TEs for PD disaggregation:
a run is a list of per-rank runs, each of its pool's rank (L, NP_run, P,
Hkv/tp, hd), and stays on the device end to end. Everything that copies
or counts a run's bytes goes through ``distflow.map_distinct``, so a
replicated run is copied and counted once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.distflow import _nbytes, map_distinct
from repro_torch.engine.hotloop import to_device
from repro_torch.launch.mesh import EngineMesh
from repro_torch.launch.sharding import (engine_kv_pool_spec,
                                         engine_kv_run_spec)


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
    """Global device-tier KV pool for the attention layers of one engine,
    one per rank of its mesh."""

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int,
                 dtype: torch.dtype, mesh: EngineMesh):
        self.cfg = cfg
        self.n_layers = sum(1 for k in cfg.layer_kinds()
                            if k.startswith("attn"))
        self.page_size = page_size
        self.n_pages = n_pages
        self.mesh = mesh
        # rank 0's device: the allocator's and the hot state's side
        self.device = mesh.device
        # the split dimension of every rank's pool: 3 (KV heads) or None
        self.spec = engine_kv_pool_spec(cfg, mesh.tp)
        # the ranks whose pools are distinct storage
        self.ranks = list(range(mesh.tp)) if self.spec is not None else [0]
        heads = cfg.n_kv_heads // len(self.ranks)
        shape = (max(self.n_layers, 1), n_pages, page_size, heads,
                 cfg.head_dim)
        # zeros, not empty: the kernels read whole pages and mask the tail
        # by select, so every slot must hold a finite value
        own = {r: (torch.zeros(shape, dtype=dtype, device=mesh.devices[r]),
                   torch.zeros(shape, dtype=dtype, device=mesh.devices[r]))
               for r in self.ranks}
        owner = [r if r in own else 0 for r in range(mesh.tp)]
        self.k: List[torch.Tensor] = [own[o][0] for o in owner]
        self.v: List[torch.Tensor] = [own[o][1] for o in owner]
        self._free: List[int] = list(range(n_pages))
        self._refs: Dict[int, PageRef] = {}
        # DRAM tier: handle -> (k, v) per-rank lists of host runs (L,
        # NP_run, P, Hkv/tp, hd), one host copy per distinct pool
        self.dram: Dict[int, Tuple[list, list]] = {}
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
    def _run_index(self, pages: List[int]) -> Dict[torch.device,
                                                   torch.Tensor]:
        """A page list as a device index on each of the mesh's devices,
        uploaded without draining the stream."""
        idx = to_device(np.asarray(pages, np.int64), self.device)
        return dict(zip(self.mesh.devices, self.mesh.broadcast(idx)))

    def gather(self, pages: List[int]) -> Tuple[list, list]:
        """The page run of ``pages`` copied to host memory (the v1 host
        round trip of a migration), one copy per distinct run."""
        k, v = self.gather_device(pages)
        return map_distinct(torch.Tensor.cpu, k), \
            map_distinct(torch.Tensor.cpu, v)

    def gather_device(self, pages: List[int]) -> Tuple[list, list]:
        """The page run of ``pages`` as new device tensors, one per rank
        (L, NP_run, P, Hkv/tp, hd): one ``index_select`` per distinct pool,
        enqueued on the current stream, so a later write to those pages
        (their next owner's) runs after the gather has read them."""
        idx = self._run_index(pages)
        return tuple(map_distinct(lambda t: t.index_select(1, idx[t.device]),
                                  pools) for pools in (self.k, self.v))

    def scatter_run(self, pages: List[int], k_run: list, v_run: list,
                    layer_start: int = 0) -> None:
        """Write a page run, in this pool's layout (one run per rank), into
        ``pages`` in place: layers [layer_start, layer_start + L_run) of
        every distinct pool (a layer chunk of a migration)."""
        if not pages:
            return
        idx = self._run_index(pages)
        for r in self.ranks:
            i = idx[self.mesh.devices[r]]
            l1 = layer_start + k_run[r].shape[0]
            self.k[r][layer_start:l1].index_copy_(
                1, i, k_run[r].to(self.k[r].dtype))
            self.v[r][layer_start:l1].index_copy_(
                1, i, v_run[r].to(self.v[r].dtype))

    def run_sharding(self):
        """Where a page run bound for this pool must land: this pool's mesh
        and a run's head split there (``engine_kv_run_sharding``)."""
        return self.mesh, engine_kv_run_spec(self.cfg, self.mesh.tp)

    # ------------------------------------------------------------- tiers
    def copy_to_dram(self, pages: List[int]) -> int:
        """RTC `Copy`: device → DRAM, one host run per distinct pool.
        Returns a DRAM handle."""
        idx = self._run_index(pages)
        pin = self.device.type == "cuda"

        def to_host(pool):
            run = pool[:, idx[pool.device]]
            host = torch.empty(run.shape, dtype=run.dtype, pin_memory=pin)
            host.copy_(run)
            return host
        handle = self._dram_next
        self._dram_next += 1
        self.dram[handle] = (map_distinct(to_host, self.k),
                             map_distinct(to_host, self.v))
        return handle

    def populate_from_dram(self, handle: int, pages: List[int]) -> None:
        """RTC `Populate` data plane: DRAM → device into allocated pages,
        every distinct pool."""
        k_host, v_host = self.dram[handle]
        idx = self._run_index(pages)
        n = len(pages)
        for r in self.ranks:
            dev = self.mesh.devices[r]
            self.k[r][:, idx[dev]] = k_host[r][:, :n].to(dev,
                                                         non_blocking=True)
            self.v[r][:, idx[dev]] = v_host[r][:, :n].to(dev,
                                                         non_blocking=True)

    def dram_bytes(self, handle: int) -> int:
        return _nbytes(self.dram[handle])

    def drop_dram(self, handle: int) -> None:
        self.dram.pop(handle, None)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return (n_tokens + page_size - 1) // page_size
