"""Fast scaling (§6), torch port of ``repro/core/scaling.py``: the 5-step
pipeline, pre-warmed pods/TEs, DRAM pre-loading, the DRAM-warm pool and
NPU-fork.

Two kinds of thing live here.

* **Cost models, copied as models.** ``ScaleTimings``, ``ModelLoader``,
  ``FastScaler``, ``DRAMPageCache`` and ``tier_seconds`` price the
  paper's bring-up steps with the reference's constants (an Ascend
  cluster's pod creation, NPU init, SSD and PCIe rates, through
  DistFlow's ``BACKENDS``). They are kept unchanged so both packages'
  modelled clocks agree; none of their figures is a measurement of the
  card the port runs on.
* **Real state.** ``WarmPool`` holds host copies of real weights (pinned
  when they came from a card, one copy per distinct storage);
  ``npu_fork_live`` copies every shard of a live TE into new storage on
  the destination mesh, re-split when the two TEs' tp differ.

One difference from the reference: on a single device, the reference's
fork (``jax.device_put`` onto the device the params already live on)
returns the same arrays, so its fork aliases the source's weights. The
port copies, device to device, every time: a fork that shares storage
moves no bytes and frees nothing when it is released.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.engine.distflow import (BACKENDS, BufferInfo, DistFlow,
                                         _fanout_penalty, _nbytes,
                                         map_distinct, tree_leaves, tree_map)
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh


@dataclass
class ScaleTimings:
    """Baseline step latencies (seconds) — Figure 9's 'before' bars."""
    scaler_pre: float = 40.0            # pod creation / resource alloc
    te_pre_load: float = 35.0           # python startup + NPU init + HCCL
    te_pre_load_optimized: float = 22.0  # late-import + parallel init (-35%)
    te_post_load_warmup: float = 12.0   # engine warm-up profiling
    te_post_load_alloc: float = 3.0     # CPU/NPU block allocation
    te_post_load_optimized: float = 0.8  # offline profile + async alloc + dummy req
    scaler_post: float = 5.0            # global TE list propagation
    scaler_post_optimized: float = 0.5  # proactive push
    torch_init: float = 0.3             # tensor init overhead on load


@dataclass
class ModelAsset:
    name: str
    n_bytes: int                        # total weight bytes
    tp: int = 1                         # partitions (each TE loads 1/tp)


class WarmPoolMismatchError(ValueError):
    """A warm-pool entry was requested (or constructed from) under the
    wrong model-asset identity — refusing to silently build a TE from the
    wrong params (DESIGN.md §11)."""


@dataclass
class PreWarmedPod:
    pod_id: str
    busy: bool = False


@dataclass
class PreWarmedTE:
    """Model- and parallelism-agnostic pre-warmed TE (§6.1): Python/NPU/HCCL
    init already done; can be bound to any model + TP/PP/SP layout."""
    te_id: str
    bound_model: Optional[str] = None
    busy: bool = False


def _events(device: torch.device):
    """A started CUDA event pair on ``device`` (None off a card)."""
    if device.type != "cuda":
        return None
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record(torch.cuda.current_stream(device))
    return ev


def _first_device(tree) -> torch.device:
    found = tree_leaves(tree)
    return found[0].device if found else torch.device("cpu")


def copy_to_host(tree):
    """A host copy of a weights tree (a TE's list of rank trees), one copy
    per distinct storage: leaves that share one (a replicated tensor the
    ranks refer to) share their host copy. From a card, the copy lands in
    ONE pinned buffer allocated first (views of it, 256-byte aligned, keep
    the tree's structure), filled by ``non_blocking=True`` copies behind
    one CUDA event pair and waited for once at the end; CPU tensors are
    cloned. Returns ``(host_tree, pin_s, events)``: the host seconds the
    pinned allocation took and the copies' event pair (0.0 and None off a
    card)."""
    dev = _first_device(tree)
    leaves = tree_leaves(tree)
    if dev.type != "cuda":
        host = iter(map_distinct(lambda t: t.detach().clone(), leaves))
        return tree_map(lambda _: next(host), tree), 0.0, None
    srcs: list = []                # the distinct leaves, in order

    def index(t):
        srcs.append(t)
        return len(srcs) - 1
    which = map_distinct(index, leaves)
    offs, total = [], 0
    for t in srcs:
        offs.append(total)
        total += -(-t.nbytes // 256) * 256
    t0 = time.monotonic()
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    pin_s = time.monotonic() - t0
    dsts = [buf[o:o + t.nbytes].view(t.dtype).view(t.shape)
            for o, t in zip(offs, srcs)]
    host = iter([dsts[i] for i in which])
    host_tree = tree_map(lambda _: next(host), tree)
    ev = _events(dev)
    for dst, src in zip(dsts, srcs):
        dst.copy_(src, non_blocking=True)
    ev[1].record(torch.cuda.current_stream(dev))
    ev[1].synchronize()         # the host copy is read by the pool's users
    return host_tree, pin_s, ev


def copy_to_device(rank_trees: list, mesh: EngineMesh):
    """Rank r's tree copied into new storage on rank r's device, for every
    rank of ``mesh``, each ``copy_`` enqueued with ``non_blocking=True`` on
    the device's current stream (the stream the plane steps on; nothing
    waits): a warm bring-up's host-to-device upload (from pinned memory).
    A host tensor that several ranks on one device share is uploaded
    once. Returns ``(new_rank_trees, events)``: the copies' CUDA event
    pair on rank 0's card, else None."""
    ev = _events(mesh.device)
    out: list = [None] * mesh.tp
    for dev in mesh.distinct:
        rs = [r for r, d in enumerate(mesh.devices) if d == dev]
        leaves = [t for r in rs for t in tree_leaves(rank_trees[r])]
        new = iter(map_distinct(lambda t: SH.place(t, dev, copy=True),
                                leaves))
        for r in rs:
            out[r] = tree_map(lambda _: next(new), rank_trees[r])
    if ev is not None:
        ev[1].record(torch.cuda.current_stream(mesh.device))
    return out, ev


class WarmPool:
    """DRAM-warm tier of the cold-start ladder (DESIGN.md §10): host copies
    of REAL weights trees, one entry per model asset, pinned when they
    came from a card.

    A hit turns TE bring-up into a host-to-device copy onto the TE's
    device plus warmup: no model re-init and no deserialization (the
    ``DRAMPageCache`` below models the safetensors FILE cache, which still
    pays tensor-init on load; this pool holds ready tensors). The pool is
    fed two ways: predictive ``put`` by the cluster manager, and RELEASED
    TEs draining their device-resident params back to host instead of
    dropping the bytes. One entry serves ANY number of concurrent
    bring-ups: an upload only reads it, nothing consumes it."""

    def __init__(self, capacity_bytes: float = 64e9):
        self.capacity = capacity_bytes
        self.entries: "OrderedDict[str, Any]" = OrderedDict()
        self.sizes: Dict[str, int] = {}
        self.tags: Dict[str, str] = {}   # entry -> model-asset identity
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_evicted = 0

    def used(self) -> int:
        return sum(self.sizes.values())

    def put(self, name: str, params, host_copy: bool = True,
            tag: Optional[str] = None) -> bool:
        """Keep one asset's params in host memory, LRU-evicting until it
        fits. ``params`` may be device-resident: ``host_copy=True`` copies
        them (into pinned memory when they lie on a card; callers that
        already hold a host copy, e.g. a released TE's drained params,
        pass False). Returns False when the asset alone exceeds capacity
        (dropped, not partially resident). ``tag`` records the model-asset
        identity of the entry (defaults to ``name``); re-putting an
        existing entry under a DIFFERENT tag is an integrity violation and
        raises ``WarmPoolMismatchError``."""
        tag = tag or name
        if name in self.entries:
            if self.tags.get(name, name) != tag:
                raise WarmPoolMismatchError(
                    f"warm-pool entry {name!r} is tagged "
                    f"{self.tags.get(name, name)!r}; refusing re-put under "
                    f"tag {tag!r}")
            self.entries.move_to_end(name)
            return True
        n = _nbytes(params)
        if n > self.capacity:
            return False
        while self.used() + n > self.capacity and self.entries:
            victim, _ = self.entries.popitem(last=False)
            self.evictions += 1
            self.bytes_evicted += self.sizes.pop(victim)
            self.tags.pop(victim, None)
        if host_copy:
            params = copy_to_host(params)[0]
        self.entries[name] = params
        self.sizes[name] = n
        self.tags[name] = tag
        return True

    def get(self, name: str, tag: Optional[str] = None):
        """The host params for ``name`` (hit, refreshes LRU order) or None
        (miss). Hit/miss counters are the accounting the scale-out path
        reports per bring-up tier. Passing ``tag`` asserts the model-asset
        identity the caller is about to build a TE for: a mismatch raises
        ``WarmPoolMismatchError`` instead of silently handing back the
        wrong weights."""
        params = self.entries.get(name)
        if params is None:
            self.misses += 1
            return None
        if tag is not None and self.tags.get(name, name) != tag:
            raise WarmPoolMismatchError(
                f"warm-pool entry {name!r} is tagged "
                f"{self.tags.get(name, name)!r}, not {tag!r} — wrong model "
                f"asset for this bring-up")
        self.hits += 1
        self.entries.move_to_end(name)
        return params

    def hit(self, name: str) -> bool:
        """Non-counting peek (capacity planning / tier pricing)."""
        return name in self.entries

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_evicted": self.bytes_evicted,
                "resident": len(self.entries), "used_bytes": self.used()}


class DRAMPageCache:
    """Host page cache of safetensors-format weights (§6.2). The cluster
    manager pre-loads models predicted to scale."""

    def __init__(self, capacity_bytes: float = 1.5e12):
        self.capacity = capacity_bytes
        self.resident: Dict[str, ModelAsset] = {}

    def used(self) -> float:
        return sum(a.n_bytes for a in self.resident.values())

    def preload(self, asset: ModelAsset) -> bool:
        if asset.name in self.resident:
            return True
        while self.used() + asset.n_bytes > self.capacity and self.resident:
            # evict least-recently preloaded (FIFO is fine for the cache sim)
            self.resident.pop(next(iter(self.resident)))
        if asset.n_bytes > self.capacity:
            return False
        self.resident[asset.name] = asset
        return True

    def hit(self, model: str) -> bool:
        return model in self.resident


@dataclass
class LoadResult:
    path: str                           # "dram_hit" | "dram_miss" | "npu_fork_ici" | "npu_fork_dcn"
    seconds: float
    bytes_moved: int
    params: Any = None                  # live-fork path: the forked tree
    events: Any = None                  # live fork on a card: its copies' CUDA event pair


def npu_fork_live(params: list, cfg, dst_mesh: EngineMesh,
                  source: Optional[DistFlow] = None, link: str = "ici",
                  target_owners=(), contention: float = 1.0):
    """NPU-fork (§6.3, DESIGN.md §7): bring a new TE's weights up from a
    live TE's resident shards (``params``, one tree per source rank)
    instead of re-initializing them.

    Every destination shard of ``dst_mesh`` is copied into new storage on
    its rank's device, device to device, each ``copy_`` non-blocking on
    the stream the plane steps on, and re-split by ``launch.sharding.
    reshard`` when the source's tp and the destination's differ (the
    ``LoadResult``'s ``events`` is the copies' CUDA event pair on a card).
    The transfer is priced as the reference prices it: the whole model's
    bytes (a replicated leaf once) over ``dst_mesh.tp`` parallel "ici"
    links, on ``source``'s DistFlow clock and log when given
    (``link="dcn"`` prices the scale-out fallback over one per-host link),
    so both packages' simulated clocks stay twins. Returns
    ``(forked_rank_trees, LoadResult)``."""
    ev = _events(dst_mesh.device)
    forked = SH.reshard_tree(params, SH.te_param_specs(cfg, len(params)),
                             SH.te_param_specs(cfg, dst_mesh.tp), dst_mesh)
    if ev is not None:
        ev[1].record(torch.cuda.current_stream(dst_mesh.device))
    n = _nbytes(params)
    backend = "ici" if link == "ici" else "dcn"
    links = dst_mesh.tp if backend == "ici" else 1
    if source is not None:
        # charge() advances the source clock AND every linked target's, and
        # the contention multiplier lands in the clock/log too, so the
        # returned seconds and the DistFlow accounting agree
        xfer = source.charge(n, backend, links=links, fanout=contention,
                             peer_owners=tuple(target_owners))
        secs = xfer.sim_seconds
    else:
        spec = BACKENDS[backend]
        secs = spec["lat"] + (n / max(1, links) / spec["bw"]) * contention
    return forked, LoadResult(f"npu_fork_{link}", secs, n, params=forked,
                              events=ev)


def tier_seconds(asset: ModelAsset, tier: str,
                 timings: ScaleTimings = ScaleTimings()) -> float:
    """Modeled TE-Load wall for one bring-up of ``asset`` through a
    cold-start-ladder tier (DESIGN.md §10): ``fork`` = per-shard NPU-fork
    over ICI, ``warm`` = WarmPool hit -> PCIe upload (no tensor init),
    anything else = cold (tensor init + SSD read). This is the reference's
    full-size pricing of the paper's cluster, which ``scale_to(pace=asset)``
    holds each bring-up job to; it is a model, not a figure of the card."""
    per_te = asset.n_bytes / max(1, asset.tp)
    if tier == "fork":
        return per_te / BACKENDS["ici"]["bw"]
    if tier == "warm":
        return per_te / BACKENDS["pcie_dram"]["bw"]
    return timings.torch_init + per_te / BACKENDS["ssd"]["bw"]


class ModelLoader:
    """TE-Load step (§6.2): local loading via PCIe (DRAM hit/miss) or
    NPU-fork over chip-to-chip links from a running TE."""

    def __init__(self, dram: DRAMPageCache, timings: ScaleTimings = ScaleTimings(),
                 warm: Optional[WarmPool] = None):
        self.dram = dram
        self.t = timings
        self.warm = warm

    def local_load(self, asset: ModelAsset, n_parallel_tes: int = 1) -> LoadResult:
        per_te = asset.n_bytes / asset.tp
        if self.warm is not None and self.warm.hit(asset.name):
            # DRAM-warm tier (DESIGN.md §10): ready tensors, no torch init —
            # bring-up is pure PCIe upload bandwidth
            bw = BACKENDS["pcie_dram"]["bw"] / max(1, n_parallel_tes)
            return LoadResult("warm_pool", per_te / bw, int(per_te))
        if self.dram.hit(asset.name):
            bw = BACKENDS["pcie_dram"]["bw"] / max(1, n_parallel_tes)  # PCIe contention
            return LoadResult("dram_hit", self.t.torch_init + per_te / bw, int(per_te))
        bw = BACKENDS["ssd"]["bw"] / max(1, n_parallel_tes)
        self.dram.preload(asset)
        return LoadResult("dram_miss", self.t.torch_init + per_te / bw, int(per_te))

    def npu_fork(self, asset: ModelAsset, source: DistFlow,
                 targets: List[DistFlow], link: str = "ici",
                 source_busy_frac: float = 0.0,
                 payload=None, dst_mesh=None, cfg=None) -> LoadResult:
        """Broadcast weights from a running TE to `targets` (§6.2). Dedicated
        transfer engines keep interference low: `source_busy_frac` models
        prefill/decode contention on the source (Figure 11b/c).

        With a real weights tree in ``payload`` plus ``cfg``, this is the
        LIVE fork: the weights actually move (``npu_fork_live``) instead of
        the byte-counting simulation."""
        if payload is not None and cfg is not None:
            _, lr = npu_fork_live(
                payload, cfg, dst_mesh, source=source, link=link,
                target_owners=tuple(t.owner for t in targets),
                contention=1.0 + 0.15 * source_busy_frac)
            return lr
        per_te = asset.n_bytes / asset.tp
        src = BufferInfo(owner=source.owner, tier="npu",
                         payload=payload if payload is not None else b"\0")
        dsts = [BufferInfo(owner=t.owner, tier="npu", deliver=lambda _p: None)
                for t in targets]
        source.broadcast(src, dsts, backend="ici" if link == "ici" else "dcn")
        bw = BACKENDS["ici" if link == "ici" else "dcn"]["bw"]
        fanout = _fanout_penalty(len(targets))
        contention = 1.0 + 0.15 * source_busy_frac   # AICPU-offloaded: small
        secs = (per_te / bw) * fanout * contention
        return LoadResult(f"npu_fork_{link}", secs, int(per_te) * len(targets))

    def theoretical(self, asset: ModelAsset) -> float:
        return (asset.n_bytes / asset.tp) / BACKENDS["pcie_dram"]["bw"]


@dataclass
class LoadSpreadTrigger:
    """Serving-plane scale-out trigger (DESIGN.md §9): fire when the
    relative load spread across the fleet's TEs stays above ``threshold``
    for ``patience`` consecutive observations. Firing is one-shot per
    breach: the trigger disarms until the spread next drops below the
    threshold — a freshly forked TE joins with zero load, which KEEPS the
    spread high, so re-arming on recovery (not on time) is what prevents a
    fork storm — and ``max_fires`` caps total fires for bounded fleets.

    ``observe`` reports a capacity DEFICIT (how many TEs short the fleet
    is), not a boolean: with ``te_capacity`` set, a burst that needs four
    more TEs requests the whole fork tree in ONE fire instead of one fork
    per re-arm cycle. 0 = don't scale."""

    threshold: float = 0.5              # (max-min)/max relative spread
    patience: int = 8                   # consecutive breached observations
    min_load: float = 1.0               # ignore spread across near-idle TEs
    max_fires: int = 1
    te_capacity: Optional[float] = None  # tokens of work one TE absorbs
    breach_steps: int = 0
    armed: bool = True
    fires: int = 0
    last_deficit: int = 0

    def observe(self, loads: List[float]) -> int:
        """Feed one observation of the fleet's live loads; returns the TE
        deficit — 0 => hold, k >= 1 => scale out by k (the caller forks;
        k > 1 plans a fork tree)."""
        peak = max(loads) if loads else 0.0
        spread = 0.0 if peak < self.min_load \
            else (peak - min(loads)) / peak
        if spread <= self.threshold:
            self.breach_steps = 0
            self.armed = True
            return 0
        if not self.armed or self.fires >= self.max_fires:
            return 0
        self.breach_steps += 1
        if self.breach_steps < self.patience:
            return 0
        self.armed = False
        self.breach_steps = 0
        self.fires += 1
        if self.te_capacity is None:
            deficit = 1
        else:
            want = math.ceil(sum(loads) / max(1e-9, self.te_capacity))
            deficit = max(1, want - len(loads))
        self.last_deficit = deficit
        return deficit


@dataclass
class DrainTrigger:
    """Scale-IN trigger (DESIGN.md §9) — the low-watermark twin of
    ``LoadSpreadTrigger``: fire when the fleet's mean load per live TE
    stays below ``low_watermark`` for ``patience`` consecutive
    observations while more than ``min_serving`` TEs are serving. The
    caller drains one TE (stop admissions -> finish/migrate out -> release
    its device window).

    Firing is one-shot per drain: the trigger disarms when it fires and
    re-arms only when the caller reports the drain COMPLETE (``rearm()``,
    called at RELEASED) or the mean load recovers above the watermark —
    a draining TE's load migrating onto its peers keeps the fleet mean
    low, so time-based re-arming would drain the whole fleet in one idle
    spell. Mutual exclusion with the scale-out trigger is owned by the
    serving plane: neither trigger is even fed while the other's action
    is in flight."""

    low_watermark: float = 2.0          # mean tokens of work per live TE
    patience: int = 8                   # consecutive low observations
    min_serving: int = 1                # never drain below this many TEs
    max_fires: int = 64
    resurge_factor: float = 4.0         # resurgence = mean > factor*watermark
    breach_steps: int = 0
    armed: bool = True
    fires: int = 0

    def observe(self, loads: List[float], n_serving: Optional[int] = None
                ) -> bool:
        """Feed one observation of the live fleet's loads; True => drain one
        TE now. ``n_serving`` defaults to ``len(loads)``."""
        n = len(loads) if n_serving is None else n_serving
        if n <= self.min_serving:
            self.breach_steps = 0
            return False
        mean = sum(loads) / max(1, len(loads))
        if mean > self.low_watermark:
            self.breach_steps = 0
            self.armed = True
            return False
        if not self.armed or self.fires >= self.max_fires:
            return False
        self.breach_steps += 1
        if self.breach_steps < self.patience:
            return False
        self.armed = False
        self.breach_steps = 0
        self.fires += 1
        return True

    def rearm(self) -> None:
        """Report the in-flight drain finished (TE reached RELEASED)."""
        self.armed = True

    def resurgent(self, loads: List[float]) -> bool:
        """Load-resurgence check for drain-CANCEL (DESIGN.md §10): True
        when the mean load across the still-serving TEs has shot past
        ``resurge_factor`` x the low watermark — the capacity being
        drained is needed after all."""
        if not loads:
            return False
        return (sum(loads) / len(loads)
                > self.resurge_factor * self.low_watermark)


@dataclass
class ScaleEvent:
    te_id: str
    steps: Dict[str, float]
    total: float
    path: str


class FastScaler:
    """End-to-end scaling pipeline (Figure 8): Scaler-Pre -> TE-Pre-Load ->
    TE-Load -> TE-Post-Load -> Scaler-Post, with every §6 optimization
    toggleable so Figure 9's before/after is reproducible (modelled
    seconds of the paper's cluster)."""

    def __init__(self, dram: DRAMPageCache, timings: ScaleTimings = ScaleTimings(),
                 n_prewarm_pods: int = 4, n_prewarm_tes: int = 4,
                 warm: Optional[WarmPool] = None):
        self.t = timings
        self.dram = dram
        self.warm = warm
        self.loader = ModelLoader(dram, timings, warm=warm)
        self.pods = [PreWarmedPod(f"pod-{i}") for i in range(n_prewarm_pods)]
        self.tes = [PreWarmedTE(f"pw-te-{i}") for i in range(n_prewarm_tes)]
        self.events: List[ScaleEvent] = []

    def _grab_pod(self) -> Optional[PreWarmedPod]:
        for p in self.pods:
            if not p.busy:
                p.busy = True
                return p
        return None

    def _grab_te(self, model: str) -> Optional[PreWarmedTE]:
        # prefer a pre-warmed TE already bound to this model's DRAM preload
        for te in self.tes:
            if not te.busy and te.bound_model == model:
                te.busy = True
                return te
        for te in self.tes:
            if not te.busy:
                te.busy = True
                return te
        return None

    def scale_one(self, asset: ModelAsset, optimized: bool = True,
                  source: Optional[DistFlow] = None,
                  targets: Optional[List[DistFlow]] = None,
                  link: str = "ici", n_parallel: int = 1,
                  preloaded: Optional[LoadResult] = None) -> ScaleEvent:
        """Run the 5-step pipeline. ``preloaded`` lets a caller that already
        executed the TE-Load step (the serving plane's live
        ``FlowServe.fork_from``, DESIGN.md §9) price the pipeline around it
        without charging the transfer fabric twice."""
        steps: Dict[str, float] = {}
        # 1. Scaler-Pre
        pod = self._grab_pod() if optimized else None
        steps["scaler_pre"] = 0.2 if pod is not None else self.t.scaler_pre
        # 2. TE-Pre-Load
        te = self._grab_te(asset.name) if optimized else None
        if te is not None:
            steps["te_pre_load"] = 0.5                    # pool hit
        else:
            steps["te_pre_load"] = (self.t.te_pre_load_optimized if optimized
                                    else self.t.te_pre_load)
        # 3. TE-Load
        if preloaded is not None:
            lr = preloaded
        elif source is not None and targets:
            lr = self.loader.npu_fork(asset, source, targets, link=link)
        else:
            lr = self.loader.local_load(asset, n_parallel_tes=n_parallel)
        steps["te_load"] = lr.seconds
        # 4. TE-Post-Load
        steps["te_post_load"] = (self.t.te_post_load_optimized if optimized else
                                 self.t.te_post_load_warmup + self.t.te_post_load_alloc)
        # 5. Scaler-Post
        steps["scaler_post"] = (self.t.scaler_post_optimized if optimized
                                else self.t.scaler_post)
        ev = ScaleEvent(te_id=te.te_id if te else f"cold-te-{len(self.events)}",
                        steps=steps, total=sum(steps.values()), path=lr.path)
        self.events.append(ev)
        return ev

    def release(self, te_id: str) -> None:
        for te in self.tes:
            if te.te_id == te_id:
                te.busy = False
        for p in self.pods:
            p.busy = False
