"""DistFlow — §4.4: point-to-point and M:N tensor transfer between engines
(torch port of ``repro/engine/distflow.py``).

Control plane: ``link_cluster`` builds peer groups (the M:N prefill <->
decode channels of §4.6). Data plane: ``transfer(src_info, dst_info)`` on
whole payloads (the v1 path) and ``transfer_sharded`` on device-resident
page runs that never pass through the host (the v2 path).

Every transfer is priced on a simulated clock by a ``BACKENDS`` entry, and
both endpoints' clocks advance by the same amount. These prices are the
reference's model of a simulated fabric (its Ascend/TPU analogues: "ici"
for scaled-up links, "dcn" for the scale-out network, "memcpy" for shared
memory, and the host tiers); they are kept unchanged so that the two
packages' simulated clocks agree on the same byte counts. They are not a
figure of the card the port runs on, and nothing here measures the card:
the device time of a migration is read with CUDA events by whoever wants
it (``chip_smoke.py`` phase 5).

``transfer_sharded`` splits a run (one run per source rank) into layer
chunks, puts each chunk in the destination pool's layout and records a
CUDA event after it. On one card at one layout source and destination
share the device, so the move is a no-op and the gather that built the
run was the move; across cards it is a peer copy, and between two tp the
KV heads are re-split in flight.
Every engine enqueues on the default stream, and so does DistFlow: the
gather is ordered before any later write to the source pages, and the
importer's stream waits on each chunk's event (``wait_chunk``) with no
host sync.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.sharding import reshard

BACKENDS = {
    "ici": {"bw": 50e9, "lat": 1e-6},
    "dcn": {"bw": 25e9, "lat": 10e-6},
    "memcpy": {"bw": 400e9, "lat": 0.5e-6},
    "pcie_dram": {"bw": 25e9, "lat": 5e-6},
    "ssd": {"bw": 3e9, "lat": 100e-6},
}

_xfer_ids = itertools.count()


class TransferFault(RuntimeError):
    """Transient wire failure: the transfer did NOT happen (no bytes
    charged, nothing delivered). Callers restore both endpoints' request
    state and retry."""


@dataclass
class BufferInfo:
    """src/dst descriptor: owner engine id, memory tier, opaque buffer."""
    owner: str
    tier: str                      # "npu" | "dram" | "ssd"
    payload: Any = None            # tensors / nested dict (src side)
    deliver: Optional[Callable[[Any], None]] = None  # dst side sink


@dataclass
class Transfer:
    xfer_id: int
    n_bytes: int
    backend: str
    sim_seconds: float
    wall_seconds: float
    done: bool = True
    links: int = 1                 # parallel fabric links priced


@dataclass
class MigrationHandle:
    """An asynchronous page-run migration. Every chunk's copy is already
    enqueued, so the source is free at once.

      * ``wait_chunk(i)`` — the caller's current stream waits on chunk
        ``i``'s event (no host sync); returns ``(layer_start, k, v)``. An
        importer scatters each layer chunk behind its own event.
      * ``chunk_ready(i)`` — a non-blocking query of that event.
      * ``wait()`` — every chunk, as ``{"chunks": [...]}``.
    ``xfer.done`` flips once every chunk has been waited on or seen ready.
    CPU chunks carry no event and are always ready."""
    xfer: Transfer
    chunks: List[Tuple[int, Any, Any]]
    events: List[Optional[Any]]
    landed: List[bool] = None
    src_owner: str = ""
    dst_owner: str = ""

    def __post_init__(self):
        if self.landed is None:
            self.landed = [False] * len(self.chunks)

    def _land(self, i: int) -> None:
        self.landed[i] = True
        if all(self.landed):
            self.xfer.done = True

    def wait_chunk(self, i: int) -> Tuple[int, Any, Any]:
        ev = self.events[i]
        if ev is not None:
            for dev in {t.device for t in self.chunks[i][1]}:
                torch.cuda.current_stream(dev).wait_event(ev)
        self._land(i)
        return self.chunks[i]

    def chunk_ready(self, i: int) -> bool:
        if self.landed[i]:
            return True
        ev = self.events[i]
        if ev is None or ev.query():
            self._land(i)
            return True
        return False

    def wait(self) -> Dict[str, Any]:
        for i in range(len(self.chunks)):
            self.wait_chunk(i)
        return {"chunks": self.chunks}

    @property
    def n_bytes(self) -> int:
        return self.xfer.n_bytes


def _storage_key(t: torch.Tensor):
    """What makes two tensors the same bytes: device, first element's
    address and size (a tensor without storage, on the meta device, is
    only itself)."""
    return (t.device, t.data_ptr() or id(t), t.nbytes)


def map_distinct(fn, tensors: List[torch.Tensor]) -> list:
    """``fn`` over each distinct storage among ``tensors`` once, in order;
    entries that share a storage (a replicated tensor the ranks on one
    device refer to) share the result. The one place the port decides
    what counts once: DistFlow's byte counts, host copies of page runs,
    the DRAM tier and the warm pool all go through it."""
    done: Dict[Any, Any] = {}
    out = []
    for t in tensors:
        key = _storage_key(t)
        if key not in done:
            done[key] = fn(t)
        out.append(done[key])
    return out


def _nbytes(x) -> int:
    """Bytes of a payload, summed over its leaves (dict values, list and
    tuple items) as the reference sums a pytree's: a tensor's or array's
    ``nbytes`` (no copy to the host), any other leaf's as a numpy scalar.
    A storage that several leaves refer to counts once, as the reference
    counts a replicated global array once (``map_distinct``)."""
    leaves: list = []
    _leaves(x, leaves)
    tensors = [t for t in leaves if torch.is_tensor(t)]
    seen = {_storage_key(t): int(t.nbytes) for t in tensors}
    return sum(seen.values()) + sum(_leaf_nbytes(v) for v in leaves
                                    if not torch.is_tensor(v))


def _leaf_nbytes(v) -> int:
    nb = getattr(v, "nbytes", None)
    return int(nb) if nb is not None else int(np.asarray(v).nbytes)


def _leaves(x, out: list) -> None:
    if x is None:
        return
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)


def tree_map(fn, tree):
    """``fn`` over every leaf of a weights tree (nested dicts and lists,
    tensors at the leaves), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a weights tree, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _fanout_penalty(n_dsts: int) -> float:
    """Tree-broadcast depth penalty."""
    return 1.0 + 0.1 * max(0, math.ceil(math.log2(max(n_dsts, 1))))


class DistFlow:
    """One DistFlow endpoint per engine; linked peers share a registry."""

    def __init__(self, owner: str, default_backend: str = "ici"):
        self.owner = owner
        self.default_backend = default_backend
        self.peers: Dict[str, "DistFlow"] = {}
        self.log: List[Transfer] = []
        self.sim_clock = 0.0
        # fault-injection hook (src_owner, dst_owner, n_bytes) -> None,
        # raising TransferFault BEFORE any bytes move
        self.fault_hook: Optional[Callable[[str, str, int], None]] = None

    # -------------------------------------------------------- control
    def link_cluster(self, peers: List["DistFlow"]) -> None:
        """LinkCluster: establish an M:N peer group (symmetric)."""
        for p in peers:
            if p.owner == self.owner:
                continue
            self.peers[p.owner] = p
            p.peers[self.owner] = self

    # -------------------------------------------------------- accounting
    def charge(self, n_bytes: int, backend: str, *, links: int = 1,
               fanout: float = 1.0, peer_owners: Tuple[str, ...] = (),
               wall: float = 0.0, done: bool = True) -> Transfer:
        """Price a transfer and advance BOTH endpoints' clocks. Latency is
        charged once: chunks pipeline their launch latency behind the
        previous chunk's wire time."""
        spec = BACKENDS[backend]
        links = max(1, links)
        sim = spec["lat"] + (n_bytes / links / spec["bw"]) * fanout
        self.sim_clock += sim
        for owner in set(peer_owners):
            peer = self.peers.get(owner)
            if peer is not None and peer is not self:
                peer.sim_clock += sim
        xfer = Transfer(next(_xfer_ids), n_bytes, backend, sim, wall,
                        done=done, links=links)
        self.log.append(xfer)
        return xfer

    # -------------------------------------------------------- data (v1)
    def transfer(self, src: BufferInfo, dst: BufferInfo,
                 backend: Optional[str] = None) -> Transfer:
        """Hand src.payload to dst.deliver and charge its bytes."""
        backend = backend or self._pick_backend(src, dst)
        if self.fault_hook is not None:
            self.fault_hook(src.owner, dst.owner, _nbytes(src.payload))
        t0 = time.monotonic()
        payload = src.payload
        if dst.deliver is not None:
            dst.deliver(payload)
        return self.charge(_nbytes(payload), backend,
                           peer_owners=(dst.owner,),
                           wall=time.monotonic() - t0)

    def broadcast(self, src: BufferInfo, dsts: List[BufferInfo],
                  backend: Optional[str] = None) -> List[Transfer]:
        """One-to-many transfer, priced as a single tree traversal; every
        destination's clock advances by it."""
        backend = backend or self.default_backend
        spec = BACKENDS[backend]
        t0 = time.monotonic()
        n = _nbytes(src.payload)
        for d in dsts:
            if d.deliver is not None:
                d.deliver(src.payload)
        wall = time.monotonic() - t0
        sim = spec["lat"] + (n / spec["bw"]) * _fanout_penalty(len(dsts))
        self.sim_clock += sim
        out = []
        for d in dsts:
            peer = self.peers.get(d.owner)
            if peer is not None and peer is not self:
                peer.sim_clock += sim
            out.append(Transfer(next(_xfer_ids), n, backend, sim, wall))
        self.log.extend(out)
        return out

    # -------------------------------------------------------- data (v2)
    def transfer_sharded(self, kv: Dict[str, Any], dst_owner: str, *,
                         src_dim, dst, src_tp: int, dst_tp: int,
                         layer_chunks: int = 4,
                         backend: Optional[str] = None) -> MigrationHandle:
        """Device-resident page-run transfer (DistFlow v2). ``kv`` holds
        runs ``{"k", "v"}``, one per source rank (L, NP_run, P, Hkv/tp,
        hd), split on ``src_dim`` (None: one run the ranks share). They go
        in ``layer_chunks`` layer-contiguous chunks onto ``dst`` = (mesh,
        head split) of the destination pool (``run_sharding``), each chunk
        re-split by ``launch.sharding.reshard`` when the layouts differ
        (P at tp 4 -> D at tp 2 joins adjacent head shards pairwise) and
        left as it is when it already lies where it must; an event is
        recorded after each chunk. Priced per parallel link: min(src_tp,
        dst_tp) "ici" links each carry bytes/links, a replicated run
        counted once. Returns the handle at once; nothing waits."""
        backend = backend or self.default_backend
        if self.fault_hook is not None:
            self.fault_hook(self.owner, dst_owner, _nbytes([kv["k"], kv["v"]]))
        t0 = time.monotonic()
        k, v = kv["k"], kv["v"]
        dst_mesh, dst_dim = dst
        n_layers = int(k[0].shape[0])
        step = max(1, -(-n_layers // max(1, layer_chunks)))
        chunks: List[Tuple[int, Any, Any]] = []
        events: List[Optional[Any]] = []
        for l0 in range(0, n_layers, step):
            kc, vc = ([t[l0:l0 + step] for t in runs] for runs in (k, v))
            kc, vc = (reshard(c, src_dim, dst_dim, dst_mesh, copy=False)
                      for c in (kc, vc))
            ev = None
            if kc[0].is_cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(kc[0].device))
            chunks.append((l0, kc, vc))
            events.append(ev)
        links = max(1, min(src_tp, dst_tp)) if backend == "ici" else 1
        xfer = self.charge(_nbytes([k, v]), backend, links=links,
                           peer_owners=(dst_owner,),
                           wall=time.monotonic() - t0, done=False)
        return MigrationHandle(xfer=xfer, chunks=chunks, events=events,
                               src_owner=self.owner, dst_owner=dst_owner)

    def _pick_backend(self, src: BufferInfo, dst: BufferInfo) -> str:
        if src.tier == "dram" and dst.tier == "npu":
            return "pcie_dram"
        if src.tier == "npu" and dst.tier == "dram":
            return "pcie_dram"
        if src.tier == "ssd" or dst.tier == "ssd":
            return "ssd"
        if src.owner == dst.owner:
            return "memcpy"
        return self.default_backend

    # -------------------------------------------------------- stats
    def bytes_moved(self) -> int:
        return sum(t.n_bytes for t in self.log)
