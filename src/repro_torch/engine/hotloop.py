"""Device-resident decode-batch state for the hot loop (torch port of
``repro/engine/hotloop.py``, DESIGN.md §8).

One persistent set of device tensors that the fused decode horizon
carries forward:

  * ``bt``       (Bb, Pb) int32 — bucketed block table; padding entries
                 point at the pool's scratch page.
  * ``lengths``  (Bb,) int32 — advanced on the device each decode step.
  * ``last_tok`` (Bb,) int32 — the sampler's output feeds the next step.
  * ``active``   (Bb,) bool — real rows vs bucket padding.
  * ``temps``/``top_ps`` (Bb,) f32 — per-row sampling params.
  * ``gen``      — the torch.Generator of the stochastic draws.

On a tensor-parallel TE these O(batch) vectors live once, on rank 0's
device (``launch.sharding.engine_decode_state_device``), where sampling
runs on the gathered logits; each rank reads the block table and lengths
through the mesh once per decode step.

Buckets are powers of two. Batch events (join, leave, page growth) are
incremental scatters into these tensors; a step with no event costs the
host nothing but the horizon's launches. A host mirror of ``temps`` lets
the runner pick the all-greedy shortcut without reading the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.sharding import engine_decode_state_device

Row = Tuple[str, List[int], int, int, float, float]
#     (seq_id, pages, length, last_tok, temperature, top_p)


def to_device(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``, without draining the stream.
    On a card the copy goes from pinned memory with ``non_blocking=True``:
    PyTorch's pinned caching allocator records the copy on the stream and
    keeps the staging block until it has run (a copy from pageable memory
    would synchronize the stream). On the CPU the tensor is the array's
    own, as before."""
    t = torch.as_tensor(np.asarray(arr), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, arr) -> None:
    """Copy a host array into ``dst`` in place, without draining the
    stream (from pinned memory, non-blocking, on a card)."""
    t = torch.as_tensor(np.asarray(arr), dtype=dst.dtype)
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)


def pack_i32(*arrays) -> np.ndarray:
    """Host arrays as one flat int32 array, in order (the layout
    ``split_views`` cuts)."""
    return np.concatenate([np.asarray(a, np.int32).reshape(-1)
                           for a in arrays])


def split_views(buf: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Views of consecutive runs of the flat ``buf``, one per shape."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(buf[off:off + n].view(tuple(shape)))
        off += n
    return out


def i32_buffer(shapes, device) -> torch.Tensor:
    """A zeroed flat int32 buffer holding one run per shape (the layout
    ``split_views`` cuts and ``pack_i32`` fills)."""
    return torch.zeros((sum(int(np.prod(sh)) for sh in shapes),),
                       dtype=torch.int32, device=device)


def upload_i32(device, *arrays) -> List[torch.Tensor]:
    """Host int32 arrays -> device views, in ONE host-to-device copy that
    does not drain the stream."""
    return split_views(to_device(pack_i32(*arrays), device),
                       [np.shape(a) for a in arrays])


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def pow2s(cap: int) -> List[int]:
    """Every power-of-two bucket up to (and including) pow2_bucket(cap)."""
    out, b = [], 1
    while b <= pow2_bucket(max(1, cap)):
        out.append(b)
        b *= 2
    return out


class DecodeHotState:
    """Persistent on-device decode-batch metadata + host-side slot map."""

    def __init__(self, pool, gen: torch.Generator):
        self.pool = pool
        self.device = engine_decode_state_device(pool.mesh)
        self.scratch = pool.scratch_page()  # padding rows' KV write sink
        self.gen = gen
        self.bb = 0                         # batch bucket (rows)
        self.pb = 0                         # page bucket (block-table cols)
        self.seq_ids: List[Optional[str]] = []
        self.npages: List[int] = []
        self.slot_of: Dict[str, int] = {}
        self.bt = self.lengths = self.last_tok = None
        self.active = self.temps = self.top_ps = None
        self.temps_host = np.zeros((0,), np.float32)
        self.event_dispatches = 0   # device scatters spent on batch events
        self._force_rebuild = True

    @property
    def all_greedy(self) -> bool:
        return not bool((self.temps_host > 0.0).any())

    # ------------------------------------------------------------ helpers
    def _t(self, arr, dtype) -> torch.Tensor:
        return to_device(arr, self.device, dtype)

    def _set(self, name: str, idx, values, dtype) -> None:
        getattr(self, name)[self._t(idx, torch.long)] = self._t(values, dtype)
        self.event_dispatches += 1

    def reset(self) -> None:
        """Declare the device rows stale: the next sync rebuilds every row
        from host values."""
        self._force_rebuild = True

    def evict(self, seq_id: str) -> None:
        """Release a sequence's row now (finish / release), so a reused id
        joins fresh instead of aliasing the stale row. Safe with a horizon
        in flight: launches already queued read the old values in stream
        order."""
        slot = self.slot_of.pop(seq_id, None)
        if slot is None:
            return
        self.seq_ids[slot] = None
        self.npages[slot] = 0
        self._set("active", [slot], [False], torch.bool)
        self._set("lengths", [slot], [1], torch.int32)
        self.bt[slot, :1].fill_(self.scratch)   # a scalar fill: no host copy
        self.event_dispatches += 1

    # ------------------------------------------------------------ planning
    def needs_rebuild(self, rows: List[Tuple[str, int]]) -> bool:
        """rows: (seq_id, n_pages). True when the next sync cannot be
        expressed as incremental scatters — bucket growth or a reset."""
        if self._force_rebuild or self.bb == 0:
            return True
        if pow2_bucket(len(rows)) > self.bb:
            return True
        return max(n for _, n in rows) > self.pb

    def oversized(self, rows: List[Tuple[str, int]]) -> bool:
        """True when either bucket is >=2x what the batch needs."""
        if self.bb == 0:
            return False
        return (pow2_bucket(len(rows)) <= self.bb // 2
                or pow2_bucket(max(n for _, n in rows)) <= self.pb // 2)

    # ------------------------------------------------------------ sync
    def sync(self, rows: List[Row], can_shrink: bool = False) -> int:
        """Reconcile the device state with the batch about to run.
        Host-provided length/last_tok are honoured only for JOINING rows;
        existing rows' carried state is device-authoritative. Returns the
        number of device scatters spent (0 in steady state)."""
        ev0 = self.event_dispatches
        rows2 = [(r[0], len(r[1])) for r in rows]
        if (can_shrink and self.oversized(rows2)) or self.needs_rebuild(rows2):
            self._rebuild(rows)
            return self.event_dispatches - ev0
        incoming = {r[0] for r in rows}
        leave = [i for i, sid in enumerate(self.seq_ids)
                 if sid is not None and sid not in incoming]
        if leave:
            for i in leave:
                del self.slot_of[self.seq_ids[i]]
                self.seq_ids[i] = None
                self.npages[i] = 0
            self._set("active", leave, [False] * len(leave), torch.bool)
            self._set("lengths", leave, [1] * len(leave), torch.int32)
            # park the freed row's per-step KV write on the scratch sink
            # (index_fill_ takes the page id as a scalar: no host copy)
            self.bt[:, 0].index_fill_(0, self._t(leave, torch.long),
                                      self.scratch)
            self.event_dispatches += 1
        joins, extends = [], []
        for r in rows:
            slot = self.slot_of.get(r[0])
            if slot is None:
                joins.append(r)
            elif len(r[1]) != self.npages[slot]:
                extends.append((slot, r[1]))
        if joins:
            slots, bt_rows = [], []
            for sid, pages, *_ in joins:
                i = self.seq_ids.index(None)
                self.seq_ids[i] = sid
                self.npages[i] = len(pages)
                self.slot_of[sid] = i
                slots.append(i)
                row = np.full((self.pb,), self.scratch, np.int32)
                row[:len(pages)] = pages
                bt_rows.append(row)
            self._set("bt", slots, np.stack(bt_rows), torch.int32)
            self._set("lengths", slots, [r[2] for r in joins], torch.int32)
            self._set("last_tok", slots, [r[3] for r in joins], torch.int32)
            self._set("active", slots, [True] * len(joins), torch.bool)
            temps = [r[4] for r in joins]
            self._set("temps", slots, temps, torch.float32)
            self.temps_host[slots] = temps
            self._set("top_ps", slots, [r[5] for r in joins], torch.float32)
        if extends:
            # ALL page appends this step land in one scatter
            ridx, cidx, vals = [], [], []
            for slot, pages in extends:
                old = self.npages[slot]
                for c in range(old, len(pages)):
                    ridx.append(slot)
                    cidx.append(c)
                    vals.append(pages[c])
                self.npages[slot] = len(pages)
            self.bt[self._t(ridx, torch.long), self._t(cidx, torch.long)] = \
                self._t(vals, torch.int32)
            self.event_dispatches += 1
        return self.event_dispatches - ev0

    # ------------------------------------------------------------ rebuild
    def _rebuild(self, rows: List[Row]) -> None:
        """Full row reconstruction from host-authoritative values at the
        exact power-of-two buckets the batch needs."""
        self._force_rebuild = False
        self.bb = pow2_bucket(len(rows))
        self.pb = pow2_bucket(max(len(r[1]) for r in rows))
        bt = np.full((self.bb, self.pb), self.scratch, np.int32)
        lengths = np.ones((self.bb,), np.int32)
        last_tok = np.zeros((self.bb,), np.int32)
        active = np.zeros((self.bb,), bool)
        temps = np.zeros((self.bb,), np.float32)
        top_ps = np.ones((self.bb,), np.float32)
        self.seq_ids = [None] * self.bb
        self.npages = [0] * self.bb
        self.slot_of = {}
        for i, (sid, pages, length, tok, temp, top_p) in enumerate(rows):
            self.seq_ids[i] = sid
            self.npages[i] = len(pages)
            self.slot_of[sid] = i
            bt[i, :len(pages)] = pages
            lengths[i] = length
            last_tok[i] = tok
            active[i] = True
            temps[i] = temp
            top_ps[i] = top_p
        self.bt = self._t(bt, torch.int32)
        self.lengths = self._t(lengths, torch.int32)
        self.last_tok = self._t(last_tok, torch.int32)
        self.active = self._t(active, torch.bool)
        self.temps = self._t(temps, torch.float32)
        self.top_ps = self._t(top_ps, torch.float32)
        self.temps_host = temps
        self.event_dispatches += 6
