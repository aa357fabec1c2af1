"""A TE's tensor-parallel mesh (the port of ``repro/launch/mesh.py::
make_engine_mesh``, ``:36``).

The reference puts a TE on a 1 x tp ("data", "model") mesh and lets GSPMD
insert the collectives. The port keeps one controller and makes both
explicit: each rank's shard is a tensor of its own on that rank's device,
the partials of a row-parallel product are summed by ``all_reduce`` and
vocab-sliced logits are joined by ``all_gather``. Over one rank both are
the identity. No ``torch.distributed``: NCCL cannot put two ranks on one
card, and the reference has no multi-process layer to mirror.

The activations a TE carries from layer to layer (the residual stream,
the norms' outputs, the logits) live on rank 0's device; ``broadcast``
hands a rank its own view of one.

Rank r of a TE at device offset o lies on visible card (i + o + r) mod n,
where i is the index of the card the TE was given (0 for ``"cuda"``) and n
the visible card count: on one card every rank shares it. The reference
raises where the port co-locates (``repro/launch/mesh.py:45-51``); a CPU
or meta TE puts every rank on that device."""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch


class EngineMesh:
    """The ranks of one TE: ``devices[r]`` is rank r's device and
    ``distinct`` the distinct devices in rank order."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: List[torch.device] = list(devices)
        self.tp = len(self.devices)
        self.distinct: List[torch.device] = list(dict.fromkeys(self.devices))

    @property
    def device(self) -> torch.device:
        """Rank 0's device: where the TE's activations, its sampling and
        its decode hot state live."""
        return self.devices[0]

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` as each rank reads it: one copy per distinct device other
        than ``t``'s, shared by the ranks there. When every rank lies on
        ``t``'s device no ``.to`` is issued: every rank gets ``t``."""
        if self.distinct == [t.device]:
            return [t] * self.tp
        copies = {t.device: t}
        out = []
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d, non_blocking=True)
            out.append(copies[d])
        return out

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the ranks' partials, added in rank order on rank 0's
        device: a partial on another device is copied there first, and the
        sum reaches that device again through ``broadcast`` when the next
        layer reads it. Over one partial it is that partial, unchanged."""
        out = parts[0]
        for p in parts[1:]:
            out = out + (p if p.device == out.device
                         else p.to(out.device, non_blocking=True))
        return out

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int) -> torch.Tensor:
        """The ranks' slices joined on ``dim`` on rank 0's device. Over one
        slice it is that slice, unchanged."""
        if len(parts) == 1:
            return parts[0]
        dev = parts[0].device
        return torch.cat([p if p.device == dev
                          else p.to(dev, non_blocking=True) for p in parts],
                         dim)

    def scatter(self, t: torch.Tensor, n: int,
                dim: int) -> List[torch.Tensor]:
        """``t`` cut into ``n`` equal slices on ``dim``, slice r on rank r's
        device (a view of ``t`` where that is ``t``'s device). Cut into one
        slice it is ``[t]``."""
        if n == 1:
            return [t]
        return [s if s.device == d else s.to(d, non_blocking=True)
                for s, d in zip(t.split(t.shape[dim] // n, dim),
                                self.devices)]

    def regroup(self, parts: Sequence[torch.Tensor], n: int,
                dim: int) -> List[torch.Tensor]:
        """Even slices of one tensor on ``dim`` (rank r's on rank r's
        device) as ``n`` even slices: the slices themselves when there are
        ``n`` of them, else their join cut again (``scatter``)."""
        if len(parts) == n:
            return list(parts)
        return self.scatter(self.all_gather(parts, dim), n, dim)


def split_ranks(ps: list, full: int, width: int) -> list:
    """The ranks holding distinct slices of a dimension of size ``full``
    whose shard has ``width``: every rank when it splits, rank 0 alone
    when each rank holds it whole."""
    return ps[:full // width]


def make_engine_mesh(tp: int, offset: int, device) -> EngineMesh:
    """The mesh of a TE of width ``tp`` whose device window starts
    ``offset`` devices past ``device`` (the module docstring has the
    rule)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    dev = torch.device(device)
    if dev.type != "cuda":
        return EngineMesh([dev] * tp)
    n = torch.cuda.device_count()
    first = (dev.index or 0) + offset
    return EngineMesh([torch.device("cuda", (first + r) % n)
                       for r in range(tp)])


@functools.lru_cache(maxsize=None)
def one_rank(device: torch.device) -> EngineMesh:
    """The mesh of one rank on ``device`` (one object per device): what a
    caller holding one weights tree (the teacher-forced ``forward``, a
    test) passes to the block bodies."""
    return EngineMesh([device])
