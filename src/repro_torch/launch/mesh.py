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
from typing import Dict, List, Optional, Sequence, Tuple

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

    @property
    def ways(self) -> int:
        """How many ways the tensor parallelism splits a split dim: the
        rank count (a ``DeviceMesh``: its model axis's width)."""
        return self.tp

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

    def all_reduce(self, parts: Sequence[torch.Tensor],
                   ranks: Optional[int] = None) -> torch.Tensor:
        """The sum of the ranks' partials, added in rank order on rank 0's
        device: a partial on another device is copied there first, and the
        sum reaches that device again through ``broadcast`` when the next
        layer reads it. Over one partial it is that partial, unchanged.
        ``ranks``: how many ranks hold partials, which the caller reads
        off the shards' widths (``len(parts)`` here, checked; a
        ``DeviceMesh`` runs one of them and reads it)."""
        _expect(ranks, len(parts), "partials")
        out = parts[0]
        for p in parts[1:]:
            out = out + (p if p.device == out.device
                         else p.to(out.device, non_blocking=True))
        return out

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int,
                   full: Optional[int] = None) -> torch.Tensor:
        """The ranks' slices joined on ``dim`` on rank 0's device. Over one
        slice it is that slice, unchanged. ``full``: the joined extent on
        ``dim`` as the caller knows it (checked here; a ``DeviceMesh``
        reads it)."""
        _expect(full, sum(p.shape[dim] for p in parts), f"extent on {dim}")
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

    def regroup(self, parts: Sequence[torch.Tensor], n: int, dim: int,
                full: Optional[int] = None) -> List[torch.Tensor]:
        """Even slices of one tensor on ``dim`` (rank r's on rank r's
        device) as ``n`` even slices: the slices themselves when there are
        ``n`` of them, else their join cut again (``scatter``). ``full``
        as in ``all_gather``."""
        if len(parts) == n:
            _expect(full, sum(p.shape[dim] for p in parts),
                    f"extent on {dim}")
            return list(parts)
        return self.scatter(self.all_gather(parts, dim, full), n, dim)


def _expect(given: Optional[int], actual: int, what: str) -> None:
    if given is not None and given != actual:
        raise ValueError(f"the caller expects {given} {what}, the ranks "
                         f"hold {actual}")


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


class _Mirror(torch.autograd.Function):
    """The identity, whose backward records a collective: the gradient's
    counterpart of a forward one (an all-reduce's is the all-reduce of
    the column-parallel input's gradient, a gather's a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, log, key, nbytes):
        ctx.log, ctx.key, ctx.nbytes = log, key, nbytes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.log[ctx.key] = ctx.log.get(ctx.key, 0.0) + ctx.nbytes
        return g, None, None, None


_MIRROR = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter"}


class DeviceMesh(EngineMesh):
    """Rank 0 of a model axis ``model`` ranks wide, run alone on
    ``device``: what one device of the production mesh computes. The
    caller passes rank 0's weights tree (``[tree]``) and caches; each
    collective returns what rank 0 would hold after it and is recorded in
    ``collectives`` ({"kind@axis": result bytes}, the reference's proxy
    for wire bytes, ``roofline.py:54``; under autograd its gradient's
    counterpart too): an all-reduce of a partial held by more than one
    rank returns that partial (the sum's stand-in), a gather of a slice
    narrower than ``full`` returns the slice repeated to ``full`` (the
    gathered tensor's stand-in, which writes as many bytes), and
    ``scatter`` keeps rank 0's slice. The values are stand-ins: the dry
    run counts and times this program, and reads no value of it."""

    def __init__(self, device, model: int):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        super().__init__([device])
        self.model = model
        self.collectives: Dict[str, float] = {}

    @property
    def ways(self) -> int:
        return self.model

    def collective(self, kind: str, t: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
        """Record ``kind`` over ``axis`` with result ``t``; returns ``t``
        (through ``_Mirror`` when it needs a gradient)."""
        key, nbytes = self.record(kind, t, axis)
        if t.requires_grad:
            t = _Mirror.apply(t, self.collectives, f"{_MIRROR[kind]}@{axis}",
                              nbytes)
        return t

    def record(self, kind: str, t: torch.Tensor, axis: str = "model"):
        """Count ``kind`` over ``axis`` with result ``t`` (a collective
        the program makes without running it here); (key, bytes)."""
        key, nbytes = f"{kind}@{axis}", t.numel() * t.element_size()
        self.collectives[key] = self.collectives.get(key, 0.0) + nbytes
        return key, nbytes

    def all_reduce(self, parts, ranks=None):
        if len(parts) != 1:
            raise ValueError("a DeviceMesh runs one rank")
        if (ranks or 1) > 1:
            return self.collective("all-reduce", parts[0])
        return parts[0]

    def all_gather(self, parts, dim, full=None):
        p, = parts
        if full is None or full == p.shape[dim]:
            return p
        return self.collective("all-gather", torch.cat(
            [p] * (full // p.shape[dim]), dim))

    def scatter(self, t, n, dim):
        return [t.narrow(dim, 0, t.shape[dim] // n)]

    def regroup(self, parts, n, dim, full=None):
        p, = parts
        whole = full or p.shape[dim]
        if whole // p.shape[dim] == n:
            return [p]
        return self.scatter(self.all_gather(parts, dim, full), n, dim)


# ------------------------------------------------------- production mesh
GPUS_PER_NODE = 8        # an H100 SXM node: 8 cards on one NVLink switch


class ProductionMesh:
    """The reference's production mesh (``repro/launch/mesh.py:25-29``)
    as axis names and sizes, with no devices: (16, 16) ("data", "model")
    or (2, 16, 16) ("pod", "data", "model"). Ranks are numbered with the
    last axis fastest and fill nodes of ``GPUS_PER_NODE`` cards in order,
    so an axis whose stride times size exceeds a node (the 16-wide model
    axis spans two nodes; data and pod cross nodes) rides the inter-node
    link, and one within a node rides NVLink (``link``)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = 1
        for n in shape:
            self.size *= n

    def link(self, axis: str) -> str:
        """"nvlink" when every group of ``axis`` lies in one node, else
        "ib"; a joined "a,b" takes the slower of its axes."""
        if "," in axis:
            links = {self.link(a) for a in axis.split(",")}
            return "ib" if "ib" in links else "nvlink"
        stride = 1
        for a in reversed(self.axis_names):
            if a == axis:
                break
            stride *= self.shape[a]
        return "nvlink" if stride * self.shape[axis] <= GPUS_PER_NODE \
            else "ib"


def make_production_mesh(multi_pod: bool = False) -> ProductionMesh:
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
