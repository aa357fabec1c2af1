"""Roofline terms of a cell on the production mesh at the H100's figures
(the port of ``repro/launch/roofline.py:81-164``).

Three terms per (arch x shape x mesh) cell, in seconds, for one device:
    compute    = Σ_unit operations / that unit's peak
    memory     = bytes touched / HBM rate
    collective = Σ_axis wire bytes on the axis / that axis's link rate

The counts come from the meta device (``launch/meta_count.py``), not from
an XLA artifact: the operations by unit (bf16 products on the tensor
cores, fp32 ones and the recurrences' per-token bodies on the CUDA cores,
the chunked WKV6 in TF32), the bytes each operation touches, and the
collectives, recorded where the port makes them (``DeviceMesh``, the
model axis) or from the specs (FSDP and data-parallel gradients, the
data and pod axes) as {kind@axis: result bytes}. Peaks, HBM rate and
NVLink are ``core/perf_model.py``'s data-sheet figures. The inter-node
link is InfiniBand NDR, 400 Gb/s = 50 GB/s per card per direction (one
ConnectX-7 port per GPU, the data sheet's figure for an H100 SXM node);
``launch.mesh.ProductionMesh.link`` says which axis rides it: on the
production mesh every axis does (the 16-wide model axis spans two 8-card
nodes). The overlap model is the reference's: the step takes the
largest term."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.core import perf_model as PM
from repro_torch.kernels import work as W

IB_BW = 50e9        # bytes/s per direction per card, InfiniBand NDR (data
#                     sheet: 400 Gb/s)
LINK_BW = {"nvlink": PM.LINK_BW, "ib": IB_BW}

# wire-traffic multipliers per collective kind (ring algorithms, n large)
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


@dataclass
class CellCost:
    flops: float = 0.0                # per device, all units
    bytes_hbm: float = 0.0            # per device, bytes touched
    coll: Dict[str, float] = field(default_factory=dict)   # kind@axis
    flops_by_unit: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "CellCost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes_hbm += other.bytes_hbm * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult
        for k, v in other.flops_by_unit.items():
            self.flops_by_unit[k] = self.flops_by_unit.get(k, 0.0) + v * mult

    def wire_bytes(self) -> float:
        return sum(v * _WIRE_FACTOR.get(k.split("@")[0], 1.0)
                   for k, v in self.coll.items())

    def wire_by_axis(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, v in self.coll.items():
            kind, _, axis = k.partition("@")
            out[axis] = out.get(axis, 0.0) + v * _WIRE_FACTOR.get(kind, 1.0)
        return out


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float                # 6·N·D (global, analytic)
    hlo_flops_global: float           # the counted operations, all devices

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        # optimistic overlap model: the dominant term is the floor
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops_global \
            if self.hlo_flops_global else 0.0


def make_terms(cost: CellCost, n_chips: int, model_flops_global: float,
               mesh) -> RooflineTerms:
    """The three terms of ``cost`` (one device's) on ``mesh`` (a
    ``ProductionMesh``: which link each axis rides)."""
    peaks = W.peaks()
    units = cost.flops_by_unit or {"bf16": cost.flops}
    compute_s = sum(f / peaks[u] for u, f in units.items())
    coll_s = sum(b / LINK_BW[mesh.link(axis)]
                 for axis, b in cost.wire_by_axis().items())
    return RooflineTerms(compute_s=compute_s,
                         memory_s=cost.bytes_hbm / PM.HBM_BW,
                         collective_s=coll_s, model_flops=model_flops_global,
                         hlo_flops_global=cost.flops * n_chips)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D for inference (per step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                     # one token per sequence
    return 2.0 * n_active * tokens
