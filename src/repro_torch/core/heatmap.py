"""PD-disaggregated vs PD-colocated heatmap (§5.3.1, Figure 6), torch
port of ``repro/core/heatmap.py``.

For each (prefill_len, decode_ratio, rps) cell a batch of identical
requests is priced on (a) a PD-disaggregated 1P+1D pair and (b) a
PD-colocated TE with chunked prefill, and the cell holds
    value = JCT_colocated / JCT_disaggregated - 1
(positive: disaggregation wins, the paper's convention). The combined
heatmap (the element-wise sum over RPS, §5.3.2) feeds the PD-aware step of
Algorithm 1. Prices come from ``TECostModel`` on ``TEHardware`` (one H100
by default); the KV hand-off is priced on ``TEHardware.link_bw``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.perf_model import TECostModel, TEHardware

PREFILL_LENS = [256, 512, 1024, 2048, 4096, 8192]
DECODE_RATIOS = [0.05, 0.1, 0.25, 0.5, 1.0, 2.0]
RPS_GRID = [0.2, 0.4, 0.6, 0.8, 1.0, 1.2]


@dataclass
class HeatmapStudy:
    cfg: ModelConfig
    hw: TEHardware = field(default_factory=TEHardware)
    prefill_lens: List[int] = field(default_factory=lambda: list(PREFILL_LENS))
    decode_ratios: List[float] = field(default_factory=lambda: list(DECODE_RATIOS))
    rps_grid: List[float] = field(default_factory=lambda: list(RPS_GRID))

    def __post_init__(self):
        self.cost = TECostModel(self.cfg, self.hw)

    # ---------------------------------------------------------------- cells
    def jct_disaggregated(self, p_len: int, d_len: int, rps: float) -> float:
        """1 prefill TE + 1 decode TE. Prefill pipelines with decode; under
        load the slower stage saturates (M/D/1-flavoured waiting)."""
        t_p = self.cost.prefill_time(p_len)
        batch = max(1, min(16, int(rps * d_len * self.cost.decode_step_time(8, p_len) * 8)))
        t_d = self.cost.decode_time(d_len, batch, p_len)
        # queueing: an arrival every 1/rps; service at the bottleneck stage
        util = min(0.95, rps * max(t_p, t_d / max(batch, 1)))
        wait = (util / max(1e-9, (1 - util))) * max(t_p, t_d / max(batch, 1)) * 0.5
        # KV transfer between TEs (by request), overlapped with decode ramp
        kv_bytes = self.cost.kv_bytes_per_token * p_len
        t_xfer = kv_bytes / self.hw.link_bw
        return t_p + t_xfer + t_d + wait

    def jct_colocated(self, p_len: int, d_len: int, rps: float) -> float:
        """One PD-colocated TE with chunked prefill: decode steps are slowed
        by interleaved prefill chunks (interference), prefill is stretched
        by sharing the token budget with decodes."""
        t_p = self.cost.prefill_time(p_len)
        batch = max(1, min(16, int(rps * d_len * self.cost.decode_step_time(8, p_len) * 8)))
        chunk = 512
        n_chunks = max(1, p_len // chunk)
        t_chunk = self.cost.prefill_time(chunk, kv_context=p_len // 2)
        decode_step = self.cost.decode_step_time(batch, p_len + d_len // 2)
        # while prefilling a new request, concurrent decodes slow down:
        interference = n_chunks * max(0.0, t_chunk - decode_step * 0.2)
        t_d = self.cost.decode_time(d_len, batch, p_len) + interference
        util = min(0.95, rps * (t_p + t_d) / max(batch, 1))
        wait = (util / max(1e-9, (1 - util))) * (t_p + t_d) / max(batch, 1) * 0.5
        return t_p + t_d + wait

    # ---------------------------------------------------------------- grid
    def compute(self, rps: float) -> np.ndarray:
        grid = np.zeros((len(self.prefill_lens), len(self.decode_ratios)))
        for i, pl in enumerate(self.prefill_lens):
            for j, r in enumerate(self.decode_ratios):
                dl = max(1, int(pl * r))
                jd = self.jct_disaggregated(pl, dl, rps)
                jc = self.jct_colocated(pl, dl, rps)
                grid[i, j] = jc / jd - 1.0
        return grid

    def combined(self) -> np.ndarray:
        """Element-wise sum across all RPS values (§5.3.2 step 1)."""
        return np.sum([self.compute(r) for r in self.rps_grid], axis=0)


def lookup(combined: np.ndarray, prefill_lens, decode_ratios,
           p_len: int, d_len: int) -> float:
    """Nearest-cell lookup of the PD-aware step."""
    i = int(np.argmin([abs(p_len - x) for x in prefill_lens]))
    ratio = d_len / max(p_len, 1)
    j = int(np.argmin([abs(ratio - x) for x in decode_ratios]))
    return float(combined[i, j])
