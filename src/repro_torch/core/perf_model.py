"""Analytic serving-performance model (torch port of
``repro/core/perf_model.py``): prices prefill and decode work on a TE so
that the PD heatmap and cluster-scale studies run the real scheduling
code against plausible timings.

The hardware defaults are one NVIDIA H100 SXM from NVIDIA's data sheet
(dense rates, no sparsity, at the full 700 W power limit); the model is
not calibrated against measurements of the card. ``MFU_PREFILL``,
``MBU_DECODE`` and ``STEP_OVERHEAD`` are the reference's modelling
assumptions, carried over unchanged: they are not measured here either.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s, H100 SXM (data sheet)
HBM_BW = 3.35e12           # bytes/s of HBM3, H100 SXM (data sheet)
LINK_BW = 450e9            # bytes/s per direction of NVLink 4 (data sheet:
#                            900 GB/s total, both directions)
MFU_PREFILL = 0.55         # modelling assumption: fraction of peak reached
#                            in prefill (the reference's)
MBU_DECODE = 0.70          # modelling assumption: fraction of HBM bandwidth
#                            reached in decode (the reference's)
STEP_OVERHEAD = 2.0e-3     # modelling assumption: host cost per engine
#                            step in seconds (the reference's)


@dataclass
class TEHardware:
    n_chips: int = 1
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW             # the PD pair's KV link, per TE


@dataclass
class TECostModel:
    """Prices one TE's work for a given model config."""
    cfg: ModelConfig
    hw: TEHardware = field(default_factory=TEHardware)
    kv_bytes_per_token: Optional[float] = None

    def __post_init__(self):
        c = self.cfg
        if self.kv_bytes_per_token is None:
            la = sum(1 for k in c.layer_kinds() if k.startswith("attn"))
            self.kv_bytes_per_token = 2 * la * c.n_kv_heads * c.head_dim * 2  # bf16

    # ------------------------------------------------------------ prefill
    def prefill_time(self, n_tokens: int, kv_context: int = 0) -> float:
        """Compute-bound: 2 N_active FLOPs/token + the attention term."""
        c = self.cfg
        flops = 2.0 * c.active_param_count() * n_tokens
        # attention score/AV FLOPs: 4 * L * H * hd * S_kv per token
        la = sum(1 for k in c.layer_kinds() if k.startswith("attn"))
        avg_ctx = kv_context + n_tokens / 2
        if c.window:
            avg_ctx = min(avg_ctx, c.window)
        flops += 4.0 * la * c.n_heads * c.head_dim * avg_ctx * n_tokens
        return flops / (self.hw.n_chips * self.hw.peak_flops * MFU_PREFILL)

    # ------------------------------------------------------------ decode
    def decode_step_time(self, batch: int, avg_context):
        """Memory-bound: stream weights once per step + KV per sequence.
        ``avg_context`` may be an int64 array of contexts (one step each)."""
        c = self.cfg
        weight_bytes = 2.0 * c.active_param_count()     # bf16
        ctx = np.minimum(avg_context, c.window) if c.window else avg_context
        kv_bytes = batch * self.kv_bytes_per_token * ctx
        t_mem = (weight_bytes + kv_bytes) / (self.hw.n_chips * self.hw.hbm_bw * MBU_DECODE)
        t_flops = (2.0 * c.active_param_count() * batch
                   / (self.hw.n_chips * self.hw.peak_flops * MFU_PREFILL))
        return np.maximum(t_mem, t_flops) + STEP_OVERHEAD

    def decode_time(self, n_tokens: int, batch: int, context0: int) -> float:
        """Total time to emit n_tokens per sequence at a fixed batch: the
        steps' times as one array, added in order by a running sum (the
        reference's loop, with the same roundings)."""
        if n_tokens <= 0:
            return 0.0
        steps = self.decode_step_time(
            batch, np.arange(context0, context0 + n_tokens, dtype=np.int64))
        return float(np.cumsum(steps)[-1])
