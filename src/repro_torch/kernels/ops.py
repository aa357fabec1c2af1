"""Public kernel ops of the port (the counterpart of
``repro/kernels/ops.py``): the two attention kernels of the paged family
and the two recurrences of the slot family.

``impl`` selects the route:
  * "auto" — the CUDA kernel for CUDA tensors, the plain PyTorch version
    for CPU tensors (the engine default). The choice follows only where the
    tensors lie: a CUDA tensor launches its kernel or raises, never falls
    back.
  * "ref"  — the plain version on any device; kept so ``chip_smoke.py``
    and the tests can hold a kernel against it on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counts
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as R
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import wkv6 as WKV


def _route(x: torch.Tensor, impl: str) -> str:
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if impl == "ref" or x.device.type == "cpu":
        return "ref"
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return "cuda"


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None, impl: str = "auto"):
    if _route(q, impl) == "ref":
        return R.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                     lengths, softcap=softcap, window=window)
    return PA.paged_attention(q, k_pages, v_pages, block_tables, lengths,
                              softcap=softcap, window=window)


def paged_prefill(q, k_pages, v_pages, cu_tokens, entry_bt, entry_start,
                  tiles, softcap: Optional[float] = None,
                  window: Optional[int] = None, impl: str = "auto"):
    """Ragged paged prefill attention; ``tiles`` (from
    ``flash_prefill.build_tiles``) is read by the kernel only."""
    if _route(q, impl) == "ref":
        return R.paged_prefill_ref(q, k_pages, v_pages, cu_tokens, entry_bt,
                                   entry_start, softcap=softcap,
                                   window=window)
    return FP.paged_prefill(q, k_pages, v_pages, cu_tokens, entry_bt,
                            entry_start, tiles, softcap=softcap,
                            window=window)


def flash_prefill(q, k, v, softcap: Optional[float] = None,
                  window: Optional[int] = None, impl: str = "auto"):
    if _route(q, impl) == "ref":
        return R.flash_prefill_ref(q, k, v, softcap=softcap, window=window)
    return FP.flash_prefill(q, k, v, softcap=softcap, window=window)


def wkv6(r, k, v, w, u, state, impl: str = "auto"):
    """WKV6 with a carried state: r, k, v, w (B, T, H, hd), u (H, hd)
    fp32, state (B, H, hd, hd) fp32. The new state is written over
    ``state`` in place on both routes. Returns (y, state)."""
    if _route(r, impl) == "ref":
        y, s = R.wkv6_ref(r, k, v, w, u, state)
        state.copy_(s)
        return y, state
    return WKV.wkv6(r, k, v, w, u, state)


def rglru(a, b, h0, impl: str = "auto"):
    """RG-LRU recurrence: a, b (B, T, W), h0 (B, W) fp32. Returns
    (h (B, T, W), h_last (B, W) fp32)."""
    if _route(a, impl) == "ref":
        return R.rglru_ref(a, b, h0)
    return RG.rglru(a, b, h0)


def reset_launches() -> None:
    """Zero every kernel's launch count (chip_smoke does this just before
    it drives a main path)."""
    counts.reset()


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, all threads."""
    return counts.totals()
