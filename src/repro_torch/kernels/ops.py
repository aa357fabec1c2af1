"""Public kernel ops of the port (the counterpart of
``repro/kernels/ops.py``): the two attention kernels of the paged family
and the two recurrences of the slot family.

``impl`` selects the route:
  * "auto" — the CUDA kernel for CUDA tensors, the plain PyTorch version
    for CPU tensors (the engine default). The choice follows only where the
    tensors lie: a CUDA tensor launches its kernel or raises, never falls
    back.
  * "ref"  — the plain version on any device; kept so ``chip_smoke.py``
    and the tests can hold a kernel against it on the same inputs. The
    recurrences' plain versions are the per-token loops.
  * "scan" — the plain versions in the reference's sequence forms, on any
    device: the recurrences through the chunked WKV6
    (``models/rwkv6.py::wkv_chunked``) and the associative RG-LRU scan
    (``models/rglru.py::associative_scan``), the attention entries as
    "ref". The train step's route: the reference trains through these
    forms, and the CUDA kernels have no backward.

A meta tensor (the dry run, ``launch/dryrun.py``) computes no values: on
it every entry returns empty outputs of the right shapes and dtypes and
records its kernel's work (``work.record``, the formulas of
``kernels/work.py``) under any ``impl``, launching nothing and running
no plain arithmetic; it adds no launch. The one exception is "scan" for
the recurrences, the train step's differentiable forms, which run op by
op on meta as on any device. Where the work depends on values (the paged
entries' lengths), the meta route counts what the block tables can hold.
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
from repro_torch.kernels import work as W


def _route(x: torch.Tensor, impl: str) -> str:
    """Where ``impl`` sends a call on ``x``: "cuda", "ref", "scan" or
    "meta" (a meta tensor under "auto" or "ref")."""
    if impl not in ("auto", "ref", "scan"):
        raise ValueError(
            f"impl must be 'auto', 'ref' or 'scan', got {impl!r}")
    if x.device.type == "meta" and impl != "scan":
        return "meta"
    if impl != "auto":
        return impl
    if x.device.type == "cpu":
        return "ref"
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return "cuda"


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None, impl: str = "auto"):
    if q.is_meta:
        b, h, hd = q.shape
        _, p, hkv, _ = k_pages.shape
        keys = min(block_tables.shape[1] * p, window or 2 ** 62)
        W.record("paged_attention", W.paged_attention(
            b, h, hkv, hd, b * keys, block_tables.numel(), q.element_size()))
        return torch.empty_like(q)
    if _route(q, impl) != "cuda":
        return R.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                     lengths, softcap=softcap, window=window)
    return PA.paged_attention(q, k_pages, v_pages, block_tables, lengths,
                              softcap=softcap, window=window)


def paged_prefill(q, k_pages, v_pages, cu_tokens, entry_bt, entry_start,
                  tiles, softcap: Optional[float] = None,
                  window: Optional[int] = None, impl: str = "auto"):
    """Ragged paged prefill attention; ``tiles`` (from
    ``flash_prefill.build_tiles``) is read by the kernel only."""
    if q.is_meta:
        sb, pb = entry_bt.shape
        n = max(1, q.shape[0] // sb)
        cap = pb * k_pages.shape[1]
        W.record("flash_prefill", W.paged_prefill(
            q.shape[1], k_pages.shape[2], q.shape[2], [max(0, cap - n)] * sb,
            [n] * sb, window, entry_bt.numel(), q.element_size()))
        return torch.empty_like(q)
    if _route(q, impl) != "cuda":
        return R.paged_prefill_ref(q, k_pages, v_pages, cu_tokens, entry_bt,
                                   entry_start, softcap=softcap,
                                   window=window)
    return FP.paged_prefill(q, k_pages, v_pages, cu_tokens, entry_bt,
                            entry_start, tiles, softcap=softcap,
                            window=window)


def flash_prefill(q, k, v, softcap: Optional[float] = None,
                  window: Optional[int] = None, impl: str = "auto"):
    if q.is_meta:
        b, s, h, hd = q.shape
        W.record("flash_prefill", W.flash_prefill(
            b, s, h, k.shape[2], hd, window, q.element_size()))
        return torch.empty_like(q)
    if _route(q, impl) != "cuda":
        return R.flash_prefill_ref(q, k, v, softcap=softcap, window=window)
    return FP.flash_prefill(q, k, v, softcap=softcap, window=window)


def wkv6(r, k, v, w, u, state, impl: str = "auto"):
    """WKV6 with a carried state: r, k, v, w (B, T, H, hd), u (H, hd)
    fp32, state (B, H, hd, hd) fp32. The new state is written over
    ``state`` in place on every route. Returns (y, state). "ref" runs the
    per-token loop, "scan" the reference's chunked form (chunks of 64
    tokens; differentiable, and it reads ``state`` through a copy, so
    autograd keeps the initial state it saved)."""
    route = _route(r, impl)
    if route == "meta":
        b, t, h, hd = r.shape
        W.record("wkv6", W.wkv6(b, t, h, hd, WKV.plan(t, hd)["chunked"],
                                r.element_size()))
        return torch.empty_like(r), state
    if route == "cuda":
        return WKV.wkv6(r, k, v, w, u, state)
    if route == "scan":
        from repro_torch.models.rwkv6 import wkv_chunked   # it imports ops
        y, s = wkv_chunked(r, k, v, w, u, state)
    else:
        y, s = R.wkv6_ref(r, k, v, w, u, state)
    state.copy_(s)
    return y, state


def rglru(a, b, h0, impl: str = "auto"):
    """RG-LRU recurrence: a, b (B, T, W), h0 (B, W) fp32. Returns
    (h (B, T, W), h_last (B, W) fp32). "ref" runs the per-token loop,
    "scan" the reference's associative scan with h0 folded into the first
    step."""
    route = _route(a, impl)
    if route == "meta":
        W.record("rglru", W.rglru(*a.shape))
        return torch.empty_like(a), torch.empty_like(h0, dtype=torch.float32)
    if route == "cuda":
        return RG.rglru(a, b, h0)
    if route == "scan":
        from repro_torch.models.rglru import scan_linear   # it imports ops
        return scan_linear(a, b, h0)
    return R.rglru_ref(a, b, h0)


def reset_launches() -> None:
    """Zero every kernel's launch count (chip_smoke does this just before
    it drives a main path)."""
    counts.reset()


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, all threads."""
    return counts.totals()
