"""Paged-attention decode: the CUDA kernel ``csrc/paged_attention.cu`` and
its launcher. It replaces the Pallas kernel
``repro/kernels/paged_attention.py::paged_attention``; its plain version is
``ref.paged_attention_ref``, and ``ref.paged_attention_split_ref`` emulates
the kernel's split-and-merge. Go through ``ops.paged_attention``, which
routes CPU tensors to the plain version.

The kernel is split-K (flash-decoding): each (sequence, KV head) is cut
into ``n_splits`` runs of pages, one block each, merged by a second small
kernel. The split count depends on shapes only (never on the lengths, which
live on the device inside a decode horizon), so a call never syncs with the
host and can be captured in a CUDA graph. One call counts one launch."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, counts, tma

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC = {torch.float32: 4, torch.bfloat16: 8}    # elements per 16-byte load
MAX_SPLITS = 32
_sm_count: Dict[int, int] = {}


def n_splits(b: int, hkv: int, maxp: int, n_sm: int) -> int:
    """Splits per (sequence, KV head) for a batch of ``b`` sequences over
    ``hkv`` KV heads with block tables ``maxp`` pages wide on a card of
    ``n_sm`` SMs: enough that the B * Hkv * S blocks cover the SMs twice,
    never more than ``maxp`` (a split needs a page) or MAX_SPLITS."""
    if b * hkv <= 0:
        return 1
    want = -(-2 * n_sm // (b * hkv))
    return max(1, min(want, maxp, MAX_SPLITS))


def sm_count(dev: torch.device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount), read once per
    device; no host sync."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def _fn():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, i, p, p, p, p, i, i, i, i, i, i, i, i, f,
                       i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Launch the decode kernel. q: (B, H, hd); k/v pages (NP, P, Hkv, hd)
    (a contiguous layer view of the pool); block_tables (B, MAXP) int32;
    lengths (B,) int32. ``splits`` overrides ``n_splits`` (tests hold each
    split count against the plain version). Returns (B, H, hd) in q's
    dtype."""
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
    b, h, hd = q.shape
    _, p, hkv, hd2 = k_pages.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("paged_attention kernel needs CUDA tensors")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}: "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if hd2 != hd or v_pages.shape != k_pages.shape or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if hd % VEC[q.dtype] or hd > 256:
        raise ValueError(f"head_dim {hd} must be a multiple of "
                         f"{VEC[q.dtype]} up to 256 for {q.dtype}")
    if p > 256 or (p * hd * q.element_size()) % 128:
        raise ValueError(f"a page of one KV head ({p} x {hd}) must be a "
                         f"multiple of 128 bytes, at most 256 rows")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("block_tables/lengths batch mismatch")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    maxp = block_tables.shape[1]
    s = splits if splits is not None else n_splits(b, hkv, maxp,
                                                   sm_count(dev))
    if s < 1:
        raise ValueError(f"splits must be >= 1, got {s}")
    ws = torch.empty((b * h * s * (hd + 2),) if s > 1 else (0,),
                     dtype=torch.float32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        # one TMA box = one page of one KV head (P rows x hd)
        k_map, k_row0 = tma.pool_map(k_pages, hd, p)
        v_map, v_row0 = tma.pool_map(v_pages, hd, p)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            q.data_ptr(), k_map, v_map, k_row0, v_row0,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), b, h, hkv, hd, p, maxp, s, DTYPES[q.dtype],
            float(softcap or 0.0), int(window or 0), stream)
    _build.check(rc, "paged_attention")
    counts.add("paged_attention")
    return out
