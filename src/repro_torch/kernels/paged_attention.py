"""Paged-attention decode: the CUDA kernel ``csrc/paged_attention.cu`` and
its launcher. It replaces the Pallas kernel
``repro/kernels/paged_attention.py::paged_attention``; its plain version is
``ref.paged_attention_ref``. Go through ``ops.paged_attention``, which
routes CPU tensors to the plain version."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0        # kernel launches since the last reset (main-path proof)


def _fn():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the decode kernel. q: (B, H, hd); k/v pages (NP, P, Hkv, hd)
    (a contiguous layer view of the pool); block_tables (B, MAXP) int32;
    lengths (B,) int32. Returns (B, H, hd) in q's dtype."""
    global launches
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
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, h, hkv, hd, p, block_tables.shape[1], DTYPES[q.dtype],
                float(softcap or 0.0), int(window or 0), stream)
    _build.check(rc, "paged_attention")
    launches += 1
    return out
