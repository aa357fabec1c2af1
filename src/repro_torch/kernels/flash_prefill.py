"""Flash prefill: the CUDA kernel ``csrc/flash_prefill.cu`` and its two
entry points, replacing the Pallas kernel
``repro/kernels/flash_prefill.py::flash_prefill``.

  * ``paged_prefill`` — the paged variable-length form the engine's ragged
    prefill launches: packed query tiles over keys read through each
    entry's block-table row (plain version ``ref.paged_prefill_ref``).
  * ``flash_prefill`` — the Pallas signature over dense (B, S, ·, hd)
    tensors, viewed as B one-entry page runs (plain version
    ``ref.flash_prefill_ref``).

bf16 runs on the tensor cores (``wgmma``, K/V pages copied by TMA into a
ring of stages, through maps over the whole pool from ``tma``); fp32 runs
an exact CUDA-core body. Go through ``ops``, which routes CPU tensors to
the plain versions."""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, counts, tma

BLOCK_Q = 32        # tokens per query tile; equals BQ in flash_prefill.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_tiles(n_tokens: int, n_entries: int) -> int:
    """Tile-list length for a bucket of ``n_tokens`` flat tokens over
    ``n_entries`` entries: every entry and the padding tail may each end
    in a partial tile."""
    return -(-n_tokens // BLOCK_Q) + n_entries + 1


def build_tiles(cu_tokens: Sequence[int], n_tokens: int) -> np.ndarray:
    """Host-side tile list (max_tiles, 3) int32 of (entry, start, end):
    each entry's tokens [cu[e], cu[e+1]) cut into runs of at most BLOCK_Q;
    the padding tail [cu[-1], n_tokens) as entry -1 (the kernel writes
    zeros there); unused slots (0, 0, 0) make their block exit."""
    n_entries = len(cu_tokens) - 1
    tiles = np.zeros((max_tiles(n_tokens, n_entries), 3), np.int32)
    k = 0
    spans = [(e, cu_tokens[e], cu_tokens[e + 1]) for e in range(n_entries)]
    spans.append((-1, cu_tokens[-1], n_tokens))
    for e, a, b in spans:
        for s in range(a, b, BLOCK_Q):
            tiles[k] = (e, s, min(s + BLOCK_Q, b))
            k += 1
    return tiles


def _fn():
    lib = _build.load("flash_prefill")
    fn = lib.flash_prefill_paged_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p, i, i, i, i, i, i,
                       i, f, i, p]
        fn.restype = ctypes.c_int
        lib.flash_prefill_block_q.restype = ctypes.c_int
        if lib.flash_prefill_block_q() != BLOCK_Q:
            raise RuntimeError("flash_prefill.cu BQ differs from BLOCK_Q")
    return fn


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, cu_tokens: torch.Tensor,
                  entry_bt: torch.Tensor, entry_start: torch.Tensor,
                  tiles: torch.Tensor, softcap: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Launch the paged varlen prefill kernel. q: (Tb, H, hd); k/v pages
    (NP, P, Hkv, hd); cu_tokens (Sb+1,), entry_bt (Sb, Pb), entry_start
    (Sb,), tiles (n_tiles, 3) from ``build_tiles`` — all int32 on q's
    device. Returns (Tb, H, hd) in q's dtype (padding rows zero)."""
    _build.refuse_grad("flash_prefill", q, k_pages, v_pages)
    tb, h, hd = q.shape
    _, p, hkv, hd2 = k_pages.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_prefill kernel needs CUDA tensors")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}: "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if hd2 != hd or v_pages.shape != k_pages.shape or h % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if q.dtype == torch.bfloat16 and (hd % 8 or hd > 256
                                      or p not in (8, 16, 32, 64)):
        raise ValueError(f"head_dim {hd}, page size {p}: the bf16 "
                         f"tensor-core body takes a multiple of 8 up to 256 "
                         f"and pages of 8, 16, 32 or 64 rows")
    sb = entry_bt.shape[0]
    if cu_tokens.shape != (sb + 1,) or entry_start.shape != (sb,) \
            or tiles.ndim != 2 or tiles.shape[1] != 3:
        raise ValueError("entry metadata shapes disagree")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("cu_tokens", cu_tokens), ("entry_bt", entry_bt),
                    ("entry_start", entry_start), ("tiles", tiles)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
    for name, x in (("cu_tokens", cu_tokens), ("entry_bt", entry_bt),
                    ("entry_start", entry_start), ("tiles", tiles)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(dev):
        k_map = v_map = None
        k_row0 = v_row0 = 0
        if q.dtype == torch.bfloat16:
            # one TMA box = 64 columns (128 bytes) of one page, swizzled
            k_map, k_row0 = tma.pool_map(k_pages, 64, p, swizzle128=True)
            v_map, v_row0 = tma.pool_map(v_pages, 64, p, swizzle128=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_map, v_map, k_row0, v_row0,
                cu_tokens.data_ptr(), entry_bt.data_ptr(),
                entry_start.data_ptr(), tiles.data_ptr(), out.data_ptr(),
                tiles.shape[0], h, hkv, hd, p, entry_bt.shape[1],
                DTYPES[q.dtype], float(softcap or 0.0), int(window or 0),
                stream)
    _build.check(rc, "flash_prefill")
    counts.add("flash_prefill")
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Dense entry with the Pallas signature: q (B, S, H, hd), k/v
    (B, S, Hkv, hd) -> (B, S, H, hd). Sequence b is entry b; its K/V rows
    are page run b of a pool with page size gcd(S, 16), so no copy."""
    _build.refuse_grad("flash_prefill", q, k, v)
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype == torch.bfloat16 and s % 16:
        # the bf16 body reads pages of 8-64 rows: pad the sequence to a
        # multiple of 16 (causality keeps the pad keys out of every real
        # row) and drop the pad rows
        pad = (0, 0, 0, 0, 0, -s % 16)
        return flash_prefill(*(F.pad(x, pad) for x in (q, k, v)),
                             softcap=softcap, window=window)[:, :s]
    p = math.gcd(s, 16)
    pb = s // p
    dev = q.device
    cu = [i * s for i in range(b + 1)]
    meta = torch.from_numpy(np.concatenate([
        np.asarray(cu, np.int32),
        np.arange(b * pb, dtype=np.int32),           # entry_bt, row-major
        np.zeros((b,), np.int32),                    # entry_start
        build_tiles(cu, b * s).reshape(-1)])).to(dev)
    cu_t = meta[:b + 1]
    ebt = meta[b + 1:b + 1 + b * pb].view(b, pb)
    est = meta[b + 1 + b * pb:b + 1 + b * pb + b]
    tiles = meta[b + 1 + b * pb + b:].view(-1, 3)
    o = paged_prefill(q.contiguous().view(b * s, h, hd),
                      k.contiguous().view(b * pb, p, hkv, hd),
                      v.contiguous().view(b * pb, p, hkv, hd),
                      cu_t, ebt, est, tiles, softcap=softcap, window=window)
    return o.view(b, s, h, hd)
