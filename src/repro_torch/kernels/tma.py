"""TMA tensor maps (``csrc/tma_map.cu``) for the kernels that copy with TMA.

A map fixes a tensor's base address, dims, strides and the box one TMA
copy moves; it is encoded on the host once per geometry and cached (the
caching allocator hands the same addresses out again, so a launcher that
maps fresh tensors on every call mostly finds its maps here).

- ``pool_map``: a paged K/V pool's whole storage as rows of ``Hkv * hd``
  elements (the layers of a multi-layer pool are consecutive runs of
  rows); a layer's view is reached by its first row, passed to the kernel.
- ``seq_map``: a contiguous (B, T, W) tensor as a 3-D map of
  (W, T, B) with boxes of ``box_w`` channels x ``box_t`` steps of one row.

The geometry is computed in Python (``pool_geometry``, ``seq_geometry``)
so that the CPU tests can check it; only the encoding needs the card."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_maps: Dict[tuple, ctypes.Array] = {}


def _fn():
    fn = _build.load("tma_map").tma_encode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, i, ll, ll, ctypes.POINTER(ctypes.c_int), i, i]
        fn.restype = ctypes.c_int
    return fn


def encode(base: int, dtype: torch.dtype, dims: Tuple[int, ...],
           strides: Tuple[int, ...], box: Tuple[int, ...],
           swizzle128: bool = False) -> ctypes.Array:
    """The 128-byte map of the tensor at address ``base``: ``dims`` in
    elements (innermost first), ``strides`` the outer strides in bytes,
    ``box`` one copy's sizes; cached by all of them."""
    key = (base, dtype, dims, strides, box, swizzle128)
    buf = _maps.get(key)
    if buf is None:
        if len(_maps) > 256:
            _maps.clear()
        n = len(dims)
        buf = ctypes.create_string_buffer(128)
        rc = _fn()(buf, base, n, (ctypes.c_longlong * n)(*dims),
                   (ctypes.c_longlong * max(n - 1, 1))(*strides),
                   (ctypes.c_int * n)(*box), DTYPES[dtype], int(swizzle128))
        if rc != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed with "
                               f"CUresult {rc}")
        _maps[key] = buf
    return buf


def pool_geometry(pages: torch.Tensor) -> Tuple[tuple, tuple, int]:
    """(dims, byte strides, first row of this view) of a page pool view
    (NP, P, Hkv, hd) seen as the rows of its whole storage."""
    _, _, hkv, hd = pages.shape
    cols = hkv * hd
    row0, rem = divmod(pages.storage_offset(), cols)
    if rem:
        raise ValueError("page pool view must start on a row of Hkv * hd")
    rows = pages.untyped_storage().nbytes() // (cols * pages.element_size())
    return (cols, rows), (cols * pages.element_size(),), row0


def pool_map(pages: torch.Tensor, box_cols: int, box_rows: int,
             swizzle128: bool = False) -> Tuple[ctypes.Array, int]:
    """(128-byte map, first row of this view) for a page pool view
    (NP, P, Hkv, hd) read in boxes of ``box_cols`` x ``box_rows``, written
    to shared memory with the 128-byte swizzle if ``swizzle128``."""
    dims, strides, row0 = pool_geometry(pages)
    buf = encode(pages.untyped_storage().data_ptr(), pages.dtype, dims,
                 strides, (box_cols, box_rows), swizzle128)
    return buf, row0


def seq_geometry(x: torch.Tensor) -> Tuple[tuple, tuple]:
    """(dims, byte strides) of a contiguous (B, T, W) tensor as a 3-D map
    (W, T, B)."""
    if not x.is_contiguous():
        raise ValueError("seq_map needs a contiguous tensor")
    bsz, t, w = x.shape
    e = x.element_size()
    return (w, t, bsz), (w * e, t * w * e)


def seq_map(x: torch.Tensor, box_w: int, box_t: int) -> ctypes.Array:
    """The map of a contiguous (B, T, W) tensor read or written in boxes
    of ``box_w`` channels x ``box_t`` steps of one batch row."""
    dims, strides = seq_geometry(x)
    return encode(x.data_ptr(), x.dtype, dims, strides, (box_w, box_t, 1))
