"""TMA tensor maps over the paged K/V pools (``csrc/tma_map.cu``).

A map covers a pool's whole storage as rows of ``Hkv * hd`` elements (the
layers of a multi-layer pool are consecutive runs of rows) and fixes the
box one TMA load copies. It is built once per (storage, box) and cached;
a layer's view is reached by its first row, passed to the kernel."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_maps: Dict[tuple, ctypes.Array] = {}


def _fn():
    fn = _build.load("tma_map").tma_make_map
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_longlong, i, i, i, i, i]
        fn.restype = ctypes.c_int
    return fn


def pool_map(pages: torch.Tensor, box_cols: int, box_rows: int,
             swizzle128: bool = False) -> Tuple[ctypes.Array, int]:
    """(128-byte map, first row of this view) for a page pool view
    (NP, P, Hkv, hd) read in boxes of ``box_cols`` x ``box_rows``, written
    to shared memory with the 128-byte swizzle if ``swizzle128``."""
    _, _, hkv, hd = pages.shape
    cols = hkv * hd
    row0, rem = divmod(pages.storage_offset(), cols)
    if rem:
        raise ValueError("page pool view must start on a row of Hkv * hd")
    st = pages.untyped_storage()
    rows = st.nbytes() // (cols * pages.element_size())
    key = (st.data_ptr(), rows, cols, pages.dtype, box_cols, box_rows,
           swizzle128)
    buf = _maps.get(key)
    if buf is None:
        if len(_maps) > 256:
            _maps.clear()
        buf = ctypes.create_string_buffer(128)
        rc = _fn()(buf, st.data_ptr(), rows, cols, DTYPES[pages.dtype],
                   box_cols, box_rows, int(swizzle128))
        if rc != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed with "
                               f"CUresult {rc}")
        _maps[key] = buf
    return buf, row0
