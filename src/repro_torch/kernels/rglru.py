"""RG-LRU recurrence: the CUDA kernel ``csrc/rglru_scan.cu`` and its
launcher. It replaces the Pallas kernel
``repro/kernels/rglru_scan.py::rglru``; its plain version is
``ref.rglru_ref``. Go through ``ops.rglru``, which routes CPU tensors to
the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0        # kernel launches since the last reset (main-path proof)


def _fn():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Launch the recurrence ``h_t = a_t * h_{t-1} + b_t``. a, b: (B, T, W)
    in one dtype (fp32 on the engine path, bf16 also taken); h0: (B, W)
    fp32. Returns (h (B, T, W) in a's dtype, h_last (B, W) fp32)."""
    global launches
    bsz, t, w = a.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("rglru kernel needs CUDA tensors")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a/b must share one of {list(DTYPES)}: {a.dtype}, "
                        f"{b.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError("h0 must be float32")
    if b.shape != a.shape or h0.shape != (bsz, w):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b), ("h0", h0)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
    h = torch.empty_like(a)
    if bsz * t * w == 0:
        return h, h0.clone()
    h_last = torch.empty_like(h0)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                h_last.data_ptr(), bsz, t, w, DTYPES[a.dtype], stream)
    _build.check(rc, "rglru")
    launches += 1
    return h, h_last
