"""RG-LRU recurrence: the CUDA kernels ``csrc/rglru_scan.cu`` and their
launcher. They replace the Pallas kernel
``repro/kernels/rglru_scan.py::rglru``; the plain version is
``ref.rglru_ref``. Go through ``ops.rglru``, which routes CPU tensors to
the plain version.

``plan`` picks the body from the shapes alone: the streamed body (tiles of
a and b in a ring of shared-memory stages, filled by TMA copies) for a
chunk of ``STREAM_MIN_T`` steps or more whose rows are 16-byte aligned,
else the per-thread body (the decode step)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counts, tma

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STREAM_MIN_T = 16       # shorter calls (decode) take the per-thread body
CHANNELS = 16           # channels per block of the streamed body
STEPS = 64              # steps per TMA tile of the streamed body


def plan(t: int, w: int, elem_bytes: int, aligned: bool = True) -> dict:
    """The body and grid for a call with T steps and width ``w``:
    ``channels`` per block (0 = the per-thread body, 64 threads a block)
    and ``blocks`` per batch row. TMA needs rows of a 16-byte multiple at
    16-byte aligned addresses."""
    if t >= STREAM_MIN_T and aligned and (w * elem_bytes) % 16 == 0:
        return {"channels": CHANNELS, "blocks": -(-w // CHANNELS)}
    return {"channels": 0, "blocks": -(-w // 64)}


def _fn():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Launch the recurrence ``h_t = a_t * h_{t-1} + b_t``. a, b: (B, T, W)
    in one dtype (fp32 on the engine path, bf16 also taken); h0: (B, W)
    fp32. Returns (h (B, T, W) in a's dtype, h_last (B, W) fp32)."""
    _build.refuse_grad("rglru", a, b, h0)
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
    if bsz * t * w == 0:
        return torch.empty_like(a), h0.clone()
    aligned = all(x.data_ptr() % 16 == 0 for x in (a, b))
    return _launch(a, b, h0, plan(t, w, a.element_size(), aligned)["channels"])


def _launch(a, b, h0, channels: int):
    """One launch of the body ``channels`` selects (0: per thread;
    ``CHANNELS``: streamed) on arguments ``rglru`` has checked; ``rglru``
    passes what ``plan`` picks (a same-call timing of the other body
    passes the other)."""
    bsz, t, w = a.shape
    dev = a.device
    h = torch.empty_like(a)           # the allocator aligns it to 512 bytes
    h_last = torch.empty_like(h0)
    maps = [tma.seq_map(x, CHANNELS, STEPS) for x in (a, b, h)] \
        if channels else [None] * 3
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                h_last.data_ptr(), bsz, t, w, DTYPES[a.dtype], channels,
                *maps, stream)
    _build.check(rc, "rglru")
    counts.add("rglru")
    return h, h_last
