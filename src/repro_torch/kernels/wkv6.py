"""WKV6: the CUDA kernels ``csrc/wkv6.cu`` and their launcher. They replace
the Pallas kernel ``repro/kernels/rwkv6_wkv.py::wkv6`` and, unlike it,
carry a state in and out; the plain version is ``ref.wkv6_ref``. Go
through ``ops.wkv6``, which routes CPU tensors to the plain version.

``plan`` picks the body from the shapes alone: the per-token recurrence for
a decode step (T = 1), else the chunked form (chunks of ``CHUNK`` tokens,
sub-chunks of ``SUB``, the v-columns of a head split over blocks of
``V_COLS``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counts

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 16          # tokens per chunk (one step of the kernel's chain)
SUB = 4             # tokens per sub-chunk (where cross-pair decays meet)
V_COLS = 16         # v-columns per block of the chunked body


def plan(t: int, hd: int) -> dict:
    """The body and grid for a call of T tokens at head dim ``hd`` (shapes
    only): ``chunked`` (bool), ``chunks`` (the serial steps of a block) and
    ``splits`` (blocks per (b, h): the chunked body splits a head's
    v-columns into blocks of ``V_COLS``; blocks of 8, two per SM, were
    slower on the H100, as each block recomputes its chunk's scores)."""
    if t <= 1:
        return {"chunked": False, "chunks": t, "splits": 1}
    return {"chunked": True, "chunks": -(-t // CHUNK), "splits": hd // V_COLS}


def _fn():
    lib = _build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor):
    """Launch the WKV6 kernel. r, k, v, w: (B, T, H, hd), one dtype (fp32
    or bf16), T >= 1; u: (H, hd) fp32; state: (B, H, hd, hd) fp32 (k-dim
    by v-dim). The state after the last token is written over ``state``
    IN PLACE. Returns (y (B, T, H, hd) in r's dtype, state)."""
    _build.refuse_grad("wkv6", r, k, v, w, u, state)
    b, t, h, hd = r.shape
    dev = r.device
    if dev.type != "cuda":
        raise ValueError("wkv6 kernel needs CUDA tensors")
    if r.dtype not in DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"r/k/v/w must share one of {list(DTYPES)}: "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if u.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError("u and state must be float32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if any(x.shape != r.shape for x in (k, v, w)) or u.shape != (h, hd) \
            or state.shape != (b, h, hd, hd):
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, u "
                         f"{tuple(u.shape)}, state {tuple(state.shape)}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
    if b * t == 0 or h == 0:
        return torch.empty_like(r), state
    pl = plan(t, hd)
    return _launch(r, k, v, w, u, state, pl["splits"] if pl["chunked"] else 0)


def _launch(r, k, v, w, u, state, splits: int):
    """One launch of the body ``splits`` selects (0: per token; hd/16:
    chunked) on arguments ``wkv6`` has checked; ``wkv6`` passes what
    ``plan`` picks (a same-call timing of the other body passes the
    other)."""
    b, t, h, hd = r.shape
    dev = r.device
    y = torch.empty_like(r)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), b, t, h, hd,
                DTYPES[r.dtype], splits, stream)
    _build.check(rc, "wkv6")
    counts.add("wkv6")
    return y, state
