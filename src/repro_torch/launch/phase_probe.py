"""Clock traces of the slot family's two kernels, phase by phase, on the
card (a diagnostic).

    PYTHONPATH=src python -m repro_torch.launch.phase_probe

Builds ``csrc/wkv6.cu`` and ``csrc/rglru_scan.cu`` once more with
``-DPROBE`` into ``csrc/_build/probe/``: their ``STAMP`` lines, empty in
the port's own build, then have thread 0 of block (0, 0) write
``clock64()`` at each phase boundary. Runs each kernel at its main-path
shape (rwkv6-1.6b WKV6 prefill (1, 256, 32, 64) bf16; recurrentgemma-2b
RG-LRU prefill (1, 256, 2560) fp32) after two warm-up launches, and prints
the cycles of each phase: for WKV6 per window of chunks (P1a, P1b, P2,
P3, P4, as the kernel's comments name them), for RG-LRU per 64-step tile
(the wait for its TMA copy and the chain). A stamp marks where thread 0
passes; work the compiler moves across it lands in the neighbouring
phase.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import _build, tma
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import wkv6 as WKV

PROBE_DIR = _build.BUILD_DIR / "probe"
SLOTS = 4096                 # g_clk's length in the kernels


def _build_probe(stem: str) -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    so = PROBE_DIR / f"lib{stem}.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPROBE",
                          "-o", str(so), str(_build.CSRC / f"{stem}.cu")],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc -DPROBE failed on {stem}.cu:\n"
                           f"{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.probe_read.argtypes = [ctypes.c_void_p]
    return lib


def _read(lib) -> list:
    buf = torch.zeros(SLOTS, dtype=torch.int64)
    torch.cuda.synchronize()
    if lib.probe_read(buf.data_ptr()) != 0:
        raise RuntimeError("probe_read failed")
    return buf.tolist()


def main() -> None:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)

    lib = _build_probe("wkv6")
    lib.wkv6_launch.argtypes = [p] * 7 + [i] * 6 + [p]
    b, t, h, hd = 1, 256, 32, 64
    r, k, v = (torch.randn((b, t, h, hd), generator=gen, device=dev)
               .bfloat16() * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, hd), generator=gen,
                                         device=dev) * 0.5 - 1)).bfloat16()
    u = torch.randn((h, hd), generator=gen, device=dev) * 0.3
    st = torch.randn((b, h, hd, hd), generator=gen, device=dev) * 0.5
    y = torch.empty_like(r)
    for _ in range(3):
        rc = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w.data_ptr(), u.data_ptr(), st.data_ptr(),
                             y.data_ptr(), b, t, h, hd, 1,
                             WKV.plan(t, hd)["splits"], stream)
        _build.check(rc, "wkv6 probe")
    c = _read(lib)
    windows = [n for n in range(SLOTS // 8) if c[8 * n] and c[8 * n + 5]]
    print(f"wkv6 chunked body, (1, 256, 32, 64) bf16, block 0: "
          f"{c[8 * windows[-1] + 5] - c[0]} cycles; per window "
          f"[P1a, P1b, P2, P3, P4]:")
    for n in windows:
        print(f"  window {n}: {[c[8 * n + j + 1] - c[8 * n + j] for j in range(5)]}")

    lib = _build_probe("rglru_scan")
    lib.rglru_launch.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    a = torch.sigmoid(torch.randn((1, 256, 2560), generator=gen, device=dev))
    bb = torch.randn_like(a) * 0.2
    h0 = torch.randn((1, 2560), generator=gen, device=dev)
    hs, hl = torch.empty_like(a), torch.empty_like(h0)
    maps = [tma.seq_map(x, RG.CHANNELS, RG.STEPS) for x in (a, bb, hs)]
    for _ in range(3):
        rc = lib.rglru_launch(a.data_ptr(), bb.data_ptr(), h0.data_ptr(),
                              hs.data_ptr(), hl.data_ptr(), 1, 256, 2560, 0,
                              RG.CHANNELS, *maps, stream)
        _build.check(rc, "rglru probe")
    c = _read(lib)
    tiles = [n for n in range(64) if c[8 + 4 * n] and c[10 + 4 * n]]
    print("rglru streamed body, (1, 256, 2560) fp32, block 0; per 64-step "
          "tile [start (from tile 0's start), wait, chain]:")
    for n in tiles:
        print(f"  tile {n}: {[c[8 + 4 * n] - c[8], c[9 + 4 * n] - c[8 + 4 * n], c[10 + 4 * n] - c[9 + 4 * n]]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
