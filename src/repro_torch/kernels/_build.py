"""Build and load the port's CUDA kernels (route (b): ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``).

Nothing is compiled at import: the first kernel launch calls ``load``,
which compiles EVERY ``csrc/*.cu`` at once — one ``nvcc`` process per
source, all started together — into ``csrc/_build/`` (git-ignored). Each
library is named by a hash of its source and flags, so an edited kernel
never loads a stale binary. There is no fallback: a missing ``nvcc`` or a
failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0        # wall time of the last build (0.0 = none yet)
ptxas_report: Dict[str, str] = {}   # per source: registers / smem / spills


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC): the port's "
                       "CUDA kernels are built from csrc/ at first use")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing, in parallel.
    Returns {stem: library path}."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _lib_path(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((s, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        ptxas_report[s.stem] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s.name} (rc {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[s.stem])
    build_seconds = time.monotonic() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all
    sources on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _libs[stem] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a launch of kernel ``what``: a
    launcher fills its outputs through ctypes, so autograd never sees
    them and a backward would give no gradient to anything upstream. No
    kernel has a backward (the reference trains through jnp scans and
    masked attention, never through a Pallas kernel), so a loss asks for
    the plain versions by name (``impl="scan"``, the reference's sequence
    forms of the recurrences, or ``impl="ref"``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and autograd cannot "
            f"see its outputs; under autograd call the plain version "
            f"(impl='scan' or 'ref')")
