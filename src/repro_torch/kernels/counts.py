"""Launch counts of the port's kernels (the main-path proof): each
kernel's wrapper calls ``add`` once where it launches its kernel, and
nowhere else.

Fleet worker threads launch concurrently, so the process-wide totals are
updated under a lock, and each thread also keeps its own tally: a TE's
step runs on one thread, so the change of that thread's tally across the
step is exactly that TE's launches (``FlowServe.kernel_launches``),
whatever other TEs launch on other threads meanwhile.

A captured CUDA graph launches its kernels without Python, so a decode
program (``engine/programs.py``) adds its body's tally on every replay
and takes back what its body counted while it was being captured."""
from __future__ import annotations

import threading
from typing import Dict

NAMES = ("paged_attention", "flash_prefill", "wkv6", "rglru")

_lock = threading.Lock()
_totals: Dict[str, int] = dict.fromkeys(NAMES, 0)
_local = threading.local()


def _tally() -> Dict[str, int]:
    tally = getattr(_local, "tally", None)
    if tally is None:
        tally = _local.tally = dict.fromkeys(NAMES, 0)
    return tally


def add(name: str, n: int = 1) -> None:
    with _lock:
        _totals[name] += n
    _tally()[name] += n


def totals() -> Dict[str, int]:
    """Launches of every thread since the last ``reset``."""
    with _lock:
        return dict(_totals)


def reset() -> None:
    with _lock:
        for name in NAMES:
            _totals[name] = 0


def thread_tally() -> Dict[str, int]:
    """This thread's launches since it started (never reset)."""
    return dict(_tally())
