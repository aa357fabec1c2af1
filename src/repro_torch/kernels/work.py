"""The work of each kernel of the port: the bytes it must move (each input
read once, each output written once) and the operations it does, and the
least time one card takes for them (``bound``: the larger of the bytes
over the HBM rate and the operations over the peak of the unit that runs
them, the card's figures from ``core/perf_model.py``). One home for every
user: ``chip_smoke.py`` prints each kernel's bound from these formulas,
and the meta route of ``ops`` records them for the dry run's count
(``record``), so a kernel's count never comes from its plain version's
step-by-step arithmetic.

``es`` is the element size of the bf16 (or fp32) activations; the int32
tables are counted at 4 bytes."""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence, Tuple



def peaks() -> dict:
    """{unit: operations per second} of the card (``core/perf_model.py``,
    imported here: ``core`` imports the engine, which imports the
    kernels)."""
    from repro_torch.core import perf_model as PM
    return {"bf16": PM.PEAK_FLOPS, "tf32": PM.TF32_FLOPS,
            "fp32": PM.FP32_FLOPS, "hbm": PM.HBM_BW}


@dataclass(frozen=True)
class Work:
    nbytes: int
    flops: int          # the arithmetic's own operation count
    unit: str = "bf16"  # the units that run it: a key of peaks()
    ops: Optional[int] = None   # operations the units issue (TF32 split: 3x)

    @property
    def issued(self) -> int:
        return self.flops if self.ops is None else self.ops

    def bound(self) -> Tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time and what sets
        it."""
        return bound(self.nbytes, self.issued, self.unit)


def bound(nbytes: float, ops: float, unit: str = "bf16") -> Tuple[float, str]:
    pk = peaks()
    b, f = nbytes / pk["hbm"], ops / pk[unit]
    return max(b, f) * 1e3, ("bytes" if b >= f else "operations")


def decode_keys(lengths: Iterable[int], window: Optional[int]) -> int:
    """Keys one decode step reads over sequences of ``lengths``."""
    return sum(min(n, window or n) for n in lengths)


def paged_attention(b: int, h: int, hkv: int, hd: int, n_keys: int,
                    table_entries: int, es: int = 2) -> Work:
    """Decode attention of ``b`` queries over ``n_keys`` keys in all: q in
    and out, each key's K and V read once, the block table and lengths."""
    return Work(2 * (es * b * h * hd) + 2 * es * n_keys * hkv * hd
                + 4 * (table_entries + b), 4 * h * hd * n_keys)


def paged_prefill(h: int, hkv: int, hd: int, starts: Sequence[int],
                  lens: Sequence[int], window: Optional[int],
                  table_entries: int, es: int = 2) -> Work:
    """Ragged paged prefill: entry i's ``lens[i]`` queries after a cached
    prefix of ``starts[i]`` tokens, each attending to the causal keys in
    its window; the keys an entry's queries reach are read once."""
    win = window or 2 ** 62
    pairs = sum(sum(min(s + j + 1, win) for j in range(n))
                for s, n in zip(starts, lens))
    keys_read = sum(s + n - max(0, s - win + 1) for s, n in zip(starts, lens))
    n_tok, sb = sum(lens), len(lens)
    return Work(2 * (es * n_tok * h * hd) + 2 * es * keys_read * hkv * hd
                + 4 * (table_entries + 3 * sb + 1), 4 * h * hd * pairs)


def causal_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs of a causal attention over ``s`` positions."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_prefill(b: int, s: int, h: int, hkv: int, hd: int,
                  window: Optional[int], es: int = 2) -> Work:
    """The dense entry: ``b`` sequences of ``s`` positions from scratch."""
    return Work(b * (2 * (es * s * h * hd) + 2 * es * s * hkv * hd),
                b * 4 * h * hd * causal_pairs(s, window))


def wkv6(b: int, t: int, h: int, hd: int, chunked: bool,
         es: int = 2) -> Work:
    """WKV6 over (b, t, h, hd): r, k, v, w in and y out, u, and the fp32
    state read and written. The chunked body runs its products on the
    tensor cores as three TF32 products each (its split precision), the
    per-token body on the CUDA cores in fp32."""
    n = b * t * h * hd
    flops = b * t * h * (5 * hd * hd + 3 * hd)
    nbytes = 5 * es * n + 4 * h * hd + 2 * 4 * b * h * hd * hd
    if chunked:
        return Work(nbytes, flops, "tf32", 3 * flops)
    return Work(nbytes, flops, "fp32")


def rglru(b: int, t: int, w: int) -> Work:
    """The RG-LRU recurrence over (b, t, w) in fp32: a and b in, h out, h0
    in and h_last out; a multiply and an add a step."""
    return Work(3 * 4 * b * t * w + 2 * 4 * b * w, 2 * b * t * w, "fp32")


# ------------------------------------------------------- the meta route's sink
_local = threading.local()


def record(name: str, work: Work) -> None:
    """A kernel's work on the meta device, to every sink open on this
    thread (``recording``); none open, it is dropped."""
    for sink in getattr(_local, "sinks", ()):
        sink(name, work)


@contextlib.contextmanager
def recording(sink: Callable[[str, Work], None]):
    """Send ``record``'s calls on this thread to ``sink`` inside the
    block."""
    sinks = _local.__dict__.setdefault("sinks", [])
    sinks.append(sink)
    try:
        yield
    finally:
        sinks.remove(sink)
