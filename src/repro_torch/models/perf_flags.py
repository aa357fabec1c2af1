"""Opt-in performance features of the reference (the counterpart of
``repro/models/perf_flags.py``). Every flag is off by default and each
preserves numerics. The port reads ``banded_swa_prefill`` (the plain
prefill attention of ``swa`` archs, ``transformer.self_attention``),
``windowed_decode`` (``serving.decode_step``) and ``ring_buffer_decode``
(``steps.decode_cache``'s default, the reference dry run's choice of a
decode cache). ``chunked_ce`` has no reader in either package: it is
carried as a field, and setting it raises rather than doing nothing."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class PerfFlags:
    # decode: SWA archs read only the trailing window+1 slots of a linear
    # cache instead of masking the whole context
    windowed_decode: bool = False
    # prefill: SWA attention over a gathered diagonal band instead of the
    # full-causal chunk scan (the plain route; the CUDA kernel skips the
    # key blocks outside the window by itself)
    banded_swa_prefill: bool = False
    # train: cross-entropy computed in sequence chunks
    chunked_ce: bool = False
    # decode: a rotating KV buffer of ring_len(cfg) slots for windowed archs
    ring_buffer_decode: bool = False


_FLAGS = PerfFlags()
UNREAD = ("chunked_ce",)


def get() -> PerfFlags:
    return _FLAGS


def set_flags(**kw) -> PerfFlags:
    global _FLAGS
    on = [k for k in UNREAD if kw.get(k)]
    if on:
        raise NotImplementedError(f"perf flags {on} have no reader in the "
                                  f"port (nor in the reference)")
    _FLAGS = replace(_FLAGS, **kw)
    return _FLAGS


def reset() -> None:
    global _FLAGS
    _FLAGS = PerfFlags()
