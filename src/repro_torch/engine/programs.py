"""Device programs of the decode hot loop: the port's counterpart of the
reference's jit caches for it, ``_decode_fused_fn`` (one program per
(K, Bb, Pb), ``repro/engine/runners/paged.py:481-530``) and ``_sample_fn``
(one all-slot decode+sample program, ``repro/engine/runners/slot.py:
233-250``), counted as the reference counts its cache misses
(``jit_compiles``).

A ``Program`` is one body over static inputs, kept in its TE's
``ProgramCache`` under a key:

  * On a card its first call runs the body eagerly on the TE's side
    stream (this builds the kernels, sets their attributes, warms cuBLAS
    and the allocator; its result is that call's result), then captures
    the body once as a CUDA graph into the TE's graph pool. Every later
    call replays the graph: one device program per call.
  * On the CPU the same object runs its body over its static inputs
    directly: the plain path, as ``kernels/ops.py`` sends CPU tensors to
    the plain kernels. So the CPU tests go through the keys and the
    copies in and out.

A call copies the caller's tensors into the static inputs (device to
device, in stream order, no host read) and returns the body's outputs. On
a card those are the graph's static outputs, which the next replay of any
program of the same pool may overwrite: the caller consumes them in stream
order before its next call (the engine copies a token block to pinned
memory right after the call; the paged runner copies the carried lengths
and last tokens back into its state in place). The body must read nothing
but its static inputs and storage that never moves (weights, pools,
caches): a graph holds raw addresses, so ``release`` drops every program
before a TE's weights go.

Launch counts (``kernels/counts.py``) are added in Python, so a replay
would count nothing: a program records the tally its body counted during
capture, takes it back out (a capture launches nothing) and adds it on
every replay.

Every program of one TE shares one graph pool; programs of two TEs never
share one. Captures serialize on one process lock and use the
thread-local capture mode, so fleet threads may launch eagerly while one
of them captures. A capture that fails raises, naming the key: nothing
falls back to the eager body. A TE whose ranks lie on more than one
device keeps the eager body (``ProgramCache.enabled`` is decided from the
mesh when the TE is built).
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import counts

Body = Callable[..., Tuple[torch.Tensor, ...]]

# one capture at a time in the process (the caching allocator and the
# capture's synchronisation are process-wide)
_capture_lock = threading.Lock()


class Program:
    """One body over static inputs (module docstring). ``inputs`` are the
    static input tensors by name, ``gen`` the generator the body draws
    from (registered with the graph before capture; None for a body that
    draws nothing)."""

    def __init__(self, key: tuple, body: Body,
                 inputs: Dict[str, torch.Tensor], cache: "ProgramCache",
                 gen: Optional[torch.Generator] = None):
        self.key = key
        self.body = body
        self.inputs = inputs
        self.gen = gen
        self.cache = cache
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[str, int] = {}   # kernel launches of one replay
        self.capture_ms = 0.0                # host wall of the capture

    def __call__(self, **src: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Copy ``src`` into the static inputs of the same names, run the
        program and return its outputs."""
        for name, t in src.items():
            self.inputs[name].copy_(t, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            for name, n in self.launches.items():
                counts.add(name, n)
            return self.outputs
        if next(iter(self.inputs.values())).device.type != "cuda":
            return self.body(**self.inputs)
        return self._build()

    def _build(self) -> Tuple[torch.Tensor, ...]:
        """The first call on a card: the body eagerly on the side stream
        (its outputs are this call's), then the capture."""
        dev = next(iter(self.inputs.values())).device
        with _capture_lock, torch.cuda.device(dev):
            side = self.cache.side_stream(dev)
            cur = torch.cuda.current_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self.body(**self.inputs)
            cur.wait_stream(side)
            for t in out:
                t.record_stream(cur)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            if self.gen is not None:
                graph.register_generator_state(self.gen)
            before = counts.thread_tally()
            t0 = time.perf_counter()
            # no cyclic collection inside the capture: a dropped TE's
            # graphs destroyed there would invalidate it; the outer stream
            # context puts the caller's stream back even when a failed
            # capture_end leaves the graph's own unexited
            collect = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(side), torch.cuda.graph(
                        graph, pool=self.cache.pool(), stream=side,
                        capture_error_mode="thread_local"):
                    outputs = self.body(**self.inputs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"decode program {self.key}: capture failed: {e}") from e
            finally:
                if collect:
                    gc.enable()
                taken = {n: c - before[n]
                         for n, c in counts.thread_tally().items()}
                for name, n in taken.items():
                    counts.add(name, -n)
            self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.graph, self.outputs = graph, outputs
        self.launches = {n: c for n, c in taken.items() if c}
        return out


class ProgramCache:
    """A TE's programs by key, its graph pool and side stream. ``builds``
    counts the programs made (the reference's ``jit_compiles``: its
    bucketed keys make it 0 in steady state after a warmup)."""

    def __init__(self, mesh):
        # a graph replays on one device: a TE spread over several keeps
        # the eager body
        self.enabled = len(mesh.distinct) == 1
        self.programs: Dict[tuple, Program] = {}
        self.builds = 0
        self.released = False
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None

    def get(self, key: tuple, make: Callable[[], Program]) -> Program:
        """The program of ``key``, made by ``make`` on its first use."""
        prog = self.programs.get(key)
        if prog is None:
            if self.released:
                raise RuntimeError(
                    f"decode program {key}: the TE released its weights")
            prog = self.programs[key] = make()
            self.builds += 1
        return prog

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def pool_id(self):
        """The graph pool's id (a memory snapshot's ``segment_pool_id``),
        or None before the first capture."""
        return self._pool

    def side_stream(self, dev: torch.device) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        return self._side

    def release(self) -> None:
        """Drop every program and the pool (the TE's weights are going:
        a graph must never replay over freed storage)."""
        self.programs.clear()
        self._pool = self._side = None
        self.released = True
