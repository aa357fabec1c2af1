"""Device programs: the port's counterpart of the reference's jit caches.
A ``ProgramCache`` holds programs of three kinds: each TE has one for the
first two, and each ``training.train`` call one for the third:

  * decode programs, counted as ``jit_compiles``: ``_decode_fused_fn``
    (one K-step decode+sample program per (K, Bb, Pb),
    ``repro/engine/runners/paged.py:481-530``), ``_decode_fn`` (the
    unfused per-step decode, ``:450-461``; the port keys it ("step", B,
    maxp)), ``_sample_fn`` (the all-slot decode+sample step,
    ``repro/engine/runners/slot.py:233-250``) and ``_decode_jit`` (the
    unfused all-slot step, ``:192-199``; key ("step",));
  * prefill programs, counted as ``prefill_jit_compiles``: ``_ragged_fn``
    (the whole step's ragged prefill and its first tokens,
    ``repro/engine/runners/paged.py:268-346``; key ("ragged", Tb, Pb, Sb,
    all-greedy)), the per-sequence ``_prefill_fn`` (``:186-234``; key
    ("chunk", c, npages)) and the slot family's ``_prefill_fn``
    (``repro/engine/runners/slot.py:160-180``; key ("slot_prefill", cb)
    plus the names of the request's modality inputs, ``n_valid`` a static
    input so one program serves every real length in a bucket);
  * train programs, counted as ``train_builds``: ``step_fn =
    jax.jit(make_train_step(bundle, tcfg))``
    (``repro/training/train_loop.py:84``): the forward with per-block
    remat, the gradients, the microbatch sums and AdamW of one step, the
    weights and the optimizer state updated in place (key (B, S,
    microbatches, the modality inputs' names and shapes);
    ``training/train_loop.py::TrainProgram``). Its cache is built for the
    one device of the weights (``launch/mesh.py::one_rank``).

The keys of the serving kinds are disjoint (the new ones lead with a tag).
The reference counts a jit cache miss; the port counts the programs it
builds (the reference's ``_decode_fn`` also retraces for a new B without
counting it, where the port builds and counts one program per (B, maxp)).

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
program of the same pool, of either kind, may overwrite: the caller
consumes them in stream order before its next call (the engine copies a
token block to pinned memory right after the call and fetches a prefill
step's first tokens at once; the paged runner copies the carried lengths
and last tokens back into its state in place; the slot runner copies its
staged rows back into the slot; logits handed to a caller are cloned or
sampled before the next call). The body must read nothing but its static
inputs and storage that never moves (weights, pools, caches, the slot
runner's staging cache): a graph holds raw addresses, so ``release``
drops every program before a TE's weights go.

Launch counts (``kernels/counts.py``) are added in Python, so a replay
would count nothing: a program records the tally its body counted during
capture, takes it back out (a capture launches nothing) and adds it on
every replay.

Every program of one cache shares one graph pool; two caches never share
one. Captures serialize on one process lock and use the thread-local
capture mode, so fleet threads may launch eagerly while one of them
captures. That mode also admits a train program's backward: autograd
runs a CUDA backward on its own device thread, which launches into the
capturing stream (so its work is captured) and whose allocations on that
stream go to the pool; only the capturing thread is barred from unsafe
calls. A capture that fails raises, naming the kind and the key: nothing
falls back to the eager body. ``capture_ms`` is the host wall of the
capture and the graph's instantiation. A train program keeps its
``cudaGraph_t`` (``keep_graph``) to record its node count and
instantiates it apart, timing that part as ``instantiate_ms``; the
serving programs keep none. A TE whose ranks lie on more
than one device keeps the eager bodies (``ProgramCache.enabled`` is
decided from the mesh when the TE is built).
"""
from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import counts

Body = Callable[..., Tuple[torch.Tensor, ...]]

# one capture at a time in the process (the caching allocator and the
# capture's synchronisation are process-wide)
_capture_lock = threading.Lock()


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with ``keep_graph`` (libcuda's
    ``cuGraphGetNodes``)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t))
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return int(n.value)


class Program:
    """One body over static inputs (module docstring). ``inputs`` are the
    static input tensors by name, ``gen`` the generator the body draws
    from (registered with the graph before capture; None for a body that
    draws nothing), ``kind`` the count it goes into."""

    def __init__(self, key: tuple, body: Body,
                 inputs: Dict[str, torch.Tensor], cache: "ProgramCache",
                 gen: Optional[torch.Generator] = None,
                 kind: str = "decode"):
        self.key = key
        self.kind = kind                     # one of ProgramCache.KINDS
        self.body = body
        self.inputs = inputs
        self.gen = gen
        self.cache = cache
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[str, int] = {}   # kernel launches of one replay
        self.capture_ms = 0.0                # host wall of the capture,
        self.instantiate_ms = 0.0            # its instantiation a part of it
        self.nodes: Optional[int] = None     # the graph's node count (train)

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
            if self.kind == "train":
                # an eager train step leaves tensors in reference cycles
                # (autograd and remat closures): collect them, so that the
                # cache the capture empties first no longer holds them
                # beside the pool
                gc.collect()
            torch.cuda.synchronize(dev)
            # a train graph keeps its cudaGraph_t to count its nodes; the
            # serving graphs (hundreds per TE) drop theirs at capture_end
            keep = self.kind == "train"
            graph = torch.cuda.CUDAGraph(keep_graph=keep)
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
                    f"{self.kind} program {self.key}: capture failed: "
                    f"{e}") from e
            finally:
                if collect:
                    gc.enable()
                taken = {n: c - before[n]
                         for n, c in counts.thread_tally().items()}
                for name, n in taken.items():
                    counts.add(name, -n)
            if keep:
                self.nodes = _node_count(graph)
                t1 = time.perf_counter()
                graph.instantiate()
                self.instantiate_ms = 1e3 * (time.perf_counter() - t1)
            self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.graph, self.outputs = graph, outputs
        self.launches = {n: c for n, c in taken.items() if c}
        return out


class ProgramCache:
    """Programs of every kind by key, their graph pool and side stream:
    a TE's, or a train job's. ``builds`` counts the decode programs made
    (the reference's ``jit_compiles``), ``prefill_builds`` the prefill
    programs (its ``prefill_jit_compiles``): its bucketed keys make both
    0 in steady state after a warmup. ``train_builds`` counts the train
    programs (one per batch shape)."""

    KINDS = ("decode", "prefill", "train")

    def __init__(self, mesh):
        # a graph replays on one device: a TE spread over several keeps
        # the eager bodies
        self.enabled = len(mesh.distinct) == 1
        self.by_kind: Dict[str, Dict[tuple, Program]] = {
            k: {} for k in self.KINDS}
        self.n_built: Dict[str, int] = dict.fromkeys(self.KINDS, 0)
        self.released = False
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None

    @property
    def programs(self) -> Dict[tuple, Program]:
        """The decode programs by key."""
        return self.by_kind["decode"]

    @property
    def prefill_programs(self) -> Dict[tuple, Program]:
        """The prefill programs by key."""
        return self.by_kind["prefill"]

    @property
    def builds(self) -> int:
        return self.n_built["decode"]

    @property
    def prefill_builds(self) -> int:
        return self.n_built["prefill"]

    @property
    def train_builds(self) -> int:
        return self.n_built["train"]

    def all(self) -> List[Program]:
        """Every program of every kind."""
        return [p for k in self.KINDS for p in self.by_kind[k].values()]

    def get(self, key: tuple, make: Callable[[], Program],
            kind: str = "decode") -> Program:
        """The ``kind`` program of ``key``, made by ``make`` on its first
        use."""
        progs = self.by_kind[kind]
        prog = progs.get(key)
        if prog is None:
            if self.released:
                raise RuntimeError(
                    f"{kind} program {key}: its owner released its weights")
            prog = progs[key] = make()
            self.n_built[kind] += 1
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
        """Drop every program and the pool (the weights they read are
        going: a graph must never replay over freed storage)."""
        for progs in self.by_kind.values():
            progs.clear()
        self._pool = self._side = None
        self.released = True
