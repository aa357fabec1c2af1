"""FLOWSERVE — the serving engine (§4), torch port of the colocated path
of ``repro/engine/flowserve.py``. One engine == one task engine (TE) on one
device: the master (this class) runs the scheduler; the executor is the
runner of the model's family (``engine/runners``), which decides the data
plane.

  * paged family (attention-only towers): a page pool with the RTC prefix
    cache. A step packs every planned prefill chunk into ONE ragged
    prefill pass (first tokens sampled in it) and runs decode as K-step
    fused horizons over the device-resident batch state, fetching each
    horizon's tokens one horizon late. Each pass and each horizon is one
    device program (``engine/programs.py``: a CUDA graph replayed on a
    card), counted as ``prefill_jit_compiles`` and ``jit_compiles``.
  * slot family (rwkv6, recurrentgemma, seamless-m4t enc-dec,
    llama-3.2-vision): dense per-slot caches, no pool and no RTC. Prefill
    is chunked per sequence on its slot, with the request's modality
    inputs (``Request.extra``) refilling the cross cache at every chunk,
    each chunk one program per length bucket over the slot's staged rows;
    decode is one all-slot step with sampling in the same program; prefix
    reuse restores a state checkpoint taken when an earlier request
    released its slot.

The reference's switches, each read from ``ecfg`` at every step and each
on by default, give the baselines its tests and benchmarks compare
against: ``enable_prefix_cache=False`` runs a paged TE without an RTC (no
prefix reuse, no DRAM tier) and a slot TE without state checkpoints;
``async_sched=False`` plans each step at its start instead of while the
previous one runs; ``batched_prefill=False`` gives a paged TE one prefill
pass per sequence per chunk (the first token then comes from the decode
path); ``fused_decode=False`` runs one decode step per iteration and
samples its logits on the host (``_commit_tokens``), for both families.
Every one of these paths runs through its programs on one device.

Modes (§4.5): "colocated" (chunked prefill and decode in one TE),
"prefill" (a P-TE: prefill only; a finished prompt waits in
``pop_migratable`` for ``migrate_out``) and "decode" (a D-TE: decode only,
over sequences that ``import_request`` admits). A migration moves a
paged sequence's page run over DistFlow, device to device and in layer
chunks that the D-TE scatters behind their CUDA events just before the
sequence's first decode; a slot sequence moves as its slot snapshot.

The fleet runtime (``core/serving_plane.py``) steps TEs from per-unit
worker threads while its JE thread migrates, forks and reads loads,
so every public entry point holds the engine's ``RLock``
(``_executor_safe``) and ``migrate_out`` takes both endpoints' locks in
name order. A TE comes up three ways: built on a weights tree it is
given (the fleet's TEs share one), forked from a live TE (``fork_from``:
every parameter copied device to device into the new TE's own storage)
or uploaded from a ``WarmPool`` entry (``from_warm``); ``release_params``
drains a TE's weights to pinned host memory for that pool. A
``FaultPlan`` (``core/faults.py``) hooks ``step``, ``migrate_out`` and
``fork_from``; ``void_pending_imports`` and ``cancel_queued`` let the
plane recover and drain.

Tensor parallelism (``EngineConfig.tp``, both families): the TE's ranks
form one ``launch.mesh.EngineMesh``, built once; the constructor shards
the full weights tree it is given (``launch/sharding.py``), and a TE's
weights are always the list of its ranks' trees (one at tp 1), its pool
one pool per rank, a page run one run per rank, and a slot TE's dense
caches one cache per rank. A migration re-splits the KV heads, or a slot
snapshot's leaves, when the two TEs' tp differ, and a fork re-splits the
weights onto the new TE's mesh. A state checkpoint is a slot snapshot of
the TE's own ranks.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.distflow import (BufferInfo, DistFlow, TransferFault,
                                         _nbytes, tree_leaves)
from repro_torch.engine.hotloop import DecodeHotState, pow2_bucket, pow2s
from repro_torch.engine.kv_cache import (OutOfPagesError, PagedKVPool,
                                         pages_needed)
from repro_torch.engine.rtc import RelationalTensorCache, RTCCostModel
from repro_torch.engine.runners import SequenceState, resolve_family
from repro_torch.engine.sampling import SamplingParams, sample_batch
from repro_torch.engine.scheduler import Scheduler, SchedulerConfig
from repro_torch.engine.tokenizer import EOS_ID, ByteTokenizer
from repro_torch.kernels import counts
from repro_torch.kernels import flash_prefill as FP
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh
from repro_torch.models import serving as S
from repro_torch.models import transformer as T

_req_ids = itertools.count()


@dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    req_id: str = ""
    ctx_id: Optional[str] = None        # explicit context-caching id
    arrival: float = field(default_factory=time.monotonic)
    # modality stubs, numpy (1, P, D): "vision_embeds" (VLM) or "frames"
    # (enc-dec); a request without them gets zeros
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if not self.req_id:
            self.req_id = f"req-{next(_req_ids)}"


@dataclass
class Completion:
    req_id: str
    tokens: List[int]
    ttft: float
    finish: float
    arrival: float
    n_prompt: int

    @property
    def tpot(self) -> float:
        n = max(len(self.tokens) - 1, 1)
        return (self.finish - self.arrival - self.ttft) / n


@dataclass
class EngineConfig:
    mode: str = "colocated"             # colocated | prefill | decode
    tp: int = 1                         # ranks of the TE's mesh
    device_offset: int = 0              # first device of its 1 x tp window
    n_pages: int = 256                  # paged family: pool pages
    page_size: int = 16
    n_slots: int = 8                    # slot family: slots
    max_len: int = 256                  # slot family: per-slot capacity
    max_batch_tokens: int = 64
    max_decode_batch: int = 8
    chunk_size: int = 16
    max_prefill_seqs: int = 8           # concurrent mid-prefill sequences
    enable_prefix_cache: bool = True
    async_sched: bool = True
    fused_decode: bool = True           # K-step decode horizons (DESIGN §8)
    decode_horizon: int = 8             # max fused multi-step K (1 = off)
    batched_prefill: bool = True        # one-dispatch ragged prefill (§12)
    dtype: torch.dtype = torch.float32  # KV pool / slot cache dtype
    seed: int = 0
    kernel_impl: str = "auto"           # "auto" = the kernels on CUDA |
                                        # "ref" = their plain versions


def _executor_safe(fn):
    """Serialize an engine entry point on the per-engine RLock: fleet
    worker threads step TEs while the JE's own thread runs cross-unit
    actions (drain migration, fork, load reads). The RLock keeps internal
    reentrancy (step -> export -> release) free."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


def _shapes(tree):
    """A weights tree's structure and leaf shapes, comparable across
    trees (dict keys in sorted order, as a JAX tree structure keeps
    them)."""
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    if isinstance(tree, list):
        return ("list", tuple(_shapes(v) for v in tree))
    return tuple(np.shape(tree))


class FlowServe:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 name: str = "te-0", device="cuda"):
        """A TE of ``cfg`` over the full weights tree ``params``, sharded
        here over its mesh: ``ecfg.tp`` ranks from ``ecfg.device_offset``
        past ``device`` (``launch/mesh.py``)."""
        mesh = make_engine_mesh(ecfg.tp, ecfg.device_offset,
                                resolve_device(device))
        self._setup(cfg, ecfg, name, mesh)
        self._build(SH.shard(params, self.param_specs, mesh))

    @classmethod
    def _from_ranks(cls, cfg: ModelConfig, ranks: list, ecfg: EngineConfig,
                    name: str, mesh: EngineMesh) -> "FlowServe":
        """A TE over its ranks' weights trees, already on ``mesh`` (a fork
        or a warm upload)."""
        te = cls.__new__(cls)
        te._setup(cfg, ecfg, name, mesh)
        te._build(ranks)
        return te

    def _setup(self, cfg: ModelConfig, ecfg: EngineConfig, name: str,
               mesh: EngineMesh) -> None:
        self._lock = threading.RLock()   # executor safety (DESIGN.md §9)
        self.cfg = cfg
        self.ecfg = ecfg
        self.name = name
        self.family = resolve_family(cfg)
        self.mesh = mesh
        # rank 0's device: activations, sampling and the decode hot state
        self.device = mesh.device
        self.param_specs = SH.te_param_specs(cfg, ecfg.tp)
        self.tokenizer = ByteTokenizer(max(cfg.vocab_size, 259))
        self.distflow = DistFlow(owner=name)
        self.fault_plan = None           # set by FaultPlan.attach (§11)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ecfg.seed)
        # CUDA event pairs (and the pinning's host seconds) of this TE's
        # weight copies: "fork", "h2d" (from_warm), "pin_s" / "d2h"
        # (release_params); read by whoever times them
        self.transfer_timing: Dict[str, Any] = {}
        # this TE's own kernel launches, read around each step on the
        # stepping thread (counts.thread_tally), exact under fleet threads
        self.kernel_launches: Dict[str, int] = dict.fromkeys(counts.NAMES, 0)

    def _build(self, ranks: list) -> None:
        cfg, ecfg = self.cfg, self.ecfg
        if self.family.uses_pages:
            self.pool = PagedKVPool(cfg, ecfg.n_pages, ecfg.page_size,
                                    ecfg.dtype, self.mesh)
            cm = RTCCostModel(flops_per_token=2.0 * cfg.active_param_count())
            self.rtc = RelationalTensorCache(self.pool, cm) \
                if ecfg.enable_prefix_cache else None
            self.runner = self.family.runner_cls(cfg, ranks, self.pool,
                                                 impl=ecfg.kernel_impl)
        else:
            self.pool = None
            self.rtc = None
            self.runner = self.family.runner_cls(
                cfg, ranks, ecfg.n_slots, ecfg.max_len, ecfg.dtype,
                self.mesh, impl=ecfg.kernel_impl)
            # token prefix -> slot snapshot of every rank (the recurrent
            # prefix cache)
            self._state_cache: Optional[Dict[tuple, Any]] = \
                {} if ecfg.enable_prefix_cache else None

        scfg = SchedulerConfig(max_batch_tokens=ecfg.max_batch_tokens,
                               max_decode_batch=ecfg.max_decode_batch,
                               chunk_size=ecfg.chunk_size,
                               max_prefill_seqs=ecfg.max_prefill_seqs,
                               mode=ecfg.mode)
        self.scheduler = Scheduler(scfg, self.rtc)
        self._seqs: Dict[str, SequenceState] = {}
        self._requests: Dict[str, Request] = {}
        self._ttft: Dict[str, float] = {}
        self._next_plan = None
        self._prefill_done_buffer: List[str] = []  # P-TE: ready to migrate
        self.steps = 0
        self.decode_steps = 0            # decode iterations executed (B-wide)
        self.decode_tokens = 0           # tokens sampled by decode (B x K)
        self.sampler_dispatches = 0      # standalone sampling passes
        self.host_dispatches = 0         # device passes on the decode path
        self.host_syncs = 0              # blocking device->host fetches
        self.prefill_dispatches = 0      # ragged prefill passes
        self.prefill_syncs = 0           # first-token fetches after prefill
        self.sample_params: Dict[str, SamplingParams] = {}
        # decode hot loop (DESIGN.md §8): persistent device batch state,
        # in-flight token blocks (fetched one horizon late) and the
        # per-sequence count of sampled-but-uncommitted tokens
        self._hot: Optional[DecodeHotState] = None
        self._inflight: deque = deque()  # (host toks, [(slot, id)], K, event)
        self._pending: Dict[str, int] = {}
        self._completed_buf: List[Completion] = []
        self._sp_cache: tuple = (None, None, None)  # batch-keyed temps/top_ps

    @property
    def jit_compiles(self) -> int:
        """Decode-path programs built (bucketed keys => 0 in steady state;
        the reference's count of its decode-path jit cache misses)."""
        return self.runner.jit_compiles

    @property
    def prefill_jit_compiles(self) -> int:
        """Prefill-path programs built (0 after ``warmup_prefill``; the
        reference's count of its prefill-path jit cache misses)."""
        return self.runner.prefill_jit_compiles

    # ---------------------------------------------------------------- scaling
    @classmethod
    def fork_from(cls, source: "FlowServe", ecfg: EngineConfig,
                  name: str = "te-fork", link: str = "ici",
                  device=None) -> "FlowServe":
        """NPU-fork (§6.3): bring up a new TE from a live TE's resident
        weights instead of re-initializing them. Every shard of the new
        TE's mesh (``ecfg.tp`` ranks from ``ecfg.device_offset`` past
        ``device``, default the source's device) is copied into new
        storage, device to device on the stream the fleet steps on, and
        re-split when the two TEs' tp differ (``npu_fork_live``); the
        source's DistFlow prices the transfer as the reference does and
        the new TE's clock observes it too. The new TE joins the source's
        peer group. Holds the source's lock, so a fleet worker stepping the
        source waits."""
        from repro_torch.core.scaling import npu_fork_live
        if source.fault_plan is not None:
            source.fault_plan.on_fork(source)
        dev = source.device if device is None else resolve_device(device)
        mesh = make_engine_mesh(ecfg.tp, ecfg.device_offset, dev)
        with source._lock:
            ranks, lr = npu_fork_live(source.runner.params, source.cfg,
                                      mesh, source=source.distflow,
                                      link=link)
            te = cls._from_ranks(source.cfg, ranks, ecfg, name, mesh)
            source.distflow.link_cluster([te.distflow])
        te.distflow.sim_clock += lr.seconds   # the fork target observed it
        te.transfer_timing["fork"] = lr.events
        return te

    @classmethod
    def from_warm(cls, cfg: ModelConfig, host_params, ecfg: EngineConfig,
                  name: str = "te-warm", device="cuda") -> "FlowServe":
        """DRAM-warm bring-up (DESIGN.md §10): a TE built from a
        ``WarmPool`` entry's host weights (one host tree per rank, as
        ``release_params`` drains them), uploaded to the mesh's devices
        with ``non_blocking=True`` copies (from pinned memory on a card)
        in place of model re-init. The entry is only read, so any number
        of TEs can come up from it.

        Entry integrity (DESIGN.md §11): the entry's tree structure and
        leaf shapes are checked against ``cfg``'s shards at ``ecfg.tp``
        (built on the meta device, no memory) before any device memory is
        committed; a mismatch raises ``WarmPoolMismatchError``."""
        from repro_torch.core.scaling import (WarmPoolMismatchError,
                                              copy_to_device)
        expected = SH.shard(T.meta_params(cfg), SH.te_param_specs(
            cfg, ecfg.tp), make_engine_mesh(ecfg.tp, 0, "meta"))
        if _shapes(host_params) != _shapes(expected):
            raise WarmPoolMismatchError(
                f"warm-pool entry does not match model "
                f"{getattr(cfg, 'name', '?')!r} at tp={ecfg.tp} for TE "
                f"{name}: tree/shape mismatch (expected "
                f"{len(tree_leaves(expected))} leaves, got "
                f"{len(tree_leaves(host_params))})")
        mesh = make_engine_mesh(ecfg.tp, ecfg.device_offset,
                                resolve_device(device))
        ranks, ev = copy_to_device(host_params, mesh)
        te = cls._from_ranks(cfg, ranks, ecfg, name, mesh)
        te.transfer_timing["h2d"] = ev
        return te

    @property
    def fork_ready(self) -> bool:
        """True while this TE's weights are device-resident, i.e. it can be
        a fork source (a TE that drained its weights back to the warm pool
        on release is not)."""
        return self.runner.params is not None

    @_executor_safe
    def release_params(self, to_host: bool = True):
        """Drain this TE's weights to host memory (the RELEASED -> WarmPool
        leg of the cold-start ladder): pinned buffers allocated, then
        non-blocking copies from the card, waited for (``transfer_timing``
        gets "pin_s" and "d2h"). Returns the host copy of the ranks' trees,
        one copy per distinct storage (``to_host=True``), or None; either
        way the TE drops its device references and its programs of both
        kinds (a captured graph holds the weights' addresses) and stops
        being a
        fork source (the memory returns once no other TE shares the tree).
        Call only after the TE is empty: it cannot serve afterwards."""
        from repro_torch.core.scaling import copy_to_host
        params = self.runner.params
        if params is None:
            return None
        host = None
        if to_host:
            host, pin_s, ev = copy_to_host(params)
            self.transfer_timing.update(pin_s=pin_s, d2h=ev)
        self.runner.programs.release()
        self.runner.params = None
        if self.family.uses_pages:
            self.runner.layers = None       # views of the stacked weights
        return host

    @_executor_safe
    def cancel_queued(self) -> List[Request]:
        """Pull every not-yet-fully-prefilled sequence out of this engine
        (drain support, DESIGN.md §10): mid-PREFILL work on a draining TE
        is re-submitted elsewhere as a token-level restart instead of
        finishing prefill here. Returns the original ``Request`` objects
        (req_id + arrival preserved, so latency accounting spans the
        restart); their pages/slots here are freed without preserving
        prefixes."""
        out: List[Request] = []
        for seq in list(self.scheduler.queued_seqs()):
            req = self._requests.get(seq.seq_id)
            if req is None:
                continue
            self.scheduler.remove(seq)
            seq.kv_pending = None
            self.release_request(seq.seq_id, keep_prefix=False)
            out.append(req)
        return out

    # ---------------------------------------------------------------- API
    @_executor_safe
    def add_request(self, req: Request) -> str:
        seq = SequenceState(seq_id=req.req_id, tokens=list(req.prompt_tokens),
                            n_prompt=len(req.prompt_tokens),
                            extra=dict(req.extra))
        if not seq.extra:
            seq.extra = {k: v.numpy() for k, v in S.extra_inputs(
                self.cfg, 1, torch.float32, "cpu").items()}
        if not self.family.uses_pages:
            need = seq.n_prompt + req.sampling.max_new_tokens
            if need > self.ecfg.max_len:
                raise ValueError(
                    f"{req.req_id}: {seq.n_prompt} prompt + "
                    f"{req.sampling.max_new_tokens} new tokens exceed the "
                    f"slot capacity max_len={self.ecfg.max_len}")
            if self._state_cache is not None:
                self._try_state_reuse(seq)
        self._seqs[req.req_id] = seq
        self._requests[req.req_id] = req
        self.sample_params[req.req_id] = req.sampling
        # a reused req_id may carry different sampling params / TTFT stamp
        self._sp_cache = (None, None, None)
        self._ttft.pop(req.req_id, None)
        self.scheduler.admit(seq)
        return req.req_id

    @_executor_safe
    def has_work(self) -> bool:
        return bool(self._inflight or self._completed_buf) \
            or self.scheduler.has_work()

    @_executor_safe
    def step(self) -> List[Completion]:
        """One engine iteration: plan -> prefill (one ragged pass, or one
        pass per sequence chunk) -> decode (a fused K-step horizon, or the
        legacy single step when the fused path is off or under page
        pressure) -> commit -> prepare the next plan (while the device runs,
        unless ``async_sched`` is off). The kernels launched in it are added
        to ``kernel_launches``."""
        if self.fault_plan is not None:
            self.fault_plan.on_step(self)
        before = counts.thread_tally()
        out = self._step()
        for name, n in counts.thread_tally().items():
            self.kernel_launches[name] += n - before[name]
        return out

    def _step(self) -> List[Completion]:
        self.scheduler.resolve_prefix()
        self.scheduler.pump_prefetch()
        # the next plan is prepared while the device runs this step (§4.2);
        # synchronous scheduling ignores it and plans now
        plan = self._next_plan if (self.ecfg.async_sched and self._next_plan) \
            else self.scheduler.prepare_next()
        self._next_plan = None
        if self._inflight and (plan.prefill or not plan.decode):
            # prefill page allocation may preempt an in-flight sequence, and
            # a plan with no decode batch must still commit the orphaned
            # horizon: make host state authoritative first
            self._drain_inflight()

        if plan.prefill:
            if not self.family.uses_pages:
                self._prefill_slot(plan.prefill)
            elif self.ecfg.batched_prefill:
                self._prefill_batched(plan.prefill)
            else:
                self._prefill_per_seq(plan.prefill)

        if plan.decode:
            live = self._refilter(plan.decode)
            fused = False
            if live and self.ecfg.fused_decode:
                fused = self._decode_fused_step(live) \
                    if self.family.uses_pages else self._decode_slot(live)
            if not fused and live:
                self._drain_inflight()
                live = self._refilter(live)
            if not fused and live and self.family.uses_pages:
                for s in live:
                    if s in self.scheduler.running:  # not yet preempted
                        self._ensure_pages(s, len(s.tokens))
                # page pressure may have preempted batch members: their
                # freed pages may already belong to another sequence
                live = [s for s in live if s in self.scheduler.running]
            if not fused and live:
                self._land_imports(live)
                logits = self.runner.decode(live)
                self.decode_steps += 1
                self.decode_tokens += len(live)
                self.host_dispatches += 1
                if self.ecfg.async_sched:
                    self._next_plan = self.scheduler.prepare_next()
                self._commit_tokens(live, logits)
                if self._hot is not None:
                    self._hot.reset()   # device rows are stale vs host now

        if self.ecfg.async_sched and self._next_plan is None:
            self._next_plan = self.scheduler.prepare_next()
        self.steps += 1
        return self._flush_completed()

    def run_to_completion(self, max_steps: int = 10000) -> List[Completion]:
        out = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            out.extend(self.step())
        return out

    # ------------------------------------------------------- prefill
    def _prefill_batched(self, entries) -> None:
        """Batched ragged prefill (§12): pack EVERY planned chunk into ONE
        padded pow2-bucketed pass. A chunk that reaches ``n_prompt - 1``
        also takes the LAST prompt token as an extension row, so the first
        generated token is sampled in this same pass. Padding tokens park
        on the scratch page at position 0 and belong to no entry."""
        ps = self.ecfg.page_size
        todo = []
        for seq, start, chunk in entries:
            if seq.n_cached != start or seq.seq_id not in self._seqs:
                continue  # stale plan entry (seq preempted/finished)
            if not chunk:
                # single-token prompt or fully prefix-cached: prefill is
                # vacuously done; run the done-transition
                self._prefill_progress(seq)
                continue
            # a P-TE leaves the last prompt token to the D-TE, whose first
            # decode step writes its KV and samples the first token
            ext = (self.ecfg.mode != "prefill"
                   and len(seq.tokens) == seq.n_prompt
                   and start + len(chunk) == seq.n_prompt - 1)
            todo.append((seq, start, list(chunk), ext))
        if not todo:
            return
        for seq, start, chunk, ext in todo:
            self._ensure_pages(seq, start + len(chunk) + (1 if ext else 0))
        # a later entry's page allocation may have PREEMPTED an earlier one:
        # re-validate before freezing indices; dropped entries are re-planned
        packed = [(seq, start, chunk, ext) for seq, start, chunk, ext in todo
                  if seq.seq_id in self._seqs and seq.n_cached == start
                  and len(seq.pages) * ps >= start + len(chunk) + ext]
        if not packed:
            return
        scratch = self.pool.scratch_page()

        # ---- pack the flat ragged token stream + entry metadata (host)
        sb = pow2_bucket(max(self.ecfg.max_prefill_seqs, len(packed)))
        pb = pow2_bucket(max(len(s.pages) for s, _, _, _ in packed))
        flat_t, flat_p, flat_pg, flat_sl, cu = [], [], [], [], [0]
        entry_bt = np.full((sb, pb), scratch, np.int32)
        entry_start = np.zeros((sb,), np.int32)
        final_idx = np.zeros((sb,), np.int32)
        temps = np.zeros((sb,), np.float32)
        top_ps = np.ones((sb,), np.float32)
        for i, (seq, start, chunk, ext) in enumerate(packed):
            toks = chunk + ([seq.tokens[-1]] if ext else [])
            entry_bt[i, :len(seq.pages)] = seq.pages
            entry_start[i] = start
            for j, t in enumerate(toks):
                pos = start + j
                flat_t.append(t)
                flat_p.append(pos)
                flat_pg.append(seq.pages[pos // ps])
                flat_sl.append(pos % ps)
            cu.append(len(flat_t))
            final_idx[i] = len(flat_t) - 1
            if ext:
                sp = self.sample_params[seq.seq_id]
                temps[i] = sp.temperature
                top_ps[i] = sp.top_p
        cu += [cu[-1]] * (sb - len(packed))
        tb = pow2_bucket(len(flat_t))
        n_pad = tb - len(flat_t)
        flat_t += [0] * n_pad
        flat_p += [0] * n_pad
        flat_pg += [scratch] * n_pad
        flat_sl += [0] * n_pad

        # one upload into the program of (Tb, Pb, Sb, all-greedy): its
        # static operands are views of one int32 buffer
        _, toks_dev = self.runner.prefill_ragged_host(
            (flat_t, flat_p, flat_pg, flat_sl, cu, entry_bt, entry_start,
             FP.build_tiles(cu, tb), final_idx), temps, top_ps, self._gen)
        self.prefill_dispatches += 1

        # ---- commit: lengths, extension first-tokens, queue transitions;
        # the first tokens are fetched right after the program (its static
        # output), before any other program of the TE runs
        toks = None
        if any(ext for _, _, _, ext in packed):
            toks = toks_dev.cpu().numpy()
            self.prefill_syncs += 1
        for i, (seq, start, chunk, ext) in enumerate(packed):
            seq.n_cached = start + len(chunk) + (1 if ext else 0)
            if not ext:
                self._prefill_progress(seq)
                continue
            self.scheduler.on_prefill_progress(seq, True)
            self._commit_sampled([seq], [int(toks[i])])

    def _prefill_per_seq(self, entries) -> None:
        """Per-sequence paged prefill (``batched_prefill=False``; the
        reference's ``_prefill_legacy``, ``flowserve.py:429-464``): one pass
        per sequence per chunk. The chunk never takes the last prompt
        token, so the first token comes from the decode path."""
        for seq, start, chunk in entries:
            if seq.n_cached != start or seq.seq_id not in self._seqs:
                continue  # stale plan entry (seq preempted/finished)
            if chunk:
                self._ensure_pages(seq, start + len(chunk))
                self.runner.prefill_chunk(seq, chunk)
                self.prefill_dispatches += 1
            self._prefill_progress(seq)

    def _prefill_slot(self, entries) -> None:
        """Slot-family prefill: per sequence, one chunk on its slot
        (``flowserve.py:429-459``). A sequence gets its slot at its first
        chunk, and a planned state checkpoint is restored into it then."""
        for seq, start, chunk in entries:
            if seq.n_cached != start or seq.seq_id not in self._seqs:
                continue  # stale plan entry (seq finished)
            if seq.slot is None:
                if not self.runner.alloc_slot(seq):
                    self.scheduler.ready.appendleft(seq)  # no slot; retry
                    if seq in self.scheduler.prefilling:
                        self.scheduler.prefilling.remove(seq)
                    continue
                if seq.state is not None:
                    self.runner.restore_state(
                        seq, self._state_cache[seq.state])
                    seq.state = None
            if chunk:
                self.runner.prefill_chunk(seq, chunk)
                self.prefill_dispatches += 1
            self._prefill_progress(seq)

    def _prefill_progress(self, seq: SequenceState) -> None:
        """Queue transition after a chunk without an extension row: done
        once every token but the last is cached."""
        done = seq.n_cached >= len(seq.tokens) - 1
        if done:
            self._on_prefill_done(seq)
        self.scheduler.on_prefill_progress(seq, done)

    def _on_prefill_done(self, seq: SequenceState) -> None:
        """Prefill covered tokens [0, n_prompt - 1); the last prompt token
        goes through the decode path (its KV write and the first token's
        logits), here (colocated) or on the D-TE (a P-TE buffers the
        sequence for migration and stamps its TTFT now)."""
        if self.ecfg.mode == "prefill":
            self._prefill_done_buffer.append(seq.seq_id)
            self._ttft[seq.seq_id] = \
                time.monotonic() - self._requests[seq.seq_id].arrival

    def _try_state_reuse(self, seq: SequenceState) -> None:
        """Slot-family prefix cache: the longest state checkpoint whose
        token prefix is a proper prefix of the prompt (exact-boundary
        reuse, DESIGN.md §4). ``n_cached`` is committed now (the scheduler
        plans chunks from it); the snapshot is restored once a slot is
        assigned. The key is the token prefix alone, as in the reference:
        a cross-attention tower then reuses self-attention K/V computed
        under another request's modality memory (kept for parity)."""
        best_key, best_len = None, 0
        prompt = tuple(seq.tokens[:seq.n_prompt])
        for key in self._state_cache:
            n = len(key)
            if best_len < n < len(prompt) and prompt[:n] == key:
                best_key, best_len = key, n
        if best_key is not None:
            seq.state = best_key
            seq.n_cached = best_len

    def _decode_slot(self, live: List[SequenceState]) -> bool:
        """Slot-family fused decode (``_decode_slot_fused``,
        ``flowserve.py:724-753``): one all-slot decode step with sampling
        in the same pass; only the (n_slots,) token vector reaches the
        host. temps/top_ps are slot-indexed and cached on the batch's
        composition. Always runs (returns True)."""
        self._land_imports(live)
        batch_key = tuple((s.seq_id, s.slot) for s in live)
        if self._sp_cache[0] != batch_key:
            temps = np.zeros((self.ecfg.n_slots,), np.float32)
            top_ps = np.ones((self.ecfg.n_slots,), np.float32)
            for s in live:
                sp = self.sample_params[s.seq_id]
                temps[s.slot] = sp.temperature
                top_ps[s.slot] = sp.top_p
            self._sp_cache = (batch_key, temps, top_ps)
        _, temps, top_ps = self._sp_cache
        toks_dev = self.runner.decode_sample(live, temps, top_ps, self._gen)
        self.decode_steps += 1
        self.decode_tokens += len(live)
        self.host_dispatches += 1
        # the next plan needs only counts: prepare it before the blocking
        # token fetch (§4.2)
        if self.ecfg.async_sched:
            self._next_plan = self.scheduler.prepare_next()
        toks = toks_dev.cpu().numpy()
        self.host_syncs += 1
        self._commit_sampled(live, [int(toks[s.slot]) for s in live])
        return True

    # ------------------------------------------------------- decode hot loop
    def warmup_decode(self, max_pages: Optional[int] = None,
                      horizons: Optional[List[int]] = None) -> int:
        """Build the decode program of every pow2 batch bucket up to
        ``max_decode_batch`` x every pow2 page bucket up to ``max_pages`` x
        every pow2 horizon up to ``decode_horizon`` (all-greedy keys), each
        run once on the scratch page: serving inside that grid builds no
        program. Returns the number of shapes run (0 for the slot family,
        which has no horizon buckets)."""
        if not self.family.uses_pages or not self.ecfg.fused_decode:
            return 0
        if max_pages is None:
            max_pages = max(1, self.ecfg.n_pages
                            // max(1, self.ecfg.max_decode_batch))
        return self.runner.warmup_fused(
            pow2s(self.ecfg.max_decode_batch), pow2s(max_pages),
            horizons if horizons is not None
            else pow2s(self.ecfg.decode_horizon), self._gen)

    def warmup_prefill(self, max_tokens: Optional[int] = None,
                       max_pages: Optional[int] = None) -> int:
        """Build the ragged prefill program of every pow2 token bucket up
        to the step budget (plus one extension token per prompt row) x
        every pow2 page bucket up to ``max_pages`` (all-greedy keys), each
        run once as an all-padding plan on the scratch page: serving
        inside that grid builds no prefill program. Returns the number of
        shapes run (0 for the slot family)."""
        if not self.family.uses_pages:
            return 0
        if max_pages is None:
            max_pages = max(1, self.ecfg.n_pages
                            // max(1, self.ecfg.max_decode_batch))
        cap = ((max_tokens if max_tokens is not None
                else self.ecfg.max_batch_tokens)
               + self.ecfg.max_prefill_seqs)
        return self.runner.warmup_ragged(
            pow2s(cap), pow2s(max_pages),
            pow2_bucket(self.ecfg.max_prefill_seqs))

    def _refilter(self, seqs: List[SequenceState]) -> List[SequenceState]:
        return [s for s in seqs if s.seq_id in self._seqs
                and s in self.scheduler.running]

    def _hot_state(self) -> DecodeHotState:
        if self._hot is None:
            self._hot = DecodeHotState(self.pool, self._gen)
        return self._hot

    def _decode_fused_step(self, live: List[SequenceState]) -> bool:
        """One decode iteration of the hot loop (DESIGN.md §8): sync the
        persistent device state (no scatter in steady state), enqueue a
        K-step decode+sample horizon, and fetch the PREVIOUS horizon's
        token block. Returns False when the fused path cannot run (page
        pressure that needs preemption); the caller takes the legacy
        path."""
        ps = self.pool.page_size
        for _ in range(3):   # a drain restarts the attempt; converges
            if not live:
                return True
            hlen = {s.seq_id: len(s.tokens) + self._pending.get(s.seq_id, 0)
                    for s in live}
            rem = {s.seq_id: self.sample_params[s.seq_id].max_new_tokens
                   - (hlen[s.seq_id] - s.n_prompt) for s in live}
            if min(rem.values()) < 1:
                # a stop already sits in an uncommitted block: commit it
                self._drain_inflight()
                live = self._refilter(live)
                continue
            # horizon the scheduler can prove, floored to a pow2 bucket,
            # then shrunk until the page growth fits WITHOUT preemption
            k = self.scheduler.safe_horizon(live, self.ecfg.decode_horizon,
                                            min(rem.values()))
            k = 1 << (max(1, k).bit_length() - 1)
            free = self.pool.free_page_count() + len(self.pool.reclaimable())
            while k >= 1:
                need = sum(max(0, pages_needed(hlen[s.seq_id] + k, ps)
                               - len(s.pages)) for s in live)
                if need <= free:
                    break
                k //= 2
            if k < 1:
                self._drain_inflight()
                return False
            try:
                hot = self._hot_state()
                for s in live:
                    self._ensure_pages_no_preempt(s, hlen[s.seq_id] + k)
            except OutOfPagesError:
                self._drain_inflight()
                return False
            rows2 = [(s.seq_id, len(s.pages)) for s in live]
            if self._inflight and (hot.needs_rebuild(rows2)
                                   or hot.oversized(rows2)):
                # a rebuild from host values is coherent only once nothing
                # is pending
                self._drain_inflight()
                live = self._refilter(live)
                continue
            self._land_imports(live)
            self.host_dispatches += hot.sync(
                [(s.seq_id, s.pages, len(s.tokens),
                  s.tokens[-1] if s.tokens else 0,
                  self.sample_params[s.seq_id].temperature,
                  self.sample_params[s.seq_id].top_p) for s in live],
                can_shrink=not self._inflight)
            toks = self.runner.decode_fused(hot, k)
            event = None
            if toks.is_cuda:
                # the block goes to pinned host memory behind the horizon;
                # the event marks that copy done, so the commit one horizon
                # later waits for this block alone (DESIGN.md §8)
                host = torch.empty(toks.shape, dtype=toks.dtype,
                                   pin_memory=True)
                host.copy_(toks, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                toks = host
            self.host_dispatches += 1
            self.decode_steps += k
            self.decode_tokens += k * len(live)
            for s in live:
                self._pending[s.seq_id] = self._pending.get(s.seq_id, 0) + k
            self._inflight.append(
                (toks, [(hot.slot_of[s.seq_id], s.seq_id) for s in live], k,
                 event))
            if self.ecfg.async_sched:
                self._next_plan = self.scheduler.prepare_next()
            # fetch the PREVIOUS horizon's block, computed behind the
            # horizon just enqueued
            while len(self._inflight) > 1:
                self._commit_oldest()
            return True
        return False

    def _commit_oldest(self) -> None:
        """Commit the oldest in-flight token block, already on its way to
        the host: wait for its own copy (never for a later horizon), then
        append tokens, stamp TTFT, finish sequences whose EOS /
        max_new_tokens stop fired (post-stop tokens are discarded)."""
        toks_host, rows, k, event = self._inflight.popleft()
        if event is not None and not event.query():
            self.host_syncs += 1
            event.synchronize()
        toks = toks_host.numpy()
        for slot, sid in rows:
            seq = self._seqs.get(sid)
            if seq is None or sid not in self._pending:
                continue   # finished by an earlier block's late EOS
            sp = self.sample_params[sid]
            stopped = False
            for j in range(k):
                tok = int(toks[j, slot])
                seq.tokens.append(tok)
                self._pending[sid] -= 1
                if self._ttft.get(sid, 0.0) == 0.0:
                    self._ttft[sid] = \
                        time.monotonic() - self._requests[sid].arrival
                n_new = len(seq.tokens) - seq.n_prompt
                if (sp.stop_on_eos and tok == EOS_ID) \
                        or n_new >= sp.max_new_tokens:
                    stopped = True
                    break
            seq.n_cached = len(seq.tokens) - 1
            if stopped:
                self._pending.pop(sid, None)
                self._finish(seq)

    def _drain_inflight(self) -> None:
        """Commit every in-flight horizon: host state becomes
        authoritative (before legacy decode, preemption, rebuilds)."""
        while self._inflight:
            self._commit_oldest()

    def _flush_completed(self) -> List[Completion]:
        out, self._completed_buf = self._completed_buf, []
        return out

    def _finish(self, seq: SequenceState) -> None:
        req = self._requests[seq.seq_id]
        self._completed_buf.append(Completion(
            req_id=seq.seq_id, tokens=seq.tokens[seq.n_prompt:],
            ttft=self._ttft[seq.seq_id], finish=time.monotonic(),
            arrival=req.arrival, n_prompt=seq.n_prompt))
        self.scheduler.on_finished(seq)
        # releasing pages with a later block in flight is safe: the pool is
        # written in stream order, and a page's next owner writes (and
        # masks) before it reads
        self.release_request(seq.seq_id)

    # ---------------------------------------------------------------- pages
    def _new_page(self) -> int:
        """One page: through the RTC (which evicts cached prefixes
        coherently with its index), or from the pool's free list when the
        TE runs without a prefix cache."""
        return self.rtc.append_block() if self.rtc is not None \
            else self.pool.alloc(1)[0]

    def _ensure_pages_no_preempt(self, seq: SequenceState,
                                 n_tokens: int) -> None:
        """Fused-path page growth: evicting cached prefixes is fine,
        preemption is not (it would invalidate in-flight horizons)."""
        need = pages_needed(n_tokens, self.pool.page_size) - len(seq.pages)
        for _ in range(max(0, need)):
            seq.pages.append(self._new_page())

    def _ensure_pages(self, seq: SequenceState, n_tokens: int) -> None:
        need = pages_needed(n_tokens, self.pool.page_size) - len(seq.pages)
        for _ in range(max(0, need)):
            while True:
                try:
                    page = self._new_page()
                    break
                except OutOfPagesError:
                    victim = self._pick_victim(exclude=seq)
                    if victim is None:
                        raise
                    self._preempt(victim)
            seq.pages.append(page)

    def _pick_victim(self, exclude: SequenceState) -> Optional[SequenceState]:
        """Most recently admitted page-holding seq (decoding, then
        mid-prefill), excluding the requester."""
        for pool in (self.scheduler.running, self.scheduler.prefilling):
            for cand in reversed(pool):
                if cand is not exclude and cand.pages:
                    return cand
        return None

    def _preempt(self, seq: SequenceState) -> None:
        # commit in-flight horizons first: the victim may have uncommitted
        # tokens, and requeue resets state the commits would corrupt
        if self._inflight:
            self._drain_inflight()
            if seq.seq_id not in self._seqs \
                    or (seq not in self.scheduler.running
                        and seq not in self.scheduler.prefilling):
                return   # the drain already finished (released) the victim
        self._pending.pop(seq.seq_id, None)
        if self._hot is not None:
            self._hot.reset()   # the victim's device row must not be reused
        own = seq.pages[seq.reused_pages:]
        shared = seq.pages[:seq.reused_pages]
        self.pool.release(own)
        if shared:
            self.pool.release(shared, keep_cached=True)
        seq.reused_pages = 0
        # an import not yet landed is void: its pages were just released,
        # and the requeued sequence prefills from scratch
        seq.kv_pending = None
        self.scheduler.requeue(seq)

    @_executor_safe
    def release_request(self, req_id: str, keep_prefix: bool = True) -> None:
        seq = self._seqs.pop(req_id, None)
        self._pending.pop(req_id, None)
        if self._hot is not None:
            self._hot.evict(req_id)   # a reused id must join fresh
        if seq is None:
            return
        if not self.family.uses_pages:
            # checkpoint the slot's state under the tokens it covers, then
            # free the slot (flowserve.py:1009-1014)
            if self._state_cache is not None and seq.slot is not None:
                key = tuple(seq.tokens[:seq.n_cached])
                if key and len(self._state_cache) < 32:
                    self._state_cache[key] = self.runner.snapshot_state(seq)
            self.runner.free_slot(seq)
        elif seq.pages:
            own = seq.pages[seq.reused_pages:]
            shared = seq.pages[:seq.reused_pages]
            preserve = self.rtc is not None and keep_prefix \
                and seq.n_cached > 0
            if preserve:
                self.rtc.preserve_prefix(tuple(seq.tokens[:seq.n_cached]),
                                         seq.pages,
                                         ctx_id=self._requests[req_id].ctx_id)
            self.pool.release(own, keep_cached=preserve)
            if shared:
                self.pool.release(shared, keep_cached=True)
        self._requests.pop(req_id, None)

    # ---------------------------------------------------------------- PD
    def _land_imports(self, live: List[SequenceState]) -> None:
        """Scatter the in-flight imports of the sequences about to decode,
        enqueued ahead of the step that reads their pages."""
        for s in live:
            handle, s.kv_pending = s.kv_pending, None
            if handle is not None:   # the first decode of a migrated seq
                self._import_layerwise(handle, s)

    def _import_layerwise(self, handle, seq: SequenceState) -> None:
        """Scatter each layer chunk behind its own event: the stream waits
        for chunk i alone before chunk i's scatter, and the host never
        waits."""
        for i in range(len(handle.chunks)):
            self.runner.import_kv({"chunks": [handle.wait_chunk(i)]},
                                  seq.pages)

    @_executor_safe
    def pop_migratable(self) -> List[str]:
        """P-TE: request ids whose prefill finished, ready to migrate."""
        out, self._prefill_done_buffer = self._prefill_done_buffer, []
        return out

    @_executor_safe
    def migratable_running(self) -> List[str]:
        """Request ids in the decode set whose state can move now: fully
        prefilled and not still waiting on an import of their own."""
        return [s.seq_id for s in self.scheduler.running
                if s.kv_pending is None]

    @_executor_safe
    def export_kv(self, req_id: str, host_gather: bool = False):
        """The migration payload of ``req_id``: the KV of its first
        ``n_cached`` tokens (a P-TE: the prompt but its last token) and
        what the D-TE needs to carry on. In-flight horizons are committed
        first, so the run covers every sampled token."""
        self._drain_inflight()
        seq = self._seqs[req_id]
        payload = self.runner.export_kv(seq, host_gather=host_gather) \
            if self.family.uses_pages else self.runner.export_kv(seq)
        payload["req_id"] = req_id
        payload["sampling"] = self.sample_params[req_id]
        payload["arrival"] = self._requests[req_id].arrival
        # a mid-decode sequence already produced its first token here
        payload["ttft"] = self._ttft.get(req_id, 0.0)
        return payload

    def migrate_out(self, req_id: str, dst: "FlowServe", overlap: bool = True,
                    layer_chunks: int = 4, host_gather: bool = False,
                    keep_prefix: bool = True) -> str:
        """Move a request's KV or slot state to the D-TE ``dst`` over
        DistFlow and release it here (by-request PD migration, §4.5).

        Paged path: the page run goes device to device in ``layer_chunks``
        chunks. With ``overlap`` the D-TE keeps stepping and scatters the
        chunks just before the sequence's first decode; without it they
        are scattered now. ``host_gather`` takes the v1 host round trip,
        as the slot family always does (a snapshot is small). On a
        ``TransferFault`` or ``OutOfPagesError`` the D-TE is left
        untouched, the sequence is restored here and the error re-raised.

        Executor safety: both endpoints' locks are taken up front in name
        order, so a drain migrating A -> B while the fleet steps B cannot
        deadlock against a B -> A hand-off."""
        first, second = ((self, dst) if self.name <= dst.name
                         else (dst, self))
        with first._lock, second._lock:
            return self._migrate_out_locked(req_id, dst, overlap,
                                            layer_chunks, host_gather,
                                            keep_prefix)

    def _migrate_out_locked(self, req_id: str, dst: "FlowServe",
                            overlap: bool, layer_chunks: int,
                            host_gather: bool, keep_prefix: bool) -> str:
        # committing in-flight horizons may finish the candidate
        self._drain_inflight()
        if req_id not in self._seqs:
            return req_id
        seq = self._seqs[req_id]
        was_running = seq in self.scheduler.running
        self.scheduler.remove(seq)
        payload = self.export_kv(req_id, host_gather=host_gather)
        try:
            if not self.family.uses_pages or host_gather:
                if host_gather and self.family.uses_pages:
                    # price the host round trip both ways, as the reference
                    n_kv = _nbytes([payload["k"], payload["v"]])
                    self.distflow.charge(n_kv, "pcie_dram")
                self.distflow.transfer(
                    BufferInfo(owner=self.name, tier="npu", payload=payload),
                    BufferInfo(owner=dst.name, tier="npu",
                               deliver=dst.import_request))
                if host_gather and self.family.uses_pages:
                    dst.distflow.charge(n_kv, "pcie_dram")
            else:
                kv = {"k": payload.pop("k"), "v": payload.pop("v")}
                payload["kv_handle"] = self.distflow.transfer_sharded(
                    kv, dst.name, src_dim=self.pool.spec,
                    dst=dst.pool.run_sharding(), src_tp=self.ecfg.tp,
                    dst_tp=dst.ecfg.tp, layer_chunks=layer_chunks)
                dst.import_request(payload)
                if not overlap:
                    dst.finish_pending_imports()
        except (TransferFault, OutOfPagesError):
            if was_running and req_id in self._seqs:
                self.scheduler.admit_running(seq)
            raise
        # injected source crash mid-migration: the destination already
        # imported (the sequence continues there), but this TE dies before
        # cleaning up; recovery dedupes against the survivor
        if self.fault_plan is not None:
            self.fault_plan.on_migration(self, dst.name)
        self.release_request(req_id, keep_prefix=keep_prefix)
        return req_id

    @_executor_safe
    def finish_pending_imports(self) -> None:
        """D-TE: scatter every import still in flight now (the eager
        complement of the lazy scatter at the first decode)."""
        self._land_imports(list(self._seqs.values()))

    @_executor_safe
    def void_pending_imports(self, dead_owners) -> List[Request]:
        """Recovery (DESIGN.md §11): void every in-flight KV import whose
        SOURCE TE died. Its chunks came from the dead TE, so they are never
        scattered: the sequence's local state is released and its original
        ``Request`` returned for a prompt-level restart on a survivor.
        Idempotent per sequence (the handle is dropped), which is what
        makes recovery dedupe-safe."""
        out: List[Request] = []
        for seq in list(self._seqs.values()):
            handle = seq.kv_pending
            if handle is None \
                    or getattr(handle, "src_owner", None) not in dead_owners:
                continue
            seq.kv_pending = None
            req = self._requests.get(seq.seq_id)
            self.scheduler.remove(seq)
            self.release_request(seq.seq_id, keep_prefix=False)
            if req is not None:
                out.append(req)
        return out

    @_executor_safe
    def import_request(self, payload) -> str:
        """D-TE: admit a migrated, prefilled request. Its next decode step
        processes its last prompt token. A mid-decode arrival keeps the
        TTFT its source stamped. Pages come through the RTC; when they run
        out, everything allocated is given back and ``OutOfPagesError``
        raised before any state is committed (a slot TE raises the same
        when no slot is free)."""
        req = Request(prompt_tokens=payload["tokens"][:payload["n_prompt"]],
                      sampling=payload["sampling"], req_id=payload["req_id"])
        req.arrival = payload["arrival"]
        seq = SequenceState(seq_id=req.req_id,
                            tokens=list(payload["tokens"]),
                            n_prompt=payload["n_prompt"],
                            n_cached=payload["n_cached"])
        if self.family.uses_pages:
            try:
                for _ in range(payload["n_pages"]):
                    seq.pages.append(self._new_page())
            except OutOfPagesError:
                self.pool.release(seq.pages)
                raise
        elif not self.runner.alloc_slot(seq):
            raise OutOfPagesError(
                f"decode TE {self.name} has no free slot for migrated "
                f"request {req.req_id}")
        self._seqs[req.req_id] = seq
        self._requests[req.req_id] = req
        self.sample_params[req.req_id] = req.sampling
        self._sp_cache = (None, None, None)   # same aliasing rule as add
        self._ttft.pop(req.req_id, None)
        if (payload.get("ttft", 0.0) > 0.0
                and len(payload["tokens"]) > payload["n_prompt"]):
            self._ttft[req.req_id] = payload["ttft"]
        handle = payload.get("kv_handle")
        if handle is not None:
            seq.kv_pending = handle        # scattered at its first decode
        elif self.family.uses_pages:
            self.runner.import_kv(payload, seq.pages)
        else:
            self.runner.import_kv(payload, seq)
        self.scheduler.admit_running(seq)
        return req.req_id

    def prefix_cache_stats(self) -> Dict[str, int]:
        """The RTC's counters (hits, tokens reused, ...); empty without
        one."""
        return dict(self.rtc.stats) if self.rtc is not None else {}

    @_executor_safe
    def load_metrics(self) -> Dict[str, float]:
        """The TE's live load signals for the JE's ``TEHandle.refresh``:

        * ``queued_prefill_tokens`` — prefill tokens owed to queued
          sequences;
        * ``inflight_decode_tokens`` — the remaining ``max_new_tokens`` of
          every sequence resident here (in-flight horizons counted through
          ``_pending``; a PD pair's sequence lives in one TE at a time);
        * ``horizon_headroom`` — the fused horizon the scheduler can prove
          now (a TE decoding K steps per dispatch serves decode cheaper);
        * ``n_queued`` / ``n_running`` / ``occupancy`` /
          ``free_page_frac`` — queue depth and capacity."""
        sch = self.scheduler
        decode_toks = 0
        running_rem = []
        running = set(id(s) for s in sch.running)
        for seq in self._seqs.values():
            sp = self.sample_params.get(seq.seq_id)
            if sp is None:
                continue
            produced = (max(0, len(seq.tokens) - seq.n_prompt)
                        + self._pending.get(seq.seq_id, 0))
            rem = max(0, sp.max_new_tokens - produced)
            decode_toks += rem
            if id(seq) in running:
                running_rem.append(rem)
        headroom = 1
        if self.family.uses_pages and self.ecfg.fused_decode and running_rem:
            # the fused path's own proof; its budget term is the batch's
            # least remaining max_new_tokens
            headroom = sch.safe_horizon(list(sch.running),
                                        self.ecfg.decode_horizon,
                                        max(1, min(running_rem)))
        return {
            "queued_prefill_tokens": float(sch.queued_prefill_tokens()),
            "inflight_decode_tokens": float(decode_toks),
            "horizon_headroom": float(max(1, headroom)),
            "n_queued": sch.queue_depth(),
            "n_running": len(sch.running),
            "occupancy": sch.occupancy(),
            "free_page_frac": (self.pool.free_page_count() / self.pool.n_pages
                               if self.pool is not None else 1.0),
        }

    # ---------------------------------------------------------------- legacy
    def _commit_tokens(self, seqs: List[SequenceState], logits) -> None:
        """Legacy (non-fused) sampling: the whole batch in one pass, then
        commit on the host. Per-batch temperature/top_p arrays are cached
        keyed on the batch composition."""
        batch_key = tuple(s.seq_id for s in seqs)
        if self._sp_cache[0] != batch_key:
            sps = [self.sample_params[sid] for sid in batch_key]
            self._sp_cache = (
                batch_key,
                np.asarray([sp.temperature for sp in sps], np.float32),
                np.asarray([sp.top_p for sp in sps], np.float32))
        _, temps, top_ps = self._sp_cache
        toks = sample_batch(logits, temps, top_ps, self._gen,
                            self.cfg.vocab_size).cpu().numpy()
        self.sampler_dispatches += 1
        self.host_dispatches += 1
        self.host_syncs += 1             # the copy blocks on this step
        self._commit_sampled(seqs, [int(t) for t in toks])

    def _commit_sampled(self, seqs: List[SequenceState],
                        toks: List[int]) -> None:
        """Commit one freshly sampled token per sequence: append, stamp
        TTFT, and finish on EOS / max_new_tokens."""
        for seq, tok in zip(seqs, toks):
            sp = self.sample_params[seq.seq_id]
            seq.tokens.append(tok)
            if self._ttft.get(seq.seq_id, 0.0) == 0.0:
                self._ttft[seq.seq_id] = \
                    time.monotonic() - self._requests[seq.seq_id].arrival
            n_new = len(seq.tokens) - seq.n_prompt
            if (sp.stop_on_eos and tok == EOS_ID) or n_new >= sp.max_new_tokens:
                self._finish(seq)

