"""The live serving plane (DESIGN.md §9), torch port of
``repro/core/serving_plane.py``: a model-serving JE that owns an ELASTIC
fleet of the port's FLOWSERVE TEs and routes requests through Algorithm 1.

An external ``UserRequest`` decomposes into a serving ``Job`` whose
``Task``s (prefill/decode or colocated) land on live engines:

* **PD groups (M:N, §4.6)**: ``pd=N`` builds N 1P:1D pairs; ``pd=NpXd``
  builds a group whose N prefill TEs feed X decode TEs. Each finished
  prefill's KV migrates to the group's LEAST-LOADED decode member
  (``FlowServe.migrate_out``), pumped every JE step with capacity-gated
  back-pressure and transfer retries;
* **PD-colocated TEs**: one engine runs both phases.

The fleet is a runtime (``core/fleet.py``):

* **per-TE executors** — with ``fleet_threads > 1`` every fleet unit (one
  PD group or one colocated TE) steps on its own pinned worker thread;
  ``step()`` is submit/collect over a barrier-free event queue. Every
  unit enqueues on its device's default stream;
* **lifecycle** — every TE walks ``PROVISIONING -> WARMING -> SERVING <->
  DRAINING -> RELEASED``; only SERVING TEs admit placements;
* **scale-out** (``LoadSpreadTrigger``, ``scale_to``): NPU-fork from live
  TEs in fork-tree rounds, then the DRAM-warm pool, then cold
  construction;
* **scale-in** (``DrainTrigger``, ``drain``): admissions stop, in-flight
  decodes finish or migrate out, mid-prefill requests restart elsewhere,
  then the TE is released (its weights to the warm pool when one is
  attached);
* **fault recovery** (``core/faults.py``): a failed unit is quarantined
  and its requests restart once each on survivors.

Device windows: a TE owns ``tp`` devices from its window's offset
(``EngineConfig.device_offset``; ``_device_count``: the visible cards of
a CUDA plane, one for a CPU plane). On one card every TE after the first
takes window 0 unowned, the reference's simulated co-residence branch;
all of them then share the card, and so do a TE's ranks. The initial
fleet's TEs share the one weights tree the plane is given (each TE's
shards are views of it on its device); a forked or warm TE owns its copy.
``TopologySpec.tp`` and ``EngineConfig.tp`` are merged as the reference
merges them; both runner families serve at tp > 1.
"""
from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.abstractions import (Job, RequestType, Status,
                                           TaskKind, UserRequest, decompose)
from repro_torch.core.faults import (AdmissionRejected, FaultPlan, ForkFault,
                                     TEFailureError, TransferFault,
                                     backoff_s)
from repro_torch.core.fleet import FleetExecutor, TEState
from repro_torch.core.predictor import TraceEMAPredictor
from repro_torch.core.scaling import (DrainTrigger, FastScaler,
                                      LoadResult, LoadSpreadTrigger,
                                      ModelAsset, WarmPool, tier_seconds)
from repro_torch.core.scheduling import (DistSchedConfig,
                                         DistributedScheduler, SchedRequest,
                                         TEHandle, _engine_load,
                                         _predictor_trained,
                                         round_robin_scheduler)
from repro_torch.engine import (Completion, EngineConfig, FlowServe,
                                Request, SamplingParams)
from repro_torch.engine.distflow import _nbytes
from repro_torch.engine.kv_cache import OutOfPagesError

_PD_GROUP_RE = re.compile(r"^(\d+)p(\d+)d$")


def _drop_engines(handle: TEHandle) -> None:
    """A RELEASED handle gives up its engines. Request records still point
    at it (their load is released on it when they complete, as in the
    reference), and must not keep a dead or drained TE's pool alive."""
    handle.engine = handle.decode_engine = None
    handle.prefill_engines = handle.decode_engines = None


def _device_count(device: torch.device) -> int:
    """Devices a plane on ``device`` can give its TEs windows on: the
    visible cards for a CUDA plane, one for a CPU plane."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


@dataclass
class TopologySpec:
    """Fleet shape: PD groups plus ``colo`` PD-colocated TEs, each TE an
    SPMD program over ``tp`` devices. ``pd=N`` means N disaggregated
    1P:1D pairs; ``pd=NpXd`` (e.g. ``pd=1p2d``) means one M:N group of N
    prefill TEs feeding X decode TEs (§4.6)."""

    pd: int = 0
    colo: int = 1
    tp: int = 1
    pd_groups: List[Tuple[int, int]] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "TopologySpec":
        """Parse a ``--topology`` string: ``"pd=2,colo=2"``,
        ``"pd=1p2d,colo=1"``, ``"pd=1,colo=1,tp=2"``."""
        kw: Dict[str, Any] = {}
        groups: List[Tuple[int, int]] = []
        for part in spec.split(","):
            if not part.strip():
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in ("pd", "colo", "tp"):
                raise ValueError(f"bad topology entry {part!r} in {spec!r} "
                                 "(want pd=N|pd=NpXd,colo=N[,tp=N])")
            m = _PD_GROUP_RE.match(val.strip()) if key == "pd" else None
            if m is not None:
                n_p, n_d = int(m.group(1)), int(m.group(2))
                if n_p < 1 or n_d < 1:
                    raise ValueError(f"empty PD group {val!r} in {spec!r}")
                groups.append((n_p, n_d))
            else:
                kw[key] = int(val)
        topo = cls(pd_groups=groups, **kw)
        if not topo.groups() and topo.colo < 1:
            raise ValueError(f"empty topology {spec!r}")
        return topo

    def groups(self) -> List[Tuple[int, int]]:
        """(n_prefill, n_decode) per PD group; ``pd=N`` ⇒ N (1,1) pairs."""
        return self.pd_groups + [(1, 1)] * self.pd

    def n_engines(self) -> int:
        return sum(p + d for p, d in self.groups()) + self.colo


@dataclass
class _PlaneRequest:
    """JE-side per-request record tying the §3 abstractions together."""

    job: Job
    sreq: SchedRequest
    handle: TEHandle
    engine_req: Request
    submitted: float = field(default_factory=time.monotonic)


class ServingJobEngine:
    """Model-serving JE over a live FLOWSERVE fleet (DESIGN.md §9). Its TEs
    run on ``device`` (``"cuda"`` by default; the CPU only when asked)."""

    decode_dominance: float = 4.0   # decode/prefill load ratio ⇒ grow 1P:Xd

    def __init__(self, cfg, params, topology: TopologySpec, *,
                 heatmap, prefill_lens, decode_ratios, predictor=None,
                 policy: str = "dist_sched",
                 ecfg: Optional[EngineConfig] = None,
                 dcfg: Optional[DistSchedConfig] = None,
                 scaler: Optional[FastScaler] = None,
                 trigger: Optional[LoadSpreadTrigger] = None,
                 drain_trigger: Optional[DrainTrigger] = None,
                 warm_pool: Optional[WarmPool] = None,
                 fleet_threads: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 admission_limit: Optional[int] = None,
                 device="cuda"):
        if policy not in ("dist_sched", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.topology = topology
        base = ecfg if ecfg is not None else EngineConfig()
        # TopologySpec.tp and EngineConfig.tp describe the same thing;
        # whichever side was set wins, conflicting non-defaults are an error
        # (the reference's serving_plane.py:158-167)
        if base.tp != topology.tp:
            if base.tp == 1:
                base = replace(base, tp=topology.tp)
            elif topology.tp == 1:
                topology.tp = base.tp
            else:
                raise ValueError(f"conflicting tp: EngineConfig.tp={base.tp} "
                                 f"vs TopologySpec.tp={topology.tp}")
        self._base_ecfg = base
        self._offset_cursor = 0
        self._free_windows: List[int] = []      # released device windows
        self._window_of: Dict[str, int] = {}    # engine name -> owned window
        # window bookkeeping is JE-thread state, but concurrent fork
        # rounds (scale_to) allocate windows for in-flight bring-ups: the
        # lock + reserved set guarantee two forks are never handed the same
        # freed window before either registers
        self._window_lock = threading.Lock()
        self._reserved_windows: set = set()
        self.engines: List[FlowServe] = []
        self.policy = policy
        self.scaler = scaler
        self.trigger = trigger
        self.drain_trigger = drain_trigger
        self.warm_pool = warm_pool
        self.scale_events: List[Dict[str, Any]] = []
        self.resubmits: List[Dict[str, Any]] = []   # mid-prefill restarts
        self.lifecycle_log: List[Tuple[int, str, str]] = []
        # fault tolerance (DESIGN.md §11)
        self.fault_plan = fault_plan            # set BEFORE spawning: the
        #                                         initial fleet gets hooks
        self.admission_limit = admission_limit  # queued-per-serving-TE cap
        self.rejections: List[Dict[str, Any]] = []
        self._parked: List[Request] = []        # recovered, no survivor yet
        self._xfer_retry: Dict[str, Tuple[int, int]] = {}  # rid -> (n, due)
        self.xfer_retries = 0
        self.xfer_backoff_cap = 8               # max steps between retries
        self.steps = 0
        self.fleet_threads = fleet_threads
        self._fleet: Optional[FleetExecutor] = None
        self._fork_pool: Optional[FleetExecutor] = None  # scale_to rounds
        self._scale_seq = 0                     # te-scaleN naming

        handles: List[TEHandle] = []
        for gi, (n_p, n_d) in enumerate(topology.groups()):
            handle = TEHandle(f"te-pd{gi}", "pd_pair",
                              state=TEState.PROVISIONING)
            pes = [self._spawn(f"te-pd{gi}-p{j}" if n_p > 1
                               else f"te-pd{gi}-p", "prefill")
                   for j in range(n_p)]
            des = [self._spawn(f"te-pd{gi}-d{j}" if n_d > 1
                               else f"te-pd{gi}-d", "decode")
                   for j in range(n_d)]
            handle.engine, handle.decode_engine = pes[0], des[0]
            if n_p > 1:
                handle.prefill_engines = pes
            if n_d > 1:
                handle.decode_engines = des
            self._bring_up(handle)
            handles.append(handle)
        for i in range(topology.colo):
            handle = TEHandle(f"te-colo{i}", "colocated",
                              state=TEState.PROVISIONING)
            handle.engine = self._spawn(f"te-colo{i}", "colocated")
            self._bring_up(handle)
            handles.append(handle)
        # one M:N DistFlow peer group over the whole fleet (§4.6): PD groups
        # migrate KV, NPU-fork broadcasts weights, all on linked clocks
        for i, eng in enumerate(self.engines):
            eng.distflow.link_cluster(
                [p.distflow for p in self.engines[i + 1:]])

        if predictor is None and policy == "dist_sched":
            # PR-4 follow-up: predicted_decode comes from completed-request
            # traces (EMA per mix), not the sampling budget
            predictor = TraceEMAPredictor()
        self._handles = handles           # shared list: RR sees fleet churn
        self.scheduler = DistributedScheduler(
            handles, heatmap, prefill_lens, decode_ratios,
            predictor=predictor,
            cfg=dcfg if dcfg is not None else DistSchedConfig())
        self._rr = round_robin_scheduler(self._handles) \
            if policy == "round_robin" else None
        self.requests: Dict[str, _PlaneRequest] = {}
        self.jobs: Dict[str, Job] = {}
        self.completions: List[Completion] = []
        # per-group queue of (prefill TE, req_id) waiting on decode capacity
        self._migrate_pending: Dict[str, deque] = {
            h.te_id: deque() for h in handles if h.te_type == "pd_pair"}

    # ------------------------------------------------------------ fleet
    def _spawn(self, name: str, mode: str) -> FlowServe:
        off, owned = self._alloc_window()
        te = None
        try:
            ecfg = replace(self._base_ecfg, mode=mode, device_offset=off)
            te = FlowServe(self.cfg, self.params, ecfg, name=name,
                           device=self.device)
            self._commit_window(name, off, owned)
        finally:
            if te is None:              # bring-up raised: free the window
                self._abort_window(off, owned)
        self._attach_faults(te)
        self.engines.append(te)
        return te

    def _attach_faults(self, te: FlowServe) -> None:
        """Wire the plane's fault plan into one engine (no-op without one).
        Every engine the plane creates — initial fleet, trigger forks,
        scale_to rounds — passes through here so injection covers the
        WHOLE fleet, not just the seed TEs."""
        if self.fault_plan is not None:
            self.fault_plan.attach(te)

    def _alloc_window(self) -> Tuple[int, bool]:
        """Disjoint per-TE device windows (DESIGN.md §7/§9) — width tp, or
        ONE device per TE at tp=1 so concurrent executors overlap device
        work instead of queueing on device 0. The free list fed by RELEASED
        TEs (scale-in) is consulted FIRST: a future fork reuses a drained
        TE's window before growing the fleet's device footprint. When the
        fleet outgrows the visible devices, later TEs fall back to window 0
        (simulated co-residence, not owned) rather than failing bring-up.
        Returns (offset, owned).

        An allocated window is RESERVED until ``_commit_window`` registers
        the TE that uses it: concurrent fork rounds allocate several
        windows before any of their bring-ups finish, and a release landing
        mid-round must not re-hand an offset that an in-flight fork already
        holds."""
        width = max(1, self.topology.tp)
        with self._window_lock:
            while self._free_windows:
                off = self._free_windows.pop()
                if off in self._reserved_windows:
                    continue
                self._reserved_windows.add(off)
                return off, True
            if self._offset_cursor + width \
                    <= _device_count(self.device):
                off = self._offset_cursor
                self._offset_cursor += width
                self._reserved_windows.add(off)
                return off, True
            return 0, False

    def _commit_window(self, name: str, off: int, owned: bool) -> None:
        """Bind an allocated window to its now-registered TE (clears the
        in-flight reservation). Only an OWNED allocation holds a
        reservation — discarding unconditionally would clobber another
        in-flight fork's legitimate claim on offset 0 whenever a fallback
        (unowned) bring-up commits."""
        with self._window_lock:
            if owned:
                self._reserved_windows.discard(off)
                self._window_of[name] = off

    def _abort_window(self, off: int, owned: bool) -> None:
        """Release an in-flight window reservation whose bring-up FAILED
        (fork raised between alloc and commit). Without this the offset
        stays reserved forever and the fleet's device footprint shrinks
        permanently (§11 — the reserved-window leak)."""
        with self._window_lock:
            if owned:
                self._reserved_windows.discard(off)
                self._free_windows.append(off)

    def _bring_up(self, handle: TEHandle) -> None:
        """PROVISIONING → WARMING → SERVING (the §6 pipeline's TE-side
        states; bring-up here is synchronous, the transitions are what the
        rest of the plane keys on)."""
        self._log_state(handle, handle.transition(TEState.WARMING))
        self._log_state(handle, handle.transition(TEState.SERVING))

    def _log_state(self, handle: TEHandle, state: TEState) -> None:
        self.lifecycle_log.append((self.steps, handle.te_id, state.value))

    @property
    def handles(self) -> List[TEHandle]:
        return list(self._handles)

    def n_serving(self) -> int:
        return sum(1 for h in self._handles
                   if h.state is TEState.SERVING)

    def close(self) -> None:
        if self._fleet is not None:
            self._fleet.close()
            self._fleet = None
        if self._fork_pool is not None:
            self._fork_pool.close()
            self._fork_pool = None

    # ------------------------------------------------------------ intake
    def submit(self, tokens, sampling: Optional[SamplingParams] = None,
               predicted_decode: Optional[int] = None,
               request: Optional[UserRequest] = None) -> str:
        """request → job → task(s) → TE (Algorithm 1 or round-robin).

        Returns the request id; its ``Completion`` surfaces from ``step``
        once the decode finishes (on a group decode member or the colocated
        TE). ``predicted_decode`` defaults to the trace-trained EMA
        predictor's estimate (``TraceEMAPredictor``; the sampling budget
        only before any trace exists or under round-robin)."""
        sampling = sampling if sampling is not None else SamplingParams()
        if request is None:
            request = UserRequest(rtype=RequestType.CHAT,
                                  payload={"tokens": list(tokens),
                                           "max_new_tokens":
                                               sampling.max_new_tokens})
        self._check_admission(request)
        job = decompose(request)[0]
        job.status = Status.RUNNING
        self.jobs[job.job_id] = job
        if predicted_decode is None:
            pred = self.scheduler.predictor
            if self._rr is None and pred is not None \
                    and _predictor_trained(pred):
                predicted_decode = pred.predict_tokens(tokens)
            else:
                # no trace yet (or round-robin): the sampling budget is the
                # only honest estimate — a cold default would misroute
                # pd_aware and over-reserve load on the chosen TE
                predicted_decode = sampling.max_new_tokens
        sreq = SchedRequest(tokens=list(tokens),
                            predicted_decode=predicted_decode)
        if self._rr is not None:
            handle = self._rr(sreq)
        else:
            handle = self.scheduler.dist_sched(sreq)
            self.scheduler.commit(sreq, handle)
        if handle.te_type == "pd_pair":
            # Algorithm-1 M:N extension (§4.6): least-loaded prefill member
            pe = min(handle.prefill_members(), key=_engine_load)
            tp_ = job.spawn(TaskKind.PREFILL, tokens=list(tokens))
            tp_.te_id, tp_.status = pe.name, Status.RUNNING
            td = job.spawn(TaskKind.DECODE)
            td.te_id = None               # decode member picked at handoff
        else:
            pe = handle.engine
            tc = job.spawn(TaskKind.COLOCATED, tokens=list(tokens))
            tc.te_id, tc.status = pe.name, Status.RUNNING
        ereq = Request(prompt_tokens=list(tokens), sampling=sampling,
                       req_id=request.req_id)
        ereq.arrival = request.arrival      # TTFT from EXTERNAL arrival
        pe.add_request(ereq)
        self.requests[request.req_id] = _PlaneRequest(job, sreq, handle, ereq)
        return request.req_id

    def _check_admission(self, request: UserRequest) -> None:
        """Graceful degradation (DESIGN.md §11): with ``admission_limit``
        set, the plane's TOTAL queued-prefill backlog is bounded at
        ``limit × n_serving`` — capacity lost to failures shrinks the bound
        automatically (deficit-aware shedding). A breach REJECTS the
        request explicitly (``Status.REJECTED`` job + ``AdmissionRejected``)
        instead of building unbounded backlog while ``scale_to`` repairs
        the fleet."""
        if self.admission_limit is None:
            return
        serving = [h for h in self._handles if h.state is TEState.SERVING]
        cap = self.admission_limit * len(serving)
        queued = len(self._parked)
        for h in serving:
            for eng in self._members(h):
                queued += eng.load_metrics()["n_queued"]
        if serving and queued < cap:
            return
        job = decompose(request)[0]
        job.status = Status.REJECTED
        self.jobs[job.job_id] = job
        self.rejections.append({"req_id": request.req_id, "step": self.steps,
                                "queued": queued, "cap": cap,
                                "n_serving": len(serving)})
        raise AdmissionRejected(
            f"admission shed: {queued} queued >= cap {cap} "
            f"({len(serving)} serving TEs)", req_id=request.req_id)

    # ------------------------------------------------------------ drive
    def step(self) -> List[Completion]:
        """One JE iteration: step every live fleet unit — serially, or as
        submit/collect over the per-TE executors (``fleet_threads > 1``) so
        units overlap wall-clock work — then run the cross-unit phase on
        the JE thread: harvest completions, pump drains, feed the
        scale triggers."""
        units = [h for h in self._handles
                 if h.state in (TEState.SERVING, TEState.DRAINING)]
        out: List[Completion] = []
        failures: List[Tuple[str, BaseException]] = []
        if self.fleet_threads > 1 and len(units) > 1:
            if self._fleet is None:
                self._fleet = FleetExecutor(self.fleet_threads)
            for h in units:
                self._fleet.submit(h.te_id,
                                   (lambda hh=h: self._step_unit(hh)))
            done, failed = self._fleet.collect(len(units))
            for _, comps in done:
                out.extend(comps)
            failures.extend(failed)
        else:
            for h in units:
                try:
                    out.extend(self._step_unit(h))
                except Exception as exc:   # same quarantine as the threaded
                    failures.append((h.te_id, exc))   # path (§11)
        for comp in out:
            self._on_complete(comp)
        self.completions.extend(out)
        # containment AFTER harvesting: the surviving units' completions
        # this step are real — a failure never nukes them
        for te_id, exc in failures:
            self._on_unit_failure(te_id, exc)
        self._flush_parked()
        try:
            self._pump_drains()
        except TEFailureError as exc:
            # a source crashed mid-migration on the JE thread (drain
            # pump) — same quarantine as a worker-thread failure; the
            # remaining drains pump next step
            h = next((hh for hh in self._handles
                      if any(e.name == exc.te
                             for e in self._members(hh))), None)
            if h is not None:
                self._on_unit_failure(h.te_id, exc)
        self._maybe_scale()
        self.steps += 1
        return out

    def _step_unit(self, handle: TEHandle) -> List[Completion]:
        """One unit's step: group-local work only (executor-safe — a unit's
        worker never touches another unit's engines). PD groups pump their
        internal handoff here: prefill members step, finished prefills
        migrate to the least-loaded decode member (capacity-gated
        backpressure), decode members step."""
        out: List[Completion] = []
        if handle.te_type == "pd_pair":
            for pe in handle.prefill_members():
                if pe.has_work():
                    pe.step()
            pending = self._migrate_pending[handle.te_id]
            for pe in handle.prefill_members():
                pending.extend((pe, rid) for rid in pe.pop_migratable())
            while pending:
                pe, rid = pending[0]
                if not self._try_migrate(pe, handle.pick_decode_member(),
                                         rid):
                    break                 # backpressure: retry next step
                pending.popleft()
            for de in handle.decode_members():
                if de.has_work():
                    out.extend(de.step())
        else:
            eng = handle.engine
            if eng.has_work():
                out.extend(eng.step())
        return out

    def has_work(self) -> bool:
        return bool(self.requests) or any(
            h.state is TEState.DRAINING for h in self._handles)

    def run_to_completion(self, max_steps: int = 20000) -> List[Completion]:
        out: List[Completion] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            out.extend(self.step())
        return out

    # ------------------------------------------------------------ PD pump
    def _try_migrate(self, pe: FlowServe, de: FlowServe, req_id: str) -> bool:
        """Hand one request's KV from ``pe`` to ``de`` over the §7 sharded
        path (PD handoff or drain migration). Returns False when the
        destination pool lacks pages for the KV run — the request stays
        queued on the source (backpressure) and the pump retries next
        step."""
        seq = pe._seqs.get(req_id)
        if seq is None:
            return True                   # released upstream; drop
        retry = self._xfer_retry.get(req_id)
        if retry is not None and self.steps < retry[1]:
            return False                  # backing off a transient fault
        if de.pool is not None:
            # cheap pre-gate; cached (reclaimable) pages count because the
            # import path evicts them coherently through the RTC
            free = de.pool.free_page_count() + len(de.pool.reclaimable())
            if len(seq.pages) > free:
                return False
        # import_request signals exhaustion (pages or slots) by raising
        # BEFORE committing destination state and before the source
        # releases — the request parks on the source side and retries
        try:
            pe.migrate_out(req_id, de)
        except OutOfPagesError:
            return False
        except TransferFault:
            # transient wire failure: both endpoints already restored their
            # state (flowserve rolls back) — retry with capped exponential
            # backoff, measured in plane steps (§11)
            attempts = retry[0] + 1 if retry is not None else 1
            due = self.steps + min(self.xfer_backoff_cap,
                                   2 ** (attempts - 1))
            self._xfer_retry[req_id] = (attempts, due)
            self.xfer_retries += 1
            return False
        self._xfer_retry.pop(req_id, None)
        rec = self.requests.get(req_id)
        for task in (rec.job.tasks if rec is not None else ()):
            if task.kind == TaskKind.PREFILL:
                task.status = Status.DONE
            elif task.kind == TaskKind.DECODE:
                task.te_id, task.status = de.name, Status.RUNNING
            elif task.kind == TaskKind.COLOCATED:
                task.te_id = de.name      # drain migration re-homed it
        return True

    # ------------------------------------------------------------ harvest
    def _on_complete(self, comp: Completion) -> None:
        rec = self.requests.pop(comp.req_id, None)
        if rec is None:
            return
        for task in rec.job.tasks:
            task.status = Status.DONE
        rec.job.status = Status.DONE
        rec.job.result = comp
        if self._rr is None:
            # release the ACTUAL consumption, not the prediction — the
            # complete() drift fix only helps if callers pass actuals
            self.scheduler.complete(rec.sreq, rec.handle,
                                    actual_decode=len(comp.tokens))
            pred = self.scheduler.predictor
            if pred is not None and hasattr(pred, "observe"):
                # train the EMA predictor on the completed trace (§5.3.3)
                pred.observe(rec.sreq.tokens, len(comp.tokens))

    # ------------------------------------------------------------ failure
    def _handle_of_engine(self, eng: FlowServe) -> Optional[TEHandle]:
        for h in self._handles:
            if eng in self._members(h):
                return h
        return None

    def _on_unit_failure(self, te_id: str, exc: BaseException) -> None:
        """Detect → contain → recover for one failed fleet unit (§11).

        Containment: the unit walks FAILED → RELEASED, leaves routing
        (``admitting`` is False the moment it leaves SERVING; the handle
        is removed from both schedulers' views), and its device windows
        return to the free list for the repair fork to reuse.

        Recovery keeps the at-most-once invariant by building ONE restart
        set keyed on req_id, in this order: (1) survivors' in-flight KV
        imports whose SOURCE died are voided — those sequences restart;
        (2) requests resident on the dead unit restart UNLESS they are
        alive on a survivor (a mid-migration request whose import already
        landed continues on the destination — restarting it too would
        duplicate tokens); (3) only requests the plane still tracks
        restart (completed ones are done). Each restart re-enters the
        least-loaded surviving prefill-capable engine from the PROMPT via
        ``_resubmit`` (req_id + arrival preserved, restart counted); with
        no survivor it parks until capacity returns."""
        handle = next((h for h in self._handles if h.te_id == te_id), None)
        if handle is None:
            return                        # already quarantined
        self._log_state(handle, handle.transition(TEState.FAILED))
        dead = self._members(handle)
        dead_names = {e.name for e in dead}
        restart: Dict[str, Request] = {}
        for eng in self.engines:
            if eng in dead:
                continue
            for req in eng.void_pending_imports(dead_names):
                restart[req.req_id] = req
        alive = set()
        for eng in self.engines:
            if eng not in dead:
                alive.update(eng._requests.keys())
        for eng in dead:
            for rid, req in list(eng._requests.items()):
                if rid not in alive:
                    restart.setdefault(rid, req)
        restart = {rid: req for rid, req in restart.items()
                   if rid in self.requests}
        # quarantine: windows to the free list, engines/handle out of every
        # routing structure (a FAILED unit is replaced, not rebooted here —
        # scale_to repairs the fleet from survivors)
        self._log_state(handle, handle.transition(TEState.RELEASED))
        for eng in dead:
            with self._window_lock:
                off = self._window_of.pop(eng.name, None)
                if off is not None:
                    self._free_windows.append(off)
            if eng in self.engines:
                self.engines.remove(eng)
        self._handles.remove(handle)      # shared list: RR sees the removal
        self.scheduler.tes.pop(handle.te_id, None)
        self._migrate_pending.pop(handle.te_id, None)
        _drop_engines(handle)
        for rid in restart:
            self._xfer_retry.pop(rid, None)
        self.scale_events.append({"kind": "te_failure", "step": self.steps,
                                  "te_id": te_id, "error": repr(exc),
                                  "n_restarted": len(restart),
                                  "event": None})
        # the traceback's frames hold the dead unit's engines (their pools,
        # hot state and pinned buffers): drop them so that memory returns
        exc.__traceback__ = None
        if self.drain_trigger is not None:
            self.drain_trigger.rearm()    # capacity loss: never keep draining
        if self.trigger is not None:
            # the lost capacity must be able to re-fire scale-out
            # immediately, whatever the trigger's re-arm state was
            self.trigger.armed = True
            self.trigger.breach_steps = 0
        for rid, req in restart.items():
            dst = self._resubmit_destination(exclude=handle)
            if dst is None:
                self._parked.append(req)
                continue
            self._resubmit(req, dst, src=te_id, reason="te_failure")

    def _flush_parked(self) -> None:
        """Re-home requests whose failure-time restart found no surviving
        admitting engine (total capacity loss) once repair restores one."""
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        for req in parked:
            dst = self._resubmit_destination(exclude=None)
            if dst is None:
                self._parked.append(req)
            else:
                self._resubmit(req, dst, src="parked", reason="te_failure")

    def restart_counts(self) -> Dict[str, int]:
        """Per-request restart tally over the whole run (at-most-once
        accounting input for the fault bench)."""
        counts: Dict[str, int] = {}
        for r in self.resubmits:
            counts[r["req_id"]] = counts.get(r["req_id"], 0) + 1
        return counts

    # ------------------------------------------------------------ scale-in
    def drain(self, te_id: str) -> TEHandle:
        """Begin scale-in of one TE (DESIGN.md §9): SERVING → DRAINING.
        Admissions stop immediately (Algorithm 1 and RR both skip
        non-admitting handles); each subsequent ``step`` migrates its
        movable decodes out over the §7 path and lets the rest finish,
        then releases the TE. Illegal states raise ``LifecycleError``."""
        handle = next((h for h in self._handles if h.te_id == te_id), None)
        if handle is None:
            raise KeyError(f"unknown TE {te_id!r}")
        self._log_state(handle, handle.transition(TEState.DRAINING))
        self.scale_events.append({"kind": "drain", "step": self.steps,
                                  "te_id": te_id, "event": None})
        return handle

    def cancel_drain(self, te_id: str) -> TEHandle:
        """Drain-CANCEL (DESIGN.md §10): DRAINING → SERVING on a load
        resurgence — the capacity being drained is needed after all, so
        admissions resume instead of releasing the window. The state
        machine already permits the transition; this is what drives it."""
        handle = next((h for h in self._handles if h.te_id == te_id), None)
        if handle is None:
            raise KeyError(f"unknown TE {te_id!r}")
        self._log_state(handle, handle.transition(TEState.SERVING))
        self.scale_events.append({"kind": "drain_cancel", "step": self.steps,
                                  "te_id": te_id, "event": None})
        if self.drain_trigger is not None:
            self.drain_trigger.rearm()    # the in-flight drain is over
        return handle

    def _pump_drains(self) -> None:
        """JE-thread drain progress. First the resurgence check: if the
        still-serving TEs' mean load shot past the drain trigger's
        resurgence watermark, every in-flight drain is CANCELLED
        (DRAINING → SERVING) instead of pumped. Otherwise each draining
        TE's mid-PREFILL work is re-submitted to a prefill-capable
        destination (token-level restart — finishing prefill on a TE
        that's leaving just delays the release), its movable decodes
        migrate to the least-loaded admitting destination
        (capacity-gated), and the TE is released once genuinely empty."""
        draining = [h for h in self._handles if h.state is TEState.DRAINING]
        if not draining:
            return
        if self.drain_trigger is not None:
            serving = [h for h in self._handles
                       if h.state is TEState.SERVING]
            if serving and self.drain_trigger.resurgent(
                    [h.refresh() for h in serving]):
                for handle in draining:
                    self.cancel_drain(handle.te_id)
                return
        for handle in draining:
            dst = self._drain_destination(exclude=handle)
            if dst is not None:
                resub_dst = self._resubmit_destination(exclude=handle)
                if resub_dst is not None:
                    for eng in self._members(handle):
                        for req in eng.cancel_queued():
                            self._resubmit(req, resub_dst, src=eng.name)
                for eng in self._decode_side(handle):
                    for rid in eng.migratable_running():
                        if not self._try_migrate(eng, dst, rid):
                            break
            if not any(e.has_work() for e in self._members(handle)) \
                    and not self._migrate_pending.get(handle.te_id):
                self._release(handle)

    def _resubmit_destination(self, exclude: TEHandle) -> Optional[FlowServe]:
        """Least-loaded admitting PREFILL-capable engine outside
        ``exclude`` (a decode-mode member can't restart a prompt)."""
        best, best_load = None, None
        for h in self._handles:
            if h is exclude or not h.admitting:
                continue
            if h.te_type == "pd_pair":
                eng = min(h.prefill_members(), key=_engine_load)
            else:
                eng = h.engine
            if eng is None:
                continue
            load = _engine_load(eng)
            if best_load is None or load < best_load:
                best, best_load = eng, load
        return best

    def _resubmit(self, req: Request, dst: FlowServe, src: str,
                  reason: str = "drain") -> None:
        """Token-level restart of a mid-PREFILL (or failure-recovered)
        request on ``dst``: the original ``Request`` (req_id + external
        arrival preserved, so TTFT spans the restart) re-enters the
        destination's scheduler from the prompt. Recorded in ``resubmits``,
        NOT ``scale_events`` — it's request routing, not fleet shape."""
        dst.add_request(req)
        rec = self.requests.get(req.req_id)
        if rec is not None:
            for task in rec.job.tasks:
                if task.kind in (TaskKind.PREFILL, TaskKind.COLOCATED):
                    task.te_id, task.status = dst.name, Status.RUNNING
        self.resubmits.append({"req_id": req.req_id, "from": src,
                               "to": dst.name, "step": self.steps,
                               "reason": reason})

    def _members(self, handle: TEHandle) -> List[FlowServe]:
        if handle.te_type == "pd_pair":
            return [*handle.prefill_members(), *handle.decode_members()]
        return [handle.engine]

    def _decode_side(self, handle: TEHandle) -> List[FlowServe]:
        return (handle.decode_members() if handle.te_type == "pd_pair"
                else [handle.engine])

    def _drain_destination(self, exclude: TEHandle) -> Optional[FlowServe]:
        """Least-loaded admitting decode-capable engine outside ``exclude``."""
        best, best_load = None, None
        for h in self._handles:
            if h is exclude or not h.admitting:
                continue
            eng = (h.pick_decode_member() if h.te_type == "pd_pair"
                   else h.engine)
            if eng is None:
                continue
            load = _engine_load(eng)
            if best_load is None or load < best_load:
                best, best_load = eng, load
        return best

    def _release(self, handle: TEHandle) -> None:
        """DRAINING → RELEASED: drop the TE from the fleet and return its
        device window to the free list (the next fork reuses it). With a
        ``WarmPool`` attached, the TE's device-resident params drain back
        to host DRAM on the way out — the RELEASED → warm leg of the
        cold-start ladder (DESIGN.md §10) — so a later scale-out comes up
        from warm instead of cold."""
        self._log_state(handle, handle.transition(TEState.RELEASED))
        asset = self._asset_name()
        for eng in self._members(handle):
            if self.warm_pool is not None:
                host = eng.release_params(
                    to_host=not self.warm_pool.hit(asset))
                if host is not None:
                    self.warm_pool.put(asset, host, host_copy=False)
            with self._window_lock:
                off = self._window_of.pop(eng.name, None)
                if off is not None:
                    self._free_windows.append(off)
            if eng in self.engines:
                self.engines.remove(eng)
        self._handles.remove(handle)      # shared list: RR sees the removal
        self.scheduler.tes.pop(handle.te_id, None)
        self._migrate_pending.pop(handle.te_id, None)
        _drop_engines(handle)
        self.scale_events.append({"kind": "release", "step": self.steps,
                                  "te_id": handle.te_id, "event": None})
        if self.drain_trigger is not None:
            self.drain_trigger.rearm()    # the in-flight drain completed

    # ------------------------------------------------------------ scaling
    def _maybe_scale(self) -> None:
        if self.trigger is None and self.drain_trigger is None:
            return
        # mutual exclusion (per TE and per fleet): while ANY TE drains,
        # neither trigger is fed — a draining TE's load collapsing toward
        # zero looks exactly like a spread breach, and forking while
        # shrinking (or vice versa) would thrash. The spread trigger also
        # must not RE-ARM off the drain's transient profile. (Checked
        # before refreshing: refresh() locks every engine.)
        if any(h.state is TEState.DRAINING for h in self._handles):
            return
        live = [h for h in self._handles if h.state is TEState.SERVING]
        loads = [h.refresh() for h in live]
        deficit = self.trigger.observe(loads) if self.trigger is not None \
            else 0
        if deficit > 1:
            # capacity deficit (te_capacity set): one fire requests the
            # whole fork TREE instead of one fork per re-arm cycle
            self.scale_to(self.n_serving() + deficit)
            return
        if deficit:
            self._scale_out()
            return
        if self.drain_trigger is not None:
            if self.trigger is not None and self.trigger.breach_steps > 0:
                return                    # a fork may be imminent: hold
            if self.drain_trigger.observe(loads, self.n_serving()):
                self._start_drain()

    def _start_drain(self) -> None:
        """Pick the scale-in victim: the least-loaded admitting colocated
        TE (PD group members are structural — their decode side shrinks
        only when a grown member empties, future work). A fired trigger
        with NO drainable candidate re-arms immediately — otherwise a
        pd-only fleet would disarm it forever on the first idle spell."""
        cands = [h for h in self._handles
                 if h.te_type == "colocated" and h.admitting]
        if len(cands) < 1 or self.n_serving() <= 1:
            if self.drain_trigger is not None:
                self.drain_trigger.rearm()
            return
        victim = min(cands, key=lambda h: h.load)
        self.drain(victim.te_id)

    fork_max_attempts: int = 4          # per-fork retry budget (§11)

    def _scale_out(self) -> None:
        """Spread breach: NPU-fork capacity from a live engine (§6.3).
        Decode-dominated pressure with a PD group present grows that
        group's decode side (M:N, §4.6); anything else forks a whole
        colocated TE. FastScaler prices the 5-step bring-up pipeline
        around the same fork.

        Fault handling (§11): a transient ``ForkFault`` retries with
        capped exponential backoff, rotating to an ALTERNATIVE source; a
        source that dies mid-fork (``TEFailureError``) is quarantined via
        ``_on_unit_failure`` and the retry continues from a survivor. The
        window reservation is released in a ``finally`` whenever no TE
        registers — a failed fork must not leak the offset."""
        live = [h for h in self._handles if h.admitting]
        pd_handles = [h for h in live if h.te_type == "pd_pair"]
        total_p = sum(h.prefill_load for h in live)
        total_d = sum(h.decode_load for h in live)
        grow_group = (pd_handles
                      and total_d > self.decode_dominance * max(1.0, total_p))
        if grow_group:
            group = max(pd_handles, key=lambda h: h.decode_load)
            candidates = sorted(group.decode_members(), key=_engine_load)
            name = f"{group.te_id}-d{len(group.decode_members())}"
            mode = "decode"
        else:
            group = None
            candidates = sorted((h.decode_engine or h.engine for h in live),
                                key=_engine_load)
            name = f"te-scale{self._scale_seq}"
            mode = "colocated"
        off, owned = self._alloc_window()
        te = src_engine = None
        try:
            ecfg = replace(self._base_ecfg, mode=mode, device_offset=off)
            for attempt in range(self.fork_max_attempts):
                if not candidates:
                    break
                src_engine = candidates[attempt % len(candidates)]
                try:
                    te = FlowServe.fork_from(src_engine, ecfg, name=name,
                                             device=self.device)
                    break
                except ForkFault:
                    time.sleep(backoff_s(attempt))
                except TEFailureError as exc:
                    src_handle = self._handle_of_engine(src_engine)
                    dead = set(self._members(src_handle)) \
                        if src_handle is not None else {src_engine}
                    if src_handle is not None:
                        self._on_unit_failure(src_handle.te_id, exc)
                    candidates = [c for c in candidates
                                  if c not in dead and c.fork_ready]
                    if group is not None and not candidates:
                        break   # the group's own decode side is gone
            if te is not None:
                self._commit_window(name, off, owned)
        finally:
            if te is None:
                self._abort_window(off, owned)
        if te is None:
            self.scale_events.append({"kind": "fork_failed",
                                      "step": self.steps, "te_id": name,
                                      "event": None})
            if self.trigger is not None:
                self.trigger.armed = True   # deficit persists: re-fire
            return
        self._attach_faults(te)
        # the new TE walks the same lifecycle as the initial fleet
        handle = (group if group is not None else
                  TEHandle(name, "colocated", state=TEState.PROVISIONING))
        if group is None:
            self._scale_seq += 1
        for eng in self.engines:
            eng.distflow.link_cluster([te.distflow])
        self.engines.append(te)
        event = None
        if self.scaler is not None:
            asset = ModelAsset(name=self._asset_name(),
                               n_bytes=_nbytes(self.params),
                               tp=max(1, self.topology.tp))
            # fork_from already moved the weights and charged DistFlow;
            # hand its transfer to the pipeline as the TE-Load step
            xfer = src_engine.distflow.log[-1]
            event = self.scaler.scale_one(
                asset, optimized=True,
                preloaded=LoadResult("npu_fork_ici", xfer.sim_seconds,
                                     xfer.n_bytes))
        if group is not None:
            group.grow_decode(te)
            self.scale_events.append({"kind": "grow_decode",
                                      "step": self.steps, "te_id": name,
                                      "group": group.te_id,
                                      "source": src_engine.name,
                                      "event": event})
            return
        handle.engine = te
        self._bring_up(handle)
        self._handles.append(handle)
        self.scheduler.tes[name] = handle
        self.scale_events.append({"kind": "fork", "step": self.steps,
                                  "te_id": name, "source": src_engine.name,
                                  "event": event})

    # ------------------------------------------------------------ mass scale
    def _asset_name(self) -> str:
        return getattr(self.cfg, "name", "model")

    def _fork_sources(self) -> List[FlowServe]:
        """Every SERVING engine whose params are still device-resident —
        the fork-source pool a scale-out round fans out from."""
        out: List[FlowServe] = []
        for h in self._handles:
            if h.state is not TEState.SERVING:
                continue
            out.extend(e for e in self._members(h) if e.fork_ready)
        return out

    def _fork_executor(self) -> FleetExecutor:
        if self._fork_pool is None:
            self._fork_pool = FleetExecutor(8)
        return self._fork_pool

    def scale_to(self, n: int, fan_out: bool = True,
                 warmup: bool = False,
                 pace: Optional[ModelAsset] = None) -> Dict[str, Any]:
        """Mass scale-out to ``n`` SERVING TEs through the cold-start
        ladder (DESIGN.md §10), in O(log N) FORK ROUNDS:

        * round k forks one new TE from EVERY fork-ready SERVING engine —
          each TE that reached SERVING in round k is a source in round
          k+1, so the fleet doubles per round (λScale's multicast tree);
          forks within a round run concurrently on executor threads
          (``fork_from`` is executor-safe via the per-source RLock);
        * when the round's deficit exceeds the source pool, the remainder
          comes up from the DRAM-warm tier (``WarmPool``) — one host
          entry serves any number of concurrent ``device_put``s;
        * with neither a source nor a warm entry, bring-up is cold init.

        ``fan_out=False`` degrades to serial one-at-a-time forking (the
        bench baseline: identical registration path and final placement,
        N-1 rounds instead of ceil(log2 N)). ``warmup`` precompiles a
        small decode grid on each new TE before it's declared SERVING.
        ``pace`` holds every bring-up job to the modeled full-size tier
        cost of that asset (``scaling.tier_seconds``): the CPU sim's
        smoke-scale copies finish in microseconds, so without pacing the
        measured wall is pure python overhead — with it, each job's wall
        is the larger of its real device work and the priced transfer,
        the same modeled-cost idiom as ``FastScaler``. Returns the
        executed plan (per-round TEs/sources/tiers + wall)."""
        plan: Dict[str, Any] = {
            "target": n, "start_serving": self.n_serving(),
            "rounds": [], "tiers": {"fork": 0, "warm": 0, "cold": 0}}
        t_all = time.monotonic()
        asset = self._asset_name()
        # tag asserts the entry's model-asset identity (§11): a mispointed
        # pool entry fails loudly here, not as a TE serving wrong weights
        warm_params = self.warm_pool.get(asset, tag=asset) \
            if self.warm_pool is not None else None
        stalls = 0                      # consecutive zero-progress rounds
        while self.n_serving() < n:
            deficit = n - self.n_serving()
            sources = self._fork_sources()
            n_fork = min(deficit, len(sources))
            n_rest = deficit - n_fork if warm_params is not None \
                or not sources else 0
            if not sources:
                n_rest = deficit            # warm or cold: no source needed
            if not fan_out:
                n_fork = min(1, n_fork)
                n_rest = 0 if n_fork else min(1, n_rest)
            jobs: List[Tuple[str, int, bool, str, Optional[str], Any]] = []
            for j in range(n_fork + n_rest):
                off, owned = self._alloc_window()
                name = f"te-scale{self._scale_seq}"
                self._scale_seq += 1
                ecfg = replace(self._base_ecfg, mode="colocated",
                               device_offset=off)
                if j < n_fork:
                    tier, src = "fork", sources[j]
                elif warm_params is not None:
                    tier, src = "warm", None
                else:
                    tier, src = "cold", None
                pace_s = tier_seconds(pace, tier) if pace is not None else 0.0
                jobs.append((name, off, owned, tier,
                             src.name if src is not None else None,
                             self._job_bring_up(name, ecfg, tier, src,
                                                warm_params, warmup,
                                                pace_s=pace_s)))
            t_round = time.monotonic()
            failed: Dict[str, BaseException] = {}
            if len(jobs) > 1:
                pool = self._fork_executor()
                for name, _, _, _, _, fn in jobs:
                    pool.submit(name, fn)
                done_list, failed_list = pool.collect(len(jobs))
                done = dict(done_list)
                failed = dict(failed_list)
            else:
                done = {}
                for name, _, _, _, _, fn in jobs:
                    try:
                        done[name] = fn()
                    except Exception as exc:
                        failed[name] = exc
            round_tes = []
            for name, off, owned, tier, src_name, _ in jobs:
                if name not in done:
                    # bring-up failed (transient ForkFault retries next
                    # round from the recomputed deficit): free the window
                    # reservation, and if the SOURCE died mid-fork,
                    # quarantine it before the next round forks from it
                    self._abort_window(off, owned)
                    exc = failed.get(name)
                    dead_te = getattr(exc, "te", None)
                    if dead_te is not None:
                        src_handle = next(
                            (h for h in self._handles
                             if any(e.name == dead_te
                                    for e in self._members(h))), None)
                        if src_handle is not None:
                            self._on_unit_failure(src_handle.te_id, exc)
                    continue
                te, fork_s = done[name]
                self._register_scaled(te, off, owned, tier, src_name,
                                      fork_s, len(plan["rounds"]))
                plan["tiers"][tier] += 1
                round_tes.append(name)
            plan["rounds"].append({
                "round": len(plan["rounds"]), "tes": round_tes,
                "failed": sorted(failed),
                "sources": [j[4] for j in jobs if j[4] is not None],
                "wall_s": time.monotonic() - t_round})
            if round_tes:
                stalls = 0
            else:
                stalls += 1
                if stalls >= 4:
                    raise RuntimeError(
                        f"scale_to({n}) stalled: {stalls} consecutive "
                        f"rounds with no successful bring-up "
                        f"(last errors: {sorted(map(repr, failed.values()))})")
                time.sleep(backoff_s(stalls))
        plan["wall_s"] = time.monotonic() - t_all
        plan["n_serving"] = self.n_serving()
        return plan

    def _job_bring_up(self, name: str, ecfg: EngineConfig, tier: str,
                      src: Optional[FlowServe], warm_params, warmup: bool,
                      pace_s: float = 0.0):
        """One bring-up closure, safe to run on an executor thread: builds
        the TE through its tier's path (fork: a copy of the source's
        weights; warm: an upload of the pool entry; cold: construction on
        the plane's own weights tree, shared) and optionally runs a small
        decode grid. It waits for the bring-up's device work, so its wall
        includes the copies. ``pace_s`` > 0 pads the job to the modeled
        full-size tier cost (a sleep releases the GIL, so padded jobs in
        one round overlap as transfers on independent links would).
        Registration stays on the JE thread."""
        dev = self.device

        def job():
            t0 = time.monotonic()
            if tier == "fork":
                te = FlowServe.fork_from(src, ecfg, name=name, device=dev)
            elif tier == "warm":
                te = FlowServe.from_warm(self.cfg, warm_params, ecfg,
                                         name=name, device=dev)
            else:
                te = FlowServe(self.cfg, self.params, ecfg, name=name,
                               device=dev)
            if te.device.type == "cuda":
                torch.cuda.synchronize(te.device)
            if warmup:
                te.warmup_decode(max_pages=2, horizons=[1])
            left = pace_s - (time.monotonic() - t0)
            if left > 0:
                time.sleep(left)
            return te, time.monotonic() - t0
        return job

    def _register_scaled(self, te: FlowServe, off: int, owned: bool,
                         tier: str, src_name: Optional[str], fork_s: float,
                         rnd: int) -> None:
        """JE-thread registration of one scaled-out TE: commit its
        window, link it into the fleet's DistFlow peer group, walk the
        lifecycle to SERVING, and expose it to Algorithm 1."""
        self._commit_window(te.name, off, owned)
        self._attach_faults(te)
        for eng in self.engines:
            eng.distflow.link_cluster([te.distflow])
        self.engines.append(te)
        event = None
        if self.scaler is not None:
            asset = ModelAsset(name=self._asset_name(),
                               n_bytes=_nbytes(self.params),
                               tp=max(1, self.topology.tp))
            # the bring-up already happened: hand its measured wall to the
            # pipeline as the TE-Load step (tiered pricing, no double
            # charge on the transfer fabric)
            path = {"fork": "npu_fork_ici", "warm": "warm_pool",
                    "cold": "cold_init"}[tier]
            event = self.scaler.scale_one(
                asset, optimized=True,
                preloaded=LoadResult(path, fork_s, asset.n_bytes))
        handle = TEHandle(te.name, "colocated", state=TEState.PROVISIONING)
        handle.engine = te
        self._bring_up(handle)
        self._handles.append(handle)
        self.scheduler.tes[te.name] = handle
        self.scale_events.append({"kind": "fork", "step": self.steps,
                                  "te_id": te.name, "source": src_name,
                                  "tier": tier, "round": rnd,
                                  "event": event})

    # ------------------------------------------------------------ stats
    def fleet_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-handle live load snapshot (refreshes every handle)."""
        out = {}
        for handle in self._handles:
            handle.refresh()
            out[handle.te_id] = {"load": handle.load,
                                 "n_running": handle.n_running,
                                 "type": handle.te_type,
                                 "state": handle.state.value,
                                 "n_prefill": len(handle.prefill_members())
                                 if handle.te_type == "pd_pair" else 0,
                                 "n_decode": len(handle.decode_members())
                                 if handle.te_type == "pd_pair" else 0}
        return out
