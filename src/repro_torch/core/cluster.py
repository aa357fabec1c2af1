"""Cluster manager + Job/Task executors (§3) and the AUTOSCALER (§6), the
port's own copy of ``repro/core/cluster.py`` (pure Python over the
port's abstractions, lifecycle, scaling and scheduling modules).

The cluster manager is the HA control plane: TE-group membership, health
(heartbeats, reboot-on-failure per §7), and scaling triggered by load /
SLO-violation metrics. JEs pull requests, decompose them (request-job-task)
and drive the distributed scheduler; TEs wrap FLOWSERVE engines behind the
TE-shell (health + scaling hooks).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.abstractions import (Job, JobKind, Status, Task,
                                           TaskKind, UserRequest, decompose)
from repro_torch.core.fleet import TEState, advance
from repro_torch.core.scaling import FastScaler, ModelAsset
from repro_torch.core.scheduling import (DistributedScheduler, SchedRequest,
                                         TEHandle)


# ---------------------------------------------------------------------------
# Task executor (TE-shell around an engine)
# ---------------------------------------------------------------------------


@dataclass
class TaskExecutor:
    te_id: str
    te_type: str                         # "colocated" | "prefill" | "decode"
    engine: Any = None                   # FlowServe (live) or sim cost model
    healthy: bool = True
    state: TEState = TEState.SERVING     # lifecycle (core/fleet.py)
    last_heartbeat: float = field(default_factory=time.monotonic)
    tasks_done: int = 0

    def transition(self, new: TEState) -> TEState:
        """Validated lifecycle walk; illegal transitions raise."""
        self.state = advance(self.state, new)
        return self.state

    def drained(self) -> bool:
        """A DRAINING TE is releasable once its engine holds no work."""
        return self.state is TEState.DRAINING and (
            self.engine is None or not getattr(self.engine, "has_work",
                                               lambda: False)())

    def heartbeat(self) -> None:
        self.last_heartbeat = time.monotonic()

    def fail(self) -> None:
        """Mark the TE crashed: unhealthy + lifecycle FAILED (legal from
        SERVING/DRAINING/WARMING; a TE already RELEASED stays released)."""
        self.healthy = False
        if self.state in (TEState.SERVING, TEState.DRAINING,
                          TEState.WARMING):
            self.transition(TEState.FAILED)

    def reboot(self) -> None:
        """§7: reboot the component; RTC state is soft (recomputed), so no
        consistency protocol is needed. A FAILED TE walks the legal
        FAILED → WARMING → SERVING path back (reboot-in-place)."""
        self.healthy = True
        self.heartbeat()
        if self.state is TEState.FAILED:
            self.transition(TEState.WARMING)
            self.transition(TEState.SERVING)
        if self.engine is not None and getattr(self.engine, "rtc", None) is not None:
            # soft state: drop the prefix index; pages are reclaimed lazily
            from repro_torch.engine.rtc import RelationalTensorCache
            eng = self.engine
            eng.rtc = RelationalTensorCache(eng.pool, eng.rtc.cost)
            eng.scheduler.rtc = eng.rtc


# ---------------------------------------------------------------------------
# Job executor
# ---------------------------------------------------------------------------


class JobExecutor:
    """Model-serving JE: decomposes requests and dispatches tasks to TEs via
    the distributed scheduler (Algorithm 1)."""

    def __init__(self, je_id: str, scheduler: DistributedScheduler,
                 dispatch: Callable[[Task, TEHandle], Any]):
        self.je_id = je_id
        self.scheduler = scheduler
        self.dispatch = dispatch
        self.jobs: Dict[str, Job] = {}
        self.healthy = True

    def handle(self, request: UserRequest) -> List[Job]:
        jobs = decompose(request)
        for job in jobs:
            self.jobs[job.job_id] = job
            if job.kind == JobKind.SERVING:
                self._serve(job)
            else:
                # post-training jobs: one shard task (training substrate)
                task = job.spawn(TaskKind.TRAIN_SHARD if job.kind == JobKind.TRAINING
                                 else TaskKind.PREPROCESS_SHARD,
                                 payload=request.payload)
                task.status = Status.PENDING
        return jobs

    def _serve(self, job: Job) -> None:
        tokens = job.request.payload["tokens"]
        sreq = SchedRequest(tokens=tokens,
                            predicted_decode=job.request.payload.get("max_new_tokens", 128))
        te = self.scheduler.dist_sched(sreq)
        self.scheduler.commit(sreq, te)
        if te.te_type == "pd_pair":
            t1 = job.spawn(TaskKind.PREFILL, tokens=tokens)
            t2 = job.spawn(TaskKind.DECODE, tokens=tokens)
            t1.te_id = te.te_id + "/prefill"
            t2.te_id = te.te_id + "/decode"
            self.dispatch(t1, te)
            self.dispatch(t2, te)
        else:
            t = job.spawn(TaskKind.COLOCATED, tokens=tokens)
            t.te_id = te.te_id
            self.dispatch(t, te)


# ---------------------------------------------------------------------------
# Cluster manager + autoscaler
# ---------------------------------------------------------------------------


@dataclass
class AutoscalerConfig:
    high_load: float = 0.80              # scale-up trigger (pool utilization)
    low_load: float = 0.25               # scale-down trigger
    slo_violation_rate: float = 0.05
    cooldown_s: float = 5.0
    max_tes: int = 64
    min_tes: int = 1


class ClusterManager:
    """Centralized HA module: membership, health, autoscaling."""

    def __init__(self, scaler: FastScaler, asset: ModelAsset,
                 cfg: AutoscalerConfig = AutoscalerConfig(),
                 te_factory: Optional[Callable[[str], TaskExecutor]] = None,
                 heartbeat_timeout: float = 10.0):
        self.scaler = scaler
        self.asset = asset
        self.cfg = cfg
        self.te_factory = te_factory or (lambda te_id: TaskExecutor(te_id, "colocated"))
        self.tes: Dict[str, TaskExecutor] = {}
        self.jes: Dict[str, JobExecutor] = {}
        self._te_seq = 0                 # monotonic: drain holes must not
        #                                  recycle a live TE's id
        self._last_scale = 0.0
        self.heartbeat_timeout = heartbeat_timeout
        self.scale_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- health
    def check_health(self) -> List[str]:
        """Reboot TEs whose heartbeat lapsed (§7 fault recovery)."""
        rebooted = []
        now = time.monotonic()
        for te in self.tes.values():
            if not te.healthy or te.state is TEState.FAILED \
                    or now - te.last_heartbeat > self.heartbeat_timeout:
                te.reboot()
                rebooted.append(te.te_id)
        return rebooted

    # ------------------------------------------------------------- scaling
    def autoscale(self, load: float, slo_violations: float,
                  now: Optional[float] = None) -> int:
        """Returns TE delta applied (positive = scaled up)."""
        now = now if now is not None else time.monotonic()
        # earlier drains may have emptied since the last evaluation — reap
        # on EVERY tick (a victim that lingered past its drain decision
        # would otherwise leak: the low-load branch is gated on
        # n_serving() > min_tes and can stop re-entering forever)
        self.reap_drained()
        if now - self._last_scale < self.cfg.cooldown_s:
            return 0
        n = len(self.tes)
        delta = 0
        if (load > self.cfg.high_load or slo_violations > self.cfg.slo_violation_rate) \
                and n < self.cfg.max_tes:
            delta = min(max(1, n), self.cfg.max_tes - n)   # double, capped
            for _ in range(delta):
                ev = self.scaler.scale_one(self.asset, optimized=True)
                while f"te-{self._te_seq}" in self.tes:   # externally
                    self._te_seq += 1                     # registered ids
                te = self.te_factory(f"te-{self._te_seq}")
                self._te_seq += 1
                self.tes[te.te_id] = te
                self.scale_log.append({"dir": "up", "event": ev.total,
                                       "path": ev.path, "t": now})
        elif load < self.cfg.low_load and self.n_serving() > self.cfg.min_tes:
            # scale-in is a DRAIN, not a delete (lifecycle, core/fleet.py):
            # the victim stops admitting, empties, then reap_drained()
            # releases its resources — a TE with no engine drains instantly
            victim = next((self.tes[tid] for tid in reversed(self.tes)
                           if self.tes[tid].state is TEState.SERVING), None)
            if victim is not None:
                delta = -1
                victim.transition(TEState.DRAINING)
                self.scale_log.append({"dir": "down", "te_id": victim.te_id,
                                       "t": now})
                self.reap_drained()
        if delta:
            self._last_scale = now
        return delta

    def n_serving(self) -> int:
        return sum(1 for te in self.tes.values()
                   if te.state is TEState.SERVING)

    def reap_drained(self) -> List[str]:
        """Release every DRAINING TE that has emptied: transition to
        RELEASED, return its pre-warm resources, drop it from membership.
        With a warm pool on the scaler (DESIGN.md §10), a live engine's
        device-resident params drain back to host DRAM on the way out, so
        the next scale-up takes the warm path instead of reloading."""
        released = []
        warm = getattr(self.scaler, "warm", None)
        for te_id in [t for t, te in self.tes.items() if te.drained()]:
            te = self.tes[te_id]
            te.transition(TEState.RELEASED)
            if warm is not None and te.engine is not None \
                    and hasattr(te.engine, "release_params"):
                host = te.engine.release_params(
                    to_host=not warm.hit(self.asset.name))
                if host is not None:
                    warm.put(self.asset.name, host, host_copy=False)
            self.scaler.release(te_id)
            del self.tes[te_id]
            released.append(te_id)
        return released

    def register_te(self, te: TaskExecutor) -> None:
        self.tes[te.te_id] = te

    def register_je(self, je: JobExecutor) -> None:
        self.jes[je.je_id] = je
