"""Deterministic fault injection for the elastic fleet (DESIGN.md §11),
the port's own copy of ``repro/core/faults.py``.

A ``FaultPlan`` is a seeded list of ``FaultSpec``s evaluated at hook
points inside the live engines:

* ``FlowServe.step``       — TE crash at step N / during PREFILL, plus
  straggler delay (the TE stalls but does not die);
* ``FlowServe.migrate_out`` — TE crash MID-MIGRATION (the source dies
  after the destination imported, before the source cleaned up);
* ``FlowServe.fork_from``  — transient fork failure (``ForkFault``: the
  scale-out path retries with backoff and another source) or a source
  crash mid-fork;
* ``DistFlow.transfer(_sharded)`` — transient transfer failure
  (``TransferFault``, the port's own from ``engine/distflow.py``): the
  migration is voided on the wire, both endpoints' request state is
  restored, and the pump retries with capped exponential backoff.

A crash surfaces as ``TEFailureError`` out of the unit's step; the
serving plane's quarantine path (``ServingJobEngine._on_unit_failure``)
turns it into FAILED -> RELEASED plus request recovery. Every fired spec
is recorded in ``FaultPlan.injected``, and the plan's ``seed`` makes the
victim choice replayable: ``choose_victim`` draws from numpy's
``RandomState`` as the reference does, so one seed picks the same TE in
both packages.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.engine.distflow import TransferFault  # noqa: F401  (re-export)


class TEFailureError(RuntimeError):
    """A TE (or one engine of its unit) crashed — the whole fleet unit is
    quarantined by the serving plane."""

    def __init__(self, msg: str, te: Optional[str] = None):
        super().__init__(msg)
        self.te = te


class ForkFault(RuntimeError):
    """Transient NPU-fork failure: the fork did not happen, the source is
    fine — retry (with backoff / an alternative source)."""


class AdmissionRejected(RuntimeError):
    """Admission control shed this request (bounded queue under capacity
    loss, DESIGN.md §11) — explicit rejection instead of unbounded
    backlog."""

    def __init__(self, msg: str, req_id: str = ""):
        super().__init__(msg)
        self.req_id = req_id


def backoff_s(attempt: int, base: float = 0.005, cap: float = 0.1) -> float:
    """Capped exponential backoff delay for retry attempt ``attempt``."""
    return min(cap, base * (2 ** max(0, attempt)))


@dataclass
class FaultSpec:
    """One injectable fault. ``te`` matches an engine name exactly or by
    prefix (``"te-pd0"`` hits every member of that group); None matches
    any engine. ``at_step`` arms the spec once the engine's local step
    counter reaches it. ``phase`` scopes a crash: "step" (any step),
    "prefill" (only while the engine holds queued prefill work),
    "migration" (inside ``migrate_out``) or "fork" (as a fork source).
    ``count`` is the firing budget (transient faults fire N times then
    clear). ``delay_s`` is the straggler stall per firing."""

    kind: str                       # "te_crash" | "xfer_fail" | "fork_fail"
    #                                 | "straggler"
    te: Optional[str] = None
    at_step: Optional[int] = None
    phase: str = "step"
    count: int = 1
    delay_s: float = 0.0


class FaultPlan:
    """Seeded, thread-safe fault schedule shared by every engine of one
    plane (hooks run on fleet worker threads)."""

    KINDS = ("te_crash", "xfer_fail", "fork_fail", "straggler")

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs)
        for spec in self.specs:
            if spec.kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {spec.kind!r}")
        self.injected: List[Dict[str, Any]] = []
        self._rng = np.random.RandomState(self.seed)
        self._lock = threading.Lock()

    def choose_victim(self, names: Sequence[str]) -> str:
        """Seeded deterministic victim pick (sorted for order stability)."""
        names = sorted(names)
        return names[int(self._rng.randint(len(names)))]

    def add(self, spec: FaultSpec) -> "FaultPlan":
        if spec.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {spec.kind!r}")
        with self._lock:
            self.specs.append(spec)
        return self

    # ------------------------------------------------------------ matching
    def _fire(self, kind: str, te: Optional[str], step: Optional[int],
              phase: Optional[str] = None) -> Optional[FaultSpec]:
        """Find + consume one firing of a matching spec; records it."""
        with self._lock:
            for spec in self.specs:
                if spec.kind != kind or spec.count <= 0:
                    continue
                if spec.te is not None and te is not None \
                        and te != spec.te and not te.startswith(spec.te):
                    continue
                if spec.at_step is not None and step is not None \
                        and step < spec.at_step:
                    continue
                if kind == "te_crash" and phase is not None \
                        and spec.phase != phase:
                    continue
                spec.count -= 1
                self.injected.append({"kind": kind, "te": te, "step": step,
                                      "phase": phase or spec.phase})
                return spec
        return None

    # ------------------------------------------------------------ hooks
    def on_step(self, engine) -> None:
        """``FlowServe.step`` entry hook: straggler stall, then crash-at-
        step / crash-during-PREFILL. Raises ``TEFailureError`` on crash."""
        name, step = engine.name, engine.steps
        spec = self._fire("straggler", name, step)
        if spec is not None and spec.delay_s > 0:
            time.sleep(spec.delay_s)
        phases = ["step"]
        if engine.scheduler.queued_seqs():
            phases.insert(0, "prefill")
        for phase in phases:
            if self._fire("te_crash", name, step, phase) is not None:
                raise TEFailureError(
                    f"injected crash of {name} at step {step} ({phase})",
                    te=name)

    def on_migration(self, src_engine, dst_name: str) -> None:
        """``migrate_out`` hook (source side, after the destination
        imported): the source dies mid-migration."""
        name = src_engine.name
        if self._fire("te_crash", name, src_engine.steps,
                      "migration") is not None:
            raise TEFailureError(
                f"injected crash of {name} mid-migration to {dst_name}",
                te=name)

    def on_fork(self, source) -> None:
        """``fork_from`` hook: transient ``ForkFault`` or a source crash
        mid-fork (``TEFailureError``)."""
        name = source.name
        if self._fire("fork_fail", name, source.steps) is not None:
            raise ForkFault(f"injected transient fork failure on {name}")
        if self._fire("te_crash", name, source.steps, "fork") is not None:
            raise TEFailureError(
                f"injected crash of fork source {name}", te=name)

    def xfer_hook(self, src_owner: str, dst_owner: str, n_bytes: int) -> None:
        """``DistFlow.transfer(_sharded)`` hook: transient wire failure on
        a migration whose src OR dst matches the spec."""
        for owner in (src_owner, dst_owner):
            if self._fire("xfer_fail", owner, None) is not None:
                raise TransferFault(
                    f"injected transfer failure {src_owner} -> {dst_owner} "
                    f"({n_bytes} bytes)")

    # ------------------------------------------------------------ wiring
    def attach(self, engine) -> None:
        """Wire this plan into one engine (step/migration/fork hooks via
        ``engine.fault_plan``, wire faults via the DistFlow hook)."""
        engine.fault_plan = self
        engine.distflow.fault_hook = self.xfer_hook

    # ------------------------------------------------------------ stats
    def fired(self, kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for f in self.injected
                       if kind is None or f["kind"] == kind)
