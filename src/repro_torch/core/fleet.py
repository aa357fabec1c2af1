"""Elastic fleet runtime (torch port of ``repro/core/fleet.py``,
DESIGN.md §9): the TE lifecycle and the per-unit executors.

* **TE lifecycle** — every fleet member walks ``PROVISIONING -> WARMING ->
  SERVING <-> DRAINING -> RELEASED``; ``advance`` validates each move and
  anything else raises ``LifecycleError``. Only SERVING TEs admit new
  placements; a DRAINING TE finishes or migrates out what it holds.
* **FleetExecutor** — one pinned worker thread per fleet unit (a PD group
  or a colocated TE, up to a thread budget), so units step concurrently.
  The JE submits one step per unit and collects results in finish order
  from one queue; cross-unit actions stay on the JE thread. PyTorch drops
  the GIL around each op it dispatches, so units may overlap their host
  enqueue, but every op's return then takes the GIL back from the other
  units' Python. Every unit enqueues on the device's default stream (a
  worker never sets a stream of its own).
"""
from __future__ import annotations

import enum
import queue
import threading
from typing import Any, Callable, Dict, List, Tuple


class TEState(str, enum.Enum):
    PROVISIONING = "provisioning"   # devices allocated, engine building
    WARMING = "warming"             # weights resident, warmup running
    SERVING = "serving"             # admitting + executing
    DRAINING = "draining"           # admissions stopped; emptying
    FAILED = "failed"               # crashed; quarantined, work recovering
    RELEASED = "released"           # device window freed; terminal


class LifecycleError(RuntimeError):
    """Raised on an illegal TE state transition."""


_LEGAL: Dict[TEState, Tuple[TEState, ...]] = {
    TEState.PROVISIONING: (TEState.WARMING, TEState.RELEASED),
    TEState.WARMING: (TEState.SERVING, TEState.FAILED),
    TEState.SERVING: (TEState.DRAINING, TEState.FAILED),
    TEState.DRAINING: (TEState.SERVING, TEState.RELEASED, TEState.FAILED),
    # FAILED -> WARMING is reboot in place; FAILED -> RELEASED is replace
    TEState.FAILED: (TEState.WARMING, TEState.RELEASED),
    TEState.RELEASED: (),
}


def advance(current: TEState, new: TEState) -> TEState:
    """Validate one lifecycle transition; returns ``new`` or raises."""
    if new not in _LEGAL[current]:
        raise LifecycleError(f"illegal TE transition {current.value} -> "
                             f"{new.value} (legal: "
                             f"{[s.value for s in _LEGAL[current]] or 'none'})")
    return new


_STOP = object()


class _Worker:
    """One daemon thread draining its own inbox into the shared results
    queue. Units are PINNED to workers, so one unit's events always run in
    order on one thread (an engine keeps its thread)."""

    def __init__(self, name: str, results: "queue.SimpleQueue"):
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._results = results
        self.thread = threading.Thread(target=self._run, name=name,
                                       daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.inbox.get()
            if item is _STOP:
                return
            tag, fn = item
            # the job's closure holds its unit's engines: drop it before
            # blocking on the inbox, or a dead unit's pool outlives it
            del item
            try:
                result, exc = fn(), None
            except BaseException as e:  # surfaced by collect()
                result, exc = None, e
            del fn
            self._results.put((tag, result, exc))
            del result, exc


class FleetExecutor:
    """Submit/collect executor over at most ``n_threads`` pinned workers.

    ``submit(unit_id, fn)`` enqueues ``fn`` on the worker the unit is
    pinned to (units are assigned round-robin on first submit, so a fleet
    larger than the thread budget shares workers without losing per-unit
    order). ``collect(n)`` pops ``n`` completion events in FINISH order;
    there is no barrier between units inside the executor."""

    def __init__(self, n_threads: int):
        if n_threads < 1:
            raise ValueError(f"n_threads must be >= 1, got {n_threads}")
        self.n_threads = n_threads
        self._results: queue.SimpleQueue = queue.SimpleQueue()
        self._workers: List[_Worker] = []
        self._pin: Dict[Any, _Worker] = {}
        self._closed = False

    def _worker_for(self, unit_id: Any) -> _Worker:
        w = self._pin.get(unit_id)
        if w is None:
            if len(self._workers) < self.n_threads:
                w = _Worker(f"fleet-worker-{len(self._workers)}",
                            self._results)
                self._workers.append(w)
            else:
                w = self._workers[len(self._pin) % self.n_threads]
            self._pin[unit_id] = w
        return w

    def submit(self, unit_id: Any, fn: Callable[[], Any]) -> None:
        if self._closed:
            raise RuntimeError("executor closed")
        self._worker_for(unit_id).inbox.put((unit_id, fn))

    def collect(self, n: int) -> Tuple[List[Tuple[Any, Any]],
                                       List[Tuple[Any, BaseException]]]:
        """Block until ``n`` events complete; returns ``(done, failed)``:
        ``done`` is [(unit_id, result)] for units that finished and
        ``failed`` [(unit_id, exc)] for units whose fn raised. A failing
        unit is QUARANTINED by the caller: its failure never aborts the
        other units' step, and collect itself never raises. All ``n``
        events are always drained so none is left orphaned."""
        done: List[Tuple[Any, Any]] = []
        failed: List[Tuple[Any, BaseException]] = []
        for _ in range(n):
            tag, result, exc = self._results.get()
            if exc is not None:
                failed.append((tag, exc))
            else:
                done.append((tag, result))
        return done, failed

    def close(self) -> None:
        self._closed = True
        for w in self._workers:
            w.inbox.put(_STOP)
        for w in self._workers:
            w.thread.join(timeout=5.0)
