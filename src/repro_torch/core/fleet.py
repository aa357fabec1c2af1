"""TE lifecycle of the fleet (torch port of the state machine in
``repro/core/fleet.py``, DESIGN.md §9).

Every fleet member walks ``PROVISIONING -> WARMING -> SERVING <-> DRAINING
-> RELEASED``; ``advance`` validates each move and anything else raises
``LifecycleError``. Only SERVING TEs admit new placements; a DRAINING TE
finishes or migrates out what it holds. The per-TE executors
(``FleetExecutor``) come with the fleet slice.
"""
from __future__ import annotations

import enum
from typing import Dict, Tuple


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
