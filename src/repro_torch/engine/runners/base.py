"""Runner-family registry of the port (own copy of the JAX package's
``engine/runners/base.py``, DESIGN.md §12). It is a separate registry
object, so registering a family here can never replace an entry of the
JAX package's registry. The paged family registers first, the slot
family last with an always-true predicate (the fallback)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig


@dataclass
class SequenceState:
    seq_id: str
    tokens: List[int]                   # full token ids (prompt + generated)
    n_prompt: int
    n_cached: int = 0                   # tokens with KV/state materialized
    pages: List[int] = field(default_factory=list)
    reused_pages: int = 0               # prefix-cache pages (shared, pinned)
    slot: Optional[int] = None          # SlotRunner slot id
    state: Any = None                   # state-checkpoint key to restore
                                        # when the slot is assigned
    # modality inputs the model reads (host arrays, (1, P, D)): only what
    # the runner passes to the model; the host's own keys live apart
    extra: Dict[str, Any] = field(default_factory=dict)
    # a migrated sequence's KV import still in flight (DistFlow's
    # MigrationHandle), scattered before its first decode step; the
    # reference keeps it in ``extra["_kv_pending"]``
    kv_pending: Any = None


@dataclass(frozen=True)
class RunnerFamily:
    """One registry entry: a predicate over ``ModelConfig``, the runner
    class (the facade over a prefill/decode pair) that executes it, and
    the family's KV data plane: a page pool with the RTC prefix cache
    (``uses_pages``) or dense slot caches with state checkpoints."""
    name: str
    runner_cls: type
    matches: Callable[[ModelConfig], bool]
    uses_pages: bool


_FAMILIES: List[RunnerFamily] = []


def register_family(family: RunnerFamily) -> RunnerFamily:
    """Append a family (order = match priority); a same-named entry is
    replaced in place."""
    for i, f in enumerate(_FAMILIES):
        if f.name == family.name:
            _FAMILIES[i] = family
            return family
    _FAMILIES.append(family)
    return family


def resolve_family(cfg: ModelConfig) -> RunnerFamily:
    """First registered family whose predicate accepts ``cfg``."""
    for fam in _FAMILIES:
        if fam.matches(cfg):
            return fam
    raise LookupError(
        f"no runner family of the port matches model "
        f"{getattr(cfg, 'name', cfg)!r}")
