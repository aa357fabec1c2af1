"""Runner families of the port. Importing this package registers the
paged family (the only one ported so far)."""
from repro_torch.engine.runners.base import (  # noqa: F401
    RunnerFamily, SequenceState, register_family, resolve_family,
)
from repro_torch.engine.runners.paged import PagedRunner

register_family(RunnerFamily(
    name="paged", runner_cls=PagedRunner,
    matches=lambda cfg: cfg.attn_kind in ("global", "swa", "local_global")))
