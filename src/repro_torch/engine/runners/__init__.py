"""Runner families of the port. Importing this package registers them in
match order: ``paged`` (attention-only towers without modality memory:
paged KV, ragged prefill, fused decode horizons), then ``slot`` (recurrent,
hybrid and cross-attention towers: dense per-slot caches), registered last
with an always-true predicate as the JAX package registers it."""
from repro_torch.engine.runners.base import (  # noqa: F401
    RunnerFamily, SequenceState, register_family, resolve_family,
)
from repro_torch.engine.runners.paged import PagedRunner
from repro_torch.engine.runners.slot import SlotRunner


def _paged_matches(cfg) -> bool:
    return (cfg.attn_kind in ("global", "swa", "local_global")
            and cfg.vision is None and cfg.encoder is None)


register_family(RunnerFamily(
    name="paged", runner_cls=PagedRunner, matches=_paged_matches,
    uses_pages=True))

register_family(RunnerFamily(
    name="slot", runner_cls=SlotRunner, matches=lambda cfg: True,
    uses_pages=False))
