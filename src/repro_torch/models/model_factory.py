"""Bundle a ModelConfig into the callables the launchers, the train loop
and the tests use (the counterpart of ``repro/models/model_factory.py``).
The serving entry points are ``models/serving.py``'s own; the bundle's
``decode_step`` refuses a full linear cache first (``serving.check_room``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.launch.mesh import one_rank
from repro_torch.models import serving as S
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init_params: Callable[..., Dict[str, Any]]
    forward: Callable[..., torch.Tensor]       # teacher-forced logits
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]

    def loss_fn(self, params, tokens, targets, mask, **extra):
        """Mean next-token cross-entropy over ``mask``-ed positions (the
        forward's default route: the kernels on the card, so call it
        without autograd there; the train loop's loss asks for the plain
        versions)."""
        logits = self.forward(self.cfg, params, tokens, **extra)
        return cross_entropy(logits, targets, mask, self.cfg.vocab_size)

    def extra_inputs(self, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
        """Modality-stub inputs (zeros) for the VLM and enc-dec towers."""
        return S.extra_inputs(self.cfg, batch, dtype, resolve_device(device))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """logits (B, S, Vp) -> the mean NLL of ``targets`` over ``mask``
    (its sum floored at 1), in fp32; the padded-vocab columns are set to
    -1e30, so they take no probability."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


def decode_step(cfg: ModelConfig, ps: list, token: torch.Tensor,
                caches: list, mesh, impl: str = "auto"):
    """``serving.decode_step`` after ``serving.check_room``."""
    S.check_room(cfg, caches)
    return S.decode_step(cfg, ps, token, caches, mesh, impl)


def get_model(name_or_cfg, smoke: bool = False) -> ModelBundle:
    cfg = name_or_cfg if isinstance(name_or_cfg, ModelConfig) \
        else get_config(name_or_cfg)
    if smoke:
        cfg = smoke_config(cfg)
    return ModelBundle(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cuda":
            T.init_params(cfg, gen, dtype, device),
        forward=T.forward,
        init_cache=lambda batch, max_len, dtype=torch.bfloat16,
            device="cuda", ring=False: S.init_cache(
                cfg, batch, max_len, dtype, one_rank(resolve_device(device)),
                ring=ring),
        prefill=S.prefill,
        decode_step=decode_step,
    )
