"""AdamW with global-norm clipping and a warmup-then-cosine schedule, as
plain functions on the port's weights trees (the counterpart of
``repro/training/optimizer.py``; no ``torch.optim``).

The state holds fp32 moments ``m`` and ``v`` shaped like the params and
``step``, a 0-d int32 tensor on the params' device. The update runs in
fp32 and casts each param back to its dtype (bf16 weights keep fp32
moments, as in the reference; ``torch.optim.AdamW`` would keep bf16
moments for bf16 params). Every quantity stays a tensor on the device:
an update makes no host sync."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.training import tree as TR


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> Dict[str, Any]:
    flat = TR.leaves(params)

    def zeros():
        return TR.unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in flat])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup to
    ``cfg.lr``, then a cosine down to ``min_lr_frac`` of it."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + 0.5 * (1 - cfg.min_lr_frac) * cfg.lr \
        * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of each leaf's sum of
    squares, in fp32."""
    return torch.sqrt(sum(leaf.float().square().sum()
                          for leaf in TR.leaves(tree)))


def adamw_update(cfg: OptimizerConfig, params, grads, opt_state):
    """One AdamW step. Returns (new_params, new_opt_state, metrics
    {"grad_norm", "lr"}). The params come back as new tensors in their own
    dtypes, as the reference returns them; the moments ``m`` and ``v`` are
    the optimizer's own and are updated IN PLACE (the new state holds the
    same tensors), so a step holds no second copy of them."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        # the reference's expression, operation by operation (no fused
        # multiply-add), so the CPU update equals it
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    new = [upd(p, g, m, v) for p, g, m, v in zip(
        TR.leaves(params), TR.leaves(grads), TR.leaves(opt_state["m"]),
        TR.leaves(opt_state["v"]))]
    return TR.unflatten(params, new), \
        {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
