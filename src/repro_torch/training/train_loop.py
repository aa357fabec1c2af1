"""Training loop for fine-tune jobs (the TRAINING job kind of §3), the
counterpart of ``repro/training/train_loop.py``.

train_step = forward (each block recomputed in the backward) -> grads ->
AdamW, optionally over microbatches whose gradients are summed in fp32
and averaged. The forward takes the reference's ``attn_impl="auto"``
(naive attention up to 2048 keys, the plain blockwise flash past them)
and asks for the plain versions of the recurrences and of the blockwise
attention by name (``impl="ref"``), as the reference trains through jnp:
the CUDA kernels have no backward and refuse autograd, so a train step
launches no hand-written kernel."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model_factory import ModelBundle, cross_entropy
from repro_torch.training import tree as TR
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            init_opt_state)


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    microbatches: int = 1
    remat: bool = True
    attn_impl: str = "auto"     # "naive" | "flash" | "auto"
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)


def make_loss_fn(bundle: ModelBundle, remat: bool = True,
                 attn_impl: str = "auto"):
    cfg = bundle.cfg

    def loss_fn(params, tokens, targets, mask, extra):
        logits = bundle.forward(cfg, params, tokens, attn_impl=attn_impl,
                                impl="ref", remat=remat, **extra)
        return cross_entropy(logits, targets, mask, cfg.vocab_size)

    return loss_fn


def value_and_grad(loss_fn, params, *args):
    """(loss, grads): ``torch.autograd.grad`` of ``loss_fn(params, *args)``
    over every param leaf, the grads a tree like ``params`` (a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives). The params
    themselves are not marked: the loss runs on detached views of them."""
    flat = [p.detach().requires_grad_() for p in TR.leaves(params)]
    loss = loss_fn(TR.unflatten(params, flat), *args)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), TR.unflatten(params, grads)


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig):
    loss_fn = make_loss_fn(bundle, tcfg.remat, tcfg.attn_impl)

    def train_step(params, opt_state, tokens, targets, mask, extra):
        n = tcfg.microbatches
        if n > 1:
            def split(x):
                return x.reshape((n, -1) + tuple(x.shape[1:]))
            mbs = zip(*(split(x) for x in (tokens, targets, mask)),
                      *(split(v) for v in extra.values()))
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in TR.leaves(params)]
            loss = 0.0
            for t, y, m, *ex in mbs:
                lv, g = value_and_grad(loss_fn, params, t, y, m,
                                       dict(zip(extra, ex)))
                for acc, gi in zip(grads, TR.leaves(g)):
                    acc.add_(gi)
                loss = loss + lv
            grads = TR.unflatten(params, [g / n for g in grads])
            loss = loss / n
        else:
            loss, grads = value_and_grad(loss_fn, params, tokens, targets,
                                         mask, extra)
        params, opt_state, metrics = adamw_update(tcfg.opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train(bundle: ModelBundle, params, data_iter, tcfg: TrainConfig,
          ckpt: Optional[CheckpointManager] = None,
          resume: bool = False,
          log: Callable[[str], None] = print) -> Tuple[Any, Dict[str, float]]:
    """Run ``tcfg.steps`` train steps on the batches of ``data_iter``
    ((tokens, targets, mask) numpy arrays), from the latest checkpoint of
    ``ckpt`` when ``resume``; log every ``log_every`` steps, save
    asynchronously every ``ckpt_every`` and blockingly at the end. The
    params stay on their device; ``params`` itself is not changed.
    Returns (params, {"loss_first", "loss_last", "wall"})."""
    opt_state = init_opt_state(params)
    start_step = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = int(opt_state["step"])
        log(f"resumed from step {start_step}")
    step_fn = make_train_step(bundle, tcfg)
    dev = opt_state["step"].device
    # the modality stubs (zeros) in the weights' dtype: torch multiplies
    # no bf16 input into fp32 weights, where jnp promotes
    extra = bundle.extra_inputs(1, dtype=params["embed"].dtype, device=dev)
    history = []
    t0 = time.monotonic()
    for step in range(start_step, tcfg.steps):
        tokens, targets, mask = (torch.from_numpy(a).to(dev)
                                 for a in next(data_iter))
        ex = {k: v.expand((tokens.shape[0],) + tuple(v.shape[1:]))
              for k, v in extra.items()}
        params, opt_state, metrics = step_fn(params, opt_state, tokens,
                                             targets, mask, ex)
        history.append(float(metrics["loss"]))
        if (step + 1) % tcfg.log_every == 0:
            log(f"step {step+1}: loss={history[-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e}")
        if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      blocking=False)
    if ckpt is not None:
        ckpt.save(tcfg.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    return params, {"loss_first": history[0] if history else float("nan"),
                    "loss_last": history[-1] if history else float("nan"),
                    "wall": time.monotonic() - t0}
