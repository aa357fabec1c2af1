"""Training loop for fine-tune jobs (the TRAINING job kind of §3), the
counterpart of ``repro/training/train_loop.py``.

train_step = forward (each block recomputed in the backward) -> grads ->
AdamW, optionally over microbatches whose gradients are summed in fp32
and averaged. The forward takes the reference's ``attn_impl="auto"``
(naive attention up to 2048 keys, the plain blockwise flash past them)
and asks for the recurrences in the reference's sequence forms
(``impl="scan"``: the chunked WKV6 of ``models/rwkv6.py::wkv_chunked``,
the associative RG-LRU scan of ``models/rglru.py``) and the plain
blockwise attention, as the reference trains through jnp: the CUDA
kernels have no backward and refuse autograd, so a train step launches
no hand-written kernel.

``make_train_step`` is the eager step; ``train`` runs the same body as a
``TrainProgram``: one device program per batch shape on a card, as the
reference jits its step."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.engine.programs import Program, ProgramCache
from repro_torch.launch.mesh import one_rank
from repro_torch.models.model_factory import ModelBundle, cross_entropy
from repro_torch.training import tree as TR
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            adamw_update_, init_opt_state)


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
                                impl="scan", remat=remat, **extra)
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


def make_grad_fn(bundle: ModelBundle, tcfg: TrainConfig):
    """(loss, grads) of one batch: ``value_and_grad`` of the loss, or,
    over ``tcfg.microbatches`` equal splits of the batch, the grads summed
    in fp32 and averaged with the losses (the reference's ``lax.scan``,
    ``repro/training/train_loop.py:50-60``)."""
    loss_fn = make_loss_fn(bundle, tcfg.remat, tcfg.attn_impl)

    def grad_fn(params, tokens, targets, mask, extra):
        n = tcfg.microbatches
        if n <= 1:
            return value_and_grad(loss_fn, params, tokens, targets, mask,
                                  extra)

        def split(x):
            return x.reshape((n, -1) + tuple(x.shape[1:]))
        mbs = zip(*(split(x) for x in (tokens, targets, mask)),
                  *(split(v) for v in extra.values()))
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in TR.leaves(params)]
        loss = 0.0
        for t, y, m, *ex in mbs:
            lv, g = value_and_grad(loss_fn, params, t, y, m,
                                   dict(zip(extra, ex)))
            for acc, gi in zip(grads, TR.leaves(g)):
                acc.add_(gi)
            loss = loss + lv
        return loss / n, TR.unflatten(params, [g / n for g in grads])

    return grad_fn


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig):
    """The reference's un-jitted train step, eager: (params, opt_state,
    tokens, targets, mask, extra) -> (new params, opt_state, metrics
    {"loss", "grad_norm", "lr"}); the caller's params are not changed.
    ``TrainProgram`` runs the same body as one device program."""
    grad_fn = make_grad_fn(bundle, tcfg)

    def train_step(params, opt_state, tokens, targets, mask, extra):
        loss, grads = grad_fn(params, tokens, targets, mask, extra)
        params, opt_state, metrics = adamw_update(tcfg.opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


BATCH = ("tokens", "targets", "mask")


class TrainProgram:
    """The train step as one device program per batch shape: the port's
    ``jax.jit(make_train_step(bundle, tcfg))``
    (``repro/training/train_loop.py:84``). Its body is
    ``make_train_step``'s, with the update written in place
    (``adamw_update_``) into ``params`` and ``opt_state``: the storage the
    program owns, which never moves. A kind-"train" ``Program`` of
    ``engine/programs.py`` keyed (B, S, microbatches, the modality inputs'
    names and shapes), as the reference's jit retraces on a new shape:
    on a card its first call runs the body eagerly, then captures it as a
    CUDA graph; later calls replay it. On the CPU it runs the body.
    ``params`` and ``opt_state`` lie on one device and must be neither
    freed nor replaced while the program lives.

    A call takes one numpy batch (tokens, targets, mask). On a card each
    array goes through a pinned buffer of its key and is copied in,
    non-blocking; the next call refills the buffers only after that copy
    has ended (an event). It returns {"loss", "grad_norm", "lr"} as 0-d
    tensors, the program's static outputs: read them before the next
    call. The modality inputs are the model's zero stubs
    (``bundle.extra_inputs``) expanded to the batch, as ``train`` feeds
    them. ``release`` drops the programs and their graph pool."""

    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig, params,
                 opt_state):
        self.params, self.opt_state = params, opt_state
        self.tcfg = tcfg
        self.device = opt_state["step"].device
        self.programs = ProgramCache(one_rank(self.device))
        self._bundle = bundle
        # the modality stubs (zeros) in the weights' dtype: torch
        # multiplies no bf16 input into fp32 weights, where jnp promotes
        self._extra = bundle.extra_inputs(1, dtype=params["embed"].dtype,
                                          device=self.device)
        self._pinned: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._uploaded: Optional[torch.cuda.Event] = None

    @property
    def builds(self) -> int:
        """Train programs built (one per batch shape)."""
        return self.programs.train_builds

    def extra(self, batch: int) -> Dict[str, torch.Tensor]:
        """The modality inputs of a batch of ``batch`` rows."""
        return {k: v.expand((batch,) + tuple(v.shape[1:]))
                for k, v in self._extra.items()}

    def _make(self, key: tuple, arrays, extra) -> Program:
        grad_fn = make_grad_fn(self._bundle, self.tcfg)

        def body(tokens, targets, mask, **extra):
            loss, grads = grad_fn(self.params, tokens, targets, mask, extra)
            metrics = adamw_update_(self.tcfg.opt, self.params, grads,
                                    self.opt_state)
            return loss, metrics["grad_norm"], metrics["lr"]

        inputs = {n: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                 device=self.device)
                  for n, a in zip(BATCH, arrays)}
        inputs.update(extra)
        return Program(key, body, inputs, self.programs, kind="train")

    def _staged(self, key: tuple, arrays) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {n: torch.from_numpy(a) for n, a in zip(BATCH, arrays)}
        host = self._pinned.get(key)
        if host is None:
            host = self._pinned[key] = {
                n: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                               pin_memory=True)
                for n, a in zip(BATCH, arrays)}
        if self._uploaded is None:
            self._uploaded = torch.cuda.Event()
        self._uploaded.synchronize()        # the last upload has ended
        for n, a in zip(BATCH, arrays):
            host[n].numpy()[...] = a
        return host

    def __call__(self, tokens, targets, mask) -> Dict[str, torch.Tensor]:
        arrays = (tokens, targets, mask)
        b, s = tokens.shape
        extra = self.extra(b)
        key = (b, s, self.tcfg.microbatches,
               tuple((k, tuple(v.shape)) for k, v in extra.items()))
        prog = self.programs.get(key, lambda: self._make(key, arrays, extra),
                                 kind="train")
        loss, gnorm, lr = prog(**self._staged(key, arrays))
        if self._uploaded is not None:
            self._uploaded.record()
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def capture_stats(self) -> List[Dict[str, Any]]:
        """Each program's key, capture and instantiate ms and node count
        (0 and None where nothing was captured: the CPU)."""
        return [{"key": list(p.key[:3]), "capture_ms": p.capture_ms,
                 "instantiate_ms": p.instantiate_ms, "nodes": p.nodes}
                for p in self.programs.all()]

    def release(self) -> None:
        self.programs.release()
        self._pinned.clear()


def train(bundle: ModelBundle, params, data_iter, tcfg: TrainConfig,
          ckpt: Optional[CheckpointManager] = None,
          resume: bool = False,
          log: Callable[[str], None] = print) -> Tuple[Any, Dict[str, Any]]:
    """Run ``tcfg.steps`` train steps on the batches of ``data_iter``
    ((tokens, targets, mask) numpy arrays), from the latest checkpoint of
    ``ckpt`` when ``resume``; log every ``log_every`` steps, save
    asynchronously every ``ckpt_every`` and blockingly at the end. Every
    step is one call of a ``TrainProgram`` (one device program per batch
    shape on a card). ``params`` itself is not changed: the program
    updates a copy of it made here (or the restored state), on the same
    device and outside any graph pool, and that copy is returned. The
    programs and their pool are dropped before the return. Returns
    (params, {"loss_first", "loss_last", "wall", "losses" (every step's),
    "grad_norms" (the logged steps'), "programs" (train programs built),
    "capture" (``TrainProgram.capture_stats``)})."""
    start_step = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params,
                              "opt": init_opt_state(params)})
        params, opt_state = state["params"], state["opt"]
        start_step = int(opt_state["step"])
        log(f"resumed from step {start_step}")
    else:
        params = TR.unflatten(params, [p.detach().clone()
                                       for p in TR.leaves(params)])
        opt_state = init_opt_state(params)
    program = TrainProgram(bundle, tcfg, params, opt_state)
    history, gnorms = [], []
    t0 = time.monotonic()
    try:
        for step in range(start_step, tcfg.steps):
            metrics = program(*next(data_iter))
            history.append(float(metrics["loss"]))
            if (step + 1) % tcfg.log_every == 0:
                gnorms.append(float(metrics["grad_norm"]))
                log(f"step {step+1}: loss={history[-1]:.4f} "
                    f"gnorm={gnorms[-1]:.3f} "
                    f"lr={float(metrics['lr']):.2e}")
            if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                # the host snapshot is taken before save returns, so the
                # next replay cannot overwrite this step's state under it
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          blocking=False)
        if ckpt is not None:
            ckpt.save(tcfg.steps, {"params": params, "opt": opt_state})
            ckpt.wait()
        stats = {"programs": program.builds,
                 "capture": program.capture_stats()}
    finally:
        program.release()
    stats.update(loss_first=history[0] if history else float("nan"),
                 loss_last=history[-1] if history else float("nan"),
                 wall=time.monotonic() - t0, losses=history,
                 grad_norms=gnorms)
    return params, stats
