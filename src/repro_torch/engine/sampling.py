"""Sampling for the port's model generator: greedy / temperature / top-p
(torch port of ``repro/engine/sampling.py``). Plain torch ops with an
explicit ``torch.Generator``: sampling is not a Pallas kernel in the
reference, so no kernel is owed here.

Greedy rows match the reference bit for bit (pad-masked argmax); stochastic
rows draw from the same distribution with the generator's bits, not JAX's
threefry bits, so they are checked for validity, not equality."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 => greedy
    top_p: float = 1.0
    max_new_tokens: int = 64
    stop_on_eos: bool = True


def _masked(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    logits = logits.float()
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG)
    return logits


def greedy_core(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, Vp) logits -> (B,) int32 pad-masked argmax (the all-greedy
    shortcut; row-for-row equal to ``sample_core`` at temperature <= 0)."""
    return _masked(logits, vocab_size).argmax(-1).to(torch.int32)


def sample_core(logits: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, gen: torch.Generator,
                vocab_size: int) -> torch.Tensor:
    """Per-row sampling: (B, Vp) logits + per-row temperature/top_p (B,)
    -> (B,) int32. Sort, top-p cutoff and a categorical draw (Gumbel-max
    over ``gen``'s uniforms); rows with temperature <= 0 are greedy. No
    host sync."""
    logits = _masked(logits, vocab_size)
    greedy = logits.argmax(-1)
    t = temperature.float().clamp_min(1e-6)[:, None]
    scaled = logits / t
    sorted_logits = scaled.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    cut_idx = (cum < top_p.float()[:, None]).sum(-1, keepdim=True)
    cutoff = sorted_logits.gather(-1, cut_idx.clamp_max(logits.shape[-1] - 1))
    limited = scaled.masked_fill(scaled < cutoff, NEG)
    final = torch.where((top_p < 1.0)[:, None], limited, scaled)
    u = torch.rand(final.shape, generator=gen, device=final.device)
    drawn = (final - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


def sample_batch(logits: torch.Tensor, temperature, top_p,
                 gen: torch.Generator, vocab_size: int) -> torch.Tensor:
    """logits (B, Vp) with per-row host params -> (B,) int32. An
    all-greedy batch (decided on the host) skips the sort pipeline."""
    temperature = np.asarray(temperature, np.float32)
    if temperature.size == 0 or float(temperature.max()) <= 0.0:
        return greedy_core(logits, vocab_size)
    dev = logits.device
    return sample_core(logits, torch.from_numpy(temperature).to(dev),
                       torch.as_tensor(np.asarray(top_p, np.float32),
                                       device=dev), gen, vocab_size)
