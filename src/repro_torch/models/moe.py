"""Mixture-of-Experts FFN of the port (Mixtral / Granite style top-k
routing), the counterpart of ``repro/models/moe.py``.

The same formulation as the reference: capacity-bounded gather -> expert
FFN as batched products -> weighted scatter-add. Tokens are cut into
``groups`` and each (group, expert) keeps at most ``moe_capacity`` tokens,
its top ones by combine weight (the GShard policy); a token beyond an
expert's capacity is dropped for that expert and counts only through its
other choices. The JAX package runs this with einsums outside any Pallas
kernel, so no kernel is owed here.

Every size comes from shapes as Python ints: no ``nonzero``, no boolean
mask indexing and no ``.item()``, so a decode horizon that runs an MoE
layer never synchronizes with the host."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def init_moe(gen: torch.Generator, d: int, cfg: MoEConfig, act: str,
             dtype: torch.dtype, dev) -> dict:
    """Router (d, E) in fp32, experts (E, d, f) / (E, f, d) in ``dtype``,
    with the reference's scales (``moe.py:24-34``)."""
    e, f = cfg.n_experts, cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, std, dt):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    p = {"router": normal((d, e), s_in, torch.float32),
         "w_up": normal((e, d, f), s_in, dtype),
         "w_down": normal((e, f, d), s_out, dtype)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal((e, d, f), s_in, dtype)
    return p


def moe_capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Tokens one expert keeps per group: its share at the capacity factor,
    rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def moe_route(p: dict, xt: torch.Tensor, cfg: MoEConfig, cap: int):
    """Routing of grouped tokens xt (G, Tg, D): the per-(token, expert)
    combine weights w_te (G, Tg, E) fp32, and each expert's kept slots:
    scores (G, E, cap), token indices (G, E, cap) and keep = score > 0."""
    e, k = cfg.n_experts, cfg.top_k
    # the router product in x's dtype; top-k and softmax in fp32
    logits = torch.einsum("gtd,de->gte", xt,
                          p["router"].to(xt.dtype)).float()
    top_logits, top_idx = torch.topk(logits, k, dim=-1)          # (G,Tg,k)
    top_w = torch.softmax(top_logits, dim=-1)
    # the k experts of a token differ, so a scatter is the one-hot sum
    w_te = torch.zeros(logits.shape[:2] + (e,), dtype=torch.float32,
                       device=xt.device).scatter_(-1, top_idx, top_w)
    # capacity: each expert keeps its top-`cap` tokens by weight
    sel_scores, sel_tok = torch.topk(w_te.transpose(1, 2), cap, dim=-1)
    return w_te, sel_scores, sel_tok, sel_scores > 0.0


def moe_apply(ps: list, x: torch.Tensor, cfg: MoEConfig, act: str, mesh,
              groups: int = 1) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), step by step as ``moe.py:46-95``, over
    the ranks' MoE params ``ps`` (one tree on one rank: ``[p]`` and
    ``launch.mesh.one_rank``). The router is replicated, so routing runs
    once, on rank 0, and every rank would drop the same assignments. Each
    rank runs its ``d_expert`` slice of every expert (``w_gate``/``w_up``
    split on their last dimension, ``w_down`` on the one before it) and
    the down projection's partials are all-reduced before the combine
    weights and the scatter-add."""
    b, s, d = x.shape
    t = b * s
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} groups")
    tg = t // groups
    e = cfg.n_experts
    cap = min(moe_capacity(tg, cfg), tg)
    _, sel_scores, sel_tok, keep = moe_route(
        ps[0], x.reshape(groups, tg, d), cfg, cap)               # (G,E,cap)
    # flat token index of each (group, expert, slot)
    flat = (sel_tok + tg * torch.arange(groups, device=x.device)[:, None,
                                                                 None])
    flat = flat.reshape(-1)
    xg = x.reshape(t, d).index_select(0, flat).view(groups, e, cap, d)
    xg = xg * keep[..., None].to(xg.dtype)
    width = ps[0]["w_up"].shape[-1]
    y = mesh.all_reduce([_experts(p, xr, act) for p, xr in
                         zip(ps[:cfg.d_expert // width], mesh.broadcast(xg))])
    y = y * (sel_scores * keep)[..., None].to(y.dtype)
    # an accumulating index_put_ sums each token's rows in flat order (a
    # sort, then one pass per token, in fp32 on the card), the same every
    # run; index_add_'s float atomics add them in another order from run
    # to run, so the same bf16 inputs could give other tokens
    out = torch.zeros((t, d), dtype=y.dtype, device=x.device)
    out.index_put_((flat,), y.reshape(-1, d), accumulate=True)
    return out.view(b, s, d)


def _experts(p: dict, xg: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFN of one rank's params over the gathered slots xg
    (G, E, cap, D) -> (G, E, cap, D): that rank's partial sum when it
    holds a ``d_expert`` slice."""
    up = torch.einsum("gecd,edf->gecf", xg, p["w_up"])
    if act in ("swiglu", "geglu"):
        gate = torch.einsum("gecd,edf->gecf", xg, p["w_gate"])
        g = F.silu(gate) if act == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = g * up
    elif act == "sqrelu":
        h = torch.relu(up).square()
    else:
        raise ValueError(act)
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def moe_aux_loss(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss of the router ``p`` over
    x (B, S, D), in fp32 (``repro/models/moe.py::moe_aux_loss``): the
    number of experts times the sum over experts of (share of top-k
    assignments) x (mean router probability). Neither train loop calls
    it."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
    frac_routed = F.one_hot(top_idx, cfg.n_experts).float().mean(
        dim=(0, 1, 2))
    frac_prob = probs.mean(dim=(0, 1))
    return cfg.n_experts * (frac_routed * frac_prob).sum()
