"""RWKV-6 "Finch" of the port: attention-free time mix with data-dependent
decay (the counterpart of ``repro/models/rwkv6.py``).

Recurrence (per head, state S in R^{hd x hd}):
    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel decay w_t = exp(-exp(w_hat_t)) computed from the input.

``rwkv_time_mix`` runs the recurrence through ``ops.wkv6`` with the carried
state, in prefill and in decode, once per rank of the TE's mesh at that
rank's heads: the WKV6 kernel on a CUDA tensor, the sequential plain
version on a CPU tensor. ``wkv_sequential`` and ``wkv_chunked`` are the
reference's two plain formulations; the train step runs ``wkv_chunked``
(``impl="scan"``), as the reference's train step does."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.launch.mesh import split_ranks
from repro_torch.models import layers as L

# Clamp on the per-token log-decay inside the chunked form's within-chunk
# products, so its exp(-cumsum) factors stay in fp32 range (lossless at
# chunk sizes <= 64; the reference's value).
LOG_DECAY_CLAMP = -30.0
LORA_RANK = 32


def wkv_sequential(r, k, v, w, u, state=None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); state (B, H, hd, hd) or None.
    Returns (y, final_state); the per-token recurrence."""
    return wkv6_ref(r, k, v, w, u, state)


def wkv_chunked(r, k, v, w, u, state=None, chunk: int = 64):
    """Chunk-parallel WKV6 (the reference's formulation of its train step
    and prefill): within a chunk the pairwise term is a masked product in
    log-decay space, across chunks the state carries. Same signature and
    result as ``wkv_sequential``. Differentiable; ``state`` is read
    through a copy and the final state is a new tensor, so ``ops.wkv6``
    may write it over ``state`` while autograd (or a recomputed block)
    still needs the initial one."""
    b, t, h, hd = r.shape
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state.to(torch.float32, copy=True)
    pad = (-t) % chunk
    if pad:
        def z(x, value=0.0):
            return F.pad(x, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    n = (t + pad) // chunk

    def chunks(x):                                 # (n, B, H, C, hd)
        return x.reshape(b, n, chunk, h, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = (chunks(x) for x in (r, k, v, w))
    u32 = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    ys = []
    for c in range(n):
        rb, kb, vb, wb = rc[c], kc[c], vc[c], wc[c]
        lw = torch.log(wb.clamp_min(1e-38)).clamp(LOG_DECAY_CLAMP, 0.0)
        cum = lw.cumsum(2)
        dec_in = torch.exp(cum - lw)
        y_state = torch.einsum("bhck,bhkv->bhcv", rb * dec_in, s)
        q_side = rb * torch.exp(cum - lw)
        k_side = kb * torch.exp(-cum)
        scores = torch.einsum("bhck,bhdk->bhcd", q_side, k_side)
        scores = torch.where(mask, scores, torch.zeros_like(scores))
        bonus = torch.einsum("bhck,bhck->bhc", rb * u32[None, :, None, :], kb)
        ys.append(y_state + torch.einsum("bhcd,bhdv->bhcv", scores, vb)
                  + bonus[..., None] * vb)
        total = cum[:, :, -1:, :]
        k_dec = kb * torch.exp(total - cum)
        s = torch.exp(total[:, :, 0, :])[..., None] * s + torch.einsum(
            "bhck,bhcv->bhkv", k_dec, vb)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, hd)
    return y[:, :t].to(r.dtype), s


# ---------------------------------------------------------------------------
# Full RWKV6 block (time mix + channel mix): parameters and application
# ---------------------------------------------------------------------------


def init_rwkv_block(gen: torch.Generator, d: int, f: int, head_dim: int,
                    dtype: torch.dtype, device) -> dict:
    """One block's weights with the reference's distributions
    (``rwkv6.py:107-133``); the lerp bases, decay base, bonus u and the
    group-norm scale stay fp32 as there."""
    h = d // head_dim
    s = 1.0 / math.sqrt(d)
    lr = LORA_RANK

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "mix_base": full((5, d), 0.5),
        "mix_lora_a": normal((d, lr), s),
        "mix_lora_b": normal((5, lr, d), 0.01),
        "wr": normal((d, d), s),
        "wk": normal((d, d), s),
        "wv": normal((d, d), s),
        "wg": normal((d, d), s),
        "wo": normal((d, d), s),
        "decay_base": full((d,), -4.0),
        "decay_lora_a": normal((d, lr), s),
        "decay_lora_b": normal((lr, d), 0.01),
        "bonus_u": full((h, head_dim), 0.0),
        "ln_x": full((d,), 1.0),
        "cm_mix": full((2, d), 0.5),
        "cm_k": normal((d, f), s),
        "cm_v": normal((f, d), 1.0 / math.sqrt(f)),
        "cm_r": normal((d, d), s),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes ``last`` (carried across
    calls)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _last_valid(x: torch.Tensor, n_valid) -> torch.Tensor:
    """x[:, n_valid-1, :]: the carried last-token input comes from the last
    REAL position, not a pad (``n_valid`` an int or a 0-d device
    tensor)."""
    return x[:, -1, :] if n_valid is None else \
        L.take_run(x, n_valid - 1, 1)[:, 0, :]


def rwkv_time_mix(ps: list, x: torch.Tensor, head_dim: int, states: list,
                  last_x: torch.Tensor, mesh,
                  n_valid=None, impl: str = "auto"):
    """The time mix over the ranks of ``mesh``. ``ps``: the ranks' time-mix
    trees; x: (B, T, D) on rank 0; ``states``: the ranks' (B, H_r, hd, hd)
    fp32 states (one tensor the ranks share when the heads replicate),
    each advanced IN PLACE through ``ops.wkv6`` on its rank; last_x:
    (B, D) the previous call's last input. Returns (y, states,
    new_last_x).

    Each rank holding a part of the state runs its heads: r, k, v and the
    gate come from the ranks' column shards of ``wr``/``wk``/``wv``/``wg``
    (a replicated one computed on rank 0 and cut), the replicated decay
    LoRA, ``bonus_u`` and ``ln_x`` are read at the rank's heads, and
    ``wo``'s row partials are all-reduced. Over one rank this is the
    one-tree arithmetic, bit for bit.

    ``n_valid`` (an int, or a 0-d device tensor that is never read on the
    host) marks positions >= n_valid as padding (the bucketed-prefill
    contract): their recurrence steps become exact identities (w -> 1,
    k -> 0) and new_last_x is taken at n_valid-1."""
    b, t, d = x.shape
    p0 = ps[0]
    delta = (_token_shift(x, last_x) - x).float()
    # data-dependent lerp (ddlerp): mix_i = base_i + lora(x)_i, each mixed
    # input made as its projection needs it and dropped after (an fp32
    # copy of x each: 4.3 GB at 524,288 tokens of rwkv6-1.6b)
    lora = torch.einsum("btr,mrd->mbtd",
                        torch.tanh((x @ p0["mix_lora_a"]).float()).to(x.dtype),
                        p0["mix_lora_b"])

    def mixed(i):
        return x.float() + delta * (p0["mix_base"][i] + lora[i].float())
    hr = states[0].shape[1]                 # heads of a state part
    parts = split_ranks(states, d // head_dim, hr)
    cols = hr * head_dim

    def proj(a, wname):
        """a @ w as the state parts' column slices, on their ranks."""
        out = [ar @ p[wname] for p, ar in zip(
            split_ranks(ps, d, p0[wname].shape[-1]),
            mesh.broadcast(a.to(x.dtype)))]
        return mesh.regroup(out, d // cols, -1, d)

    rs, ks, vs = (proj(mixed(i), n) for i, n in ((0, "wr"), (1, "wk"),
                                                 (2, "wv")))
    gs = [F.silu(g) for g in proj(mixed(4), "wg")]
    dls = mesh.broadcast(mixed(3).to(x.dtype) @ p0["decay_lora_a"])
    del lora, delta
    valid = L.valid_steps(t, n_valid, x.device)
    if valid is not None:
        valid = valid[None, :, None, None]
    ys = []
    for r, (p, state, dl, rr, kk, vv, g) in enumerate(
            zip(ps, parts, dls, rs, ks, vs, gs)):
        c = slice(r * cols, (r + 1) * cols)
        dec = p["decay_base"][c] + (dl @ p["decay_lora_b"][:, c]).float()
        w = torch.exp(-torch.exp(dec)).reshape(b, t, hr, head_dim)
        rr, kk, vv = (z.reshape(b, t, hr, head_dim) for z in (rr, kk, vv))
        if valid is not None:
            vr = valid.to(w.device)
            w = torch.where(vr, w, torch.ones_like(w))
            kk = torch.where(vr, kk, torch.zeros_like(kk))
        # the reference's cast of w to r's dtype: in bf16 that rounding is
        # part of the result
        y, _ = ops.wkv6(rr.contiguous(), kk.contiguous(), vv.contiguous(),
                        w.to(rr.dtype).contiguous(),
                        p["bonus_u"][r * hr:(r + 1) * hr], state, impl=impl)
        # per-head group norm, then the gate
        y32 = y.float()
        mu = y32.mean(-1, keepdim=True)
        var = (y32 - mu).square().mean(-1, keepdim=True)
        y32 = (y32 - mu) * torch.rsqrt(var + 1e-5)
        ys.append((y32.reshape(b, t, cols) * p["ln_x"][c]).to(x.dtype) * g)
    wo = split_ranks(ps, d, p0["wo"].shape[-2])
    out = mesh.all_reduce([y @ p["wo"] for p, y in zip(
        wo, mesh.regroup(ys, d // p0["wo"].shape[-2], -1, d))],
        d // p0["wo"].shape[-2])
    return out, states, _last_valid(x, n_valid)


def rwkv_channel_mix(ps: list, x: torch.Tensor, last_x: torch.Tensor,
                     mesh, d_ff: int, n_valid=None):
    """Squared-relu channel mix with token shift over the ranks of
    ``mesh``: ``cm_k`` split on its ``d_ff`` columns and ``cm_v`` on its
    rows (partials all-reduced), ``cm_r`` on its ``d_model`` output (the
    gate's slices gathered before it multiplies). Returns (y,
    new_last_x)."""
    d = x.shape[-1]
    p0 = ps[0]
    xs = _token_shift(x, last_x)
    delta = (xs - x).float()
    xk = (x.float() + delta * p0["cm_mix"][0]).to(x.dtype)
    xr = (x.float() + delta * p0["cm_mix"][1]).to(x.dtype)
    kv = mesh.all_reduce([
        torch.relu(a @ p["cm_k"]).square() @ p["cm_v"] for p, a in zip(
            split_ranks(ps, d_ff, p0["cm_k"].shape[-1]),
            mesh.broadcast(xk))], d_ff // p0["cm_k"].shape[-1])
    rr = mesh.all_gather([
        torch.sigmoid((a @ p["cm_r"]).float()).to(x.dtype) for p, a in zip(
            split_ranks(ps, d, p0["cm_r"].shape[-1]), mesh.broadcast(xr))],
        -1, d)
    return rr * kv, _last_valid(x, n_valid)
