"""Neural-net building blocks of the port, plain PyTorch (the counterpart
of ``repro/models/layers.py``). Layouts follow the JAX
package at every public function: activations (B, S, H, hd), weights
(d_in, d_out) applied as ``x @ w``. Norm and softmax math is fp32."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30
POS_PAD = 2 ** 30           # position of a pad key (the reference's sentinel)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the gemma-style ``(1 + w)`` form (zero-init identity)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd % 2:
        out = torch.cat([out, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """Boolean (..., Sq, Sk): True = attend; a window keeps k_pos in
    (q_pos - window, q_pos]."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _scores(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor],
            cap: Optional[float]) -> torch.Tensor:
    """fp32 scores (B, Hkv, G, Sq, Sk) of grouped-query attention, softcapped
    and masked."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(hd)
    s = softcap(s, cap)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
    return s


def _weigh(s: torch.Tensor, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pr = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v)
    return o.reshape(q.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], cap: Optional[float] = None
              ) -> torch.Tensor:
    """Naive grouped-query attention with materialised scores (the plain
    path the teacher-forced forward uses). q: (B,Sq,H,hd); k,v:
    (B,Sk,Hkv,hd); mask (B,Sq,Sk) or None."""
    return _weigh(_scores(q, k, mask, cap), v, q)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], cap: Optional[float] = None):
    """``attention`` over one slice of the keys, with each query row's
    log-sum-exp of its scores (B, Sq, H): what a log-sum-exp merge of the
    slices' outputs needs. The output is ``attention``'s, bit for bit."""
    s = _scores(q, k, mask, cap)
    b, sq, h, _ = q.shape
    lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(b, sq, h)
    return _weigh(s, v, q), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    window: Optional[int] = None,
                    cap: Optional[float] = None, chunk: int = 1024,
                    causal: bool = True) -> torch.Tensor:
    """Memory-efficient attention (``layers.py:125-178``): a running
    (max, sum, acc) triple in fp32 over key chunks of ``chunk``, so the
    (Sq, Sk) score matrix is never materialised; keys padded to whole
    chunks sit at position ``POS_PAD``. Positions give absolute token
    indices (causal, window); a non-causal call attends to every real
    key. Plain PyTorch, differentiable under autograd. q: (B,Sq,H,hd);
    k,v: (B,Sk,Hkv,hd); positions (B,Sq) / (B,Sk)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    n_chunks = max(1, -(-sk // chunk))
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=POS_PAD)
    qf = q.reshape(b, sq, hkv, n_rep, hd).float()         # grouped-query
    m = torch.full((b, hkv, n_rep, sq), -math.inf, device=q.device)
    den = torch.zeros((b, hkv, n_rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, n_rep, sq, hd), device=q.device)
    for c in range(n_chunks):
        cols = slice(c * chunk, (c + 1) * chunk)
        kb, vb, pb = k[:, cols], v[:, cols], k_positions[:, cols]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float()) * scale
        s = softcap(s, cap)
        if causal:
            msk = causal_mask(q_positions, pb, window)      # (B, Sq, C)
        else:
            msk = (pb < POS_PAD)[:, None, :]
        s = torch.where(msk[:, None, None], s, torch.full_like(s, NEG))
        m_cur = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m - m_cur)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vb.float())
        m = m_cur
    out = acc / den.clamp_min(1e-30)[..., None]            # (B,Hkv,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def banded_swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, cap: Optional[float] = None,
                         q_block: int = 1024) -> torch.Tensor:
    """Sliding-window self-attention over a gathered diagonal band
    (``layers.py:181-224``): query block i attends keys [i·Q - window,
    i·Q + Q), so the work scales with S·(window + Q), not S². A
    from-scratch prefill (positions 0..S-1) with S a multiple of the
    query block. Plain PyTorch, differentiable under autograd. q:
    (B,S,H,hd); k,v: (B,S,Hkv,hd)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qb = min(q_block, s)
    if s % qb:
        raise ValueError(f"sequence {s} is no multiple of the query block "
                         f"{qb}")
    nb = s // qb
    band = window + qb
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    idx = (torch.arange(nb, device=dev) * qb - window)[:, None] \
        + torch.arange(band, device=dev)[None, :]          # (nb, band)
    idx_c = idx.clamp(0, s - 1)
    kb, vb = k[:, idx_c], v[:, idx_c]                      # (B,nb,band,..)
    qg = q.reshape(b, nb, qb, hkv, g, hd)
    sc = torch.einsum("bnqhgd,bnkhd->bnhgqk", qg.float(), kb.float()) * scale
    sc = softcap(sc, cap)
    qpos = (torch.arange(nb, device=dev) * qb)[:, None] \
        + torch.arange(qb, device=dev)[None, :]            # (nb, qb)
    mask = idx[:, None, :] <= qpos[:, :, None]             # causal
    mask &= idx[:, None, :] > (qpos[:, :, None] - window)  # window
    mask &= (idx >= 0)[:, None, :]
    sc = torch.where(mask[None, :, None, None], sc, torch.full_like(sc, NEG))
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", pr, vb)
    return o.reshape(b, s, h, hd)


def valid_steps(t: int, n_valid, device) -> Optional[torch.Tensor]:
    """(t,) bool: which of a chunk's ``t`` positions are real under the
    bucketed-prefill contract (the first ``n_valid``), or None where all
    are (``n_valid`` None or an int of at least t). A 0-d tensor
    ``n_valid`` (the slot prefill program's device operand) always gives
    the mask, so it is never read on the host: a real step kept by the
    mask is its own value, exactly."""
    if n_valid is None or (not torch.is_tensor(n_valid) and n_valid >= t):
        return None
    return torch.arange(t, device=device) < n_valid


def take_run(x: torch.Tensor, start, n: int, dim: int = 1) -> torch.Tensor:
    """``n`` consecutive entries of ``x`` along ``dim`` from ``start``: a
    slice for an int, an ``index_select`` at device indices for a 0-d
    tensor (the same values, no host read)."""
    if not torch.is_tensor(start):
        return x.narrow(dim, start, n)
    idx = start.reshape(1).long() + torch.arange(n, device=x.device)
    return x.index_select(dim, idx)


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        # the gate's activation before the up projection: three (T, d_ff)
        # tensors live at once, not four (8 GB each at 524,288 tokens of
        # recurrentgemma-2b)
        gate = x @ p["w_gate"]
        g = F.silu(gate) if act == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        del gate
        hmid = g * (x @ p["w_up"])
    elif act == "sqrelu":
        hmid = torch.relu(x @ p["w_up"]).square()
    else:
        raise ValueError(act)
    return hmid @ p["w_down"]


def attn_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv: int, hd: int,
             positions: torch.Tensor, theta: float, qk_norm: bool = False):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), rope applied."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, n_kv, hd)
    v = (x @ p["wv"]).reshape(b, s, n_kv, hd)
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def attn_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p["wo"]
