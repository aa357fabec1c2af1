"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth of a kernel in ``csrc/``: the CPU path
runs them directly, the tests hold them against the JAX package's oracles,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card. All
math is fp32; attention masks scores at -1e30 (not -inf), as in the Pallas
bodies they mirror, and the two recurrences step token by token.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, softcap: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q: (B, H, hd) — one query per sequence (position = lengths-1).
    k_pages / v_pages: (NP, P, Hkv, hd) page pools.
    block_tables: (B, MAXP) int32 page ids (padding masked by length).
    lengths: (B,) int32 valid tokens per sequence (incl. current token).
    Returns (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    _, p, hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = h // hkv
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, maxp * p, hkv, hd)
    v = v_pages[bt].reshape(b, maxp * p, hkv, hd)
    pos = torch.arange(maxp * p, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = pos < ln
    if window is not None:
        valid &= pos > (ln - 1 - window)
    qh = q.reshape(b, hkv, g, hd).float()
    kh = k.permute(0, 2, 1, 3).float()                         # (B,Hkv,L,hd)
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.einsum("bhgd,bhld->bhgl", qh, kh) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,bhld->bhgd", pr, vh)
    return o.reshape(b, h, hd).to(q.dtype)


def split_ranges(length: int, page_size: int, maxp: int, n_splits: int,
                 window: Optional[int] = None):
    """The key range [k0, k1) each of ``n_splits`` splits of one sequence
    reads in the split-K decode kernel (``csrc/paged_attention.cu``): the
    valid pages [key_lo // P, pg_end) cut into runs of ceil(n / S) pages,
    clipped to the valid keys [key_lo, length). Splits past the valid
    range come out empty (k1 <= k0)."""
    key_lo = max(0, length - window) if window else 0
    pg_lo = key_lo // page_size
    pg_end = min(-(-length // page_size), maxp)
    per = -(-max(pg_end - pg_lo, 0) // n_splits)
    out = []
    for s in range(n_splits):
        sp0 = pg_lo + s * per
        sp1 = min(pg_end, sp0 + per)
        out.append((max(sp0 * page_size, key_lo),
                    min(sp1 * page_size, length)))
    return out


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor, n_splits: int,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Plain emulation of the split-K decode kernel: per (sequence, KV
    head) each split of ``split_ranges`` computes its fp32 partial
    (m, l, acc) over its own keys (m = -inf, l = 0 when it has none), and
    the partials merge as the combine kernel does: m* = max m_s,
    out = sum e^{m_s - m*} acc_s / max(sum e^{m_s - m*} l_s, 1e-30), an
    empty split contributing exactly 0. Same arguments as
    ``paged_attention_ref``; returns (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    _, p, hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    for i in range(b):
        qh = q[i].reshape(hkv, g, hd).float()
        parts = []
        for k0, k1 in split_ranges(int(lengths[i]), p, maxp, n_splits,
                                   window):
            if k1 <= k0:
                parts.append(None)
                continue
            pos = torch.arange(k0, k1, device=q.device)
            pages = block_tables[i].long()[pos // p]
            k = k_pages[pages, pos % p].float()              # (n, Hkv, hd)
            v = v_pages[pages, pos % p].float()
            s = torch.einsum("hgd,nhd->hgn", qh, k) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1, keepdim=True)                     # (Hkv, G, 1)
            e = torch.exp(s - m)
            parts.append((m, e.sum(-1, keepdim=True),
                          torch.einsum("hgn,nhd->hgd", e, v)))
        live = [x for x in parts if x is not None]
        if not live:
            continue
        mx = torch.stack([m for m, _, _ in live]).amax(0)
        den = sum(torch.exp(m - mx) * l for m, l, _ in live)
        num = sum(torch.exp(m - mx) * a for m, _, a in live)
        out[i] = (num / den.clamp_min(1e-30)).reshape(h, hd)
    return out.to(q.dtype)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      softcap: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window, softcapped) self-attention.
    q: (B, S, H, hd); k, v: (B, S, Hkv, hd). Returns (B, S, H, hd)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qp = torch.arange(s, device=q.device)
    mask = qp[:, None] >= qp[None, :]
    if window is not None:
        mask &= qp[None, :] > (qp[:, None] - window)
    qh = q.reshape(b, s, hkv, g, hd).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) / math.sqrt(hd)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG))
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v.float())
    return o.reshape(b, s, h, hd).to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, cu_tokens: torch.Tensor,
                      entry_bt: torch.Tensor, entry_start: torch.Tensor,
                      softcap: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Ragged paged prefill attention — the function the JAX engine's
    ``_ragged_fn`` computes by per-token gather + dense masked attention
    (``repro/engine/runners/paged.py:281-313``), stated per packed entry.

    q: (Tb, H, hd) flat packed query tokens.
    k_pages / v_pages: (NP, P, Hkv, hd) — one layer's pool, the step's fresh
        K/V already written.
    cu_tokens: (Sb+1,) flat offsets; entry e owns tokens [cu[e], cu[e+1]).
    entry_bt: (Sb, Pb) each entry's block-table row.
    entry_start: (Sb,) position of each entry's first token; token t of
        entry e sits at position entry_start[e] + t - cu[e] and attends the
        keys of its own page run at positions kp <= pos (and kp > pos -
        window).
    Tokens at or past cu[Sb] are padding and come out as zeros.
    Returns (Tb, H, hd) in q's dtype."""
    tb, h, hd = q.shape
    _, p, hkv, _ = k_pages.shape
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    cu = cu_tokens.tolist()
    starts = entry_start.tolist()
    out = torch.zeros((tb, h, hd), dtype=torch.float32, device=q.device)
    for e in range(len(cu) - 1):
        t0, t1 = cu[e], cu[e + 1]
        if t1 <= t0:
            continue
        qpos = starts[e] + torch.arange(t1 - t0, device=q.device)
        n_keys = starts[e] + (t1 - t0)
        run = entry_bt[e, :(n_keys + p - 1) // p].long()
        k = k_pages[run].reshape(-1, hkv, hd)[:n_keys].float()
        v = v_pages[run].reshape(-1, hkv, hd)[:n_keys].float()
        kpos = torch.arange(n_keys, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        qg = q[t0:t1].reshape(t1 - t0, hkv, g, hd).float()
        s = torch.einsum("qhgd,khd->hgqk", qg, k) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask, s, torch.full_like(s, NEG))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("hgqk,khd->qhgd", pr, v)
        out[t0:t1] = o.reshape(t1 - t0, h, hd)
    return out.to(q.dtype)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None):
    """The sequential WKV6 recurrence (``repro/models/rwkv6.py::
    wkv_sequential``). r, k, v, w: (B, T, H, hd); u: (H, hd); state:
    (B, H, hd, hd) fp32 mapping the k-dim to the v-dim (zeros if None).
    Per token: y = r . (S + (u * k) v^T), then S <- diag(w) S + k v^T.
    Returns (y (B, T, H, hd) in r's dtype, final state); ``state`` itself
    is not modified, and is copied, not aliased: ``ops.wkv6`` writes the
    final state over it, and autograd must keep the initial state it
    saved (a recomputed block would otherwise read the final one)."""
    b, t, h, hd = r.shape
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state.to(torch.float32, copy=True)
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]       # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(ys, 1).to(r.dtype), s


def rglru_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The sequential linear recurrence h_t = a_t h_{t-1} + b_t in fp32
    (``repro/kernels/ref.py::rglru_ref``). a, b: (B, T, W); h0: (B, W).
    Returns (h (B, T, W) in a's dtype, h_last (B, W) fp32)."""
    af, bf = a.float(), b.float()
    hc = h0.float()
    hs = []
    for i in range(a.shape[1]):
        hc = af[:, i] * hc + bf[:, i]
        hs.append(hc)
    if not hs:
        return torch.empty_like(a), hc.clone()
    return torch.stack(hs, 1).to(a.dtype), hc
