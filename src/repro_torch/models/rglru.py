"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin; the
counterpart of ``repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)                (recurrence gate)
    i_t = sigmoid(W_x x_t)                (input gate)
    a_t = exp(-c * softplus(lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the sequence form as an associative scan and decode as
one step; here both go through ``ops.rglru`` (the RG-LRU kernel on a CUDA
tensor, the sequential plain version on a CPU tensor), decode as T = 1."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_C = 8.0


def init_rglru_block(gen: torch.Generator, d: int, width: int,
                     conv_width: int, dtype: torch.dtype, device) -> dict:
    """One block's weights with the reference's distributions
    (``rglru.py:24-37``); ``lambda_p`` stays fp32 as there."""
    s = 1.0 / math.sqrt(d)
    sw = 1.0 / math.sqrt(width)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(dtype)

    return {
        "w_in": normal((d, width), s),
        "w_gate_in": normal((d, width), s),
        "conv_w": normal((conv_width, width), 0.1),
        "conv_b": torch.zeros((width,), dtype=dtype, device=device),
        "wa": normal((width, width), sw),
        "wx": normal((width, width), sw),
        "lambda_p": torch.full((width,), 2.0, dtype=torch.float32,
                               device=device),
        "w_out": normal((width, d), sw),
    }


def _rglru_coeffs(p: dict, u: torch.Tensor):
    """u: (B, T, W) post-conv activations -> fp32 (a, b) with
    h_t = a_t h_{t-1} + b_t."""
    rg = torch.sigmoid((u @ p["wa"]).float())
    ig = torch.sigmoid((u @ p["wx"]).float())
    log_a = -_C * F.softplus(p["lambda_p"].float()) * rg
    a = torch.exp(log_a)
    gated = ig * u.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    return a, b


def rglru_scan(p: dict, u: torch.Tensor, h0: torch.Tensor,
               n_valid: Optional[int] = None, impl: str = "auto"):
    """The sequence form. u: (B, T, W); h0: (B, W). Positions >= n_valid
    are padding: their steps become exact identities (a -> 1, b -> 0), so
    the returned final state equals h_{n_valid-1}. Returns (h, h_last),
    both fp32."""
    a, b = _rglru_coeffs(p, u)
    t = u.shape[1]
    if n_valid is not None and n_valid < t:
        valid = (torch.arange(t, device=u.device) < n_valid)[None, :, None]
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
    return ops.rglru(a.contiguous(), b.contiguous(),
                     h0.float().contiguous(), impl=impl)


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor,
               impl: str = "auto"):
    """One decode step. u: (B, 1, W); h: (B, W). Returns (h_seq (B, 1, W),
    h_new (B, W)) — the recurrence at T = 1."""
    return rglru_scan(p, u, h, impl=impl)


def conv1d_apply(p: dict, u: torch.Tensor, conv_state: torch.Tensor,
                 n_valid: Optional[int] = None):
    """Depthwise causal conv. u: (B, T, W); conv_state: (B, cw-1, W), the
    inputs trailing the previous call. Returns (y, new_conv_state); with
    ``n_valid`` set the new state holds the cw-1 inputs trailing the last
    REAL position."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B,cw-1+T,W)
    t = u.shape[1]
    y = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(cw):
        y = y + full[:, i:i + t, :].float() * p["conv_w"][i].float()
    y = y + p["conv_b"].float()
    if cw <= 1:
        new_state = torch.zeros_like(conv_state)
    elif n_valid is None:
        new_state = full[:, -(cw - 1):, :]
    else:
        # token j sits at full[:, (cw-1)+j]: the run ending at n_valid-1
        # starts at index n_valid
        new_state = full[:, n_valid:n_valid + cw - 1, :]
    return y.to(u.dtype), new_state


def rglru_block_apply(p: dict, x: torch.Tensor, h0: torch.Tensor,
                      conv_state: torch.Tensor, decode: bool = False,
                      n_valid: Optional[int] = None, impl: str = "auto"):
    """The Griffin recurrent block: (gelu gate) * (conv -> RG-LRU) -> out
    projection. x: (B, T, D). Returns (y, new_h, new_conv_state)."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    u = x @ p["w_in"]
    u, conv_state = conv1d_apply(p, u, conv_state, n_valid=n_valid)
    if decode:
        hseq, h = rglru_step(p, u, h0, impl=impl)
    else:
        hseq, h = rglru_scan(p, u, h0, n_valid=n_valid, impl=impl)
    y = hseq.to(x.dtype) * gate
    return y @ p["w_out"], h, conv_state
