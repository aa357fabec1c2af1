"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin; the
counterpart of ``repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)                (recurrence gate)
    i_t = sigmoid(W_x x_t)                (input gate)
    a_t = exp(-c * softplus(lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the sequence form as an associative scan and decode as
one step; here both go through ``ops.rglru`` (the RG-LRU kernel on a CUDA
tensor, the sequential plain version on a CPU tensor), decode as T = 1,
once per rank of the TE's mesh at that rank's channels."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.mesh import split_ranks
from repro_torch.models import layers as L

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


def _rglru_coeffs(p: dict, u_all: torch.Tensor, u: torch.Tensor):
    """fp32 (a, b) with h_t = a_t h_{t-1} + b_t for the channels of ``u``
    (B, T, W_r), a rank's post-conv activations; the gate products read
    the whole post-conv width ``u_all`` (B, T, W) through the rank's
    column shards of ``wa``/``wx``."""
    # each gate dropped once used (an fp32 copy of the width each: 5.4 GB
    # at 524,288 tokens of recurrentgemma-2b)
    log_a = -_C * F.softplus(p["lambda_p"].float()) \
        * torch.sigmoid((u_all @ p["wa"]).float())
    gated = torch.sigmoid((u_all @ p["wx"]).float()) * u.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    return a, b


def rglru_scan(p: dict, u_all: torch.Tensor, u: torch.Tensor,
               h0: torch.Tensor, n_valid=None,
               impl: str = "auto"):
    """The recurrence over a rank's channels, in prefill and in decode (T =
    1). u_all: (B, T, W); u: (B, T, W_r); h0: (B, W_r). Positions >=
    n_valid (an int, or a 0-d device tensor never read on the host) are
    padding: their steps become exact identities (a -> 1,
    b -> 0), so the returned final state equals h_{n_valid-1}. Returns
    (h, h_last), both fp32."""
    a, b = _rglru_coeffs(p, u_all, u)
    valid = L.valid_steps(u.shape[1], n_valid, u.device)
    if valid is not None:
        valid = valid[None, :, None]
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
    return ops.rglru(a.contiguous(), b.contiguous(),
                     h0.float().contiguous(), impl=impl)


def conv1d_apply(p: dict, u: torch.Tensor, conv_state: torch.Tensor,
                 n_valid=None):
    """Depthwise causal conv. u: (B, T, W); conv_state: (B, cw-1, W), the
    inputs trailing the previous call. Returns (y, new_conv_state); with
    ``n_valid`` set the new state holds the cw-1 inputs trailing the last
    REAL position."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B,cw-1+T,W)
    t = u.shape[1]
    y = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(cw):             # accumulated in place: 5.4 GB a copy
        y += full[:, i:i + t, :].float() * p["conv_w"][i].float()
    y += p["conv_b"].float()
    if cw <= 1:
        new_state = torch.zeros_like(conv_state)
    elif n_valid is None:
        new_state = full[:, -(cw - 1):, :]
    else:
        # token j sits at full[:, (cw-1)+j]: the run ending at n_valid-1
        # starts at index n_valid
        new_state = L.take_run(full, n_valid, cw - 1)
    return y.to(u.dtype), new_state


def rglru_block_apply(ps: list, x: torch.Tensor, h0s: list, convs: list,
                      mesh, n_valid=None,
                      impl: str = "auto"):
    """The Griffin recurrent block over the ranks of ``mesh``: (gelu gate) *
    (conv -> RG-LRU) -> out projection. ``ps``: the ranks' trees, whose
    ``w_in``/``w_gate_in``/conv/``lambda_p``/``wa``/``wx`` hold the rank's
    channels of the width; ``h0s``/``convs``: the ranks' (B, W_r) states
    and (B, cw-1, W_r) conv inputs. Each rank runs the causal conv and the
    RG-LRU on its channels (its gate products read the gathered post-conv
    width), and ``w_out``'s row partials are all-reduced. x: (B, T, D) on
    rank 0. Returns (y, [new h per rank], [new conv state per rank]), one
    entry per rank holding channels (rank 0 alone when the width does not
    split)."""
    ranks = split_ranks(ps, ps[0]["wa"].shape[0], ps[0]["w_in"].shape[-1])
    gates, us, new_convs = [], [], []
    for p, xr, cs in zip(ranks, mesh.broadcast(x), convs):
        gates.append(F.gelu(xr @ p["w_gate_in"], approximate="tanh"))
        u, c = conv1d_apply(p, xr @ p["w_in"], cs, n_valid=n_valid)
        us.append(u)
        new_convs.append(c)
    hs, ys = [], []
    for p, ua, u, h0, g in zip(ranks, mesh.broadcast(mesh.all_gather(us, -1)),
                               us, h0s, gates):
        hseq, h = rglru_scan(p, ua, u, h0, n_valid=n_valid, impl=impl)
        hs.append(h)
        ys.append(hseq.to(x.dtype) * g)
    return mesh.all_reduce([y @ p["w_out"] for p, y in zip(ranks, ys)]), \
        hs, new_convs
