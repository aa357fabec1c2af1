"""The host side of the redesigned slot-family kernels and of the hot
loop's uploads, on the CPU (this file imports no JAX).

The CUDA kernels have no CPU mode; here their planners (which body and
grid a shape gets), the geometry of the TMA maps RG-LRU's streamed body
copies through, and the chunked WKV6 body's decomposition, emulated in
PyTorch by ``emulate`` below, are held against the plain version
``ref.wkv6_ref`` (fp32: y within 2e-4, the state within 1e-4, the
tolerances of ``tests/test_torch_kernels_gpu.py``), with log-decays at the
-30 clamp and T that is no multiple of the chunk. The kernels themselves
are held against the plain versions on the card by the gpu-marked tests."""
import numpy as np
import pytest
import torch

from repro_torch.engine.hotloop import to_device
from repro_torch.kernels import ref as R
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import tma
from repro_torch.kernels import wkv6 as WKV
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


CHUNK, SUB = WKV.CHUNK, WKV.SUB   # the kernel's chunk and sub-chunk


def emulate(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The chunked body of ``csrc/wkv6.cu`` in fp32 PyTorch, with its
    factors: chunks of ``CHUNK`` tokens (the tail padded with r = k = v =
    0, w = 1), every decay a product of w's over a run of tokens (no factor
    above 1), scores of tokens in different sub-chunks of ``SUB`` meeting
    at the later sub-chunk's first token, the bonus on the diagonal.
    Same arguments as ``ref.wkv6_ref`` (``state`` required, not modified);
    returns (y in r's dtype, final state)."""
    b, t, h, hd = r.shape
    n = -(-t // CHUNK)
    pad = n * CHUNK - t

    def chunks(x, fill):
        x = x.float().permute(0, 2, 1, 3)                  # (B, H, T, hd)
        if pad:
            x = torch.cat([x, x.new_full((b, h, pad, hd), fill)], 2)
        return x.reshape(b, h, n, CHUNK, hd)

    rc, kc, vc, wc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), \
        chunks(w, 1.0)
    uf = u.float()[None, :, None, :]                       # (1, H, 1, hd)
    s = state.float().clone()
    ys = []
    for c in range(n):
        rr, kk, vv, ww = rc[:, :, c], kc[:, :, c], vc[:, :, c], wc[:, :, c]
        # exclusive prefix / suffix products over the chunk and the sub-chunk
        ones = torch.ones_like(ww[:, :, :1])
        pre = torch.cat([ones, torch.cumprod(ww, 2)[:, :, :-1]], 2)
        suf = torch.cat([torch.flip(torch.cumprod(torch.flip(ww, [2]), 2),
                                    [2])[:, :, 1:], ones], 2)
        a = torch.zeros((b, h, CHUNK, CHUNK))
        for i in range(CHUNK):
            si = i // SUB
            for j in range(i + 1):
                if j // SUB != si:
                    # r_i prod_{l=s_I}^{i-1} w_l . k_j prod_{l=j+1}^{s_I-1} w_l
                    q_side = rr[:, :, i] * torch.prod(ww[:, :, si * SUB:i], 2)
                    k_side = kk[:, :, j] * torch.prod(
                        ww[:, :, j + 1:si * SUB], 2)
                    a[:, :, i, j] = (q_side * k_side).sum(-1)
                elif j == i:
                    a[:, :, i, j] = (rr[:, :, i] * kk[:, :, i] * uf[:, :, 0]
                                     ).sum(-1)
                else:
                    mid = torch.prod(ww[:, :, j + 1:i], 2)
                    a[:, :, i, j] = (rr[:, :, i] * kk[:, :, j] * mid).sum(-1)
        ys.append(torch.einsum("bhik,bhkv->bhiv", rr * pre, s)
                  + torch.einsum("bhij,bhjv->bhiv", a, vv))
        s = pre[:, :, -1:].transpose(2, 3) * ww[:, :, -1:].transpose(2, 3) \
            * s + torch.einsum("bhjk,bhjv->bhkv", kk * suf, vv)
    y = torch.cat(ys, 2)[:, :, :t].permute(0, 2, 1, 3)
    return y.to(r.dtype).contiguous(), s


@pytest.mark.parametrize("t,hd,want", [
    (1, 64, {"chunked": False, "chunks": 1, "splits": 1}),
    (2, 64, {"chunked": True, "chunks": 1, "splits": 4}),
    (256, 64, {"chunked": True, "chunks": 16, "splits": 4}),
    (257, 64, {"chunked": True, "chunks": 17, "splits": 4}),
    (37, 16, {"chunked": True, "chunks": 3, "splits": 1}),
    (64, 128, {"chunked": True, "chunks": 4, "splits": 8}),
])
def test_wkv6_plan(t, hd, want):
    """Decode takes the per-token body; T > 1 the chunked one, ceil(T/16)
    chain steps, a head's v-columns in blocks of 16 (128 blocks at a
    full-width rwkv6-1.6b prefill)."""
    assert WKV.plan(t, hd) == want


@pytest.mark.parametrize("t,w,elem,aligned,want", [
    (256, 2560, 4, True, {"channels": 16, "blocks": 160}),
    (1, 2560, 4, True, {"channels": 0, "blocks": 40}),
    (15, 2560, 4, True, {"channels": 0, "blocks": 40}),
    (37, 200, 2, True, {"channels": 16, "blocks": 13}),
    (64, 100, 2, True, {"channels": 0, "blocks": 2}),   # 200-byte rows
    (64, 384, 4, False, {"channels": 0, "blocks": 6}),
])
def test_rglru_plan(t, w, elem, aligned, want):
    """The streamed body needs a chunk of 16 steps or more and rows of a
    16-byte multiple at 16-byte aligned addresses (TMA copies)."""
    assert RG.plan(t, w, elem, aligned) == want


def _wkv6_inputs(b, t, h, hd, seed, clamp=None):
    rs = np.random.RandomState(seed)
    r, k, v = ((rs.standard_normal((b, t, h, hd)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rs.standard_normal((b, t, h, hd)) * 0.5 - 1.0))
    if clamp:
        at = np.full_like(w, np.exp(-30.0))
        w = at if clamp == "all" else np.where(rs.rand(*w.shape) < 0.5, at, w)
    u = (rs.standard_normal((h, hd)) * 0.3).astype(np.float32)
    s0 = (rs.standard_normal((b, h, hd, hd)) * 0.5).astype(np.float32)
    return [torch.from_numpy(np.asarray(x, np.float32))
            for x in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("b,t,h,hd,clamp", [
    (1, 37, 2, 16, None), (2, 64, 2, 32, None), (1, 257, 1, 64, None),
    (1, 2, 2, 16, None), (1, 5, 1, 128, None),
    (2, 48, 2, 32, "half"), (1, 40, 1, 64, "all"), (1, 21, 2, 16, "half"),
])
def test_wkv6_chunked_emulation_vs_plain(b, t, h, hd, clamp):
    """The chunked body's decomposition (chunks of 16, sub-chunks of 4,
    decay products, bonus on the diagonal, padded tail) equals the
    sequential plain version, also with log-decays at the clamp, where an
    exp(cum) * exp(-cum) factorization would overflow."""
    r, k, v, w, u, s0 = _wkv6_inputs(b, t, h, hd, seed=t + hd, clamp=clamp)
    y_e, s_e = emulate(r, k, v, w, u, s0)
    y_r, s_r = R.wkv6_ref(r, k, v, w, u, s0)
    assert torch.isfinite(y_e).all() and torch.isfinite(s_e).all()
    np.testing.assert_allclose(y_e.numpy(), y_r.numpy(), atol=2e-4)
    np.testing.assert_allclose(s_e.numpy(), s_r.numpy(), atol=1e-4)


def test_wkv6_chunked_emulation_chained():
    """Two chained calls of T (the state carried between them) equal one
    call of 2T: the chunk boundary of a call is where the state is."""
    r, k, v, w, u, s0 = _wkv6_inputs(1, 40, 2, 16, seed=3)
    y_one, s_one = emulate(r, k, v, w, u, s0)
    y_a, s_a = emulate(*(x[:, :19] for x in (r, k, v, w)), u, s0)
    y_b, s_b = emulate(*(x[:, 19:] for x in (r, k, v, w)), u, s_a)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_one.numpy(), atol=2e-4)
    np.testing.assert_allclose(s_b.numpy(), s_one.numpy(), atol=1e-4)


def test_wkv6_emulation_leaves_state_alone():
    r, k, v, w, u, s0 = _wkv6_inputs(1, 9, 1, 16, seed=4)
    keep = s0.clone()
    emulate(r, k, v, w, u, s0)
    assert torch.equal(s0, keep)


@pytest.mark.parametrize("arr,dtype", [
    (np.arange(6, dtype=np.int32).reshape(2, 3), None),
    ([1, 0, 1], torch.bool), ([0.5, 0.25], torch.float32),
    (np.arange(4, dtype=np.int64), torch.long)])
def test_to_device_on_the_cpu(arr, dtype):
    """The upload helper on the CPU (the tests' device): the array's values
    as a CPU tensor of the asked dtype, with no pinning."""
    t = to_device(arr, torch.device("cpu"), dtype)
    assert t.device.type == "cpu" and not t.is_pinned()
    if dtype is not None:
        assert t.dtype == dtype
    np.testing.assert_array_equal(t.numpy(), np.asarray(arr))



@pytest.mark.parametrize("shape,dtype,dims,strides", [
    ((1, 256, 2560), torch.float32, (2560, 256, 1), (10240, 2621440)),
    ((3, 77, 328), torch.bfloat16, (328, 77, 3), (656, 50512)),
])
def test_seq_map_geometry(shape, dtype, dims, strides):
    """RG-LRU's maps: a (B, T, W) tensor as (W, T, B), innermost first,
    with the byte strides of a step and of a batch row."""
    assert tma.seq_geometry(torch.empty(shape, dtype=dtype)) == (dims, strides)
    with pytest.raises(ValueError):
        tma.seq_geometry(torch.empty(shape, dtype=dtype).transpose(1, 2))


def test_pool_geometry():
    """A layer's view of a multi-layer page pool: the rows of the whole
    storage, the view's first row, and a view that starts mid-row
    refused."""
    pool = torch.empty((3, 10, 16, 2, 8), dtype=torch.bfloat16)  # L, NP, P
    dims, strides, row0 = tma.pool_geometry(pool[1])
    assert dims == (16, 3 * 10 * 16) and strides == (32,)
    assert row0 == 10 * 16
    flat = pool.view(-1)[8:8 + 10 * 16 * 2 * 8].view(10, 16, 2, 8)
    with pytest.raises(ValueError):
        tma.pool_geometry(flat)
