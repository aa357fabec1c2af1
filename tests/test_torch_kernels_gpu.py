"""Each CUDA kernel of the port against its plain PyTorch version, on the
card: the ``tests/test_kernels.py`` sweep shapes and tolerances (f32 atol
2e-4, bf16 2e-2) plus the engine's ragged paged prefill form, and the slot
family's WKV6 and RG-LRU recurrences on the test_wkv6 / test_rglru sweeps
with a state carried in and out, the split-K decode at forced split
counts, and the bf16 tensor-core prefill at G = 1-8 and hd 64-256. Every
test is marked ``gpu`` and skips without a CUDA card (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import ops

PAGED_SHAPES = [(1, 4, 4, 16, 8, 3), (2, 8, 4, 32, 16, 5),
                (3, 8, 1, 64, 16, 4)]
FLASH_SHAPES = [(1, 128, 4, 4, 16), (2, 256, 8, 2, 32), (1, 64, 2, 1, 64)]
DTYPES = [torch.float32, torch.bfloat16]


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-4


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=_tol(dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,hd,page,npages", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_kernel(cuda, b, h, hkv, hd, page, npages, dtype):
    g = torch.Generator().manual_seed(0)
    pool = npages * b + 2
    q = torch.randn((b, h, hd), generator=g).to(cuda, dtype)
    kp = torch.randn((pool, page, hkv, hd), generator=g).to(cuda, dtype)
    vp = torch.randn((pool, page, hkv, hd), generator=g).to(cuda, dtype)
    bt = torch.randperm(pool, generator=g)[:b * npages].view(b, npages)
    ln = torch.randint(1, npages * page, (b,), generator=g)
    bt, ln = bt.int().to(cuda), ln.int().to(cuda)
    for softcap, window in [(None, None), (30.0, None), (None, 20)]:
        _close(ops.paged_attention(q, kp, vp, bt, ln, softcap, window),
               ops.paged_attention(q, kp, vp, bt, ln, softcap, window,
                                   impl="ref"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_kernel(cuda, b, s, h, hkv, hd, dtype):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for shape in
               ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    for softcap, window in [(None, None), (50.0, 48)]:
        _close(ops.flash_prefill(q, k, v, softcap, window),
               ops.flash_prefill(q, k, v, softcap, window, impl="ref"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_prefill_kernel_ragged(cuda, dtype):
    """A ragged pack with cached prefixes and bucket padding: the kernel
    and the plain version agree on every row, padding rows included."""
    g = torch.Generator().manual_seed(2)
    lens, starts, tb, p, hkv, hd, h = [9, 1, 33, 16], [0, 40, 7, 16], 64, 8, \
        2, 32, 8
    pb = max(-(-(s + n) // p) for s, n in zip(starts, lens))
    cu = np.cumsum([0] + lens).tolist()
    ebt = torch.randperm(40, generator=g)[:len(lens) * pb].view(-1, pb)
    kp = torch.randn((40, p, hkv, hd), generator=g).to(cuda, dtype)
    vp = torch.randn((40, p, hkv, hd), generator=g).to(cuda, dtype)
    q = torch.randn((tb, h, hd), generator=g).to(cuda, dtype)
    meta = [torch.as_tensor(np.asarray(a, np.int32)).to(cuda) for a in
            (cu, ebt.numpy(), starts, FP.build_tiles(cu, tb))]
    for softcap, window in [(None, None), (30.0, None), (None, 20)]:
        _close(ops.paged_prefill(q, kp, vp, *meta, softcap, window),
               ops.paged_prefill(q, kp, vp, *meta, softcap, window,
                                 impl="ref"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_split_counts(cuda, splits, dtype):
    """The split-K decode at a forced split count: one split (no merge),
    two, and more splits than most sequences have pages (empty splits must
    add exactly 0), with lengths from 1 to a full table, a window that
    empties whole splits, and softcap, against the plain version."""
    from repro_torch.kernels import paged_attention as PA
    g = torch.Generator().manual_seed(5)
    b, h, hkv, hd, page, maxp = 6, 16, 4, 64, 16, 12
    pool = b * maxp + 1
    q = torch.randn((b, h, hd), generator=g).to(cuda, dtype)
    kp = torch.randn((pool, page, hkv, hd), generator=g).to(cuda, dtype)
    vp = torch.randn((pool, page, hkv, hd), generator=g).to(cuda, dtype)
    bt = torch.randperm(pool, generator=g)[:b * maxp].view(b, maxp)
    bt = bt.int().to(cuda)
    ln = torch.tensor([1, 16, 17, 100, 150, maxp * page], dtype=torch.int32,
                      device=cuda)
    for softcap, window in [(None, None), (30.0, None), (None, 24),
                            (20.0, 40)]:
        got = PA.paged_attention(q, kp, vp, bt, ln, softcap, window,
                                 splits=splits)
        want = ops.paged_attention(q, kp, vp, bt, ln, softcap, window,
                                   impl="ref")
        assert torch.isfinite(got.float()).all()
        _close(got, want, dtype)


PREFILL_GS = [1, 2, 4, 8]
PREFILL_HDS = [64, 128, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", PREFILL_GS)
@pytest.mark.parametrize("hd", PREFILL_HDS)
def test_prefill_tensor_core_body(cuda, g_heads, hd):
    """The bf16 tensor-core prefill at G = 1, 2, 4, 8 query heads per KV
    head and hd 64, 128, 256 (two column halves), on a ragged pack whose
    entries start mid-page, with chunk lengths that are not multiples of
    16 (tiles with one warpgroup idle, and 32-token tiles), a cached
    prefix past one key block, and bucket padding; plain causal, then
    window + softcap."""
    g = torch.Generator().manual_seed(6)
    hkv, p = 2, 16
    h = g_heads * hkv
    lens, starts, tb = [9, 37, 23, 1], [5, 40, 77, 130], 80
    pb = max(-(-(s + n) // p) for s, n in zip(starts, lens))
    n_pool = len(lens) * pb + 3
    cu = np.cumsum([0] + lens).tolist()
    ebt = torch.randperm(n_pool, generator=g)[:len(lens) * pb].view(-1, pb)
    kp = torch.randn((n_pool, p, hkv, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    vp = torch.randn((n_pool, p, hkv, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    q = torch.randn((tb, h, hd), generator=g).to(cuda, torch.bfloat16)
    meta = [torch.as_tensor(np.asarray(a, np.int32)).to(cuda) for a in
            (cu, ebt.numpy(), starts, FP.build_tiles(cu, tb))]
    for softcap, window in [(None, None), (30.0, 50)]:
        got = ops.paged_prefill(q, kp, vp, *meta, softcap, window)
        want = ops.paged_prefill(q, kp, vp, *meta, softcap, window,
                                 impl="ref")
        _close(got, want, torch.bfloat16)
        assert not got[cu[-1]:].float().any()     # padding rows are zeros


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_horizon_never_syncs(cuda, temperature):
    """A K-step decode horizon enqueues all its work without one device to
    host synchronisation (greedy and sampled), on the kernel path."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import (EngineConfig, FlowServe, Request,
                                    SamplingParams)
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config("qwen3-8b"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    te = FlowServe(cfg, T.init_params(cfg, gen, torch.float32, cuda),
                   EngineConfig(n_pages=64, page_size=8), device=cuda)
    for i in range(3):
        te.add_request(Request(prompt_tokens=list(range(3, 14 + i)),
                               req_id=f"r{i}", sampling=SamplingParams(
                                   temperature=temperature,
                                   max_new_tokens=64, stop_on_eos=False)))
    while not te.scheduler.running or te.scheduler.prefilling:
        te.step()
    live = list(te.scheduler.running)
    hot = te._hot_state()
    for s in live:
        te._ensure_pages_no_preempt(s, len(s.tokens) + 4)
    hot.sync([(s.seq_id, s.pages, len(s.tokens), s.tokens[-1],
               temperature, 1.0) for s in live])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = te.runner.decode_fused(hot, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (4, hot.bb)
    assert int(toks.max()) < cfg.vocab_size


WKV6_SHAPES = [(1, 64, 2, 16), (2, 128, 3, 32), (1, 96, 1, 64), (8, 1, 4, 64)]
RGLRU_SHAPES = [(1, 128, 128), (2, 256, 256), (1, 64, 384), (8, 1, 2560),
                (3, 37, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,hd", WKV6_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel(cuda, b, t, h, hd, dtype):
    """y and the state after the last token, from a zero and from a random
    state; the state is updated in place on both routes. f32 y within
    2e-4 and the state within 1e-4 (fp32 sums in another order); bf16 y
    within 2e-2 + 1e-2 |y| (both round an fp32 value to bf16, and a value
    next to a rounding boundary may round one ulp, 2^-7 |y|, apart) and
    the fp32 state within 1e-4."""
    g = torch.Generator().manual_seed(3)
    r, k, v = (torch.randn((b, t, h, hd), generator=g) * 0.5 for _ in
               range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, hd), generator=g) * 0.5
                             - 1.0))
    u = (torch.randn((h, hd), generator=g) * 0.3).to(cuda)
    r, k, v, w = (x.to(cuda, dtype) for x in (r, k, v, w))
    for s0 in (torch.zeros((b, h, hd, hd)),
               torch.randn((b, h, hd, hd), generator=g) * 0.5):
        s_k, s_r = s0.to(cuda), s0.to(cuda)
        y_k, out = ops.wkv6(r, k, v, w, u, s_k)
        y_r, _ = ops.wkv6(r, k, v, w, u, s_r, impl="ref")
        assert out is s_k and y_k.dtype == dtype
        np.testing.assert_allclose(
            y_k.float().cpu().numpy(), y_r.float().cpu().numpy(),
            atol=_tol(dtype), rtol=1e-2 if dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(s_k.cpu().numpy(), s_r.cpu().numpy(),
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_kernel(cuda, b, t, w, dtype):
    """h and h_last from a random h0: the kernel rounds its multiply and
    its add as the plain version does, so fp32 agrees exactly; bf16 h
    within 2e-2 (output rounding), h_last (fp32) exactly."""
    g = torch.Generator().manual_seed(4)
    a = torch.sigmoid(torch.randn((b, t, w), generator=g)).to(cuda, dtype)
    bb = (torch.randn((b, t, w), generator=g) * 0.2).to(cuda, dtype)
    h0 = (torch.randn((b, w), generator=g) * 0.5).to(cuda)
    h_k, last_k = ops.rglru(a, bb, h0)
    h_r, last_r = ops.rglru(a, bb, h0, impl="ref")
    assert h_k.dtype == dtype and last_k.dtype == torch.float32
    _close(h_k, h_r, dtype)
    assert torch.equal(last_k, last_r)
    if dtype == torch.float32:
        assert torch.equal(h_k, h_r)
