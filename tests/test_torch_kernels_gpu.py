"""Each CUDA kernel of the port against its plain PyTorch version, on the
card: the ``tests/test_kernels.py`` sweep shapes and tolerances (f32 atol
2e-4, bf16 2e-2) plus the engine's ragged paged prefill form, and the slot
family's WKV6 and RG-LRU recurrences on the test_wkv6 / test_rglru sweeps
with a state carried in and out, the split-K decode at forced split
counts, the decode at the other paged archs' shapes (G 2-6, hd 120 and
256, softcap 50 with a window), both attention kernels at one
tensor-parallel rank's shapes (qwen3-8b at tp 2, granite-moe at tp 4, on
a layer view of a rank's pool), both recurrences on one tp-2 rank's cache
storage (rwkv6-1.6b's 16 heads, recurrentgemma-2b's 1280 channels), and
the bf16 tensor-core prefill at G =
1-8 and hd 64-256 (hd 120 padded to 128), and the dense prefill entry at
32,768 and 524,288 tokens (row blocks against the plain blockwise
function), and the fp32 body at recurrentgemma-2b's G 10 x hd 256
(its query heads in chunks that fit shared memory); the hot loop under
sync-debug
"error", the cross-attention towers' prefill chunk and decode and a tp-2
slot decode_sample included;
and the fleet control plane: a fork's weights bit-equal in new storage, a
warm upload from a pinned pool entry, the device memory a killed and a
released TE give back, a steady plane step with no sync, and threaded
stepping giving the serial plane's tokens. Every test is marked ``gpu`` and skips without a CUDA card (the kernels
have no CPU mode). This file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# (b, h, hkv, hd, page, npages): the test_kernels.py sweep, then the other
# paged archs' decode shapes: gemma2 (G 2, hd 256), granite (G 3, hd 64),
# danube (G 4, hd 120), nemotron (G 6, hd 128), and G 3 at hd 120 / G 6 at
# hd 256
PAGED_SHAPES = [(1, 4, 4, 16, 8, 3), (2, 8, 4, 32, 16, 5),
                (3, 8, 1, 64, 16, 4),
                (2, 16, 8, 256, 16, 5), (3, 24, 8, 64, 16, 4),
                (2, 32, 8, 120, 16, 5), (2, 48, 8, 128, 16, 6),
                (2, 6, 2, 120, 16, 5), (2, 12, 2, 256, 16, 4)]
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
    for softcap, window in [(None, None), (30.0, None), (None, 20),
                            (50.0, 40)]:
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


def _long_prefill(cuda, s, h, hkv, hd, window, softcap, starts, n=256):
    """The dense ``flash_prefill`` entry on one bf16 sequence of ``s``
    tokens: its rows a..a+n-1 for each a in ``starts`` against the plain
    blockwise function over those rows and the keys they see (the dense
    plain version's (S, S) scores do not fit at these lengths), within
    bf16's 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((1, s, h, hd), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, s, hkv, hd), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    out = ops.flash_prefill(q, k, v, softcap, window)
    torch.cuda.synchronize()
    for a in starts:
        lo = 0 if window is None else max(0, a - window + 1)
        qp = torch.arange(a, a + n, device=cuda)[None]
        kp = torch.arange(lo, a + n, device=cuda)[None]
        _close(out[:, a:a + n],
               L.flash_attention(q[:, a:a + n], k[:, lo:a + n],
                                 v[:, lo:a + n], qp, kp, window, softcap),
               torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, None), (4096, 50.0)])
def test_flash_prefill_dense_32k(cuda, window, softcap):
    """prefill_32k's attention (qwen3-8b: H 32, Hkv 8, hd 128; 2048 pages
    of 16 rows in one entry), global and windowed with a softcap: row
    blocks at the start, the middle and the end of the sequence."""
    _long_prefill(cuda, 32768, 32, 8, 128, window, softcap,
                  (0, 16384 - 128, 32768 - 256))


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,hd,window", [(32, 8, 128, 4096),
                                             (10, 1, 256, 2048)])
def test_flash_prefill_dense_524k(cuda, h, hkv, hd, window):
    """long_500k's length: 524,288 tokens in one entry (32,768 pages of
    16 rows, a 16,386-row tile list). At H 32 x hd 128 q holds 2^31
    elements (the kernel's offsets are 64-bit); (10, 1, 256) is
    recurrentgemma-2b's local attention at its 2048 window. Both failed
    to launch while the kernel kept the entry's page list in shared
    memory (128 KB at this length, past the card's 227 KB)."""
    assert 524288 * 32 * 128 == 2 ** 31
    _long_prefill(cuda, 524288, h, hkv, hd, window, None,
                  (0, 262144 - 128, 524288 - 256))


@pytest.mark.gpu
def test_flash_prefill_fp32_heads_past_shared_memory(cuda):
    """The fp32 body at recurrentgemma-2b's attention (H 10 / Hkv 1, hd
    256, window 2048; replicated at every tp), 2292 tokens in pages of 4
    rows: one KV head's 160 query rows would need 416 KB of shared
    memory, past the card's 227 KB, and the launch failed (cudaError 1)
    until the body split the query heads into chunks that fit."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g).to(cuda) for shape in
               ((1, 2292, 10, 256), (1, 2292, 1, 256), (1, 2292, 1, 256)))
    _close(ops.flash_prefill(q, k, v, None, 2048),
           ops.flash_prefill(q, k, v, None, 2048, impl="ref"),
           torch.float32)


# one tensor-parallel rank's attention shapes: qwen3-8b at tp 2 (H 16,
# Hkv 4, hd 128) and granite-moe-3b-a800m at tp 4 (H 6, Hkv 2, hd 64)
RANK_SHAPES = [(16, 4, 128), (6, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,hd", RANK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernels_at_one_ranks_shape(cuda, h, hkv, hd, dtype):
    """Both attention kernels as a tensor-parallel TE's runner calls them:
    on one layer's view of a rank's (L, pages, page, Hkv/tp, hd) pool, at
    the rank's head counts. The decode runs sequences up to 288 tokens
    long (the split-K planner at this head count), the prefill a ragged
    pack; both against their plain versions."""
    g = torch.Generator().manual_seed(3)
    n_pool, page, b, npg = 80, 16, 4, 18
    kpool, vpool = (torch.randn((2, n_pool, page, hkv, hd),
                                generator=g).to(cuda, dtype)
                    for _ in range(2))
    kp, vp = kpool[1], vpool[1]
    bt = torch.randperm(n_pool, generator=g)[:b * npg].view(b, npg)
    bt = bt.int().to(cuda)
    ln = torch.tensor([1, 17, 200, npg * page], dtype=torch.int32).to(cuda)
    q = torch.randn((b, h, hd), generator=g).to(cuda, dtype)
    _close(ops.paged_attention(q, kp, vp, bt, ln, None, None),
           ops.paged_attention(q, kp, vp, bt, ln, None, None, impl="ref"),
           dtype)
    lens, starts, tb = [9, 1, 33, 16], [0, 40, 7, 16], 64
    cu = np.cumsum([0] + lens).tolist()
    ebt = bt[:, :-(-(max(starts) + max(lens)) // page)].cpu().numpy()
    qp = torch.randn((tb, h, hd), generator=g).to(cuda, dtype)
    meta = [torch.as_tensor(np.asarray(a, np.int32)).to(cuda) for a in
            (cu, ebt, starts, FP.build_tiles(cu, tb))]
    _close(ops.paged_prefill(qp, kp, vp, *meta, None, None),
           ops.paged_prefill(qp, kp, vp, *meta, None, None, impl="ref"),
           dtype)


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


PREFILL_GS = [1, 2, 3, 4, 6, 8]
PREFILL_HDS = [64, 120, 128, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", PREFILL_GS)
@pytest.mark.parametrize("hd", PREFILL_HDS)
def test_prefill_tensor_core_body(cuda, g_heads, hd):
    """The bf16 tensor-core prefill at G = 1, 2, 3, 4, 6, 8 query heads per
    KV head (3 and 6 leave padding heads in a head chunk) and hd 64, 120
    (padded to 128; the last KV head's second box reaches past the row),
    128, 256 (two column halves), on a ragged pack whose
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


# ---------------------------------------------------------------------------
# the redesigned recurrences: WKV6's chunked body at its edges and at the
# main-path shape, RG-LRU's streamed body at the main-path shape
# ---------------------------------------------------------------------------

def _wkv6_case(cuda, b, t, h, hd, dtype, seed, clamp=None):
    """test_wkv6's distributions with a random state; ``clamp`` puts half
    ("half") or all ("all") of the w's at e^-30, the log-decay clamp."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((b, t, h, hd), generator=g) * 0.5 for _ in
               range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, hd), generator=g) * 0.5
                             - 1.0))
    if clamp:
        at = torch.full_like(w, float(np.exp(-30.0)))
        w = at if clamp == "all" else torch.where(
            torch.rand(w.shape, generator=g) < 0.5, at, w)
    u = (torch.randn((h, hd), generator=g) * 0.3).to(cuda)
    s0 = (torch.randn((b, h, hd, hd), generator=g) * 0.5).to(cuda)
    return [x.to(cuda, dtype) for x in (r, k, v, w)] + [u, s0]


def _wkv6_against_plain(r, k, v, w, u, s0, dtype):
    """The kernel and the plain version on one input, the test_wkv6_kernel
    tolerances: f32 y 2e-4, bf16 y 2e-2 + 1e-2 |y|, state 1e-4."""
    s_k, s_r = s0.clone(), s0.clone()
    y_k, _ = ops.wkv6(r, k, v, w, u, s_k)
    y_r, _ = ops.wkv6(r, k, v, w, u, s_r, impl="ref")
    assert torch.isfinite(y_k.float()).all() and torch.isfinite(s_k).all()
    np.testing.assert_allclose(
        y_k.float().cpu().numpy(), y_r.float().cpu().numpy(),
        atol=_tol(dtype), rtol=1e-2 if dtype == torch.bfloat16 else 0)
    np.testing.assert_allclose(s_k.cpu().numpy(), s_r.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("clamp", ["half", "all"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel_decays_at_the_clamp(cuda, clamp, dtype):
    """Log-decays at the -30 clamp (w = e^-30): a decay factor taken as
    exp(cum) * exp(-cum) over a chunk would overflow fp32 here; the
    chunked body's products of w's stay finite and agree."""
    _wkv6_against_plain(*_wkv6_case(cuda, 2, 64, 2, 64, dtype, 7, clamp),
                        dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [37, 257])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel_ragged_t(cuda, t, dtype):
    """T that is no multiple of the 16-token chunk: the padded tail."""
    _wkv6_against_plain(*_wkv6_case(cuda, 1, t, 3, 64, dtype, 8), dtype)


@pytest.mark.gpu
def test_wkv6_kernel_main_path_shape(cuda):
    """The full-width rwkv6-1.6b prefill chunk: (1, 256, 32, 64) in bf16
    from a random state (128 blocks of the chunked body)."""
    _wkv6_against_plain(*_wkv6_case(cuda, 1, 256, 32, 64, torch.bfloat16, 9),
                        torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel_chained_calls(cuda, dtype):
    """One call of 2T against two calls of T chained through the state (as
    chunked prefill carries it): the same y and state within the
    tolerances above."""
    r, k, v, w, u, s0 = _wkv6_case(cuda, 2, 96, 2, 64, dtype, 10)
    s_one, s_two = s0.clone(), s0.clone()
    y_one, _ = ops.wkv6(r, k, v, w, u, s_one)
    halves = [ops.wkv6(*(x[:, sl].contiguous() for x in (r, k, v, w)), u,
                       s_two)[0] for sl in (slice(0, 48), slice(48, 96))]
    np.testing.assert_allclose(
        torch.cat(halves, 1).float().cpu().numpy(),
        y_one.float().cpu().numpy(), atol=_tol(dtype),
        rtol=1e-2 if dtype == torch.bfloat16 else 0)
    np.testing.assert_allclose(s_two.cpu().numpy(), s_one.cpu().numpy(),
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_kernel_head_dims(cuda, hd, dtype):
    """The chunked body at every head dim it takes (hd/16 column blocks,
    hd/8 k-steps of its tensor-core products), on a ragged T."""
    from repro_torch.kernels import wkv6 as WKV
    assert WKV.plan(45, hd) == {"chunked": True, "chunks": 3,
                                "splits": hd // 16}
    _wkv6_against_plain(*_wkv6_case(cuda, 2, 45, 2, hd, dtype, 12), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t,w,streamed", [
    (77, 328, True),      # streamed, ragged T and W (the maps clip both)
    (77, 330, False),     # rows no multiple of 16 bytes: per thread
    (9, 328, False),      # shorter than a streamed chunk: per thread
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_kernel_bodies(cuda, t, w, streamed, dtype):
    """Each RG-LRU body, reached by the shapes that select it (the
    streamed one in blocks of 16 channels, the per-thread one): fp32
    bit-exact, bf16 h within 2e-2, h_last exact."""
    from repro_torch.kernels import rglru as RG
    assert bool(RG.plan(t, w, torch.tensor([], dtype=dtype).element_size())
                ["channels"]) == streamed
    g = torch.Generator().manual_seed(13)
    a = torch.sigmoid(torch.randn((3, t, w), generator=g)).to(cuda, dtype)
    bb = (torch.randn((3, t, w), generator=g) * 0.2).to(cuda, dtype)
    h0 = (torch.randn((3, w), generator=g) * 0.5).to(cuda)
    h_k, last_k = ops.rglru(a, bb, h0)
    h_r, last_r = ops.rglru(a, bb, h0, impl="ref")
    _close(h_k, h_r, dtype)
    assert torch.equal(last_k, last_r)
    if dtype == torch.float32:
        assert torch.equal(h_k, h_r)


@pytest.mark.gpu
def test_rglru_kernel_main_path_shape(cuda):
    """The full-width recurrentgemma-2b prefill chunk (1, 256, 2560) in
    fp32 on the streamed body: bit-exact against the plain version."""
    from repro_torch.kernels import rglru as RG
    assert RG.plan(256, 2560, 4)["channels"]
    g = torch.Generator().manual_seed(11)
    a = torch.sigmoid(torch.randn((1, 256, 2560), generator=g)).to(cuda)
    bb = (torch.randn((1, 256, 2560), generator=g) * 0.2).to(cuda)
    h0 = (torch.randn((1, 2560), generator=g) * 0.5).to(cuda)
    h_k, last_k = ops.rglru(a, bb, h0)
    h_r, last_r = ops.rglru(a, bb, h0, impl="ref")
    assert torch.equal(h_k, h_r) and torch.equal(last_k, last_r)


# one tensor-parallel rank's recurrence shapes at tp 2: rwkv6-1.6b's 16 of
# 32 heads and recurrentgemma-2b's 1280 of 2560 channels, prefill (one
# sequence's 256-token chunk) and decode (8 slots)
RANK_RECURRENCES = [("prefill", 1, 256), ("decode", 8, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("phase,b,t", RANK_RECURRENCES)
def test_recurrences_on_one_ranks_cache_storage(cuda, phase, b, t):
    """Both recurrences as a tp-2 slot TE calls them: on rank 1's own
    storage of the (L, B, H/2, hd, hd) rwkv state and the (L, B, W/2)
    RG-LRU state (a layer's rows of one slot in prefill, of every slot in
    decode), at the rank's head and channel counts, each against its
    plain version (test_wkv6_kernel's and test_rglru_kernel's
    tolerances)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_engine_mesh
    mesh = make_engine_mesh(2, 0, cuda)
    g = torch.Generator().manual_seed(12)
    h, hd, w, slots = 16, 64, 1280, 8
    state = SH.rank_zeros((3, slots, 2 * h, hd, hd), torch.float32, 2,
                          mesh)[1]
    hstate = SH.rank_zeros((3, slots, 2 * w), torch.float32, 2, mesh)[1]
    assert state.shape[2] == h and hstate.shape[2] == w
    state.copy_(torch.randn(state.shape, generator=g) * 0.5)
    hstate.copy_(torch.randn(hstate.shape, generator=g) * 0.5)
    rows = slice(5, 6) if phase == "prefill" else slice(None)
    s_k = state[1, rows]
    assert s_k.is_contiguous() and s_k.shape == (b, h, hd, hd)
    r, k, v = (torch.randn((b, t, h, hd), generator=g) * 0.5 for _ in
               range(3))
    wd = torch.exp(-torch.exp(torch.randn((b, t, h, hd), generator=g) * 0.5
                              - 1.0))
    u = (torch.randn((h, hd), generator=g) * 0.3).to(cuda)
    r, k, v, wd = (x.to(cuda, torch.bfloat16) for x in (r, k, v, wd))
    s_r = s_k.clone()
    y_k, out = ops.wkv6(r, k, v, wd, u, s_k)
    y_r, _ = ops.wkv6(r, k, v, wd, u, s_r, impl="ref")
    assert out is s_k
    np.testing.assert_allclose(y_k.float().cpu().numpy(),
                               y_r.float().cpu().numpy(), atol=2e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(state[1, rows].cpu().numpy(),
                               s_r.cpu().numpy(), atol=1e-4)
    h0 = hstate[2, rows]
    a = torch.sigmoid(torch.randn((b, t, w), generator=g)).to(cuda)
    bb = (torch.randn((b, t, w), generator=g) * 0.2).to(cuda)
    h_k, last_k = ops.rglru(a, bb, h0)
    h_r, last_r = ops.rglru(a, bb, h0, impl="ref")
    assert torch.equal(h_k, h_r) and torch.equal(last_k, last_r)


# ---------------------------------------------------------------------------
# the hot loop's host side never drains the stream (no blocking copy)
# ---------------------------------------------------------------------------

def _paged_te(cuda, horizon, arch="qwen3-8b"):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import EngineConfig, FlowServe
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config(arch))
    gen = torch.Generator(device=cuda).manual_seed(0)
    return FlowServe(cfg, T.init_params(cfg, gen, torch.float32, cuda),
                     EngineConfig(n_pages=64, page_size=16,
                                  decode_horizon=horizon), device=cuda)


@pytest.mark.gpu
def test_steady_decode_step_never_syncs(cuda):
    """F1: a steady-state paged step() with a horizon in flight and no
    batch event (no join, leave or page growth) makes no blocking device
    call: it enqueues the next horizon and commits the previous block from
    pinned host memory. The stream is synchronized before the step, so the
    previous block's event has completed and the commit needs no wait at
    all (a wait on that event is the one the reference also makes); any
    blocking copy, such as ``.cpu()`` of a device tensor, raises under
    sync-debug "error"."""
    _steady_step_never_syncs(cuda, "qwen3-8b")


@pytest.mark.gpu
def test_steady_moe_decode_step_never_syncs(cuda):
    """The same steady step on granite-moe smoke: the MoE layers (top-k
    routing, capacity selection, gather and scatter-add) size everything
    from shapes and enqueue no blocking copy."""
    _steady_step_never_syncs(cuda, "granite-moe-3b-a800m")


def _steady_step_never_syncs(cuda, arch):
    from repro_torch.engine import Request, SamplingParams
    from repro_torch.engine.kv_cache import pages_needed
    te = _paged_te(cuda, horizon=1, arch=arch)
    for i in range(3):
        te.add_request(Request(prompt_tokens=list(range(3, 10 + i)),
                               req_id=f"r{i}", sampling=SamplingParams(
                                   temperature=0.8, max_new_tokens=40,
                                   stop_on_eos=False)))

    def quiet():           # the next horizon needs no page and ends no one
        live = list(te.scheduler.running)
        return (te._inflight and not te.scheduler.prefilling
                and len(live) == 3 and all(
                    pages_needed(len(s.tokens) + te._pending.get(s.seq_id, 0)
                                 + 1, 16) <= len(s.pages) for s in live))

    for _ in range(30):
        if quiet():
            break
        te.step()
    assert quiet(), "no steady decode step within 30 steps"
    torch.cuda.synchronize()
    before = (te.host_syncs, te.host_dispatches, te._hot.event_dispatches,
              te.decode_steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        te.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = (te.host_syncs, te.host_dispatches, te._hot.event_dispatches,
             te.decode_steps)
    assert after == (before[0], before[1] + 1, before[2], before[3] + 1)
    assert len(te._inflight) == 1 and not te._inflight[0][0].is_cuda
    te.run_to_completion()


@pytest.mark.gpu
def test_hot_state_sync_and_evict_never_sync(cuda):
    """F2: ``DecodeHotState.sync`` with a join, a page growth and a leave in
    one call, then ``evict``, upload from pinned memory without draining
    the stream (sync-debug "error"), and the device rows come out right."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine.hotloop import DecodeHotState
    from repro_torch.engine.kv_cache import PagedKVPool
    from repro_torch.launch.mesh import make_engine_mesh
    cfg = smoke_config(get_config("qwen3-8b"))
    pool = PagedKVPool(cfg, 32, 16, torch.float32,
                       make_engine_mesh(1, 0, cuda))
    hot = DecodeHotState(pool, torch.Generator(device=cuda))
    hot.sync([("a", [1, 2], 20, 5, 0.0, 1.0), ("b", [3], 9, 6, 0.5, 0.9)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        n = hot.sync([("b", [3, 4], 17, 0, 0.5, 0.9),     # page growth
                      ("c", [7], 4, 8, 0.8, 0.95)])       # join; "a" leaves
        hot.evict("b")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n > 0
    c, b = hot.slot_of["c"], 1 - hot.slot_of["c"]
    assert "b" not in hot.slot_of
    assert hot.bt[c].tolist()[:1] == [7] and hot.lengths[c].item() == 4
    assert hot.last_tok[c].item() == 8 and bool(hot.active[c])
    assert abs(hot.temps[c].item() - 0.8) < 1e-6
    assert not bool(hot.active[b]) and hot.bt[b, 0].item() == hot.scratch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_slot_decode_sample_never_syncs(cuda, arch):
    """F2: one slot-family ``decode_sample`` (tokens and sampling params
    uploaded from pinned memory) enqueues its step with no blocking device
    call. The token fetch after it, which the reference also blocks on,
    is outside the checked region."""
    _slot_decode_sample_never_syncs(cuda, arch, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_tp2_slot_decode_sample_never_syncs(cuda, arch):
    """The same step on a tp-2 slot TE: each rank's recurrence on its part
    of the state, recurrentgemma's ring write into the rank holding the
    slot and the log-sum-exp merge of the ranks' attention, with no
    blocking device call."""
    _slot_decode_sample_never_syncs(cuda, arch, 2)


def _slot_decode_sample_never_syncs(cuda, arch, tp):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import (EngineConfig, FlowServe, Request,
                                    SamplingParams)
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config(arch))
    gen = torch.Generator(device=cuda).manual_seed(0)
    te = FlowServe(cfg, T.init_params(cfg, gen, torch.float32, cuda),
                   EngineConfig(n_slots=4, max_len=64, tp=tp), device=cuda)
    assert len(te.runner.caches) == tp
    for i in range(2):
        te.add_request(Request(prompt_tokens=list(range(3, 12 + i)),
                               req_id=f"r{i}", sampling=SamplingParams(
                                   temperature=0.8, max_new_tokens=8,
                                   stop_on_eos=False)))
    while not te.scheduler.running or te.scheduler.prefilling:
        te.step()
    live = list(te.scheduler.running)
    temps = np.zeros((4,), np.float32)
    top_ps = np.ones((4,), np.float32)
    for s in live:
        temps[s.slot], top_ps[s.slot] = 0.8, 0.9
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = te.runner.decode_sample(live, temps, top_ps, te._gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (4,) and int(toks.max()) < cfg.vocab_size


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_cross_attn_prefill_and_decode_never_sync(cuda, arch):
    """A cross-attention tower's prefill chunk with modality inputs (their
    upload from pinned memory, the cross-cache refill, the encoder for
    the enc-dec model), then one ``decode_sample`` over its cross blocks,
    enqueue with no blocking device call (sync-debug "error")."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import (EngineConfig, FlowServe, Request,
                                    SamplingParams)
    from repro_torch.engine.runners import SequenceState
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config(arch))
    key, p = (("vision_embeds", cfg.vision.n_patches) if cfg.vision
              else ("frames", cfg.encoder.n_frames))
    rs = np.random.RandomState(0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    te = FlowServe(cfg, T.init_params(cfg, gen, torch.float32, cuda),
                   EngineConfig(n_slots=4, max_len=64), device=cuda)
    prompt = list(range(3, 14))
    seq = SequenceState(seq_id="x", tokens=prompt, n_prompt=len(prompt),
                        extra={key: rs.standard_normal(
                            (1, p, cfg.d_model)).astype(np.float32)})
    assert te.runner.alloc_slot(seq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        te.runner.prefill_chunk(seq, prompt[:8])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seq.n_cached == 8
    assert int(te.runner.caches[0]["length"][seq.slot]) == 8
    te.runner.free_slot(seq)
    for i in range(2):
        te.add_request(Request(
            prompt_tokens=list(range(3, 12 + i)), req_id=f"r{i}",
            sampling=SamplingParams(temperature=0.8, max_new_tokens=8,
                                    stop_on_eos=False),
            extra={key: rs.standard_normal(
                (1, p, cfg.d_model)).astype(np.float32)}))
    while not te.scheduler.running or te.scheduler.prefilling:
        te.step()
    live = list(te.scheduler.running)
    temps = np.zeros((4,), np.float32)
    top_ps = np.ones((4,), np.float32)
    for s in live:
        temps[s.slot], top_ps[s.slot] = 0.8, 0.9
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = te.runner.decode_sample(live, temps, top_ps, te._gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (4,) and int(toks.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# PD migration on the card: device to device, no host sync on the D-TE
# ---------------------------------------------------------------------------

def _pd_pair(cuda):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import EngineConfig, FlowServe
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config("qwen3-8b"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.init_params(cfg, gen, torch.float32, cuda)
    pe, de = (FlowServe(cfg, params, EngineConfig(mode=m, n_pages=64,
                                                  page_size=16),
                        name=m, device=cuda) for m in ("prefill", "decode"))
    pe.distflow.link_cluster([de.distflow])
    return pe, de


def _pd_prefill(pe, rid, prompt, max_new=24):
    from repro_torch.engine import Request, SamplingParams
    pe.add_request(Request(prompt_tokens=prompt, req_id=rid,
                           sampling=SamplingParams(
                               temperature=0.0, max_new_tokens=max_new,
                               stop_on_eos=False)))
    while pe.has_work():
        pe.step()
    assert pe.pop_migratable() == [rid]


@pytest.mark.gpu
def test_pd_migrate_and_decode_with_pending_import_never_sync(cuda):
    """With a decode horizon in flight on the D-TE, ``migrate_out`` of a
    prefilled paged sequence (the P-TE's gather, DistFlow's layer chunks
    and events, the D-TE's admission) and then the D-TE's ``step()``s up
    to the one that scatters the pending 2-chunk import behind its events
    before the horizon that reads it, make no blocking device call
    (sync-debug "error"). The stream is synchronized before each, as in
    ``test_steady_decode_step_never_syncs``. Every request then completes
    with valid ids."""
    pe, de = _pd_pair(cuda)
    _pd_prefill(pe, "warm", list(range(3, 30)), max_new=4)  # builds kernels
    pe.migrate_out("warm", de)
    de.run_to_completion()
    _pd_prefill(pe, "a", list(range(3, 40)))
    pe.migrate_out("a", de)
    while not de._inflight:
        de.step()
    _pd_prefill(pe, "b", list(range(5, 33)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pe.migrate_out("b", de, layer_chunks=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    handle = de._seqs["b"].kv_pending
    assert handle is not None and len(handle.chunks) == 2
    assert all(ev is not None for ev in handle.events)
    steps = de.decode_steps
    # the first step may run the plan made before "b" arrived (the engine
    # plans each step while the device runs the previous one); the next
    # lands the import and decodes it
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            de.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if de._seqs["b"].kv_pending is None:
            break
    assert de._seqs["b"].kv_pending is None and handle.xfer.done
    assert de.decode_steps > steps
    comps = {c.req_id: c.tokens for c in de.run_to_completion()}
    assert sorted(comps) == ["a", "b"]
    vocab = pe.cfg.vocab_size
    assert all(len(t) == 24 and all(0 <= x < vocab for x in t)
               for t in comps.values())


@pytest.mark.gpu
@pytest.mark.parametrize("layer_chunks", [1, 3])
def test_pd_pool_run_bit_identical_after_import(cuda, layer_chunks):
    """The run the D-TE's pool holds after the import equals the run the
    P-TE exported, bit for bit, though the P-TE has written another prompt
    into the released pages before the D-TE scattered it."""
    pe, de = _pd_pair(cuda)
    _pd_prefill(pe, "a", list(range(3, 60)))
    pages = list(pe._seqs["a"].pages)
    k_exp, v_exp = (run[0].clone() for run in pe.pool.gather_device(pages))
    pe.migrate_out("a", de, layer_chunks=layer_chunks, keep_prefix=False)
    _pd_prefill(pe, "b", list(range(100, 156)))
    assert set(pe._seqs["b"].pages) == set(pages)
    de.finish_pending_imports()
    run = de._seqs["a"].pages[:len(pages)]
    assert torch.equal(de.pool.k[0][:, run], k_exp)
    assert torch.equal(de.pool.v[0][:, run], v_exp)
    assert not torch.equal(pe.pool.k[0][:, pages], k_exp)


# ---------------------------------------------------------------------------
# the fleet control plane on the card
# ---------------------------------------------------------------------------

def _fleet(cuda, topo, n_layers=None, dtype=torch.float32, **kw):
    """A serving plane of qwen3-8b on the card: smoke, or full width cut to
    ``n_layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import ServingJobEngine, TopologySpec
    from repro_torch.engine import EngineConfig
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-8b")
    cfg = smoke_config(cfg) if n_layers is None \
        else dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.init_params(cfg, gen, dtype, cuda)
    heat = np.array([[1.0, 1.0], [-1.0, -1.0]])
    return ServingJobEngine(cfg, params, TopologySpec.parse(topo),
                            heatmap=heat, prefill_lens=[16, 64],
                            decode_ratios=[0.25, 1.0],
                            ecfg=EngineConfig(n_pages=256, page_size=16,
                                              dtype=dtype),
                            device=cuda, **kw)


def _fleet_prompts(n, seed=0):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(3, 200, int(rs.choice([14, 60])))]
            for _ in range(n)]


def _failures(je):
    """The plane's quarantined units (a unit that raised is retired and its
    requests restarted, so only its scale event shows the error)."""
    return [(e["te_id"], e["error"]) for e in je.scale_events
            if e["kind"] == "te_failure"]


def _greedy(max_new=12):
    from repro_torch.engine import SamplingParams
    return SamplingParams(temperature=0.0, max_new_tokens=max_new,
                          stop_on_eos=False)


def _live_bytes():
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _pool_bytes(eng):
    from repro_torch.engine.distflow import _nbytes
    return _nbytes([eng.pool.k, eng.pool.v])


@pytest.mark.gpu
def test_fork_copies_params_bit_equal_in_new_storage(cuda):
    from repro_torch.engine.distflow import tree_leaves
    je = _fleet(cuda, "colo=1")
    try:
        plan = je.scale_to(2)
        assert plan["tiers"]["fork"] == 1
        src, fork = je.engines
        a = tree_leaves(src.runner.params)
        b = tree_leaves(fork.runner.params)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.is_cuda and y.is_cuda
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
        ev = fork.transfer_timing["fork"]
        torch.cuda.synchronize()
        assert ev[0].elapsed_time(ev[1]) > 0
    finally:
        je.close()


@pytest.mark.gpu
def test_from_warm_uploads_a_pinned_entry(cuda):
    from repro_torch.core import WarmPool
    from repro_torch.engine import EngineConfig, FlowServe
    from repro_torch.engine.distflow import tree_leaves
    warm = WarmPool()
    je = _fleet(cuda, "colo=1", warm_pool=warm)
    try:
        je.scale_to(2)
        fork = je.engines[1]
        ref = [t.clone() for t in tree_leaves(fork.runner.params)]
        je.drain(fork.name)
        je.step()                         # empty: released into the pool
        assert not _failures(je) and je.n_serving() == 1
        entry = warm.get(je._asset_name())
        host = tree_leaves(entry)
        assert all(t.is_pinned() and not t.is_cuda for t in host)
        assert fork.transfer_timing["pin_s"] >= 0
        te = FlowServe.from_warm(je.cfg, entry, EngineConfig(n_pages=16),
                                 name="te-w", device=cuda)
        got = tree_leaves(te.runner.params)
        assert len(got) == len(ref)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
        ev = te.transfer_timing["h2d"]
        torch.cuda.synchronize()
        assert ev[0].elapsed_time(ev[1]) > 0
    finally:
        je.close()


@pytest.mark.gpu
def test_memory_returns_after_a_kill(cuda):
    from repro_torch.core import FaultPlan, FaultSpec
    fp = FaultPlan(specs=[FaultSpec("te_crash", te="te-colo1", at_step=2)])
    je = _fleet(cuda, "colo=2", policy="round_robin", fault_plan=fp)
    try:
        pool = _pool_bytes(je.engines[1])
        for p in _fleet_prompts(6):
            je.submit(p, _greedy())
        before = None
        while not fp.fired("te_crash"):
            before = _live_bytes()
            je.step()
        returned = before - _live_bytes()
        assert abs(returned - pool) <= 2 * 2**20, (returned, pool)
        je.run_to_completion()
        assert len(je.completions) == 6
        fails = _failures(je)
        assert len(fails) == 1 and fails[0][0] == "te-colo1", fails
        assert "injected crash" in fails[0][1], fails
    finally:
        je.close()


@pytest.mark.gpu
def test_memory_returns_after_a_release(cuda):
    """A drained forked TE gives back its pool and its own weights."""
    from repro_torch.engine.distflow import _nbytes
    je = _fleet(cuda, "colo=1")
    try:
        je.scale_to(2)
        fork = je.engines[1]
        owned = _pool_bytes(fork) + _nbytes(fork.runner.params)
        del fork
        before = _live_bytes()
        je.drain("te-scale0")
        je.step()
        assert je.n_serving() == 1 and not _failures(je)
        returned = before - _live_bytes()
        assert abs(returned - owned) <= 2 * 2**20, (returned, owned)
    finally:
        je.close()


@pytest.mark.gpu
def test_steady_plane_step_never_syncs(cuda):
    """A steady plane step over a colocated unit (its TE in steady decode,
    the scale triggers fed from host counters) makes no blocking device
    call."""
    from repro_torch.core import DrainTrigger, LoadSpreadTrigger
    from repro_torch.engine import SamplingParams
    from repro_torch.engine.kv_cache import pages_needed
    je = _fleet(cuda, "colo=1", trigger=LoadSpreadTrigger(),
                drain_trigger=DrainTrigger())
    try:
        sp = SamplingParams(temperature=0.8, max_new_tokens=40,
                            stop_on_eos=False)
        for i in range(3):
            je.submit(list(range(3, 10 + i)), sp)
        te = je.engines[0]

        def quiet():
            live = list(te.scheduler.running)
            return (te._inflight and not te.scheduler.prefilling
                    and len(live) == 3 and all(
                        pages_needed(len(s.tokens)
                                     + te._pending.get(s.seq_id, 0) + 1, 16)
                        <= len(s.pages) for s in live))
        for _ in range(30):
            if quiet():
                break
            je.step()
        assert quiet(), "no steady decode step within 30 plane steps"
        torch.cuda.synchronize()
        syncs, steps = te.host_syncs, te.steps
        torch.cuda.set_sync_debug_mode("error")
        try:
            je.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # a sync raises inside the TE's step, which the plane quarantines:
        # the unit must still serve, having stepped once, with no failure
        assert not _failures(je), _failures(je)
        assert je.n_serving() == 1 and je.engines == [te]
        assert te.steps == steps + 1
        assert te.host_syncs == syncs
    finally:
        je.close()


@pytest.mark.gpu
def test_threaded_plane_gives_the_serial_tokens(cuda):
    """Full width cut to 2 fp32 layers, on the kernels: three executor
    threads give the serial plane's greedy tokens and decisions, and each
    TE's launches sum to the totals."""
    from repro_torch.kernels import ops
    runs = []
    for threads in (0, 3):
        je = _fleet(cuda, "pd=1,colo=1", n_layers=2, fleet_threads=threads)
        try:
            ops.reset_launches()
            rids = [je.submit(p, _greedy(16)) for p in _fleet_prompts(8, 3)]
            je.run_to_completion()
            total = ops.launch_counts()
            assert total == {k: sum(e.kernel_launches[k] for e in je.engines)
                             for k in total}
            assert total["flash_prefill"] and total["paged_attention"]
            assert not _failures(je), _failures(je)
            assert je.n_serving() == 2 and len(je.engines) == 3
            toks = {c.req_id: c.tokens for c in je.completions}
            runs.append(([toks[r] for r in rids],
                         dict(je.scheduler.decisions)))
        finally:
            je.close()
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# fine-tune jobs: the kernels refuse autograd; a train step runs the plain
# recurrences, gives the CPU step's numbers and makes no host sync
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["qwen3-8b", "rwkv6-1.6b", "recurrentgemma-2b"]


def _grad_launches(dev):
    """Each launcher entry (through ``ops``) on CUDA inputs whose floating
    tensors require grad."""
    g = torch.Generator().manual_seed(0)

    def f(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dev, dtype) \
            .requires_grad_()
    i32 = dict(dtype=torch.int32, device=dev)
    pages = (f(4, 16, 2, 64), f(4, 16, 2, 64))
    return {
        "paged_attention": lambda: ops.paged_attention(
            f(2, 4, 64), *pages, torch.zeros((2, 2), **i32),
            torch.ones((2,), **i32)),
        "paged_prefill": lambda: ops.paged_prefill(
            f(8, 4, 64), *pages, torch.tensor([0, 8], **i32),
            torch.zeros((1, 1), **i32), torch.zeros((1,), **i32),
            torch.from_numpy(FP.build_tiles([0, 8], 8)).to(dev)),
        "flash_prefill": lambda: ops.flash_prefill(
            f(1, 16, 4, 64), f(1, 16, 2, 64), f(1, 16, 2, 64)),
        "wkv6": lambda: ops.wkv6(
            f(1, 4, 2, 64), f(1, 4, 2, 64), f(1, 4, 2, 64),
            torch.rand((1, 4, 2, 64), generator=g).to(dev, torch.bfloat16)
            .requires_grad_(), f(2, 64, dtype=torch.float32),
            torch.zeros((1, 2, 64, 64), device=dev)),
        "rglru": lambda: ops.rglru(f(1, 4, 64, dtype=torch.float32),
                                   f(1, 4, 64, dtype=torch.float32),
                                   torch.zeros((1, 64), device=dev)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["paged_attention", "paged_prefill",
                                   "flash_prefill", "wkv6", "rglru"])
def test_launchers_refuse_autograd_on_the_card(cuda, entry):
    """An input that requires grad makes a launcher raise before it launches
    (its count does not move); under no_grad the same call launches."""
    from repro_torch.kernels import counts
    calls = _grad_launches(cuda)
    before = counts.totals()
    with pytest.raises(RuntimeError, match="no backward"):
        calls[entry]()
    assert counts.totals() == before
    with torch.no_grad():
        calls[entry]()
    torch.cuda.synchronize()
    name = "flash_prefill" if entry == "paged_prefill" else entry
    assert counts.totals()[name] == before[name] + 1


def _smoke_train_inputs(arch, dev):
    """The smoke model's fp32 params (drawn on the host, copied to
    ``dev``) and a seeded (tokens, targets, mask) batch of 2 x 16."""
    from repro_torch.models.model_factory import get_model
    bundle = get_model(arch, smoke=True)
    params = bundle.init_params(torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    rs = np.random.RandomState(1)
    tokens, targets = (torch.from_numpy(rs.randint(
        0, bundle.cfg.vocab_size, (2, 16)).astype(np.int32)) for _ in "tt")
    mask = torch.ones((2, 16))
    mask[1, 11:] = 0

    def to(x):
        return {k: to(v) for k, v in x.items()} if isinstance(x, dict) \
            else [to(v) for v in x] if isinstance(x, list) else x.to(dev)
    return bundle, to(params), to(tokens), to(targets), to(mask)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_gives_the_cpu_step(cuda, arch):
    """The same smoke fp32 loss-and-grad (TF32 off) on the card and on the
    CPU: loss within 1e-5 relative, grad norm within 1e-4 relative, each
    leaf within 1e-4 * max|g_leaf| + 1e-7 (the CPU tests' bound against
    the reference)."""
    from repro_torch.training import optimizer as O
    from repro_torch.training import tree as TR
    from repro_torch.training.train_loop import make_loss_fn, value_and_grad
    out = []
    for dev in (torch.device("cpu"), cuda):
        bundle, params, tokens, targets, mask = _smoke_train_inputs(arch,
                                                                    dev)
        loss, grads = value_and_grad(make_loss_fn(bundle, True), params,
                                     tokens, targets, mask, {})
        out.append((float(loss), float(O.global_norm(grads)),
                    [g.cpu() for g in TR.leaves(grads)]))
    (l0, n0, g0), (l1, n1, g1) = out
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(n1 - n0) <= 1e-4 * n0
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(
            b.abs().max()) + 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_launches_no_kernel_and_never_syncs(cuda, arch):
    """A whole train step (forward, backward, AdamW) on the card launches
    no hand-written kernel and makes no host sync under sync-debug
    "warn". The one sync a train loop makes per step is listed: reading
    the loss for the log."""
    import warnings
    from repro_torch.kernels import counts
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    bundle, params, tokens, targets, mask = _smoke_train_inputs(arch, cuda)
    step = make_train_step(bundle, TrainConfig(opt=O.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=10)))
    state = O.init_opt_state(params)
    params, state, _ = step(params, state, tokens, targets, mask, {})  # warm
    torch.cuda.synchronize()
    before = counts.totals()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as in_step:
            warnings.simplefilter("always")
            params, state, metrics = step(params, state, tokens, targets,
                                          mask, {})
        with warnings.catch_warnings(record=True) as in_log:
            warnings.simplefilter("always")
            loss = float(metrics["loss"])              # the log's read
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counts.totals() == before
    syncs = [str(w.message) for w in in_step if "synchroniz" in
             str(w.message)]
    assert not syncs, syncs
    assert any("synchroniz" in str(w.message) for w in in_log)
    assert np.isfinite(loss)
