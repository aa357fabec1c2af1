"""The port's kernels against the JAX package, on the CPU.

The CUDA kernels have no CPU mode, so here their plain PyTorch versions
(``repro_torch.kernels.ref``) are held against the JAX oracles on the
``tests/test_kernels.py`` sweep shapes and tolerances (f32 atol 2e-4,
bf16 2e-2), one case each against the Pallas kernels in interpret mode,
and the ragged paged prefill form against the gather + dense masked
attention math of ``repro/engine/runners/paged.py:281-313``. The same
inputs, made with numpy from a fixed seed, go to both sides. The two
recurrences of the slot family (WKV6, RG-LRU) are held against the Pallas
kernels in interpret mode on the ``test_wkv6``/``test_rglru`` sweeps with
those tests' tolerances, and with a carried state against the JAX
package's ``wkv_sequential``/``wkv_chunked``. The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import ops
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

PAGED_SHAPES = [(1, 4, 4, 16, 8, 3),      # MHA
                (2, 8, 4, 32, 16, 5),     # GQA
                (3, 8, 1, 64, 16, 4)]     # MQA
FLASH_SHAPES = [(1, 128, 4, 4, 16), (2, 256, 8, 2, 32), (1, 64, 2, 1, 64)]
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-4


def _pair(x, jdt, tdt):
    """One numpy array as the same-valued JAX and torch arrays."""
    return jnp.asarray(x, jdt), torch.from_numpy(np.array(x)).to(tdt)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _paged_inputs(b, h, hkv, hd, page, npages, seed=0):
    rs = np.random.RandomState(seed)
    pool = npages * b + 2
    q = rs.standard_normal((b, h, hd)).astype(np.float32)
    kp = rs.standard_normal((pool, page, hkv, hd)).astype(np.float32)
    vp = rs.standard_normal((pool, page, hkv, hd)).astype(np.float32)
    bt = rs.permutation(pool)[:b * npages].reshape(b, npages).astype(np.int32)
    lengths = rs.randint(1, npages * page, b).astype(np.int32)
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("b,h,hkv,hd,page,npages", PAGED_SHAPES)
@pytest.mark.parametrize("dname,jdt,tdt", DTYPES)
@pytest.mark.parametrize("softcap,window",
                         [(None, None), (30.0, None), (None, 20)])
def test_paged_attention_ref(b, h, hkv, hd, page, npages, dname, jdt, tdt,
                             softcap, window):
    q, kp, vp, bt, ln = _paged_inputs(b, h, hkv, hd, page, npages)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, jdt, tdt) for a in (q, kp, vp))
    want = JOPS.paged_attention(jq, jk, jv, jnp.asarray(bt), jnp.asarray(ln),
                                softcap=softcap, window=window, impl="ref")
    got = ops.paged_attention(tq, tk, tv, torch.from_numpy(bt),
                              torch.from_numpy(ln), softcap=softcap,
                              window=window)
    assert got.dtype == tdt and got.shape == (b, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dname))


@pytest.mark.parametrize("b,s,h,hkv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dname,jdt,tdt", DTYPES)
@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 48)])
def test_flash_prefill_ref(b, s, h, hkv, hd, dname, jdt, tdt, softcap,
                           window):
    rs = np.random.RandomState(1)
    q = rs.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rs.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rs.standard_normal((b, s, hkv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, jdt, tdt) for a in (q, k, v))
    want = JOPS.flash_prefill(jq, jk, jv, softcap=softcap, window=window,
                              impl="ref")
    got = ops.flash_prefill(tq, tk, tv, softcap=softcap, window=window)
    assert got.dtype == tdt and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dname))


def test_paged_attention_ref_vs_pallas():
    """One GQA case against the Pallas kernel itself (interpret mode)."""
    q, kp, vp, bt, ln = _paged_inputs(2, 8, 4, 32, 16, 5, seed=3)
    want = JOPS.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(ln), softcap=30.0, window=20,
                                impl="pallas")
    got = ops.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, bt, ln)), softcap=30.0, window=20)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4)


def test_flash_prefill_ref_vs_pallas():
    rs = np.random.RandomState(4)
    q = rs.standard_normal((2, 128, 8, 32)).astype(np.float32)
    k = rs.standard_normal((2, 128, 2, 32)).astype(np.float32)
    v = rs.standard_normal((2, 128, 2, 32)).astype(np.float32)
    want = JOPS.flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                              softcap=50.0, window=48, block_q=64,
                              block_k=32, impl="pallas")
    got = ops.flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                            softcap=50.0, window=48)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4)


# ---------------------------------------------------------------------------
# ragged paged prefill: the engine's packed form
# ---------------------------------------------------------------------------

# (start, chunk length, pages) per sequence: a fresh prompt, a 1-token
# extension-only chunk deep in a cached prefix, a chunk crossing pages
ENTRIES = [(0, 9, [3, 11]), (21, 1, [7, 2, 9]), (6, 13, [14, 1, 5])]


def _ragged_pack(ps=8, max_prefill_seqs=4):
    """Pack ENTRIES as ``FlowServe._prefill_batched`` does
    (``repro/engine/flowserve.py:511-540``): flat tokens with per-token
    page/slot/position, per-token block-table rows padded with the scratch
    page, pow2 buckets, padding tokens on scratch slot 0 at position 0 —
    plus the port's entry-level metadata for the same pack."""
    from repro.engine.hotloop import pow2_bucket
    scratch = 15
    sb = pow2_bucket(max(max_prefill_seqs, len(ENTRIES)))
    pb = pow2_bucket(max(len(pg) for _, _, pg in ENTRIES))
    flat_p, flat_pg, flat_sl, rows, cu = [], [], [], [], [0]
    entry_bt = np.full((sb, pb), scratch, np.int32)
    entry_start = np.zeros((sb,), np.int32)
    for i, (start, n, pages) in enumerate(ENTRIES):
        row = pages + [scratch] * (pb - len(pages))
        entry_bt[i, :len(pages)] = pages
        entry_start[i] = start
        for j in range(n):
            pos = start + j
            flat_p.append(pos)
            flat_pg.append(pages[pos // ps])
            flat_sl.append(pos % ps)
            rows.append(row)
        cu.append(len(flat_p))
    cu += [cu[-1]] * (sb - len(ENTRIES))
    tb = pow2_bucket(len(flat_p))
    while len(flat_p) < tb:
        flat_p.append(0)
        flat_pg.append(scratch)
        flat_sl.append(0)
        rows.append([scratch] * pb)
    return dict(positions=np.asarray(flat_p, np.int32),
                pages=np.asarray(flat_pg, np.int32),
                slots=np.asarray(flat_sl, np.int32),
                bt_tok=np.asarray(rows, np.int32), cu=np.asarray(cu, np.int32),
                entry_bt=entry_bt, entry_start=entry_start, tb=tb,
                n_real=cu[-1])


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 6)])
def test_paged_prefill_ref_vs_engine_gather(softcap, window):
    """The JAX engine's ragged attention (per-token page-run gather + dense
    masked ``L.attention``, paged.py:305-313) on a pool whose fresh KV is
    already scattered, vs the port's entry-level ``paged_prefill_ref``.
    Real rows agree within 2e-4 (f32); padding rows differ by design (JAX
    attends a scratch slot, the port writes zeros) and are not compared."""
    ps, h, hkv, hd = 8, 4, 2, 16
    pk = _ragged_pack(ps)
    rs = np.random.RandomState(5)
    n_pool = 16
    kp = rs.standard_normal((n_pool, ps, hkv, hd)).astype(np.float32)
    vp = rs.standard_normal((n_pool, ps, hkv, hd)).astype(np.float32)
    q = rs.standard_normal((pk["tb"], h, hd)).astype(np.float32)
    tb, pb = pk["bt_tok"].shape
    total = pb * ps
    win = 2 ** 30 if window is None else window
    pos2 = jnp.asarray(pk["positions"])[:, None]
    kpos_base = jnp.arange(total, dtype=jnp.int32)[None]
    kpos = jnp.where(kpos_base <= pos2, kpos_base, 2 ** 30 + 1)
    bt_tok = jnp.asarray(pk["bt_tok"])
    k_seq = jnp.asarray(kp)[bt_tok].reshape(tb, total, hkv, hd)
    v_seq = jnp.asarray(vp)[bt_tok].reshape(tb, total, hkv, hd)
    mask = JL.causal_mask(pos2, kpos)
    mask &= kpos[:, None, :] > (pos2[:, :, None] - win)
    want = JL.attention(jnp.asarray(q)[:, None], k_seq, v_seq, mask,
                        softcap)[:, 0]
    tiles = torch.from_numpy(FP.build_tiles(pk["cu"].tolist(), tb))
    got = ops.paged_prefill(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pk["cu"]), torch.from_numpy(pk["entry_bt"]),
        torch.from_numpy(pk["entry_start"]), tiles, softcap=softcap,
        window=window)
    n = pk["n_real"]
    np.testing.assert_allclose(_f32(got)[:n], np.asarray(want)[:n], atol=2e-4)
    assert not _f32(got)[n:].any()          # padding rows are zeros


def test_build_tiles_cover_each_token_once():
    cu = [0, 9, 10, 23, 23]
    tiles = FP.build_tiles(cu, 32)
    assert tiles.shape == (FP.max_tiles(32, 4), 3)
    seen = []
    for e, a, b in tiles.tolist():
        if b <= a:
            continue
        assert b - a <= FP.BLOCK_Q
        if e < 0:
            assert a >= cu[-1]              # padding tail
        else:
            assert cu[e] <= a and b <= cu[e + 1]
        seen += range(a, b)
    assert sorted(seen) == list(range(32))


@pytest.mark.parametrize("lens,n_tokens", [([9, 1, 33, 16], 64),
                                           ([32, 64, 31], 128),
                                           ([256, 128, 96, 32], 512),
                                           ([0, 5, 0], 8)])
def test_build_tiles_32_token_tiles(lens, n_tokens):
    """The tensor-core prefill takes tiles of up to 32 tokens (two
    16-token halves, one warpgroup each): each entry is cut into
    ceil(len / 32) runs, the padding tail likewise, and the list fits the
    ``max_tiles`` bound the engine allocates."""
    assert FP.BLOCK_Q == 32
    cu = np.cumsum([0] + lens).tolist()
    tiles = FP.build_tiles(cu, n_tokens).tolist()
    assert len(tiles) == FP.max_tiles(n_tokens, len(lens))
    used = [t for t in tiles if t[2] > t[1]]
    spans = lens + [n_tokens - cu[-1]]
    assert len(used) == sum(-(-n // FP.BLOCK_Q) for n in spans)
    for e, a, b in used:
        lo, hi = (cu[e], cu[e + 1]) if e >= 0 else (cu[-1], n_tokens)
        assert lo <= a < b <= hi and b - a <= FP.BLOCK_Q
        assert (a - lo) % FP.BLOCK_Q == 0
    assert sorted(t for _, a, b in used for t in range(a, b)) == \
        list(range(n_tokens))


# ---------------------------------------------------------------------------
# split-K decode: the host's split planner and the split-and-merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,maxp,n_sm,want", [
    (8, 8, 128, 132, 5),        # the main path: 320 blocks >= 2 x 132 SMs
    (1, 8, 512, 132, 32),       # one long sequence: capped at MAX_SPLITS
    (1, 8, 3, 132, 3),          # never more splits than block-table pages
    (64, 8, 128, 132, 1),       # a full batch already covers the card
    (3, 1, 64, 114, 64 // 2),   # another SM count (H100 PCIe)
    (0, 8, 16, 132, 1)])
def test_n_splits_planner(b, hkv, maxp, n_sm, want):
    """S depends on shapes only (B, Hkv, the block-table width, the SM
    count): enough blocks to cover the SMs twice, within [1, maxp] and
    MAX_SPLITS. The lengths live on the device inside a decode horizon, so
    the planner never sees them."""
    from repro_torch.kernels import paged_attention as PA
    s = PA.n_splits(b, hkv, maxp, n_sm)
    assert s == min(want, PA.MAX_SPLITS)
    assert 1 <= s <= max(1, min(maxp, PA.MAX_SPLITS))
    if b * hkv and s < min(maxp, PA.MAX_SPLITS):
        assert b * hkv * s >= 2 * n_sm


@pytest.mark.parametrize("length,page,maxp,n_splits,window", [
    (1, 16, 4, 5, None),        # length 1: one key, one non-empty split
    (32, 16, 4, 2, None),       # exact page multiple
    (48, 16, 3, 3, None),       # exact multiple filling the table
    (100, 8, 16, 8, 10),        # a window that empties most splits
    (40, 16, 8, 16, None),      # more splits than the sequence's pages
    (2000, 16, 128, 5, 2 ** 30)])  # the global-window sentinel
def test_split_ranges_partition(length, page, maxp, n_splits, window):
    """The kernel's partition (mirrored by ``ref.split_ranges``): the
    splits' key ranges are disjoint, in order, cover exactly the valid keys
    [max(0, len - window), len), start on page boundaries, and their page
    counts differ by at most one run; splits past the range are empty."""
    from repro_torch.kernels import ref as R
    rs = R.split_ranges(length, page, maxp, n_splits, window)
    assert len(rs) == n_splits
    lo = max(0, length - window) if window else 0
    keys = [k for k0, k1 in rs for k in range(k0, k1)]
    assert keys == list(range(lo, length))
    live = [(k0, k1) for k0, k1 in rs if k1 > k0]
    assert all(k0 == lo or k0 % page == 0 for k0, _ in live)
    pages = [-(-k1 // page) - k0 // page for k0, k1 in live]
    per = -(-(min(-(-length // page), maxp) - lo // page) // n_splits)
    assert all(p == per for p in pages[:-1]) and 1 <= pages[-1] <= per
    # empty splits come last (the device skips them at once)
    first_empty = next((i for i, (k0, k1) in enumerate(rs) if k1 <= k0),
                       n_splits)
    assert all(k1 <= k0 for k0, k1 in rs[first_empty:])


@pytest.mark.parametrize("b,h,hkv,hd,page,npages", PAGED_SHAPES)
@pytest.mark.parametrize("dname,jdt,tdt", DTYPES)
@pytest.mark.parametrize("softcap,window",
                         [(None, None), (30.0, None), (None, 20)])
def test_split_merge_emulation(b, h, hkv, hd, page, npages, dname, jdt, tdt,
                               softcap, window):
    """The plain emulation of split-and-merge (each split's fp32 partial
    (m, l, acc) over its own keys, merged as the combine kernel does) gives
    the plain single-pass version's answer and the JAX oracle's, for one
    split, a few, and more splits than the sequences have pages (empty
    splits contribute exactly 0)."""
    from repro_torch.kernels import ref as R
    q, kp, vp, bt, ln = _paged_inputs(b, h, hkv, hd, page, npages)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, jdt, tdt) for a in (q, kp, vp))
    want = _f32(JOPS.paged_attention(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(ln), softcap=softcap,
                                     window=window, impl="ref"))
    tbt, tln = torch.from_numpy(bt), torch.from_numpy(ln)
    single = _f32(R.paged_attention_ref(tq, tk, tv, tbt, tln, softcap,
                                        window))
    for s in (1, 2, 3, npages + 3):
        got = R.paged_attention_split_ref(tq, tk, tv, tbt, tln, s, softcap,
                                          window)
        assert got.dtype == tdt and got.shape == (b, h, hd)
        np.testing.assert_allclose(_f32(got), want, atol=_tol(dname))
        np.testing.assert_allclose(_f32(got), single, atol=_tol(dname))


@pytest.mark.parametrize("lengths,window,softcap,n_splits,has_empty", [
    ([1, 1], None, None, 4, True),      # length 1
    ([16, 48], None, 30.0, 3, True),    # exact page multiples
    ([48, 33], None, None, 3, False),   # every split holds a page
    ([100, 61], 10, None, 8, True),     # a window that empties whole splits
    ([5, 40], None, None, 16, True),    # S larger than a sequence's pages
    ([64, 64], 16, 50.0, 2, True)])     # window + softcap on a page edge
def test_split_merge_edge_cases(lengths, window, softcap, n_splits,
                                has_empty):
    """Edge cases of the split-K plan against the plain version in fp32
    (atol 2e-6: the same math summed in another order), with the empty
    splits they create checked to exist where the case says so."""
    from repro_torch.kernels import ref as R
    rs = np.random.RandomState(11)
    b, h, hkv, hd, page = len(lengths), 8, 2, 32, 16
    maxp = max(-(-n // page) for n in lengths)
    pool = b * maxp + 1
    q = torch.from_numpy(rs.standard_normal((b, h, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rs.standard_normal(
        (pool, page, hkv, hd)).astype(np.float32)) for _ in range(2))
    bt = torch.from_numpy(rs.permutation(pool)[:b * maxp].reshape(
        b, maxp).astype(np.int32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = R.paged_attention_split_ref(q, kp, vp, bt, ln, n_splits, softcap,
                                      window)
    want = R.paged_attention_ref(q, kp, vp, bt, ln, softcap, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    empty = sum(k1 <= k0 for n in lengths
                for k0, k1 in R.split_ranges(n, page, maxp, n_splits, window))
    assert (empty > 0) == has_empty


def test_launchers_refuse_cpu_tensors_and_unknown_impl():
    """No silent fallback: a kernel launcher given CPU tensors raises (the
    plain version is reached only through ``ops`` by where tensors lie),
    and ``ops`` knows no route but the kernel and the plain version."""
    from repro_torch.kernels import paged_attention as PA
    args = (torch.zeros(1, 1, 4), torch.zeros(1, 1, 1, 4),
            torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention(*args)
    with pytest.raises(ValueError, match="CUDA"):
        FP.flash_prefill(torch.zeros(1, 16, 1, 4), torch.zeros(1, 16, 1, 4),
                         torch.zeros(1, 16, 1, 4))
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(*args, impl="pallas")


# ---------------------------------------------------------------------------
# the slot family's recurrences
# ---------------------------------------------------------------------------

WKV6_SHAPES = [(1, 64, 2, 16, 16), (2, 128, 3, 32, 32), (1, 96, 1, 64, 48)]
RGLRU_SHAPES = [(1, 128, 128, 32, 128), (2, 256, 256, 64, 128),
                (1, 64, 384, 64, 128)]


def _wkv6_inputs(b, t, h, hd, seed=0):
    """tests/test_kernels.py::test_wkv6's distributions, from numpy."""
    rs = np.random.RandomState(seed)
    r, k, v = ((rs.standard_normal((b, t, h, hd)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rs.standard_normal((b, t, h, hd)) * 0.5 - 1.0)) \
        .astype(np.float32)
    u = (rs.standard_normal((h, hd)) * 0.3).astype(np.float32)
    state = (rs.standard_normal((b, h, hd, hd)) * 0.5).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("b,t,h,hd,chunk", WKV6_SHAPES)
@pytest.mark.parametrize("dname,jdt,tdt", DTYPES)
def test_wkv6_ref_vs_pallas(b, t, h, hd, chunk, dname, jdt, tdt):
    """Plain WKV6 from a zero state against the Pallas kernel (interpret
    mode), test_wkv6's tolerances: f32 2e-3 (chunked vs sequential fp32
    sums), bf16 3e-2 (output rounding)."""
    r, k, v, w, u, _ = _wkv6_inputs(b, t, h, hd)
    pairs = [_pair(a, jdt, tdt) for a in (r, k, v, w)]
    want = JOPS.wkv6(*(p[0] for p in pairs), jnp.asarray(u), chunk=chunk,
                     impl="pallas")
    state = torch.zeros((b, h, hd, hd))
    got, s_out = ops.wkv6(*(p[1] for p in pairs), torch.from_numpy(u), state)
    assert got.dtype == tdt and got.shape == (b, t, h, hd)
    assert s_out is state                  # advanced in place
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=3e-2 if dname == "bfloat16" else 2e-3)


@pytest.mark.parametrize("b,t,w,chunk,bw", RGLRU_SHAPES)
@pytest.mark.parametrize("dname,jdt,tdt", DTYPES)
def test_rglru_ref_vs_pallas(b, t, w, chunk, bw, dname, jdt, tdt):
    """Plain RG-LRU against the Pallas kernel (interpret mode),
    test_rglru's tolerances: f32 1e-4, bf16 5e-2."""
    rs = np.random.RandomState(1)
    a = (1.0 / (1.0 + np.exp(-rs.standard_normal((b, t, w))))) \
        .astype(np.float32)
    bb = (rs.standard_normal((b, t, w)) * 0.2).astype(np.float32)
    h0 = (rs.standard_normal((b, w)) * 0.5).astype(np.float32)
    (ja, ta), (jb, tb), (jh, th) = (_pair(x, jdt, tdt) for x in (a, bb, h0))
    want = JOPS.rglru(ja, jb, jh, chunk=chunk, block_w=bw, impl="pallas")
    got, h_last = ops.rglru(ta, tb, th)
    assert got.dtype == tdt and h_last.dtype == torch.float32
    tol = 5e-2 if dname == "bfloat16" else 1e-4
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol)
    np.testing.assert_allclose(h_last.numpy(), _f32(want)[:, -1], atol=tol)


@pytest.mark.parametrize("t", [1, 80])
def test_wkv6_carried_state_matches_reference(t):
    """With a random carried state, the plain WKV6 (and the port's chunked
    and sequential twins) against JAX ``wkv_sequential`` and
    ``wkv_chunked``: y and the
    final state within 2e-4 in fp32 (test_kernels.py's chunked-vs-
    sequential tolerance). T = 1 is the decode step."""
    r, k, v, w, u, s0 = _wkv6_inputs(2, t, 2, 16, seed=2)
    jin = [jnp.asarray(a) for a in (r, k, v, w, u)]
    y_seq, s_seq = JR.wkv_sequential(*jin, jnp.asarray(s0))
    y_chk, s_chk = JR.wkv_chunked(*jin, jnp.asarray(s0), chunk=32)
    tin = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    state = torch.from_numpy(s0.copy())
    y, s = ops.wkv6(*tin, state)
    from repro_torch.models import rwkv6 as TR
    y2, s2 = TR.wkv_chunked(*tin, torch.from_numpy(s0), chunk=32)
    y3, s3 = TR.wkv_sequential(*tin, torch.from_numpy(s0))
    for got_y, got_s in ((y, s), (y2, s2), (y3, s3)):
        for want_y, want_s in ((y_seq, s_seq), (y_chk, s_chk)):
            np.testing.assert_allclose(_f32(got_y), np.asarray(want_y),
                                       atol=2e-4)
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       atol=2e-4)


def test_recurrence_launchers_refuse_cpu_tensors():
    """The WKV6 and RG-LRU launchers take CUDA tensors only; the plain
    versions are reached through ``ops`` by where the tensors lie."""
    from repro_torch.kernels import rglru as RG
    from repro_torch.kernels import wkv6 as WKV
    x = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        WKV.wkv6(x, x, x, x, torch.zeros(1, 16), torch.zeros(1, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        RG.rglru(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8),
                 torch.zeros(1, 8))
    with pytest.raises(ValueError, match="impl"):
        ops.rglru(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8),
                  torch.zeros(1, 8), impl="pallas")
