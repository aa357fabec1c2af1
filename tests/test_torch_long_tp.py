"""The port's long-context path on sharded TEs against the JAX package, on
the CPU: every dense cache kind split over tp ranks (``swa``,
``local_global``, the ring, past 2048 positions), the windowed decode, the
single-shot prefill, and the step builders and ``decode_cache`` on a mesh.

The reference's serving functions take no mesh: GSPMD partitions them
under ``cache_specs``, so the unsharded JAX function is the reference's
result at every tp, and the port's ranks (every one on ``cpu``) are held
against it. Both sides run one set of seeded smoke weights in fp32 (the
numpy tree of ``test_torch_long.load``, in the layout of the JAX
``init_params``), the port's split by ``sharding.shard``. Tolerances:
logits and the ranks' joined K/V within 1e-4 of the reference's, greedy
tokens exact; the placement of the builders' K/V bit for bit. At the
smoke widths (4 query / 2 KV heads) attention splits its heads at tp 2
and replicates at tp 4, while the sequence splits at both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShapeConfig
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models import perf_flags as JPF
from repro.models import serving as JS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import perf_flags as PF
from repro_torch.models import serving as S
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)
from test_torch_long import (_argmax, _close, _extra, _jdecode, _jprefill,
                             _tokens, load)

F32 = torch.float32


def _ranks(cfg, tree, tp):
    """(mesh, the ranks' weights trees) of a TE of width ``tp``."""
    mesh = make_engine_mesh(tp, 0, "cpu")
    return mesh, SH.shard(tree, SH.te_param_specs(cfg, tp), mesh)


def _jzeros(cfg, b, max_len, ring=False):
    """The reference's zeroed cache, of the port's unsharded layout
    (``test_torch_long.py::test_init_cache_shapes_match_reference``)."""
    like = S.cache_like(cfg, b, max_len, F32, ring=ring)
    return {k: jnp.zeros(tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in like.items()}


SPLIT = {"k": 2, "v": 2, "state": 2, "h": 2, "conv": 3}


def _joined(caches, key):
    """One leaf of rank caches as one tensor: the parts joined on the dim
    they split (``engine_cache_specs``), or the replicated leaf itself."""
    parts = SH.held([c[key] for c in caches])
    return parts[0] if len(parts) == 1 else torch.cat(parts, SPLIT[key])


def _hold(caches, jc, keys=("k", "v"), atol=1e-4):
    for key in keys:
        _close(_joined(caches, key), jc[key], atol)


# ------------------------------------------------------- the split dims
SPLIT_CASES = [("h2o-danube-3-4b", 64, False), ("gemma2-9b", 64, False),
               ("recurrentgemma-2b", 4096, True), ("qwen3-8b", 3000, False)]


class _Mesh:
    """The one attribute ``prune_unsplittable`` reads of a JAX mesh."""

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}


def test_cache_split_dims_match_reference():
    """The dim each leaf splits over the ranks, at tp 2 and 4, equals the
    axis where ``"model"`` stands (inside ``("data", "model")`` too) in
    the JAX ``prune_unsplittable(cache_specs(...))`` at a slot batch of 2
    and at 16 (the reference's batch-sharded layout, its data axis of
    size 1 in a TE); the rank caches ``init_cache`` makes have those
    splits. Shapes only. A length tp does not divide (a cache of 3002 at
    tp 4) replicates on both sides."""
    cases = SPLIT_CASES + [("qwen3-8b", 3002, False)]
    for arch, max_len, ring in cases:
        jcfg, _, cfg, _ = load(arch)
        for tp in (2, 4):
            mesh = make_engine_mesh(tp, 0, "cpu")
            caches = S.init_cache(cfg, 2, max_len, F32, mesh, ring=ring)
            got_like = S.cache_like(cfg, 2, max_len, F32, ring=ring)
            specs = SH.engine_cache_specs(cfg, got_like, tp)
            for b in (2, 16):
                like = jax.eval_shape(lambda: JS.init_cache(
                    jcfg, b, max_len, jnp.float32, ring=ring))
                jspecs = JSH.prune_unsplittable(
                    JSH.cache_specs(jcfg, like, JShapeConfig(
                        "engine_slots", "decode", max_len, b), ("data",),
                        tp=tp), like, _Mesh(tp))
                for key, spec in jspecs.items():
                    dims = [i for i, ax in enumerate(tuple(spec))
                            if ax == "model" or (isinstance(ax, tuple)
                                                 and "model" in ax)]
                    want = dims[0] if dims else None
                    assert specs[key] == want, (arch, max_len, tp, b, key)
            for key, spec in specs.items():
                parts = SH.held([c[key] for c in caches])
                assert len(parts) == (1 if spec is None else tp), key
                full = tuple(got_like[key].shape)
                if spec is not None:
                    assert parts[0].shape[spec] * tp == full[spec], key
                    assert _joined(caches, key).shape == full, key
                else:
                    assert tuple(parts[0].shape) == full, key
        if max_len == 3002:
            assert specs["k"] is None


# ------------------------------------------------- serving at tp > 1
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma2-9b"])
def test_prefill_decode_match_reference(arch):
    """A 32-token prefill past the smoke window of 16 into a 64-slot cache
    at tp 2 (gemma2: local and global layers, the softcap), then 8 greedy
    decode steps: every logits row within 1e-4 of the reference's, greedy
    tokens exact, the joined K/V within 1e-4."""
    jcfg, jp, cfg, tree = load(arch)
    mesh, ps = _ranks(cfg, tree, 2)
    toks = _tokens(2, 32, seed=1)
    tc = S.init_cache(cfg, 2, 64, F32, mesh)
    assert tc[0]["k"].shape[2] == 32
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), _jzeros(cfg, 2, 64))
    with torch.no_grad():
        tl, _ = S.prefill(cfg, ps, torch.from_numpy(toks).long(), tc, mesh)
        jdec = _jdecode(jcfg)
        for _ in range(8):
            _close(tl, jl, 1e-4)
            nxt = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1)
            assert nxt.tolist() == tl[:, :cfg.vocab_size].argmax(-1).tolist()
            jl, jc = jdec(jp, jnp.asarray(nxt, jnp.int32), jc)
            tl, _ = S.decode_step(cfg, ps, torch.from_numpy(nxt).long(),
                                  tc, mesh)
    _close(tl, jl, 1e-4)
    _hold(tc, jc)


@pytest.mark.parametrize("arch,n_layers", [("h2o-danube-3-4b", None),
                                           ("recurrentgemma-2b", 3)])
def test_ring_decode_matches_reference(arch, n_layers):
    """A ring of 512 slots split over 2 ranks (256 each; recurrentgemma's
    attention replicated, its RG-LRU width split): a 500-token prefill,
    then teacher-forced decode steps past ring_len. Past position 512 the
    newest slot (t mod 512 < 256) lies on rank 0 while its window's
    oldest (t - 15 mod 512 >= 497) lies on rank 1. Logits within 1e-4 of
    the reference's ring, greedy tokens equal, the joined ring's K/V
    within 1e-4."""
    jcfg, jp, cfg, tree = load(arch, n_layers)
    mesh, ps = _ranks(cfg, tree, 2)
    n0, steps = 500, 520
    assert (steps - 1) % 512 < 256 <= (steps - cfg.window) % 512
    toks = _tokens(1, steps, seed=5)
    ring = S.init_cache(cfg, 1, 4096, F32, mesh, ring=True)
    assert [c["k"].shape[2] for c in ring] == [256, 256]
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks[:, :n0]),
                             _jzeros(cfg, 1, 4096, ring=True))
    jdec = _jdecode(jcfg)
    with torch.no_grad():
        rl, _ = S.prefill(cfg, ps, torch.from_numpy(toks[:, :n0]).long(),
                          ring, mesh)
        for t in range(n0, steps):
            _close(rl, jl, 1e-4)
            assert rl.argmax(-1).tolist() == _argmax(jl), t
            jl, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
            rl, _ = S.decode_step(cfg, ps, torch.from_numpy(toks[:, t]).long(),
                                  ring, mesh)
    _close(rl, jl, 1e-4)
    assert int(ring[0]["length"][0]) == steps
    _hold(ring, jc, keys=[k for k in jc if k != "length"])


def test_windowed_decode_matches_reference():
    """``perf_flags.windowed_decode`` on danube smoke's linear cache of
    1024 slots (past ring_len 512: a cache of at most 512 slots is a ring,
    which takes no windowed read on either side), at tp 1 and at tp 4
    (parts of 256): a 250-token prefill, then 16 steps whose window's 17
    columns cross from rank 0's part into rank 1's while ranks 2 and 3
    hold none of them (fully masked rows). Against the reference's
    windowed decode and the port's full-cache decode at the same tp:
    logits within 1e-4, greedy tokens exact, the joined K/V within 1e-4."""
    jcfg, jp, cfg, tree = load("h2o-danube-3-4b")
    n0, steps, smax = 250, 266, 1024
    toks = _tokens(2, steps, seed=1)
    prompt = torch.from_numpy(toks[:, :n0]).long()
    assert not S.is_ring(cfg, smax)
    _, jc0 = _jprefill(jcfg)(jp, jnp.asarray(toks[:, :n0]),
                             _jzeros(cfg, 2, smax))
    try:
        JPF.set_flags(windowed_decode=True)
        jdec = _jdecode(jcfg, windowed=True)
        for tp in (1, 4):
            mesh, ps = _ranks(cfg, tree, tp)
            full, win = (S.init_cache(cfg, 2, smax, F32, mesh)
                         for _ in range(2))
            assert win[0]["k"].shape[2] == smax // tp
            jc = jc0
            with torch.no_grad():
                for c in (full, win):
                    S.prefill(cfg, ps, prompt, c, mesh)
                for t in range(n0, steps):
                    tok = torch.from_numpy(toks[:, t]).long()
                    jl, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
                    PF.set_flags(windowed_decode=True)
                    wl, _ = S.decode_step(cfg, ps, tok, win, mesh)
                    PF.reset()
                    fl, _ = S.decode_step(cfg, ps, tok, full, mesh)
                    _close(wl, jl, 1e-4)
                    _close(wl, fl, 1e-4)
                    assert _argmax(jl) == wl.argmax(-1).tolist() == \
                        fl.argmax(-1).tolist(), (tp, t)
            _hold(win, jc)
    finally:
        JPF.reset()
        PF.reset()


def test_single_shot_prefill_matches_reference():
    """A cache past 2048 positions takes the single-shot prefill, its
    attention per rank over the rank's own heads: qwen3 (1 layer) at tp 2
    into 2100 slots (two parts of 1050) and at tp 4 into 2102 (4 does not
    divide it: the cache replicates) gives the reference's logits and K/V
    from length 0, then a decode step; from a length above 0 it refuses
    (the reference would ignore the cached prefix)."""
    jcfg, jp, cfg, tree = load("qwen3-8b", 1)
    toks = _tokens(2, 24, seed=2)
    for tp, max_len, parts in ((2, 2100, 2), (4, 2102, 1)):
        mesh, ps = _ranks(cfg, tree, tp)
        tc = S.init_cache(cfg, 2, max_len, F32, mesh)
        assert len(SH.held([c["k"] for c in tc])) == parts
        jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks),
                                 _jzeros(cfg, 2, max_len))
        with torch.no_grad():
            tl, _ = S.prefill(cfg, ps, torch.from_numpy(toks).long(), tc,
                              mesh)
            _close(tl, jl, 1e-4)
            _hold(tc, jc)
            nxt = np.asarray(jl).argmax(-1)
            jl, jc = _jdecode(jcfg)(jp, jnp.asarray(nxt, jnp.int32), jc)
            tl, _ = S.decode_step(cfg, ps, torch.from_numpy(nxt).long(), tc,
                                  mesh)
            _close(tl, jl, 1e-4)
            assert tl.argmax(-1).tolist() == _argmax(jl)
            with pytest.raises(ValueError, match="length 0"):
                S.prefill(cfg, ps, torch.from_numpy(toks).long(), tc, mesh)


# ------------------------------------------------ the builders on a mesh
BUILDER_CASES = [("qwen3-8b", 2064, 1), ("recurrentgemma-2b", 24, 3),
                 ("rwkv6-1.6b", 24, 1), ("llama-3.2-vision-11b", 16, None)]


@pytest.mark.parametrize("arch,s,n_layers", BUILDER_CASES)
def test_prefill_builder_matches_reference(arch, s, n_layers, monkeypatch):
    """Each family's prefill builder at tp 2, its rank caches joined,
    against the reference's builder (logits and every leaf within 1e-4)
    and against the port's tp-1 builder. qwen3 past 2048 tokens runs with
    the route forced to the card and the dense ``flash_prefill`` stubbed
    by its plain version: one launch per attention layer per rank of the
    heads."""
    jcfg, jp, cfg, tree = load(arch, n_layers)
    toks = _tokens(2, s, seed=6)
    ex = _extra(cfg, 2)
    jl, jc = jax.jit(JST.build_prefill_step(jcfg))(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in ex.items()})
    tex = {k: torch.from_numpy(v) for k, v in ex.items()}
    tt = torch.from_numpy(toks).long()
    calls = []
    if s > 2048:
        def fake(q, k, v, softcap=None, window=None, impl="auto"):
            calls.append(tuple(q.shape))
            return KR.flash_prefill_ref(q, k, v, softcap, window)
        monkeypatch.setattr(ops, "_route", lambda x, impl: "cuda"
                            if impl == "auto" else "ref")
        monkeypatch.setattr(ops, "flash_prefill", fake)
    mesh, ps = _ranks(cfg, tree, 2)
    with torch.no_grad():
        tl, tc = ST.build_prefill_step(cfg, mesh=mesh)(ps, tt, tex)
        ol, oc = ST.build_prefill_step(cfg)(tree, tt, tex)
    if s > 2048:
        h, hd = cfg.n_heads // 2, cfg.head_dim
        assert calls == [(2, s, h, hd)] * 2 * cfg.n_layers + \
            [(2, s, 2 * h, hd)] * cfg.n_layers
    _close(tl, jl, 1e-4)
    _close(tl, ol, 1e-4)
    assert sorted(tc[0]) == sorted(jc)
    for key in jc:
        got = _joined(tc, key)
        assert tuple(got.shape) == jc[key].shape, key
        _close(got, jc[key], 1e-4)
        _close(got, oc[key], 1e-4)


def test_decode_cache_of_a_sharded_builder_cache():
    """recurrentgemma (3 layers) at tp 2: a 600-token builder cache (past
    the 512-slot ring), placed by ``decode_cache`` on the mesh into a
    linear cache with room and into a ring, each joined equal bit for bit
    to ``decode_cache`` at tp 1 of the joined builder cache. Then 16
    teacher-forced decode steps on each against the reference's prefill
    of the same 600 tokens into its own linear cache and its decode
    steps: logits within 1e-4, greedy tokens exact, the linear cache's
    joined K/V within 1e-4."""
    jcfg, jp, cfg, tree = load("recurrentgemma-2b", 3)
    toks = _tokens(1, 616, seed=7)
    tt = torch.from_numpy(toks).long()
    mesh, ps = _ranks(cfg, tree, 2)
    dec = ST.build_decode_step(cfg, mesh=mesh)
    jdec = _jdecode(jcfg)
    jl0, jc0 = _jprefill(jcfg)(jp, jnp.asarray(toks[:, :600]),
                               _jzeros(cfg, 1, 640))
    with torch.no_grad():
        tl0, pc = ST.build_prefill_step(cfg, mesh=mesh)(ps, tt[:, :600], {})
        _close(tl0, jl0, 1e-4)
        whole = {k: _joined(pc, k) for k in pc[0]}
        for max_len, ring in ((640, False), (4096, True)):
            dc = ST.decode_cache(cfg, pc, max_len, ring=ring, mesh=mesh)
            want = ST.decode_cache(cfg, whole, max_len, ring=ring)
            assert sorted(dc[0]) == sorted(want)
            for key in want:
                assert torch.equal(_joined(dc, key), want[key]), key
            assert dc[0]["k"].shape[2] == (256 if ring else 320)
            jc = jc0
            for t in range(600, 616):
                tl, dc = dec(ps, tt[:, t], dc)
                jl, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
                _close(tl, jl, 1e-4)
                assert tl.argmax(-1).tolist() == _argmax(jl), (ring, t)
            if not ring:
                _hold(dc, jc)


def test_ring_as_made_equals_builder_then_decode_cache():
    """The attention builder given ``max_len`` / ``ring`` places each
    layer's K/V into the decode cache as the layer makes them: at tp 1
    and 2, danube (swa, 4 layers) over 600 tokens into a ring of 512 and
    into a linear cache of 640, every leaf of every rank equal bit for bit
    to ``decode_cache`` of the stacked builder cache, and the logits to
    the stacked builder's."""
    _, _, cfg, tree = load("h2o-danube-3-4b")
    tt = torch.from_numpy(_tokens(1, 600, seed=8)).long()
    for tp in (1, 2):
        mesh, ps = _ranks(cfg, tree, tp)
        with torch.no_grad():
            lg, stacked = ST.build_prefill_step(cfg, mesh=mesh)(ps, tt, {})
            for max_len, ring in ((4096, True), (640, False)):
                ml, made = ST.build_prefill_step(
                    cfg, mesh=mesh, max_len=max_len, ring=ring)(ps, tt, {})
                want = ST.decode_cache(cfg, stacked, max_len, ring=ring,
                                       mesh=mesh)
                assert torch.equal(ml, lg)
                for got_r, want_r in zip(made, want):
                    assert sorted(got_r) == sorted(want_r)
                    for key in want_r:
                        assert torch.equal(got_r[key], want_r[key]), \
                            (tp, ring, key)
        with pytest.raises(ValueError, match="do not fit"):
            ST.build_prefill_step(cfg, mesh=mesh, max_len=512)(ps, tt, {})
