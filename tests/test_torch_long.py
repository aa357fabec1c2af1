"""The port's long-context path against the JAX package, on the CPU: the
blockwise attention functions, the attention switch past 2048 keys, the
dense cache of every arch, the ring cache, the windowed decode, the
single-shot prefill, the from-scratch prefill builders and the shape
cells.

Both sides run identical seeded weights (numpy, bridged) at the smoke
configs in fp32, on the same numpy inputs; the torch side runs on the
CPU, so every
kernel route takes its plain version. Tolerances are stated per test:
the functions within 2e-5 (values) and 1e-4 of each leaf's max
(gradients), logits and cache tensors within 1e-4, greedy tokens exact.
One JAX program is built per (arch, length)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import steps as JST
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import perf_flags as JPF
from repro.models import serving as JS
from repro.models import transformer as JT
from repro_torch.configs import SHAPES, get_config, list_configs, \
    shape_applicable, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import one_rank
from repro_torch.models import layers as L
from repro_torch.models import perf_flags as PF
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_factory import get_model
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CPU = one_rank(torch.device("cpu"))
ARCHS = list_configs()


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return t.numpy()


@functools.lru_cache(maxsize=None)
def load(arch, n_layers=None):
    """(JAX cfg, JAX params, port cfg, port params) at smoke in fp32,
    optionally cut to ``n_layers``. The weights are drawn once from a
    seed with the reference's distributions (the port's init, which
    ``tests/test_torch_models.py`` holds to the reference's layout) as
    numpy arrays, which both sides take: the JAX side as arrays, the port
    through the bridge. (The JAX init runs op by op, seconds per model.)"""
    jcfg = jget_model(arch, smoke=True).cfg
    cfg = smoke_config(get_config(arch))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tree = _numpy_tree(T.init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.float32, "cpu"))
    if cfg.vision is not None:          # open the cross blocks' tanh gates
        n = len(cfg.cross_attn_layers())
        tree["cross_blocks"]["gate_attn"][:] = np.linspace(0.6, 0.9, n)
        tree["cross_blocks"]["gate_mlp"][:] = np.linspace(-0.7, -0.4, n)
    jp = jax.tree.map(lambda a: jnp.array(a, copy=True), tree)
    assert jax.tree.structure(jp) == jax.tree.structure(jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)))
    return jcfg, jp, cfg, params_from_numpy(cfg, tree, device="cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _extra(cfg, b, seed=3):
    """Seeded modality inputs (numpy), as a request would carry them."""
    rs = np.random.RandomState(seed)
    out = {}
    if cfg.vision is not None:
        out["vision_embeds"] = rs.standard_normal(
            (b, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["frames"] = rs.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _jcache(tc):
    """The reference's cache as copies of the port's zeroed cache (the
    layouts agree: ``test_init_cache_shapes_match_reference``). Copies:
    JAX may alias a numpy buffer and reads it asynchronously, while the
    port writes its cache in place."""
    return {k: jnp.array(v.numpy(), copy=True) for k, v in tc[0].items()}


def _argmax(x):
    return np.asarray(x).argmax(-1).tolist()


@functools.lru_cache(maxsize=None)
def _jprefill(jcfg):
    return jax.jit(functools.partial(JS.prefill, jcfg))


@functools.lru_cache(maxsize=None)
def _jdecode(jcfg, windowed=False):
    """The reference's decode step, jitted; ``perf_flags`` are read when
    it is traced, so a windowed step is a program of its own."""
    return jax.jit(functools.partial(JS.decode_step, jcfg))


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(3, 500, (b, s)).astype(
        np.int32)


# ------------------------------------------------------- the functions
# (causal, window, softcap, q offset, Sk, chunk, grads): GQA throughout;
# causal with a window and a softcap; non-causal over keys padded to whole
# chunks (pad keys at the 2^30 sentinel) at query positions after the
# keys' start; a window over small chunks; one chunk larger than Sk
FLASH_CASES = [(True, 7, 5.0, 0, 40, 16, True),
               (False, None, 4.0, 5, 37, 16, False),
               (True, 9, None, 13, 37, 8, False),
               (True, None, None, 0, 40, 1024, False)]


def _qkv(b, sq, sk, h=4, hkv=2, hd=16, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, sq, h, hd)).astype(np.float32),
            rs.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rs.standard_normal((b, sk, hkv, hd)).astype(np.float32))


def _match(inputs, jfn, tfn, grads, seed=4):
    """Values within 2e-5; with ``grads``, the gradients of sum(out * w)
    against ``jax.grad``, each leaf within 1e-4 of its max."""
    out = np.asarray(jfn(*inputs))
    _close(tfn(*map(torch.from_numpy, inputs)), out, 2e-5)
    if not grads:
        return
    w = np.random.RandomState(seed).standard_normal(out.shape).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                          argnums=(0, 1, 2)))(*map(jnp.asarray, inputs))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    (tfn(*ts) * torch.from_numpy(w)).sum().backward()
    for g_t, g_j in zip(ts, jg):
        g_j = np.asarray(g_j)
        _close(g_t.grad, g_j, 1e-4 * max(np.abs(g_j).max(), 1e-30))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    causal, window, cap, off, sk, chunk, grads = case
    b, sq = 2, 24
    qp = np.broadcast_to(off + np.arange(sq, dtype=np.int32), (b, sq))
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))

    @jax.jit
    def jfn(q, k, v):
        return JL.flash_attention(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                  window=window, softcap=cap, chunk=chunk,
                                  causal=causal)

    def tfn(q, k, v):
        return L.flash_attention(q, k, v, torch.from_numpy(qp.copy()),
                                 torch.from_numpy(kp.copy()), window, cap,
                                 chunk=chunk, causal=causal)
    _match(_qkv(b, sq, sk), jfn, tfn, grads)


@pytest.mark.parametrize("window,cap,q_block,grads", [(12, None, 16, False),
                                                      (20, 4.0, 32, True)])
def test_banded_swa_matches_reference(window, cap, q_block, grads):
    """Values (and gradients) against the reference's banded form, values
    against the plain masked attention it replaces."""
    inputs = _qkv(2, 64, 64, seed=2)

    @jax.jit
    def jfn(q, k, v):
        return JL.banded_swa_attention(q, k, v, window, softcap=cap,
                                       q_block=q_block)

    def tfn(q, k, v):
        return L.banded_swa_attention(q, k, v, window, cap, q_block)
    _match(inputs, jfn, tfn, grads)
    q, k, v = map(torch.from_numpy, inputs)
    pos = torch.arange(q.shape[1]).expand(q.shape[0], -1)
    _close(tfn(q, k, v), L.attention(q, k, v, L.causal_mask(pos, pos, window),
                                     cap), 2e-5)


def test_banded_branch_through_self_attention(monkeypatch):
    """``perf_flags.banded_swa_prefill``: an ``swa`` arch's causal
    attention past window + 1024 keys in ``self_attention`` takes the
    banded form (called once), and gives the reference's
    ``_self_attention`` under the same flag and the blockwise form
    without it, within 2e-5; a global arch keeps the blockwise form."""
    calls = []
    banded = L.banded_swa_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return banded(*a, **kw)
    monkeypatch.setattr(L, "banded_swa_attention", spy)
    cfg = smoke_config(get_config("h2o-danube-3-4b"))
    jcfg = jget_model("h2o-danube-3-4b", smoke=True).cfg
    s = 2048            # past window + 1024, whole query blocks of 1024
    q, k, v = _qkv(1, s, s, seed=5)
    pos = np.arange(s, dtype=np.int32)[None]
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    plain = T.self_attention(cfg, tq, tk, tv, tpos, tpos, cfg.window, "flash")
    try:
        PF.set_flags(banded_swa_prefill=True)
        JPF.set_flags(banded_swa_prefill=True)
        got = T.self_attention(cfg, tq, tk, tv, tpos, tpos, cfg.window,
                               "flash")
        assert len(calls) == 1
        want = jax.jit(lambda q, k, v: JT._self_attention(
            jcfg, q, k, v, jnp.asarray(pos), jnp.asarray(pos), cfg.window,
            "flash", False))(q, k, v)
        qwen = smoke_config(get_config("qwen3-8b"))
        T.self_attention(qwen, tq, tk, tv, tpos, tpos, None, "flash")
        assert len(calls) == 1
    finally:
        PF.reset()
        JPF.reset()
    _close(got, want, 2e-5)
    _close(got, plain, 2e-5)


def test_perf_flags_match_reference():
    """The reference's four fields, all off; the one the port has no
    reader for refuses to be set."""
    assert PF.PerfFlags() == PF.PerfFlags(**dataclasses.asdict(
        JPF.PerfFlags()))
    assert dataclasses.asdict(PF.get()) == dataclasses.asdict(JPF.get())
    with pytest.raises(NotImplementedError, match="chunked_ce"):
        PF.set_flags(chunked_ce=True)
    assert PF.get() == PF.PerfFlags()


# --------------------------------------------------- the attention switch
# one arch of each family with attention (MoE: mixtral; the dense one,
# qwen3, past the 2048-key switch under "auto", where it is the blockwise
# form); the weights are shared with the other tests of each arch
FORWARD_CASES = [("mixtral-8x7b", 24, "flash", None),
                 ("recurrentgemma-2b", 40, "flash", 3),
                 ("seamless-m4t-large-v2", 24, "flash", None),
                 ("llama-3.2-vision-11b", 24, "flash", None),
                 ("qwen3-8b", 2064, "auto", 1)]


@pytest.mark.parametrize("arch,s,attn_impl,n_layers", FORWARD_CASES)
def test_forward_flash_matches_reference(arch, s, attn_impl, n_layers):
    jcfg, jp, cfg, tp = load(arch, n_layers)
    toks = _tokens(1, s)
    ex = _extra(cfg, 1)
    want = jax.jit(functools.partial(JT.forward, jcfg, attn_impl=attn_impl))(
        jp, jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in ex.items()})
    got = T.forward(cfg, tp, torch.from_numpy(toks).long(),
                    attn_impl=attn_impl,
                    **{k: torch.from_numpy(v) for k, v in ex.items()})
    _close(got, want, 1e-4)


def test_kernel_route_past_the_switch(monkeypatch):
    """With the route forced to the card (CPU tensors; ``impl="ref"``
    keeps the plain route), the causal attention past 2048 keys launches
    the dense ``flash_prefill`` entry once per attention layer, with the
    layer's window and the softcap; up to 2048 keys, and for the
    bidirectional encoder, it launches nothing; a forward at other
    positions refuses the route."""
    calls = []

    def fake(q, k, v, softcap=None, window=None, impl="auto"):
        calls.append((q.shape[1], softcap, window))
        return KR.flash_prefill_ref(q, k, v, softcap, window)
    monkeypatch.setattr(ops, "_route", lambda x, impl: "cuda"
                        if impl == "auto" else "ref")
    monkeypatch.setattr(ops, "flash_prefill", fake)
    cfg = dataclasses.replace(smoke_config(get_config("gemma2-9b")),
                              n_layers=2)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                      "cpu")
    with torch.no_grad():
        T.forward(cfg, p, torch.randint(3, 500, (1, 2049)))
        assert calls == [(2049, 50.0, 16), (2049, 50.0, None)]
        with pytest.raises(NotImplementedError, match="positions"):
            T.forward(cfg, p, torch.randint(3, 500, (1, 2049)),
                      positions=torch.arange(2049)[None] + 1)
        calls.clear()
        T.forward(cfg, p, torch.randint(3, 500, (1, 2048)))
        enc = smoke_config(get_config("seamless-m4t-large-v2"))
        pe = T.init_params(enc, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
        T.encode(enc, [pe], torch.randn(1, 2100, enc.d_model), CPU)
    assert calls == []


# ------------------------------------------------- the dense cache
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes_match_reference(arch):
    jcfg = jget_model(arch, smoke=True).cfg
    cfg = smoke_config(get_config(arch))
    rings = (False, True) if cfg.attn_kind in ("swa", "hybrid_rglru") \
        else (False,)
    for ring, max_len in ((r, n) for r in rings for n in (64, 3000)):
        want = jax.eval_shape(lambda: JS.init_cache(
            jcfg, 2, max_len, jnp.float32, ring=ring))
        got, = S.init_cache(cfg, 2, max_len, torch.float32, CPU, ring=ring)
        assert sorted(got) == sorted(want)
        for key, leaf in want.items():
            assert tuple(got[key].shape) == leaf.shape, (key, ring, max_len)
            assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype)
    if len(rings) == 1:
        with pytest.raises(ValueError, match="ring"):
            S.init_cache(cfg, 2, 64, torch.float32, CPU, ring=True)


@pytest.mark.parametrize("arch", ["gemma2-9b", "h2o-danube-3-4b",
                                  "mixtral-8x7b"])
def test_prefill_decode_match_reference(arch):
    """The three archs the port's dense cache refused before: a 32-token
    prefill (past the smoke window of 16), then decode steps, every
    logits row within 1e-4 of the reference's, greedy tokens exact."""
    jcfg, jp, cfg, tp = load(arch)
    toks = _tokens(2, 32, seed=1)
    tc = S.init_cache(cfg, 2, 64, torch.float32, CPU)
    jc = _jcache(tc)
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc)
    tl, _ = S.prefill(cfg, [tp], torch.from_numpy(toks).long(), tc, CPU)
    jdec = _jdecode(jcfg)
    for _ in range(8):
        _close(tl, jl, 1e-4)
        nxt = np.asarray(jl)[:, :jcfg.vocab_size].argmax(-1)
        assert nxt.tolist() == tl[:, :cfg.vocab_size].argmax(-1).tolist()
        jl, jc = jdec(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, _ = S.decode_step(cfg, [tp], torch.from_numpy(nxt).long(), tc,
                              CPU)
    _close(tc[0]["k"], jc["k"], 1e-4)


@pytest.mark.parametrize("arch,n_layers", [("h2o-danube-3-4b", None),
                                           ("recurrentgemma-2b", 3)])
def test_ring_decode_matches_reference_and_linear(arch, n_layers):
    """A ring cache (ring_len 512 at smoke) filled from length 0: a 500-token
    prefill (positions below ring_len sit at their own slots), then
    teacher-forced decode steps past ring_len, against the reference's
    ring and then against the port's linear cache with room: logits
    within 1e-4, greedy tokens equal, the ring's K/V within 1e-4."""
    jcfg, jp, cfg, tp = load(arch, n_layers)
    assert S.ring_len(cfg) == JS.ring_len(jcfg) == 512
    n0, steps = 500, 520
    toks = _tokens(1, steps, seed=5)
    ring = S.init_cache(cfg, 1, 4096, torch.float32, CPU, ring=True)
    jc = _jcache(ring)
    lin = S.init_cache(cfg, 1, steps + 8, torch.float32, CPU)
    assert ring[0]["k"].shape[2] == 512 and not S.is_ring(cfg, steps + 8)
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks[:, :n0]), jc)
    prompt = torch.from_numpy(toks[:, :n0]).long()
    rl, _ = S.prefill(cfg, [tp], prompt, ring, CPU)
    ll, _ = S.prefill(cfg, [tp], prompt, lin, CPU)
    jdec = _jdecode(jcfg)
    for t in range(n0, steps):
        _close(rl, jl, 1e-4)
        _close(rl, ll, 1e-4)
        assert rl.argmax(-1).tolist() == ll.argmax(-1).tolist() == \
            _argmax(jl), t
        tok = torch.from_numpy(toks[:, t]).long()
        jl, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
        rl, _ = S.decode_step(cfg, [tp], tok, ring, CPU)
        ll, _ = S.decode_step(cfg, [tp], tok, lin, CPU)
    assert int(ring[0]["length"][0]) == steps > 512
    _close(ring[0]["k"], jc["k"], 1e-4)


def test_windowed_decode_matches_reference():
    """``tests/test_perf_opts.py::test_windowed_decode_equals_full``'s
    setting (danube smoke, B 2, a 64-slot cache, 32-token prefill, 8
    steps): the windowed decode against the reference's windowed decode
    and against the port's full-cache decode, each within 2e-4."""
    jcfg, jp, cfg, tp = load("h2o-danube-3-4b")
    toks = _tokens(2, 40, seed=1)
    c1 = S.init_cache(cfg, 2, 64, torch.float32, CPU)
    jc = _jcache(c1)
    c2 = S.init_cache(cfg, 2, 64, torch.float32, CPU)
    _, jc = _jprefill(jcfg)(jp, jnp.asarray(toks[:, :32]), jc)
    for c in (c1, c2):
        S.prefill(cfg, [tp], torch.from_numpy(toks[:, :32]).long(), c, CPU)
    try:
        JPF.set_flags(windowed_decode=True)
        PF.set_flags(windowed_decode=True)
        jdec = _jdecode(jcfg, windowed=True)
        for t in range(32, 40):
            tok = torch.from_numpy(toks[:, t]).long()
            jl, jc = jdec(jp, jnp.asarray(toks[:, t]), jc)
            wl, _ = S.decode_step(cfg, [tp], tok, c2, CPU)
            PF.reset()
            fl, _ = S.decode_step(cfg, [tp], tok, c1, CPU)
            PF.set_flags(windowed_decode=True)
            _close(wl, jl, 2e-4)
            _close(wl, fl, 2e-4)
    finally:
        JPF.reset()
        PF.reset()


@pytest.mark.parametrize("arch", ["qwen3-8b"])
def test_single_shot_prefill_matches_reference(arch):
    """A cache past 2048 positions takes the single-shot prefill: from
    length 0 it gives the reference's logits and K/V; from a length above
    0 it refuses (the reference would ignore the cached prefix)."""
    jcfg, jp, cfg, tp = load(arch, 1)
    toks = _tokens(2, 24, seed=2)
    tc = S.init_cache(cfg, 2, 2100, torch.float32, CPU)
    jc = _jcache(tc)
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc)
    tl, _ = S.prefill(cfg, [tp], torch.from_numpy(toks).long(), tc, CPU)
    _close(tl, jl, 1e-4)
    for key in jc:
        _close(tc[0][key], jc[key], 1e-4)
    with pytest.raises(ValueError, match="length 0"):
        S.prefill(cfg, [tp], torch.from_numpy(toks).long(), tc, CPU)


def test_slot_engine_refuses_a_cache_past_2048():
    """The slot engine keeps its chunked prefill on the joint path: a slot
    TE with an attention cache past 2048 positions is refused (the
    single-shot branch would drop a sequence's cached chunks); rwkv,
    with no attention cache, takes any length."""
    from repro_torch.engine.runners.slot import SlotRunner
    for arch, ok in (("recurrentgemma-2b", False),
                     ("seamless-m4t-large-v2", False), ("rwkv6-1.6b", True)):
        cfg = smoke_config(get_config(arch))
        p = T.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
        if ok:
            SlotRunner(cfg, [p], 2, 4096, torch.float32, CPU)
            continue
        SlotRunner(cfg, [p], 2, 2048, torch.float32, CPU)
        with pytest.raises(ValueError, match="2048"):
            SlotRunner(cfg, [p], 2, 2049, torch.float32, CPU)


def test_full_linear_cache_refuses_decode():
    """Defect 2 of the reference: decoding at the last position of a
    linear cache would drop the new token's K/V. The bundle's decode and
    the decode builder refuse it, on a builder's cache too, and decode
    once the cache has room; ``serving.decode_step`` itself reads nothing
    on the host and drops the write, as the reference does."""
    b = get_model("qwen3-8b", smoke=True)
    cfg = b.cfg
    p = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                      "cpu")
    c = S.init_cache(cfg, 2, 8, torch.float32, CPU)
    toks = torch.randint(3, 500, (2, 8))
    S.prefill(cfg, [p], toks, c, CPU)
    with pytest.raises(ValueError, match="full"):
        b.decode_step(cfg, [p], toks[:, 0], c, CPU)
    k0 = c[0]["k"].clone()
    S.decode_step(cfg, [p], toks[:, 0], c, CPU)
    assert torch.equal(c[0]["k"], k0) and c[0]["length"].tolist() == [9, 9]
    _, cache = ST.build_prefill_step(cfg)(p, toks, {})
    dec = ST.build_decode_step(cfg)
    with pytest.raises(ValueError, match="full"):
        dec(p, toks[:, 0], cache)
    roomy = ST.decode_cache(cfg, cache, 16)
    lg, roomy = dec(p, toks[:, 0], roomy)
    assert roomy["length"].tolist() == [9, 9]


# --------------------------------------------------- the prefill builders
BUILDER_CASES = [("qwen3-8b", 2064, 1), ("rwkv6-1.6b", 24, 1),
                 ("recurrentgemma-2b", 24, 3),
                 ("seamless-m4t-large-v2", 16, None),
                 ("llama-3.2-vision-11b", 16, None)]


@pytest.mark.parametrize("arch,s,n_layers", BUILDER_CASES)
def test_prefill_builder_matches_reference(arch, s, n_layers):
    jcfg, jp, cfg, tp = load(arch, n_layers)
    toks = _tokens(2, s, seed=6)
    ex = _extra(cfg, 2)
    jl, jc = jax.jit(JST.build_prefill_step(jcfg))(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in ex.items()})
    tl, tc = ST.build_prefill_step(cfg)(
        tp, torch.from_numpy(toks).long(),
        {k: torch.from_numpy(v) for k, v in ex.items()})
    _close(tl, jl, 1e-4)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key], 1e-4)


def test_ring_placement_of_a_builder_cache():
    """recurrentgemma smoke: a 600-token from-scratch prefill (past the
    512-slot ring), its last 512 positions placed at slot t mod 512 of a
    ring (``decode_cache``'s default under
    ``perf_flags.ring_buffer_decode``), decodes as the same cache placed
    linearly with room."""
    _, _, cfg, tp = load("recurrentgemma-2b", 3)
    toks = torch.from_numpy(_tokens(1, 616, seed=7)).long()
    lg, cache = ST.build_prefill_step(cfg)(tp, toks[:, :600], {})
    try:
        # the reference dry run's choice: a ring under the flag
        PF.set_flags(ring_buffer_decode=True)
        ring = ST.decode_cache(cfg, cache, 4096)
    finally:
        PF.reset()
    lin = ST.decode_cache(cfg, cache, 640)
    assert ring["k"].shape[2] == 512 and lin["k"].shape[2] == 640
    dec = ST.build_decode_step(cfg)
    for t in range(600, 616):
        rl, ring = dec(tp, toks[:, t], ring)
        ll, lin = dec(tp, toks[:, t], lin)
        _close(rl, ll, 1e-5)
        assert rl.argmax(-1).tolist() == ll.argmax(-1).tolist()


# --------------------------------------------------------- the shapes
def test_shape_cells_match_reference():
    cells = [(a, s) for a in ARCHS for s in SHAPES]
    assert len(cells) == 40
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    got = [(a, s) for a, s in cells
           if not shape_applicable(get_config(a), SHAPES[s])[0]]
    want = [(a, s) for a, s in cells
            if not jshape_applicable(jget_config(a), JSHAPES[s])[0]]
    assert got == want
    assert sorted({a for a, _ in got}) == [
        "granite-moe-3b-a800m", "llama-3.2-vision-11b", "nemotron-4-15b",
        "qwen3-8b", "seamless-m4t-large-v2"]
    assert all(s == "long_500k" for _, s in got)
    for a in ARCHS:
        assert get_config(a).subquadratic == jget_config(a).subquadratic


def test_example_batch_and_microbatches_match_reference():
    for a in ARCHS:
        cfg, jcfg = get_config(a), jget_config(a)
        assert ST.default_microbatches(cfg) == JST.default_microbatches(jcfg)
        for s in SHAPES:
            got = ST.example_batch(cfg, SHAPES[s])
            want = JST.example_batch(jcfg, JSHAPES[s])
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())


def test_bundle_serves_every_arch():
    """``get_model(arch)``'s init_cache / prefill / decode_step run for all
    ten configs at smoke width (three of them raised before), with a ring
    for the archs that take one."""
    for a in ARCHS:
        b = get_model(a, smoke=True)
        p = b.init_params(torch.Generator().manual_seed(0), torch.float32,
                          "cpu")
        ring = b.cfg.attn_kind in ("swa", "hybrid_rglru")
        c = b.init_cache(2, 32, torch.float32, "cpu", ring=ring)
        ex = {k: torch.from_numpy(v) for k, v in _extra(b.cfg, 2).items()}
        lg, _ = b.prefill(b.cfg, [p], torch.randint(3, 500, (2, 8)), c, CPU,
                          **ex)
        lg2, _ = b.decode_step(b.cfg, [p], lg.argmax(-1), c, CPU)
        assert torch.isfinite(lg2).all() and c[0]["length"].tolist() == \
            [9, 9], a
