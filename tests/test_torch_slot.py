"""The port's slot family (rwkv6, recurrentgemma) against the JAX package,
on the CPU.

Both sides run identical weights: the JAX smoke init (fp32), bridged. The
torch side runs with ``device="cpu"``, so its recurrences take the WKV6
and RG-LRU kernels' plain versions. Held here, each on numpy inputs from a
fixed seed, with the tolerance stated in the test:

  * configs, the weight bridge and the port's own init layout;
  * the rwkv time mix / channel mix and the RG-LRU block with a masked
    tail (``n_valid``), within 1e-5;
  * teacher-forced logits, and slot ``prefill`` + ``decode_step`` logits
    against ``repro/models/serving.py``, within 2e-3;
  * the port's ``FlowServe`` against the JAX ``FlowServe`` on the setup of
    ``tests/test_prefill_batching.py`` (4 slots, max_len 64, chunk 8):
    EXACT greedy tokens on ``RAGGED[:4]`` and ``_prompts(3)``, through a
    state-checkpoint prefix hit, and on reused slots (stale state must not
    leak).
One JAX TE per model serves every engine case, so its shapes compile
once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro.models import rglru as JG
from repro.models import rwkv6 as JR
from repro.models import serving as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.runners import resolve_family
from repro_torch.launch.mesh import one_rank
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
CPU = one_rank(torch.device("cpu"))     # one weights tree on one rank
SHARED = dict(n_slots=4, max_len=64, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


# tests/test_prefill_batching.py's ragged mix: 1-token prompt, tiny, one
# chunk exactly, chunk boundary + 1
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12))]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        bundle = get_model(arch, smoke=True)
        jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
        cfg = smoke_config(get_config(arch))
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        out[arch] = (bundle, jp, cfg, tp)
    return out


@pytest.fixture(scope="module")
def pairs(models):
    """One (JAX TE, torch TE) pair per model, reused by every engine case.
    Both TEs always see the same traffic in the same order, so their slot
    assignments and state-checkpoint caches stay in step."""
    return {arch: (JFlowServe(bundle, jp, JEngineConfig(**SHARED)),
                   FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu"))
            for arch, (bundle, jp, cfg, tp) in models.items()}


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _sp(cls, max_new=8):
    return cls(temperature=0.0, max_new_tokens=max_new, stop_on_eos=False)


def _serve_both(pair, tag, prompts, max_new=8):
    jte, tte = pair
    ids = [f"{tag}{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        jte.add_request(JRequest(prompt_tokens=p, req_id=rid,
                                 sampling=_sp(JSamplingParams, max_new)))
        tte.add_request(Request(prompt_tokens=p, req_id=rid,
                                sampling=_sp(SamplingParams, max_new)))
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert sorted(want) == sorted(ids)
    return [got.get(i) for i in ids], [want[i] for i in ids]


# ---------------------------------------------------------------------------
# configs, bridge, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(models, arch):
    bundle, _, cfg, _ = models[arch]
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "window", "attn_kind",
              "mlp_act", "norm", "embed_scale", "tie_embeddings",
              "rope_theta"):
        assert getattr(cfg, f) == getattr(bundle.cfg, f), f
    assert cfg.layer_kinds() == bundle.cfg.layer_kinds()
    assert cfg.param_count() == bundle.cfg.param_count()
    full = get_config(arch)
    from repro.configs import get_config as jget
    assert full.param_count() == jget(arch).param_count()
    assert full.layer_kinds() == jget(arch).layer_kinds()
    assert resolve_family(cfg).name == "slot"
    assert resolve_family(get_config("qwen3-8b")).name == "paged"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_tree_and_values(models, arch):
    _, jp, _, tp = models[arch]
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert sorted(jl, key=str) == sorted(tl, key=str)
    for path, leaf in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(models, arch):
    """The port's own init draws the same tree, shapes and dtypes as the
    JAX init at bf16 (values differ: torch vs threefry bits)."""
    bundle, _, cfg, _ = models[arch]
    jp = bundle.init_params(jax.random.PRNGKey(1), jnp.bfloat16)
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            _leaves(jax.tree.map(np.asarray, jp))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves(T.init_params(cfg, torch.Generator(),
                                             torch.bfloat16, "cpu"))}
    assert got == want


# ---------------------------------------------------------------------------
# blocks with a masked tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [None, 5])
def test_rwkv_mixes_match_reference(models, n_valid):
    """Time mix (with a random carried state and last input) and channel
    mix of layer 0 on an 8-token chunk, against ``rwkv_time_mix(...,
    chunked=True)`` / ``rwkv_channel_mix``: outputs, state and carried
    inputs within 1e-5 (fp32; chunked vs sequential sums)."""
    _, jp, cfg, tp = models["rwkv6-1.6b"]
    hd, d = cfg.rwkv.head_dim, cfg.d_model
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 8, d)).astype(np.float32)
    st = (rs.standard_normal((2, d // hd, hd, hd)) * 0.3).astype(np.float32)
    last = rs.standard_normal((2, d)).astype(np.float32)
    jtm = jax.tree.map(lambda a: a[0], jp["blocks"])["tm"]
    ttm = T.layer(tp, 0)["tm"]
    time_mix = jax.jit(JR.rwkv_time_mix, static_argnums=2,
                       static_argnames="n_valid")
    wy, wst, wl = time_mix(jtm, jnp.asarray(x), hd, jnp.asarray(st),
                           jnp.asarray(last), n_valid=n_valid)
    state = torch.from_numpy(st.copy())
    gy, (gst,), gl = R.rwkv_time_mix([ttm], torch.from_numpy(x), hd,
                                     [state], torch.from_numpy(last), CPU,
                                     n_valid=n_valid)
    for g, w in ((gy, wy), (gst, wst), (gl, wl)):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5)
    wy, wl = jax.jit(JR.rwkv_channel_mix, static_argnames="n_valid")(
        jtm, jnp.asarray(x), jnp.asarray(last), n_valid=n_valid)
    gy, gl = R.rwkv_channel_mix([ttm], torch.from_numpy(x),
                                torch.from_numpy(last), CPU, cfg.d_ff,
                                n_valid=n_valid)
    np.testing.assert_allclose(_f32(gy), _f32(wy), atol=1e-5)
    np.testing.assert_allclose(_f32(gl), _f32(wl), atol=1e-5)


@pytest.mark.parametrize("n_valid,decode", [(None, False), (5, False),
                                            (None, True)])
def test_rglru_block_matches_reference(models, n_valid, decode):
    """The Griffin recurrent block of layer 0 from a random (h, conv) state:
    the associative scan (with a masked tail) or the single decode step of
    the reference against the port's sequential recurrence; output, final
    h and conv state within 1e-5 (fp32)."""
    _, jp, cfg, tp = models["recurrentgemma-2b"]
    w, cw, d = cfg.rglru.lru_width, cfg.rglru.conv1d_width, cfg.d_model
    t = 1 if decode else 8
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, t, d)).astype(np.float32)
    h0 = rs.standard_normal((2, w)).astype(np.float32)
    conv = rs.standard_normal((2, cw - 1, w)).astype(np.float32)
    block = jax.jit(JG.rglru_block_apply,
                    static_argnames=("decode", "n_valid"))
    want = block(jp["rglru_blocks"][0]["rec"], jnp.asarray(x),
                 jnp.asarray(h0), jnp.asarray(conv), decode=decode,
                 n_valid=n_valid)
    y, (h,), (c,) = G.rglru_block_apply(
        [tp["rglru_blocks"][0]["rec"]], torch.from_numpy(x),
        [torch.from_numpy(h0)], [torch.from_numpy(conv)], CPU,
        n_valid=n_valid)
    for g, wv in zip((y, h, c), want):
        np.testing.assert_allclose(_f32(g), _f32(wv), atol=1e-5)


# ---------------------------------------------------------------------------
# whole towers: teacher-forced, and the serving entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Teacher-forced logits (zero initial states) against
    ``T.forward(attn_impl="naive")`` within 2e-4 (fp32; the reference's
    chunked WKV and associative scan sum in another order)."""
    bundle, jp, cfg, tp = models[arch]
    tokens = np.random.RandomState(5).randint(3, cfg.vocab_size, (2, 24))
    want = JT.forward(bundle.cfg, jp, jnp.asarray(tokens), attn_impl="naive")
    got = T.forward(cfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference(models, arch):
    """Two slots: a 21-token prompt in pow2-bucketed chunks of 8, 8 and 5
    (padded to 8, ``n_valid`` 5), then 4 greedy decode steps, through the
    port's ``serving.prefill``/``decode_step`` and the JAX ones: every
    logits row within 2e-3 (fp32), and the cache lengths equal."""
    bundle, jp, cfg, tp = models[arch]
    jprefill = jax.jit(lambda p, t, c, nv: JS.prefill(bundle.cfg, p, t, c,
                                                      n_valid=nv))
    jdecode = jax.jit(lambda p, t, c: JS.decode_step(bundle.cfg, p, t, c))
    prompt = np.random.RandomState(6).randint(3, cfg.vocab_size, (2, 21))
    jc = bundle.init_cache(2, 64, jnp.float32)
    tc = S.init_cache(cfg, 2, 64, torch.float32, CPU)
    for a in range(0, 21, 8):
        chunk = prompt[:, a:a + 8]
        nv = chunk.shape[1]
        padded = np.zeros((2, 8), np.int64)
        padded[:, :nv] = chunk
        wl, jc = jprefill(jp, jnp.asarray(padded, jnp.int32), jc,
                          jnp.int32(nv))
        gl, tc = S.prefill(cfg, [tp], torch.from_numpy(padded), tc, CPU,
                           n_valid=nv)
        np.testing.assert_allclose(_f32(gl), _f32(wl), atol=2e-3)
    tok = np.asarray(jnp.argmax(wl[:, :bundle.cfg.vocab_size], -1), np.int64)
    for _ in range(4):
        wl, jc = jdecode(jp, jnp.asarray(tok, jnp.int32), jc)
        gl, tc = S.decode_step(cfg, [tp], torch.from_numpy(tok), tc, CPU)
        np.testing.assert_allclose(_f32(gl), _f32(wl), atol=2e-3)
        tok = np.asarray(jnp.argmax(wl[:, :bundle.cfg.vocab_size], -1),
                         np.int64)
    assert tc[0]["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [25, 25]


# ---------------------------------------------------------------------------
# the engine: exact greedy tokens against the JAX FlowServe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mix", ["ragged", "prompts"])
def test_flowserve_greedy_parity(pairs, arch, mix):
    prompts = RAGGED if mix == "ragged" else _prompts(3)
    got, want = _serve_both(pairs[arch], f"{mix}-", prompts)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_state_checkpoint_prefix_hit(pairs, arch):
    """A finished request leaves a state checkpoint keyed by the tokens it
    covered; a later prompt that extends that key resumes from it (on both
    engines) and gives the JAX TE's tokens exactly."""
    jte, tte = pairs[arch]
    base = _prompts(1, length=13, seed0=70)[0]
    (first,), _ = _serve_both(pairs[arch], "ckpt-a", [base])
    ext = base + first + [9, 4, 11]
    n_hits = []
    for te, req in ((jte, JRequest), (tte, Request)):
        sp = _sp(JSamplingParams if te is jte else SamplingParams)
        te.add_request(req(prompt_tokens=ext, req_id="ckpt-b", sampling=sp))
        n_hits.append(te._seqs["ckpt-b"].n_cached)
    assert n_hits[0] == n_hits[1] == len(base) + len(first) - 1
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert got == want and len(got["ckpt-b"]) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slots_do_not_leak_state(models, pairs, arch):
    """Fill every slot, then serve new prompts on the freed (stale) slots:
    the tokens equal the JAX TE's and a fresh TE's."""
    _serve_both(pairs[arch], "fill-", _prompts(4, seed0=40))
    prompts = _prompts(4, length=9, seed0=50)
    got, want = _serve_both(pairs[arch], "reuse-", prompts)
    _, _, cfg, tp = models[arch]
    fresh = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    for i, p in enumerate(prompts):
        fresh.add_request(Request(prompt_tokens=p, req_id=f"f{i}",
                                  sampling=_sp(SamplingParams)))
    comps = {c.req_id: c.tokens for c in fresh.run_to_completion()}
    assert got == want == [comps[f"f{i}"] for i in range(len(prompts))]


# ---------------------------------------------------------------------------
# engine behaviour of the port alone
# ---------------------------------------------------------------------------


def test_slot_engine_counts_and_limits(models):
    """Stochastic rows serve valid tokens; decode samples one token per
    live slot per step with one host fetch; the paged warmups do nothing
    here; a request longer than a slot is refused."""
    _, _, cfg, tp = models["recurrentgemma-2b"]
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    assert te.warmup_decode() == 0 and te.warmup_prefill() == 0
    assert te.pool is None and te.rtc is None
    for i, p in enumerate(_prompts(4)):
        te.add_request(Request(prompt_tokens=p, req_id=f"s{i}",
                               sampling=SamplingParams(
                                   temperature=0.9 if i % 2 else 0.0,
                                   top_p=0.9, max_new_tokens=6,
                                   stop_on_eos=False)))
    comps = te.run_to_completion()
    assert len(comps) == 4
    for c in comps:
        assert len(c.tokens) == 6
        assert all(0 <= t < cfg.vocab_size for t in c.tokens)
    # slot prefill covers n_prompt - 1 tokens; decode samples all 6
    assert te.decode_tokens == 4 * 6
    assert te.host_syncs == te.decode_steps
    assert sorted(te.runner.free_slots) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="max_len"):
        te.add_request(Request(prompt_tokens=[1] * 60,
                               sampling=SamplingParams(max_new_tokens=8)))
