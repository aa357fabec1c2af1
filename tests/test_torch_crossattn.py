"""The port's cross-attention towers (seamless-m4t-large-v2 enc-dec and
llama-3.2-vision-11b VLM) against the JAX package, on the CPU.

Both sides run identical weights: the JAX smoke init (fp32) with the VLM
cross blocks' gates set non-zero (the init's zero gates make tanh(0) = 0
hide the whole cross path), bridged. Every case feeds seeded non-zero
modality inputs (``vision_embeds`` / ``frames``), except the one that
checks the default zero inputs. Held here, each on numpy inputs from a
fixed seed, with the tolerance stated in the test:

  * configs, the weight bridge and the port's own init layout;
  * ``memory_kv`` and ``cross_block_apply`` (gated and ungated), within
    1e-5;
  * ``encode`` at 24 frames, and at 2304 frames, past the reference's
    2048-frame switch to its chunked flash attention, within 1e-4;
  * teacher-forced logits within 1e-4;
  * slot ``prefill`` + ``decode_step`` logits against
    ``repro/models/serving.py`` and against the port's own ``forward``,
    within 2e-3, up to the cache's last slot;
  * the port's ``FlowServe`` against the JAX ``FlowServe`` on the setup of
    ``tests/test_torch_slot.py`` (4 slots, max_len 64, chunk 8): EXACT
    greedy tokens on the ragged mix and ``_prompts(3)``, on reused slots,
    through a state-checkpoint prefix hit, on the default zero inputs,
    on two requests that share a prompt prefix but not their modality
    inputs (the checkpoint key is the token prefix alone, in both), and
    on a long prompt prefilled while a short one decodes (the all-slot
    decode step advances the mid-prefill slot, in both).
One JAX TE per model serves every engine case, so its shapes compile
once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro.models import serving as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.runners import resolve_family
from repro_torch.launch.mesh import one_rank
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VLM, ENCDEC]
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


def _mem_key(cfg):
    return "vision_embeds" if cfg.vision is not None else "frames"


def _mem(cfg, seed, batch=1, n=None):
    """Seeded modality memory (batch, P, D), fp32."""
    p = n or (cfg.vision.n_patches if cfg.vision is not None
              else cfg.encoder.n_frames)
    return np.random.RandomState(seed).standard_normal(
        (batch, p, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        bundle = get_model(arch, smoke=True)
        jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
        if "gate_attn" in jp["cross_blocks"]:
            n = jp["cross_blocks"]["gate_attn"].shape[0]
            jp["cross_blocks"]["gate_attn"] = jnp.linspace(0.6, 0.9, n)
            jp["cross_blocks"]["gate_mlp"] = jnp.linspace(-0.7, -0.4, n)
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


def _submit(te, req_cls, sp_cls, rid, prompt, extra, max_new=8):
    te.add_request(req_cls(prompt_tokens=prompt, req_id=rid,
                           sampling=_sp(sp_cls, max_new),
                           extra=dict(extra)))


def _serve_both(pair, tag, prompts, seeds, max_new=8):
    """Serve ``prompts`` on both TEs, request i with the modality memory
    of seed ``seeds[i]`` (None: no ``extra``, so the engines' zeros)."""
    jte, tte = pair
    ids = [f"{tag}{i}" for i in range(len(prompts))]
    for rid, p, seed in zip(ids, prompts, seeds):
        extra = {} if seed is None else {_mem_key(tte.cfg): _mem(tte.cfg,
                                                                 seed)}
        _submit(jte, JRequest, JSamplingParams, rid, p, extra, max_new)
        _submit(tte, Request, SamplingParams, rid, p, extra, max_new)
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
              "d_ff", "vocab_size", "padded_vocab", "attn_kind", "mlp_act",
              "norm", "qk_norm", "rope_theta", "tie_embeddings", "is_encdec"):
        assert getattr(cfg, f) == getattr(bundle.cfg, f), f
    full = get_config(arch)
    for mine, ref in ((cfg, bundle.cfg), (full, jget(arch))):
        for f in ("encoder", "vision"):
            assert _fields(getattr(mine, f)) == _fields(getattr(ref, f)), f
        assert mine.cross_attn_layers() == ref.cross_attn_layers()
        assert mine.param_count() == ref.param_count()
    assert resolve_family(cfg).name == resolve_family(full).name == "slot"


def _fields(sub_config):
    return None if sub_config is None else vars(sub_config)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_tree_and_values(models, arch):
    """Every leaf, the encoder and cross blocks included, crosses with its
    value; with a bf16 weight dtype the gates, the cross blocks' norms and
    the encoder's final norm stay fp32."""
    _, jp, cfg, tp = models[arch]
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert sorted(jl, key=str) == sorted(tl, key=str)
    for path, leaf in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), leaf)
    bf = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.bfloat16)
    fp32 = {p for p, t in _leaves(bf) if t.dtype == torch.float32}
    assert ("cross_blocks", "attn", "wk") not in fp32
    if arch == VLM:
        assert {("cross_blocks", "gate_attn"), ("cross_blocks", "gate_mlp"),
                ("cross_blocks", "ln1", "scale")} <= fp32
    else:
        assert {("cross_blocks", "ln", "scale"), ("enc_final_norm", "bias"),
                ("enc_blocks", "ln1", "scale")} <= fp32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(models, arch):
    """The port's own init draws the same tree, shapes and dtypes as the
    JAX init at bf16 (values differ: torch vs threefry bits), and its VLM
    gates start at zero, as the reference's do."""
    bundle, _, cfg, _ = models[arch]
    jp = bundle.init_params(jax.random.PRNGKey(1), jnp.bfloat16)
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            _leaves(jax.tree.map(np.asarray, jp))}
    tp = T.init_params(cfg, torch.Generator(), torch.bfloat16, "cpu")
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves(tp)}
    assert got == want
    if arch == VLM:
        assert not tp["cross_blocks"]["gate_attn"].any()
        assert not tp["cross_blocks"]["gate_mlp"].any()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_kv_and_cross_block_match_reference(models, arch):
    """Cross block 1 of each tower on a random chunk over a random memory:
    ``memory_kv`` and ``cross_block_apply`` (gated for the VLM, ungated
    for the enc-dec model) within 1e-5 (fp32)."""
    _, jp, cfg, tp = models[arch]
    rs = np.random.RandomState(11)
    x = rs.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    mem = _mem(cfg, 12, batch=2)
    jpc = jax.tree.map(lambda a: a[1], jp["cross_blocks"])
    tpc = T.layer(tp, 1, "cross_blocks")
    wk, wv = JT.memory_kv(cfg, jpc["attn"], jnp.asarray(mem))
    gk, gv = T.memory_kv(cfg, [tpc["attn"]], torch.from_numpy(mem), CPU)
    np.testing.assert_allclose(_f32(gk), _f32(wk), atol=1e-5)
    np.testing.assert_allclose(_f32(gv), _f32(wv), atol=1e-5)
    gated = arch == VLM
    want = JT.cross_block_apply(cfg, jpc, jnp.asarray(x), wk, wv, gated)
    got = T.cross_block_apply(cfg, [tpc], torch.from_numpy(x), gk, gv, gated,
                              CPU)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    assert np.abs(_f32(got) - x).max() > 0.1       # the block does work


@pytest.mark.parametrize("n_frames", [24, 2304])
def test_encode_matches_reference(models, n_frames):
    """The encoder over random frames: at 24 frames the reference takes
    its naive attention, at 2304 (past its 2048-frame switch) its chunked
    flash attention; the port's naive form within 1e-4 of both (fp32)."""
    bundle, jp, cfg, tp = models[ENCDEC]
    frames = _mem(cfg, 13, n=n_frames)
    want = JT.encode(bundle.cfg, jp, jnp.asarray(frames))
    got = T.encode(cfg, [tp], torch.from_numpy(frames), CPU)
    assert got.shape == (1, n_frames, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


# ---------------------------------------------------------------------------
# whole towers: teacher-forced, and the serving entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Teacher-forced logits over random modality memories against
    ``T.forward(attn_impl="naive")`` within 1e-4 (fp32)."""
    bundle, jp, cfg, tp = models[arch]
    tokens = np.random.RandomState(5).randint(3, cfg.vocab_size, (2, 24))
    mem = {_mem_key(cfg): _mem(cfg, 14, batch=2)}
    want = JT.forward(bundle.cfg, jp, jnp.asarray(tokens), attn_impl="naive",
                      **{k: jnp.asarray(v) for k, v in mem.items()})
    got = T.forward(cfg, tp, torch.from_numpy(tokens),
                    **{k: torch.from_numpy(v) for k, v in mem.items()})
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference(models, arch):
    """Two slots of a 32-token cache over random memories: a 21-token
    prompt in pow2-bucketed chunks of 8, 8 and 5 (padded to 8, ``n_valid``
    5), then greedy decode steps until the last decode writes the cache's
    last slot (position 31), through the port's ``serving.prefill`` /
    ``decode_step`` and the JAX ones (the reference's linear-cache decode
    against the port's ring decode): every logits row within 2e-3 (fp32),
    and within 2e-3 of the port's teacher-forced ``forward`` at the same
    position."""
    bundle, jp, cfg, tp = models[arch]
    key = _mem_key(cfg)
    mem = _mem(cfg, 15, batch=2)
    jprefill = jax.jit(lambda p, t, c, m, nv: JS.prefill(
        bundle.cfg, p, t, c, n_valid=nv, **{key: m}))
    jdecode = jax.jit(lambda p, t, c: JS.decode_step(bundle.cfg, p, t, c))
    prompt = np.random.RandomState(6).randint(3, cfg.vocab_size, (2, 21))
    jc = bundle.init_cache(2, 32, jnp.float32)
    tc = S.init_cache(cfg, 2, 32, torch.float32, CPU)
    seq, rows = prompt, []
    for a in range(0, 21, 8):
        chunk = prompt[:, a:a + 8]
        nv = chunk.shape[1]
        padded = np.zeros((2, 8), np.int64)
        padded[:, :nv] = chunk
        wl, jc = jprefill(jp, jnp.asarray(padded, jnp.int32), jc,
                          jnp.asarray(mem), jnp.int32(nv))
        gl, tc = S.prefill(cfg, [tp], torch.from_numpy(padded), tc, CPU,
                           n_valid=nv, **{key: torch.from_numpy(mem)})
        np.testing.assert_allclose(_f32(gl), _f32(wl), atol=2e-3)
        rows.append((a + nv - 1, gl))
    tok = np.asarray(jnp.argmax(wl[:, :bundle.cfg.vocab_size], -1), np.int64)
    for _ in range(11):
        seq = np.concatenate([seq, tok[:, None]], 1)
        wl, jc = jdecode(jp, jnp.asarray(tok, jnp.int32), jc)
        gl, tc = S.decode_step(cfg, [tp], torch.from_numpy(tok), tc, CPU)
        np.testing.assert_allclose(_f32(gl), _f32(wl), atol=2e-3)
        rows.append((seq.shape[1] - 1, gl))
        tok = np.asarray(jnp.argmax(wl[:, :bundle.cfg.vocab_size], -1),
                         np.int64)
    assert tc[0]["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [32, 32]
    full = T.forward(cfg, tp, torch.from_numpy(seq),
                     **{key: torch.from_numpy(mem)})
    for pos, gl in rows:
        np.testing.assert_allclose(_f32(gl), _f32(full[:, pos]), atol=2e-3)


# ---------------------------------------------------------------------------
# the engine: exact greedy tokens against the JAX FlowServe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mix", ["ragged", "prompts"])
def test_flowserve_greedy_parity(pairs, arch, mix):
    prompts = RAGGED if mix == "ragged" else _prompts(3)
    seeds = [100 + i for i in range(len(prompts))]
    got, want = _serve_both(pairs[arch], f"{mix}-", prompts, seeds)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_flowserve_default_zero_inputs(pairs, arch):
    """Requests without modality inputs get the engines' zeros: the same
    tokens on both."""
    got, want = _serve_both(pairs[arch], "zero-", _prompts(2, seed0=30),
                            [None, None])
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slots_do_not_leak_state(models, pairs, arch):
    """Fill every slot, then serve new prompts with new memories on the
    freed (stale) slots: the tokens equal the JAX TE's and a fresh TE's."""
    _serve_both(pairs[arch], "fill-", _prompts(4, seed0=40),
                [200 + i for i in range(4)])
    prompts = _prompts(4, length=9, seed0=50)
    seeds = [300 + i for i in range(4)]
    got, want = _serve_both(pairs[arch], "reuse-", prompts, seeds)
    _, _, cfg, tp = models[arch]
    fresh = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    for i, (p, seed) in enumerate(zip(prompts, seeds)):
        _submit(fresh, Request, SamplingParams, f"f{i}", p,
                {_mem_key(cfg): _mem(cfg, seed)})
    comps = {c.req_id: c.tokens for c in fresh.run_to_completion()}
    assert got == want == [comps[f"f{i}"] for i in range(len(prompts))]


def _checkpoint_hit(pairs, arch, tag, seed_a, seed_b):
    """Serve a base prompt with memory ``seed_a``, then a prompt that
    extends the checkpoint it leaves, with memory ``seed_b``, on both TEs.
    Returns (port tokens, JAX tokens, the extended prompt)."""
    jte, tte = pairs[arch]
    cfg = tte.cfg
    base = _prompts(1, length=13, seed0=70 + seed_b)[0]
    (first,), _ = _serve_both(pairs[arch], f"{tag}a", [base], [seed_a])
    ext = base + first + [9, 4, 11]
    n_hits = []
    extra = {_mem_key(cfg): _mem(cfg, seed_b)}
    for te, req, spc in ((jte, JRequest, JSamplingParams),
                         (tte, Request, SamplingParams)):
        _submit(te, req, spc, f"{tag}b", ext, extra)
        n_hits.append(te._seqs[f"{tag}b"].n_cached)
    assert n_hits[0] == n_hits[1] == len(base) + len(first) - 1
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert len(got[f"{tag}b"]) == 8
    return got[f"{tag}b"], want[f"{tag}b"], ext


@pytest.mark.parametrize("arch", ARCHS)
def test_state_checkpoint_prefix_hit(pairs, arch):
    """A finished request leaves a state checkpoint keyed by the tokens it
    covered; a later prompt with the same memory that extends that key
    resumes from it (on both engines) and gives the JAX TE's tokens
    exactly."""
    got, want, _ = _checkpoint_hit(pairs, arch, "ckpt-", 400, 400)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_reused_across_modality_inputs(models, pairs, arch):
    """The reference's checkpoint key is the token prefix alone: a prompt
    that extends an earlier request's checkpoint resumes from it even when
    it carries another memory, so its prefix's self-attention K/V are the
    ones computed under the earlier memory (only the last chunk's cross
    cache is refilled). The port keeps that for parity: both engines give
    the same tokens, and they are not the tokens a fresh TE gives."""
    got, want, ext = _checkpoint_hit(pairs, arch, "stale-", 500, 501)
    assert got == want
    _, _, cfg, tp = models[arch]
    fresh = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    _submit(fresh, Request, SamplingParams, "f", ext,
            {_mem_key(cfg): _mem(cfg, 501)})
    (comp,) = fresh.run_to_completion()
    assert comp.tokens != got


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_advances_slots_mid_prefill(models, pairs, arch):
    """The reference's all-slot decode step also runs the slot of a prompt
    that is still mid-prefill: it writes a token-0 step there and advances
    that slot's length, so a long prompt prefilled while a short request
    decodes continues one position late over a garbage entry. The port
    keeps that for parity: both engines give the same tokens for the long
    prompt, and they are not what a TE serving it alone gives."""
    short = _prompts(1, length=3, seed0=80)[0]
    long = _prompts(1, length=39, seed0=81)[0]     # 5 chunks of 8
    got, want = _serve_both(pairs[arch], "mid-", [short, long], [600, 601])
    assert got == want
    _, _, cfg, tp = models[arch]
    alone = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    _submit(alone, Request, SamplingParams, "a", long,
            {_mem_key(cfg): _mem(cfg, 601)})
    (comp,) = alone.run_to_completion()
    assert comp.tokens != got[1]
