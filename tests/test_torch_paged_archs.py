"""The rest of the port's paged family against the JAX package, on the CPU:
gemma2-9b (local/global windows, both softcaps, post norms, embedding
scale, hd 256 at full width), h2o-danube-3-4b (sliding window, hd 120 at
full width) and nemotron-4-15b (layernorm, squared ReLU, G = 6 at full
width), each at its smoke config.

Both sides run identical weights: the JAX smoke init (fp32), bridged. The
torch side runs with ``device="cpu"``, so attention takes the kernels'
plain versions. Held here, with the tolerance stated in each test:

  * configs, the weight bridge and the port's own init layout;
  * teacher-forced logits against ``T.forward(attn_impl="naive")``;
  * the check of ``tests/test_models.py::test_prefill_decode_matches_forward``
    on the port's paged runner: a ragged prefill pass of two prompts, then
    decode steps over the paged pool, every logits row within 2e-3 of the
    JAX teacher-forced forward, past the smoke window of 16;
  * the port's ``FlowServe`` against the JAX ``FlowServe``: EXACT greedy
    tokens on the ragged mix of ``tests/test_prefill_batching.py`` (its
    22-token prompt crosses the window) and at the horizons K in {1, 4, 8}
    of ``tests/test_hotloop.py``, on the smoke config cut to
    ``ENGINE_LAYERS`` layers (still one local and one global layer for
    gemma2; no assertion depends on depth, and the JAX TE compiles its
    unrolled layer loop once per shape).
One JAX TE per model serves every engine case, so its shapes compile once.
``arch_suite`` makes these checks for a list of archs: this file holds
gemma2's, ``test_torch_paged_danube.py`` and ``test_torch_paged_nemotron.py``
the other two (one file per arch, so ``--dist loadfile`` spreads them over
workers), and ``test_torch_moe_granite.py`` / ``test_torch_moe_mixtral.py``
the MoE archs'."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.kv_cache import PagedKVPool
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.engine.runners import PagedRunner, resolve_family
from repro_torch.kernels import flash_prefill as FP
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma2-9b"]
ENGINE_LAYERS = 2
SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "padded_vocab", "attn_kind", "window",
                 "attn_logit_softcap", "final_logit_softcap", "qk_norm",
                 "rope_theta", "mlp_act", "norm", "post_norms", "embed_scale",
                 "tie_embeddings", "moe")


def prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


# tests/test_prefill_batching.py's ragged mix: 1-token prompt, tiny, one
# chunk exactly, chunk boundary + 1, long (22 tokens: past the window)
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]


def load(arch, n_layers=None):
    """(JAX bundle, JAX params, port config, port params) at smoke, fp32;
    with ``n_layers``, the smoke config cut to that many layers."""
    jcfg = jax_smoke_config(jax_get_config(arch))
    cfg = smoke_config(get_config(arch))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bundle = get_model(jcfg)
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


def make_pair(model):
    """One (JAX TE, torch TE) pair on the SHARED config. Both TEs always
    see the same traffic in the same order, so their prefix caches stay in
    step; both read ``decode_horizon`` afresh at every step."""
    bundle, jp, cfg, tp = model
    return (JFlowServe(bundle, jp, JEngineConfig(**SHARED)),
            FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu"))


def serve_both(pair, tag, prompt_list, decode_horizon, max_new=8):
    """Greedy tokens of both TEs for the same requests: (torch, JAX)."""
    jte, tte = pair
    jte.ecfg.decode_horizon = tte.ecfg.decode_horizon = decode_horizon
    ids = [f"{tag}{i}" for i in range(len(prompt_list))]
    for rid, p in zip(ids, prompt_list):
        jte.add_request(JRequest(prompt_tokens=p, req_id=rid,
                                 sampling=JSamplingParams(
                                     temperature=0.0, max_new_tokens=max_new,
                                     stop_on_eos=False)))
        tte.add_request(Request(prompt_tokens=p, req_id=rid,
                                sampling=SamplingParams(
                                    temperature=0.0, max_new_tokens=max_new,
                                    stop_on_eos=False)))
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert sorted(want) == ids
    assert not tte._inflight and not tte._pending
    return [got.get(i) for i in ids], [want[i] for i in ids]


def _field(cfg, f):
    """A config field, sub-configs as dicts (the two packages' MoEConfig
    classes differ)."""
    v = getattr(cfg, f)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def check_config(model, arch):
    bundle, _, cfg, _ = model
    for f in CONFIG_FIELDS:
        assert _field(cfg, f) == _field(bundle.cfg, f), f
    assert cfg.layer_kinds() == bundle.cfg.layer_kinds()
    assert T.window_schedule(cfg) == \
        np.asarray(JT.window_schedule(bundle.cfg)).tolist()
    assert resolve_family(cfg).name == "paged"
    full = get_config(arch)
    from repro.configs import get_config as jget
    jfull = jget(arch)
    for f in CONFIG_FIELDS + ("source",):
        assert _field(full, f) == _field(jfull, f), f
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert cfg.param_count() == bundle.cfg.param_count()


def check_bridge(model):
    _, jp, _, tp = model
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def _leaves(tree, pre=""):
    """{jax keystr: tensor} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, pre + f"['{k}']"))
        else:
            out[pre + f"['{k}']"] = v
    return out


def check_init_layout(model, arch):
    """The port's own init draws the JAX init's tree and shapes, and in
    bf16 keeps the same leaves in fp32 (values differ: torch vs threefry
    bits)."""
    cfg = model[2]
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jp = get_model(arch, smoke=True).init_params(jax.random.PRNGKey(0),
                                                     jdtype)
        want = {jax.tree_util.keystr(p): (l.shape, str(l.dtype))
                for p, l in jax.tree_util.tree_leaves_with_path(jp)}
        own = T.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                            device="cpu")
        got = {k: (tuple(v.shape), str(v.dtype)[6:])
               for k, v in _leaves(own).items()}
        assert got == want


def check_forward(model, atol):
    bundle, jp, cfg, tp = model
    tokens = np.random.RandomState(0).randint(3, 500, (2, 24)).astype(
        np.int32)
    want = JT.forward(bundle.cfg, jp, jnp.asarray(tokens), attn_impl="naive")
    got = T.forward(cfg, tp, torch.from_numpy(tokens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def prefill_decode_errs(model, s=24, n_prefill=18, page=8):
    """tests/test_models.py:50-65 on the port's paged runner: two prompts
    of ``s`` tokens; the first ``n_prefill`` go through one ragged prefill
    pass (two entries, padded to a pow2 bucket), the rest through decode
    steps over the paged pool; each pass's logits against the JAX
    teacher-forced forward at the same position. Returns the max abs
    errors, prefill first."""
    bundle, jp, cfg, tp = model
    b = 2
    tokens = np.random.RandomState(1).randint(3, cfg.vocab_size, (b, s))
    want = np.asarray(JT.forward(bundle.cfg, jp, jnp.asarray(tokens),
                                 attn_impl="naive"))
    pool = PagedKVPool(cfg, 16, page, torch.float32,
                       make_engine_mesh(1, 0, "cpu"))
    rt = PagedRunner(cfg, [tp], pool)
    npg = -(-s // page)
    bt = np.asarray([pool.alloc(npg) for _ in range(b)], np.int32)
    tb = 64
    flat = [(i, j) for i in range(b) for j in range(n_prefill)]
    pad = tb - len(flat)
    cu = [0, n_prefill, 2 * n_prefill]

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32))
    scratch = pool.scratch_page()
    logits, _ = rt.prefill_ragged(
        i32([tokens[i, j] for i, j in flat] + [0] * pad),
        i32([j for _, j in flat] + [0] * pad),
        i32([bt[i, j // page] for i, j in flat] + [scratch] * pad),
        i32([j % page for _, j in flat] + [0] * pad),
        i32(cu), i32(bt), i32([0, 0]), i32(FP.build_tiles(cu, tb)),
        i32([n_prefill - 1, 2 * n_prefill - 1]), None, None, True, None)
    errs = [float(np.abs(logits.numpy() - want[:, n_prefill - 1]).max())]
    for t in range(n_prefill, s):
        lg = rt.decoder.body(i32(tokens[:, t]), i32(bt), i32([t + 1] * b))
        errs.append(float(np.abs(lg.numpy() - want[:, t]).max()))
    return errs


def arch_suite(archs, config_check=None, bridge_check=None):
    """The per-arch checks of this file for ``archs``, as the members a
    test module binds (``globals().update(arch_suite(...))``): the module's
    ``models`` and ``pairs`` fixtures and its tests, each parametrized over
    ``archs``. ``config_check`` / ``bridge_check`` (a model -> None) add a
    family's own assertions to the config and bridge tests."""

    @pytest.fixture(scope="module")
    def models():
        return {arch: load(arch) for arch in archs}

    @pytest.fixture(scope="module")
    def pairs():
        return {arch: make_pair(load(arch, ENGINE_LAYERS)) for arch in archs}

    @pytest.mark.parametrize("arch", archs)
    def test_config_matches_reference(models, arch):
        check_config(models[arch], arch)
        if config_check is not None:
            config_check(models[arch])

    @pytest.mark.parametrize("arch", archs)
    def test_bridge_keeps_tree_and_values(models, arch):
        check_bridge(models[arch])
        if bridge_check is not None:
            bridge_check(models[arch])

    @pytest.mark.parametrize("arch", archs)
    def test_init_params_matches_reference_layout(models, arch):
        check_init_layout(models[arch], arch)

    @pytest.mark.parametrize("arch", archs)
    def test_forward_matches_reference(models, arch):
        """Teacher-forced logits within 1e-4 (fp32, as qwen3's)."""
        check_forward(models[arch], 1e-4)

    @pytest.mark.parametrize("arch", archs)
    def test_prefill_decode_matches_forward(models, arch):
        errs = prefill_decode_errs(models[arch])
        assert max(errs) < 2e-3, errs

    @pytest.mark.parametrize("arch", archs)
    @pytest.mark.parametrize("k", [1, 4, 8])
    def test_greedy_parity_horizons(pairs, arch, k):
        # prompts of their own per K, so no case is served from another's
        # prefix cache
        got, want = serve_both(pairs[arch], f"h{k}-",
                               prompts(4, seed0=100 * k), decode_horizon=k)
        assert got == want

    @pytest.mark.parametrize("arch", archs)
    def test_greedy_parity_ragged_mix(pairs, arch):
        got, want = serve_both(pairs[arch], "rag-", RAGGED, decode_horizon=8)
        assert got == want

    return {k: v for k, v in locals().items()
            if k.startswith("test_") or k in ("models", "pairs")}


globals().update(arch_suite(ARCHS))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_bridge_refuses_uncovered_towers(arch):
    """An enc-dec or VLM tree (encoder / cross-attention blocks) handed to
    a config without those towers: the bridge raises rather than drop the
    blocks its config does not name."""
    jp = get_model(arch, smoke=True).init_params(jax.random.PRNGKey(0),
                                                 jnp.float32)
    cfg = smoke_config(get_config("qwen3-8b"))      # a global-attention tower
    with pytest.raises(NotImplementedError, match="bridge covers"):
        params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def test_resolve_family_sends_cross_towers_to_slot():
    """The paged family claims attention-only towers without modality
    memory, as the reference's predicate does: the enc-dec and VLM configs
    resolve to the slot runner, the eight others as before."""
    from repro_torch.configs import list_configs
    cross = {"seamless-m4t-large-v2", "llama-3.2-vision-11b"}
    slot = cross | {"rwkv6-1.6b", "recurrentgemma-2b"}
    assert len(list_configs()) == 10 and cross <= set(list_configs())
    for name in list_configs():
        want = "slot" if name in slot else "paged"
        assert resolve_family(get_config(name)).name == want, name
        assert resolve_family(smoke_config(get_config(name))).name == want


