"""The port's slot family (rwkv6, recurrentgemma) against the JAX package,
on the CPU, below the engine (the engine's parity is
``test_torch_slot.py``, whose fixtures and helpers this file uses). Both
sides run identical weights: the JAX smoke init (fp32), bridged; the torch
side's recurrences take the WKV6 and RG-LRU kernels' plain versions. Held
here, each on numpy inputs from a fixed seed, with the tolerance stated in
the test:

  * configs, the weight bridge and the port's own init layout;
  * the rwkv time mix / channel mix and the RG-LRU block with a masked
    tail (``n_valid``), within 1e-5;
  * teacher-forced logits, and slot ``prefill`` + ``decode_step`` logits
    against ``repro/models/serving.py``, within 2e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JG
from repro.models import rwkv6 as JR
from repro.models import serving as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.engine.runners import resolve_family
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from test_torch_slot import ARCHS, CPU, _f32, models  # noqa: F401
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


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
