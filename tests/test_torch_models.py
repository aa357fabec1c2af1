"""The port's model math against the JAX package, on the CPU.

The weight bridge turns the JAX ``init_params`` pytree of the qwen3 smoke
config into the port's parameter dict; the port's teacher-forced logits
must then match ``T.forward(attn_impl="naive")`` within 1e-4 (fp32). The
building blocks are held one by one on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def qwen():
    bundle = get_model("qwen3-8b", smoke=True)
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = smoke_config(get_config("qwen3-8b"))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


def test_config_matches_reference(qwen):
    bundle, _, cfg, _ = qwen
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "qk_norm", "rope_theta",
              "mlp_act", "attn_logit_softcap", "final_logit_softcap"):
        assert getattr(cfg, f) == getattr(bundle.cfg, f), f
    assert cfg.layer_kinds() == bundle.cfg.layer_kinds()
    assert cfg.param_count() == bundle.cfg.param_count()
    full = get_config("qwen3-8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.padded_vocab) == \
        (36, 4096, 32, 8, 128, 12288, 152064)


def test_bridge_keeps_tree_and_values(qwen):
    _, jp, _, tp = qwen
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jleaves:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_init_params_matches_reference_layout(qwen):
    """The port's own init draws the same tree, shapes and norm dtypes as
    the JAX init (values differ: torch vs threefry bits)."""
    _, jp, cfg, _ = qwen
    g = torch.Generator().manual_seed(0)
    own = T.init_params(cfg, g, torch.float32, device="cpu")
    jshapes = {jax.tree_util.keystr(p): l.shape
               for p, l in jax.tree_util.tree_leaves_with_path(jp)}
    oshapes = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + f"['{k}']")
            else:
                oshapes[pre + f"['{k}']"] = tuple(v.shape)
    walk(own, "")
    assert oshapes == jshapes
    assert own["blocks"]["attn"]["wq"].std().item() == \
        pytest.approx(1 / np.sqrt(cfg.d_model), rel=0.05)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg, g)                # default device is the card


def test_teacher_forced_logits_match(qwen):
    bundle, jp, cfg, tp = qwen
    tokens = np.random.RandomState(0).randint(3, 500, (2, 24)).astype(np.int32)
    want = JT.forward(bundle.cfg, jp, jnp.asarray(tokens), attn_impl="naive")
    got = T.forward(cfg, tp, torch.from_numpy(tokens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_layers_match():
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (rs.standard_normal((16,)) * 0.1).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5)
    p = {k: (rs.standard_normal(s) * 0.2).astype(np.float32) for k, s in
         (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    h = rs.standard_normal((2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        L.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(h), "swiglu").numpy(),
        np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(h), "swiglu")), atol=1e-5)
