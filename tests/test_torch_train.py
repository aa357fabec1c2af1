"""The port's fine-tune step against the JAX package, on the CPU: the loss
and its gradients for every arch, the optimizer, the loss function, the
MoE auxiliary loss, and the guard that keeps autograd away from the CUDA
kernels.

Both sides run identical weights (the JAX smoke init in fp32, bridged;
the VLM's cross-block gates set non-zero, as ``test_torch_crossattn.py``
does: the init's zero gates make tanh(0) = 0 cut the cross path off, and
its gradients with it) on one seeded batch of 2 x 16 tokens with a
partial mask, the VLM and enc-dec towers with seeded non-zero modality
inputs. Held here, with the tolerances stated in each test:

  * per arch (all ten), one loss and its gradients: the reference's
    ``make_loss_fn`` under a jitted ``jax.value_and_grad`` against the
    port's (``impl="scan"``: the recurrences in the reference's sequence
    forms; remat on): loss within 1e-5 relative, grad
    norm within 1e-4 relative, each leaf within 1e-4 * max|g_leaf| +
    1e-7; and every port leaf gets a finite gradient with a non-zero
    element (no leaf is zero by construction at these inputs);
  * remat on gives remat off's gradients, bit for bit;
  * ``lr_at``, ``global_norm``, ``adamw_update`` (a mixed fp32 / bf16
    tree, 3 steps), ``cross_entropy`` (padded vocab, partial mask, value
    and gradient) and ``moe_aux_loss`` (granite's router) against the
    reference run op by op (unjitted);
  * each CUDA launcher refuses an input that requires grad before its
    library loads or a launch is counted, ``forward(impl="auto")`` under
    autograd refuses on the recurrent towers, and a train step there
    launches no kernel.
One jitted JAX loss-and-grad per arch serves both of its tests."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_configs
from repro.models import get_model as jget_model
from repro.models import model_factory as JMF
from repro.models import moe as JMOE
from repro.training import optimizer as JO
from repro.training.train_loop import make_loss_fn as jmake_loss_fn
from repro_torch.kernels import _build, counts, ops
from repro_torch.kernels import flash_prefill as FP
from repro_torch.models import moe as M
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_factory import cross_entropy, get_model
from repro_torch.training import optimizer as O
from repro_torch.training import tree as TR
from repro_torch.training.train_loop import (TrainConfig, make_loss_fn,
                                             make_train_step, value_and_grad)

ARCHS = list_configs()
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size torch ops gain nothing from intra-op threads, and the
    suite runs several workers on a few cores: one thread each here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged(arch):
    """(JAX bundle, JAX fp32 params, port bundle, port params): the JAX
    smoke init, the VLM's gates set non-zero, bridged to the port."""
    jb = jget_model(arch, smoke=True)
    jp = jb.init_params(jax.random.PRNGKey(0), jnp.float32)
    if jb.cfg.vision is not None:
        n = jp["cross_blocks"]["gate_attn"].shape[0]
        jp["cross_blocks"]["gate_attn"] = jnp.linspace(0.6, 0.9, n)
        jp["cross_blocks"]["gate_mlp"] = jnp.linspace(-0.7, -0.4, n)
    tb = get_model(arch, smoke=True)
    tp = params_from_numpy(tb.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jb, jp, tb, tp


def batch(cfg, seed=1):
    """A seeded (tokens, targets, mask, modality inputs) batch, numpy."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0.0
    extra = {}
    if cfg.vision is not None:
        extra["vision_embeds"] = rs.standard_normal(
            (B, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        extra["frames"] = rs.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return tokens, targets, mask, extra


def torch_args(tokens, targets, mask, extra):
    return (torch.from_numpy(tokens), torch.from_numpy(targets),
            torch.from_numpy(mask),
            {k: torch.from_numpy(v) for k, v in extra.items()})


@pytest.fixture(scope="module")
def grads():
    """arch -> (JAX loss, JAX grads by keystr path, port loss, port grads
    as [(path, grad)]), computed once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jb, jp, tb, tp = bridged(arch)
            tokens, targets, mask, extra = batch(tb.cfg)
            jl, jg = jax.jit(jax.value_and_grad(jmake_loss_fn(jb, True)))(
                jp, tokens, targets, mask,
                {k: jnp.asarray(v) for k, v in extra.items()})
            tl, tg = value_and_grad(make_loss_fn(tb, True), tp,
                                    *torch_args(tokens, targets, mask,
                                                extra))
            cache[arch] = (
                float(jl), {jax.tree_util.keystr(p): np.asarray(g)
                            for p, g in
                            jax.tree_util.tree_leaves_with_path(jg)},
                float(tl), TR.flatten_with_paths(tg))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(grads, arch):
    jl, jg, tl, tg = grads(arch)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert sorted(p for p, _ in tg) == sorted(jg)
    jnorm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                        for g in jg.values()))
    tnorm = float(O.global_norm([g for _, g in tg]))
    assert abs(tnorm - jnorm) <= 1e-4 * jnorm, (tnorm, jnorm)
    for path, g in tg:
        want = jg[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=1e-4 * float(np.abs(want).max()) + 1e-7, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_a_finite_nonzero_grad(grads, arch):
    """The JAX ``test_train_step_no_nan`` looks at the first leaf only;
    here every leaf must be finite and reached by the loss."""
    _, _, _, tg = grads(arch)
    for path, g in tg:
        assert torch.isfinite(g).all(), path
        assert bool((g != 0).any()), f"{path}: no gradient reached it"


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_the_plain_grads(arch):
    """Recomputing each block in the backward changes nothing (the rwkv
    block's recurrence writes its state in place: a recomputed block must
    start from the initial state again)."""
    tb = get_model(arch, smoke=True)
    tp = tb.init_params(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    args = torch_args(*batch(tb.cfg))
    l0, g0 = value_and_grad(make_loss_fn(tb, False), tp, *args)
    l1, g1 = value_and_grad(make_loss_fn(tb, True), tp, *args)
    assert torch.equal(l0, l1)
    for (path, a), b in zip(TR.flatten_with_paths(g0), TR.leaves(g1)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the optimizer and the losses, op by op against the reference
# ---------------------------------------------------------------------------

OPT = O.OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=12)
JOPT = JO.OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=12)


def test_lr_at_matches_reference():
    """Every step of the warmup and the cosine, and past its end: equal
    wherever XLA's cos and torch's cos of the step's progress agree bit
    for bit (the port runs the reference's expression operation by
    operation); where they differ by an ulp, within 4 ulps of the lr."""
    steps = range(OPT.total_steps + 6)
    got = np.array([float(O.lr_at(OPT, torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    want = np.array([float(JO.lr_at(JOPT, jnp.asarray(s, jnp.int32)))
                     for s in steps], np.float32)
    prog = np.clip((np.arange(len(got), dtype=np.float32) - OPT.warmup_steps)
                   / np.float32(OPT.total_steps - OPT.warmup_steps), 0, 1)
    same_cos = np.asarray(jnp.cos(jnp.pi * jnp.asarray(prog))) == \
        torch.cos(math.pi * torch.from_numpy(prog)).numpy()
    assert same_cos.sum() >= len(got) - 2
    np.testing.assert_array_equal(got[same_cos], want[same_cos])
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


def _mixed_tree(seed, dyadic=False):
    """A nested dict / list tree of fp32 and bf16 leaves (numpy fp32
    values). ``dyadic``: multiples of 1/64 below 4, whose squares and
    their sums are exact in fp32 in any order."""
    rs = np.random.RandomState(seed)

    def val(shape):
        if dyadic:
            return (rs.randint(-255, 256, shape) / 64.0).astype(np.float32)
        return rs.standard_normal(shape).astype(np.float32)
    return {"b": [val((3, 5)), val((7,))], "a": {"w": val((4, 6)),
                                                 "z": val((2, 3, 2))}}


BF16 = ("['a']['w']", "['b'][1]")       # the bf16 leaves of _mixed_tree


def _as_torch(tree):
    return TR.unflatten(tree, [
        torch.from_numpy(v).to(torch.bfloat16 if p in BF16 else torch.float32)
        for p, v in TR.flatten_with_paths(tree)])


def _as_jax(tree):
    return TR.unflatten(tree, [
        jnp.asarray(v, jnp.bfloat16 if p in BF16 else jnp.float32)
        for p, v in TR.flatten_with_paths(tree)])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_global_norm_matches_reference():
    """Exact where every partial sum is exact (dyadic values: only the
    order of the leaves could then matter, and it is JAX's); within 1e-6
    relative on normal values, whose sums XLA and torch order
    differently."""
    exact = _mixed_tree(0, dyadic=True)
    assert float(O.global_norm(_as_torch(exact))) == \
        float(JO.global_norm(_as_jax(exact)))
    normal = _mixed_tree(1)
    np.testing.assert_allclose(float(O.global_norm(_as_torch(normal))),
                               float(JO.global_norm(_as_jax(normal))),
                               rtol=1e-6)


def test_adamw_update_matches_reference():
    """Three AdamW steps on a mixed fp32 / bf16 tree, clipped (the grads'
    norm is above 1; dyadic grads, so the norm is exact): the params (in
    their own dtypes), the fp32 moments, the lr and the step equal the
    reference's bit for bit, the update running the reference's
    expression operation by operation."""
    tp, jp = _as_torch(_mixed_tree(2)), _as_jax(_mixed_tree(2))
    ts, js = O.init_opt_state(tp), JO.init_opt_state(jp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert all(m.dtype == torch.float32 for m in TR.leaves(ts["m"]))
    for i in range(3):
        g = _mixed_tree(10 + i, dyadic=True)
        tp, ts, tm = O.adamw_update(OPT, tp, _as_torch(g), ts)
        jp, js, jm = JO.adamw_update(JOPT, jp, _as_jax(g), js)
        assert float(tm["grad_norm"]) == float(jm["grad_norm"]) > 1.0
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for (path, a), b in zip(TR.flatten_with_paths(tp), TR.leaves(jp)):
            assert a.dtype == (torch.bfloat16 if path in BF16
                               else torch.float32)
            np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
        for key in ("m", "v"):
            for a, b in zip(TR.leaves(ts[key]), TR.leaves(js[key])):
                np.testing.assert_array_equal(_f32(a), _f32(b))


def test_cross_entropy_matches_reference():
    """Padded vocab (600 of 768 columns real) and a partial mask: the value
    and the gradient of the logits within 1e-6 relative (XLA and torch sum
    the logsumexp in different orders)."""
    rs = np.random.RandomState(3)
    logits = (rs.standard_normal((2, 5, 768)) * 3).astype(np.float32)
    targets = rs.randint(0, 600, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 1, 1, 1]], np.float32)
    jv, jg = jax.value_and_grad(JMF.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask), 600)
    t = torch.from_numpy(logits).requires_grad_()
    tv = cross_entropy(t, torch.from_numpy(targets), torch.from_numpy(mask),
                       600)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)
    assert not t.grad[..., 600:].any()
    # an all-zero mask divides by the floor of 1: zero loss
    zero = cross_entropy(t, torch.from_numpy(targets), torch.zeros((2, 5)),
                         600)
    assert float(zero) == 0.0


def test_moe_aux_loss_matches_reference():
    """granite's router at smoke width on seeded activations: within 1e-6
    relative (the router product's sums are ordered differently)."""
    jb, jp, tb, tp = bridged("granite-moe-3b-a800m")
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 16, tb.cfg.d_model)).astype(np.float32)
    want = JMOE.moe_aux_loss(jax.tree.map(lambda a: a[0],
                                          jp["blocks"]["moe"]),
                             jnp.asarray(x), jb.cfg.moe)
    got = M.moe_aux_loss({"router": tp["blocks"]["moe"]["router"][0]},
                         torch.from_numpy(x), tb.cfg.moe)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the guard: the CUDA kernels refuse autograd
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_route(monkeypatch):
    """``ops`` routes impl "auto" to the CUDA launchers whatever the
    device, and loading a kernel library fails the test."""
    real = ops._route
    monkeypatch.setattr(ops, "_route", lambda x, impl: "cuda"
                        if impl == "auto" else real(x, impl))

    def no_load(stem):
        raise AssertionError(f"library {stem} loaded")
    monkeypatch.setattr(_build, "load", no_load)


def _launcher_calls(grad):
    """One call of each launcher entry (through ``ops``) on CPU tensors,
    the floating inputs marked ``requires_grad`` when ``grad``."""
    g = torch.Generator().manual_seed(0)

    def f(*shape):
        return torch.randn(shape, generator=g).requires_grad_(grad)
    i32 = torch.int32
    pages = (f(4, 16, 2, 16), f(4, 16, 2, 16))
    return {
        "paged_attention": lambda: ops.paged_attention(
            f(2, 4, 16), *pages, torch.zeros((2, 2), dtype=i32),
            torch.ones((2,), dtype=i32)),
        "paged_prefill": lambda: ops.paged_prefill(
            f(8, 4, 16), *pages, torch.tensor([0, 8], dtype=i32),
            torch.zeros((1, 1), dtype=i32), torch.zeros((1,), dtype=i32),
            torch.from_numpy(FP.build_tiles([0, 8], 8))),
        "flash_prefill": lambda: ops.flash_prefill(
            f(1, 16, 4, 16), f(1, 16, 2, 16), f(1, 16, 2, 16)),
        "wkv6": lambda: ops.wkv6(
            f(1, 4, 2, 16), f(1, 4, 2, 16), f(1, 4, 2, 16),
            torch.rand((1, 4, 2, 16), generator=g).requires_grad_(grad),
            f(2, 16), torch.zeros((1, 2, 16, 16))),
        "rglru": lambda: ops.rglru(f(1, 4, 8), f(1, 4, 8),
                                   torch.zeros((1, 8))),
    }


@pytest.mark.parametrize("entry", ["paged_attention", "paged_prefill",
                                   "flash_prefill", "wkv6", "rglru"])
def test_launchers_refuse_autograd_first(kernel_route, entry):
    """Each launcher's first statement: an input that requires grad under
    grad mode raises before the library loads or a launch is counted.
    Without grad the same call goes on to the launcher's own checks
    (which refuse CPU tensors)."""
    before = counts.totals()
    with pytest.raises(RuntimeError, match="no backward"):
        _launcher_calls(True)[entry]()
    assert counts.totals() == before
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            _launcher_calls(True)[entry]()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launcher_calls(False)[entry]()
    assert counts.totals() == before


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_forward_on_the_kernels_refuses_autograd(kernel_route, arch):
    """``forward(impl="auto")`` (the kernels, forced here) under autograd
    raises at the recurrence; the train step asks for the plain versions
    by name and so launches no kernel, while its loss still reaches every
    leaf."""
    tb = get_model(arch, smoke=True)
    tp = tb.init_params(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    tokens, targets, mask, extra = torch_args(*batch(tb.cfg))
    tp["embed"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tb.forward(tb.cfg, tp, tokens)
    tp["embed"].requires_grad_(False)
    before = counts.totals()
    step = make_train_step(tb, TrainConfig(opt=OPT))
    new, _, metrics = step(tp, O.init_opt_state(tp), tokens, targets, mask,
                           extra)
    assert counts.totals() == before
    assert np.isfinite(float(metrics["loss"]))
    for (path, a), b in zip(TR.flatten_with_paths(new), TR.leaves(tp)):
        assert not torch.equal(a, b), f"{path} did not move"
