"""The recurrences' training forms against the JAX package, on the CPU: the
port's train step runs the reference's sequence forms (``impl="scan"``),
the chunked WKV6 of ``models/rwkv6.py::wkv_chunked`` and the associative
RG-LRU scan of ``models/rglru.py``, as the reference's train step does.

Held here, with the tolerances stated in each test (inputs seeded numpy,
fp32; the JAX side called op by op, unjitted):

  * ``associative_scan`` against ``jax.lax.associative_scan`` with the
    reference's ``combine``: bit for bit at T in {1, 2, 16, 37, 256} (the
    same recursion, the same association order);
  * ``rglru_scan`` on the scan route against the reference's, with h0 and
    an ``n_valid`` below T: the value, the final state, and the gradients
    of a seeded scalar of both with respect to ``wa``, ``wx``,
    ``lambda_p``, u and h0;
  * ``wkv_chunked`` with a carried state at T in {16, 64, 100, 256}
    (decays about the init's ``decay_base`` of -4): y, the final state,
    and ``jax.value_and_grad``'s gradients for r, k, v, w, u and the state;
  * ``ops`` on the scan route: the in-place state contract of
    ``ops.wkv6``, the per-token forms within fp32 rounding, the attention
    entries as "ref";
  * a train step of rwkv6 and recurrentgemma at smoke calls the per-token
    loops (``kernels/ref.py::wkv6_ref`` / ``rglru_ref``) zero times.
The 4-step ``train()`` of both models against the JAX ``train()`` is in
``tests/test_torch_train_state.py``, their loss and gradients per arch in
``tests/test_torch_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JG
from repro.models import rwkv6 as JRW
from repro_torch.kernels import counts, ops
from repro_torch.kernels import ref as R
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as RW
from repro_torch.models.model_factory import get_model
from repro_torch.training import optimizer as O
from repro_torch.training import tree as TR
from repro_torch.training.train_loop import TrainConfig, make_train_step
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _combine(x, y):
    """``repro/models/rglru.py::rglru_scan``'s combine."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _worst(got, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("t", [1, 2, 16, 37, 256])
def test_associative_scan_bit_equal_to_jax(t):
    """fp32 (a, b) with a in (0.5, 1) (the RG-LRU's decays) and b ~
    N(0, 1): both outputs equal ``jax.lax.associative_scan``'s bit for
    bit."""
    rs = np.random.RandomState(t)
    a = rs.uniform(0.5, 1.0, (2, t, 24)).astype(np.float32)
    b = rs.standard_normal((2, t, 24)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    ta, tb = G.associative_scan(_t(a), _t(b))
    assert ta.shape == a.shape and tb.shape == b.shape
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_rglru_scan_matches_reference():
    """B 2, T 37, W 32, n_valid 29, a non-zero h0, weights at the init's
    scales: h and the final state within 1e-6 of max |h| (the gates'
    sigmoid / softplus / exp / sqrt round by an ulp or so differently in
    XLA and torch; 1.1e-7 measured); the gradients of sum(h * c) +
    sum(h_last * c_last) with respect to wa, wx, lambda_p, u and h0 within
    2e-6 of each one's max |grad| (5.4e-7 measured). The final state
    equals h at n_valid - 1 exactly."""
    rs = np.random.RandomState(3)
    b, t, w, n_valid = 2, 37, 32, 29
    p = {"wa": (rs.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32),
         "wx": (rs.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32),
         "lambda_p": (2.0 + 0.3 * rs.standard_normal(w)).astype(np.float32)}
    u = rs.standard_normal((b, t, w)).astype(np.float32)
    h0 = rs.standard_normal((b, w)).astype(np.float32)
    c = rs.standard_normal((b, t, w)).astype(np.float32)
    c_last = rs.standard_normal((b, w)).astype(np.float32)
    names = ("wa", "wx", "lambda_p")

    def jloss(wa, wx, lam, u, h0):
        h, h_last = JG.rglru_scan({"wa": wa, "wx": wx, "lambda_p": lam}, u,
                                  h0, n_valid=n_valid)
        return jnp.sum(h * c) + jnp.sum(h_last * c_last), (h, h_last)

    (_, (jh, jlast)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(p[n]) for n in names), jnp.asarray(u),
        jnp.asarray(h0))
    leaves = [_t(p[n], True) for n in names] + [_t(u, True), _t(h0, True)]
    tu = leaves[3]
    th, tlast = G.rglru_scan(dict(zip(names, leaves[:3])), tu, tu,
                             leaves[4], n_valid=n_valid, impl="scan")
    assert th.dtype == tlast.dtype == torch.float32
    loss = (th * _t(c)).sum() + (tlast * _t(c_last)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    assert torch.equal(tlast, th[:, n_valid - 1])
    assert _worst(th.detach(), jh) <= 1e-6
    assert _worst(tlast.detach(), jlast) <= 1e-6
    for name, g, want in zip(names + ("u", "h0"), tgrads, jgrads):
        assert _worst(g, want) <= 2e-6, name


@pytest.mark.parametrize("t", [16, 64, 100, 256])
def test_wkv_chunked_matches_reference(t):
    """B 2, H 4, hd 16, a carried state, w = exp(-exp(-4 + N(0, 1))) (about
    the init's decay_base), u ~ 0.3 N(0, 1): y and the final state within
    1e-6 of their max |.| (2.7e-7 measured); the gradients of sum(y * c)
    + sum(s * c_s) for r, k, v, w, u and the state within 2e-6 of each
    one's max |grad| (3.6e-7 measured: the exp of the chunk's cumulated
    log-decays rounds by an ulp or so differently in XLA and torch)."""
    rs = np.random.RandomState(t)
    b, h, hd = 2, 4, 16
    r, k, v = (rs.standard_normal((b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(-4.0 + rs.standard_normal((b, t, h, hd)))
               ).astype(np.float32)
    u = (0.3 * rs.standard_normal((h, hd))).astype(np.float32)
    s0 = (0.1 * rs.standard_normal((b, h, hd, hd))).astype(np.float32)
    cy = rs.standard_normal((b, t, h, hd)).astype(np.float32)
    cs = rs.standard_normal((b, h, hd, hd)).astype(np.float32)
    xs = (r, k, v, w, u, s0)

    def jloss(*a):
        y, s = JRW.wkv_chunked(*a)
        return jnp.sum(y * cy) + jnp.sum(s * cs), (y, s)

    (_, (jy, js)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(x) for x in xs))
    leaves = [_t(x, True) for x in xs]
    ty, ts = RW.wkv_chunked(*leaves)
    tgrads = torch.autograd.grad((ty * _t(cy)).sum() + (ts * _t(cs)).sum(),
                                 leaves)
    assert ty.shape == r.shape and ts.shape == s0.shape
    assert torch.equal(leaves[5].detach(), _t(s0))   # the input unchanged
    assert _worst(ty.detach(), jy) <= 1e-6
    assert _worst(ts.detach(), js) <= 1e-6
    for name, g, want in zip("r k v w u state".split(), tgrads, jgrads):
        assert _worst(g, want) <= 2e-6, name


def test_scan_route_keeps_the_ops_contract():
    """``ops.wkv6`` on "scan" writes the final state over ``state`` and
    gives the per-token form's y and state within 1e-6 of their max |.|
    (fp32, T 70: a chunk and a padded tail; 2.8e-7 measured);
    ``ops.rglru`` on "scan" gives the per-token form's h and final state
    within 1e-6 (7.6e-8 measured); the
    attention entries take "scan" as "ref", bit for bit; an unknown impl
    raises."""
    rs = np.random.RandomState(5)
    b, t, h, hd = 2, 70, 2, 16
    r, k, v = (_t(rs.standard_normal((b, t, h, hd)).astype(np.float32))
               for _ in range(3))
    w = _t(np.exp(-np.exp(-4.0 + rs.standard_normal((b, t, h, hd))))
           .astype(np.float32))
    u = _t((0.3 * rs.standard_normal((h, hd))).astype(np.float32))
    s0 = _t((0.1 * rs.standard_normal((b, h, hd, hd))).astype(np.float32))
    outs = {}
    for impl in ("ref", "scan"):
        state = s0.clone()
        y, s = ops.wkv6(r, k, v, w, u, state, impl=impl)
        assert s is state
        outs[impl] = (y, s)
    assert _worst(outs["scan"][0], outs["ref"][0]) <= 1e-6
    assert _worst(outs["scan"][1], outs["ref"][1]) <= 1e-6
    a = _t(rs.uniform(0.5, 1.0, (b, t, 24)).astype(np.float32))
    bb = _t(rs.standard_normal((b, t, 24)).astype(np.float32))
    h0 = _t(rs.standard_normal((b, 24)).astype(np.float32))
    (hs, ls), (hr, lr) = (ops.rglru(a, bb, h0, impl=i)
                          for i in ("scan", "ref"))
    assert _worst(hs, hr) <= 1e-6 and _worst(ls, lr) <= 1e-6
    q = _t(rs.standard_normal((1, 16, 4, 16)).astype(np.float32))
    kv = _t(rs.standard_normal((1, 16, 2, 16)).astype(np.float32))
    assert torch.equal(ops.flash_prefill(q, kv, kv, impl="scan"),
                       ops.flash_prefill(q, kv, kv, impl="ref"))
    with pytest.raises(ValueError, match="impl must be"):
        ops.rglru(a, bb, h0, impl="loop")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_train_step_calls_no_per_token_loop(monkeypatch, arch):
    """A train step at smoke (B 2, S 16, remat) runs the recurrences
    through the sequence forms: ``wkv6_ref`` / ``rglru_ref`` (counted
    wherever they are bound) are called zero times, no kernel launch is
    counted, and every leaf moves. The same forward on ``impl="ref"``
    calls the per-token loop once per recurrent layer, so the counter
    sees them."""
    calls = {"wkv6_ref": 0, "rglru_ref": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for mod in (R, RW):
        monkeypatch.setattr(mod, "wkv6_ref", counted("wkv6_ref",
                                                      R.wkv6_ref))
    monkeypatch.setattr(R, "rglru_ref", counted("rglru_ref", R.rglru_ref))
    tb = get_model(arch, smoke=True)
    cfg = tb.cfg
    tp = tb.init_params(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    rs = np.random.RandomState(1)
    tokens, targets = (torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)) for _ in range(2))
    mask = torch.ones((2, 16))
    before = counts.totals()
    step = make_train_step(tb, TrainConfig(opt=O.OptimizerConfig(
        lr=1e-3, warmup_steps=0, total_steps=4)))
    new, _, metrics = step(tp, O.init_opt_state(tp), tokens, targets, mask,
                           {})
    assert calls == {"wkv6_ref": 0, "rglru_ref": 0}
    assert counts.totals() == before
    assert np.isfinite(float(metrics["loss"]))
    for (path, x), y in zip(TR.flatten_with_paths(new), TR.leaves(tp)):
        assert not torch.equal(x, y), f"{path} did not move"
    with torch.no_grad():
        tb.forward(cfg, tp, tokens, impl="ref")
    n_rec = sum(kind == "rglru" for kind in cfg.layer_kinds()) \
        if cfg.attn_kind == "hybrid_rglru" else cfg.n_layers
    key = "wkv6_ref" if cfg.attn_kind == "rwkv" else "rglru_ref"
    assert calls[key] == n_rec > 0
