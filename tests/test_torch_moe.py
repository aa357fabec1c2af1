"""The port's MoE (``models/moe.py``) and the two MoE archs of the paged
family, granite-moe-3b-a800m (40 experts top-8 at full width, G = 3) and
mixtral-8x7b (8 experts top-2, sliding window), against the JAX package on
the CPU.

  * ``moe_capacity`` equal to the reference's over a range of token
    counts;
  * ``moe_apply`` on seeded numpy inputs against the JAX ``moe_apply``
    with 1 and 2 capacity groups, on a drop-free config and on one whose
    skewed router sends more tokens to an expert than it keeps (capacity
    factor 1.0), fp32 within 1e-5;
  * for both archs at smoke (4 experts, drop-free): configs, bridge, own
    init layout, teacher-forced logits, prefill + decode on the paged
    runner against the forward (< 2e-3), and EXACT greedy tokens of the
    port's ``FlowServe`` against the JAX ``FlowServe`` on the ragged mix
    and at K in {1, 4, 8} — ``arch_suite`` of ``test_torch_paged_archs.py``
    with the MoE checks below, in ``test_torch_moe_granite.py`` and
    ``test_torch_moe_mixtral.py`` (one file per arch, so ``--dist
    loadfile`` can put them on two workers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import MoEConfig
from repro_torch.launch.mesh import one_rank
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)
CPU = one_rank(torch.device("cpu"))     # one weights tree on one rank


def _cfgs(**kw):
    return MoEConfig(**kw), JMoEConfig(**kw)


def test_moe_capacity_matches_reference():
    for kw in (dict(n_experts=40, top_k=8, d_expert=512),
               dict(n_experts=8, top_k=2, d_expert=64),
               dict(n_experts=4, top_k=2, d_expert=32, capacity_factor=100.0),
               dict(n_experts=4, top_k=1, d_expert=32, capacity_factor=1.0)):
        cfg, jcfg = _cfgs(**kw)
        for t in (1, 3, 7, 8, 24, 64, 100, 512, 4096):
            assert M.moe_capacity(t, cfg) == JM.moe_capacity(t, jcfg), (kw, t)
    # the full-width granite prefill pass keeps 128 tokens per expert
    assert M.moe_capacity(512, _cfgs(n_experts=40, top_k=8,
                                     d_expert=512)[0]) == 128


def test_moe_groups_match_reference():
    """The teacher-forced forward's capacity groups, as ``_moe_groups``."""
    for t in (1, 24, 63, 64, 96, 128, 130, 512, 1024, 2048):
        assert T.moe_groups(t) == JT._moe_groups(jnp.zeros((1, t, 1))), t


def _moe_inputs(act, skew, seed=0, e=4, d=32, f=48, b=2, s=24):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, s, d)).astype(np.float32)
    router = (rs.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if skew:
        # every token leans on expert 0: a shared direction in x that only
        # expert 0's router column reads
        u = rs.standard_normal(d).astype(np.float32)
        x += u
        router[:, 0] += 0.5 * u / np.linalg.norm(u)
    p = {"router": router,
         "w_up": (rs.standard_normal((e, d, f)) / np.sqrt(d)).astype(
             np.float32),
         "w_down": (rs.standard_normal((e, f, d)) / np.sqrt(f)).astype(
             np.float32)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = (rs.standard_normal((e, d, f)) / np.sqrt(d)).astype(
            np.float32)
    return x, p


def _routed_over_capacity(x, p, cfg, groups):
    """How many (group, expert) pairs are routed more tokens than they
    keep, from the inputs (numpy)."""
    b, s, d = x.shape
    xt = x.reshape(groups, -1, d)
    tg = xt.shape[1]
    top = np.argsort(-(xt @ p["router"]), axis=-1)[..., :cfg.top_k]
    cap = min(M.moe_capacity(tg, cfg), tg)
    counts = np.stack([(top == ex).any(-1).sum(-1)
                       for ex in range(cfg.n_experts)], -1)
    return int((counts > cap).sum())


@pytest.mark.parametrize("act", ["swiglu", "geglu", "sqrelu"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("drops", [False, True])
def test_moe_apply_matches_reference(act, groups, drops):
    """fp32 within 1e-5 (the same products, summed in another order). The
    dropping case must really drop: its skewed router sends expert 0 more
    tokens than its capacity at capacity factor 1.0."""
    cfg, jcfg = _cfgs(n_experts=4, top_k=2, d_expert=48,
                      capacity_factor=1.0 if drops else 100.0)
    x, p = _moe_inputs(act, skew=drops, seed=3 + groups)
    over = _routed_over_capacity(x, p, cfg, groups)
    assert (over > 0) == drops, over
    want = JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg, act, groups=groups)
    got = M.moe_apply([{k: torch.from_numpy(v) for k, v in p.items()}],
                      torch.from_numpy(x), cfg, act, CPU, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_moe_apply_rejects_uneven_groups():
    cfg, _ = _cfgs(n_experts=4, top_k=2, d_expert=48)
    x, p = _moe_inputs("swiglu", skew=False)
    with pytest.raises(ValueError, match="groups"):
        M.moe_apply([{k: torch.from_numpy(v) for k, v in p.items()}],
                    torch.from_numpy(x), cfg, "swiglu", CPU, groups=5)


def moe_config_check(model):
    """The MoE smoke rule: 4 experts, top-2, d_expert 32, drop-free."""
    cfg = model[2]
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.capacity_factor) == (4, 2, 32, 100.0)


def moe_bridge_check(model):
    """The router stays fp32."""
    assert model[3]["blocks"]["moe"]["router"].dtype == torch.float32
