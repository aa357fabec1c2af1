"""The port's serving plane against the JAX plane, on the CPU.

Both planes get the same bridged weights (the JAX smoke init of
qwen3-8b, cut to two layers: what is held is the plane, and each further
layer only lengthens the JAX compiles), the same engine shape, topology, policy, triggers and prompts;
the port's TEs run with ``device="cpu"`` (the kernels' plain versions).
Each scenario is driven identically on both, and held EXACTLY:

  * greedy tokens per request, in submission order (the two packages
    number requests with their own counters);
  * ``scheduler.decisions``, ``lifecycle_log``, ``scale_events`` (kind,
    TE, source, group, tier, round), restarts per request, transfer
    retries and rejections.

Scenarios: ``pd=1,colo=1`` under ``dist_sched`` (a heatmap that sends
short prompts to the pair, long ones to the colocated TE) and
``round_robin``; an M:N ``pd=1p2d,colo=1`` group; ``fleet_threads=3``
against the serial plane; drain under load and drain-cancel on a load
resurgence; release -> warm pool -> warm scale-out; ``scale_to`` fork
trees with ``fan_out`` on and off, then serving on every forked TE; no
fork while a drain runs; and ``from_warm`` refusing a mismatched entry
before it allocates. Logits are not compared at this level: the engine
tests hold them. One JAX/torch weight pair per module; the JAX run of a
scenario another test reuses is cached.

The JAX TEs of one config share their compiled programs while this module
runs (``share_jax_programs`` of ``test_torch_fixtures.py``): each JAX runner keeps its jitted prefill /
decode programs in per-instance dicts, whose programs depend only on the
config and the shapes (weights and pools are arguments), so every TE of a
plane would otherwise compile the same programs again. Nothing else of the
JAX engine changes.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.faults as JF
import repro.core.scaling as JS
import repro.core.scheduling as JSC
import repro.core.serving_plane as JP
import repro_torch.core.faults as TF
import repro_torch.core.scaling as TS
import repro_torch.core.scheduling as TSC
import repro_torch.core.serving_plane as TP
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.fleet import TEState as JTEState
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.fleet import TEState
from repro_torch.engine import EngineConfig, FlowServe, SamplingParams
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fixtures import share_jax_programs  # noqa: F401 (autouse)

N_LAYERS = 2      # the smoke config cut to 2 layers: the plane, not depth
SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
LENS, RATIOS = [16, 64], [0.25, 1.0]
PD_HEAT = np.ones((2, 2))
COLO_HEAT = -np.ones((2, 2))
MIXED_HEAT = np.array([[1.0, 1.0], [-1.0, -1.0]])   # short -> PD, long -> colo

# one namespace per package, so a scenario is written once
JAX = types.SimpleNamespace(
    name="jax", Plane=JP.ServingJobEngine, Topo=JP.TopologySpec,
    EngineConfig=JEngineConfig, SamplingParams=JSamplingParams,
    FaultPlan=JF.FaultPlan, FaultSpec=JF.FaultSpec,
    AdmissionRejected=JF.AdmissionRejected, WarmPool=JS.WarmPool,
    DrainTrigger=JS.DrainTrigger, LoadSpreadTrigger=JS.LoadSpreadTrigger,
    FastScaler=JS.FastScaler, DRAMPageCache=JS.DRAMPageCache,
    rr=JSC.round_robin_scheduler, TEState=JTEState)
TORCH = types.SimpleNamespace(
    name="torch", Plane=TP.ServingJobEngine, Topo=TP.TopologySpec,
    EngineConfig=EngineConfig, SamplingParams=SamplingParams,
    FaultPlan=TF.FaultPlan, FaultSpec=TF.FaultSpec,
    AdmissionRejected=TF.AdmissionRejected, WarmPool=TS.WarmPool,
    DrainTrigger=TS.DrainTrigger, LoadSpreadTrigger=TS.LoadSpreadTrigger,
    FastScaler=TS.FastScaler, DRAMPageCache=TS.DRAMPageCache,
    rr=TSC.round_robin_scheduler, TEState=TEState)


def prompts(n, length=14, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


def mixed_prompts(n, seed0=0):
    """Alternating short (15-token) and long (61-token) prompts."""
    return [prompts(1, 14 if i % 2 == 0 else 60, seed0 + i)[0]
            for i in range(n)]


def sp(P, max_new=10):
    return P.SamplingParams(temperature=0.0, max_new_tokens=max_new,
                            stop_on_eos=False)


@pytest.fixture(scope="module")
def qwen():
    bundle = get_model(dataclasses.replace(
        jax_smoke_config(jax_get_config("qwen3-8b")), n_layers=N_LAYERS))
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-8b")),
                              n_layers=N_LAYERS)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


def plane(P, qwen, topo, heat=COLO_HEAT, **kw):
    """The package's plane over the module's weights (the port's on the
    CPU)."""
    bundle, jp, cfg, tp = qwen
    if P is JAX:
        return JAX.Plane(bundle, jp, JAX.Topo.parse(topo), heatmap=heat,
                         prefill_lens=LENS, decode_ratios=RATIOS,
                         ecfg=JAX.EngineConfig(**SHARED), **kw)
    return TORCH.Plane(cfg, tp, TORCH.Topo.parse(topo), heatmap=heat,
                       prefill_lens=LENS, decode_ratios=RATIOS,
                       ecfg=TORCH.EngineConfig(**SHARED), device="cpu", **kw)


def summary(je, rids):
    """What the two planes must agree on, with request ids replaced by
    their submission index."""
    idx = {r: i for i, r in enumerate(rids)}
    toks = {c.req_id: c.tokens for c in je.completions}
    restarts = je.restart_counts()
    return dict(
        tokens=[toks.get(r) for r in rids],
        n_completions=len(je.completions),
        decisions=dict(je.scheduler.decisions),
        lifecycle=list(je.lifecycle_log),
        scale_events=[(e["kind"], e["te_id"], e.get("source"),
                       e.get("group"), e.get("tier"), e.get("round"))
                      for e in je.scale_events],
        restarts=[restarts.get(r, 0) for r in rids],
        resubmits=[(idx.get(r["req_id"]), r["from"], r["to"], r["step"],
                    r["reason"]) for r in je.resubmits],
        xfer_retries=je.xfer_retries,
        rejections=[(r["step"], r["queued"], r["cap"], r["n_serving"])
                    for r in je.rejections],
        handles=[(h.te_id, h.state.value) for h in je.handles])


_JAX_RUNS = {}


def both(qwen, scenario, key=None):
    """Run ``scenario(P, qwen) -> (plane, rids)`` on both packages and
    return their summaries (the JAX one cached under ``key``)."""
    out = {}
    for P in (JAX, TORCH):
        if P is JAX and key is not None and key in _JAX_RUNS:
            out["jax"] = _JAX_RUNS[key]
            continue
        je, rids = scenario(P, qwen)
        try:
            out[P.name] = summary(je, rids)
        finally:
            je.close()
        if P is JAX and key is not None:
            _JAX_RUNS[key] = out["jax"]
    return out["jax"], out["torch"]


def assert_same(j, t):
    for key in j:
        assert t[key] == j[key], (key, t[key], j[key])
    assert all(tok is not None for tok in t["tokens"]), "a request was lost"
    assert t["n_completions"] == len(t["tokens"]), "a duplicated completion"


def serve(P, je, ps, max_new=10):
    rids = [je.submit(list(p), sampling=sp(P, max_new)) for p in ps]
    je.run_to_completion()
    return rids


# ---------------------------------------------------------------------------
# topologies and policies
# ---------------------------------------------------------------------------


def _pd_colo(policy, threads=0):
    def scenario(P, qwen):
        je = plane(P, qwen, "pd=1,colo=1", heat=MIXED_HEAT, policy=policy,
                   fleet_threads=threads if P is TORCH else 0)
        return je, serve(P, je, mixed_prompts(6))
    return scenario


@pytest.mark.parametrize("policy", ["dist_sched", "round_robin"])
def test_pd_pair_and_colocated(qwen, policy):
    j, t = both(qwen, _pd_colo(policy), key=("pd_colo", policy))
    assert_same(j, t)
    if policy == "dist_sched":   # the heatmap sent both kinds somewhere
        assert t["decisions"]["pd_disagg"] and t["decisions"]["pd_colo"]


def test_fleet_threads_give_the_serial_run(qwen):
    """Three executor threads change wall-clock only: the port's threaded
    plane gives the serial JAX plane's tokens, decisions and lifecycle."""
    j, t = both(qwen, _pd_colo("dist_sched", threads=3),
                key=("pd_colo", "dist_sched"))
    assert_same(j, t)


def test_mn_group(qwen):
    """pd=1p2d: one prefill TE feeds both decode members."""
    holder = {}

    def scenario(P, qwen):
        je = plane(P, qwen, "pd=1p2d,colo=1", heat=MIXED_HEAT)
        rids = serve(P, je, mixed_prompts(6, seed0=10))
        holder[P.name] = [d.decode_steps
                          for d in je.handles[0].decode_members()]
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert len(holder["torch"]) == 2 and all(holder["torch"])


# ---------------------------------------------------------------------------
# scale-in
# ---------------------------------------------------------------------------


def test_drain_under_load(qwen):
    """A draining TE's in-flight decodes migrate out, the rest finish,
    then it is RELEASED."""
    def scenario(P, qwen):
        je = plane(P, qwen, "colo=2", policy="round_robin")
        rids = [je.submit(p, sampling=sp(P, 24)) for p in prompts(4)]
        for _ in range(2):
            je.step()
        victim = je.handles[1]
        eng = victim.engine
        assert eng.migratable_running()
        je.drain(victim.te_id)
        je.run_to_completion()
        assert victim.state is P.TEState.RELEASED
        assert eng.distflow.bytes_moved() > 0
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert [e[0] for e in t["scale_events"]] == ["drain", "release"]


def test_drain_cancel_on_resurgence(qwen):
    def scenario(P, qwen):
        trig = P.DrainTrigger(low_watermark=0.5, patience=100,
                              resurge_factor=1.0)
        je = plane(P, qwen, "colo=2", policy="round_robin",
                   drain_trigger=trig)
        victim = je.handles[1]
        je.drain(victim.te_id)
        rids = [je.submit(list(p), sampling=sp(P))
                for p in prompts(6, seed0=60)]
        je.step()
        assert victim.state is P.TEState.SERVING
        je.run_to_completion()
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert [e[0] for e in t["scale_events"]] == ["drain", "drain_cancel"]


def test_drain_resubmits_mid_prefill(qwen):
    """Queued prefills on a draining TE restart on the destination from
    the prompt (``resubmits``, not ``scale_events``)."""
    def scenario(P, qwen):
        je = plane(P, qwen, "colo=2", policy="round_robin")
        rids = [je.submit(list(p), sampling=sp(P))
                for p in prompts(4, length=40, seed0=80)]
        je.drain(je.handles[1].te_id)
        je.run_to_completion()
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert t["resubmits"] and [e[0] for e in t["scale_events"]] \
        == ["drain", "release"]


def test_no_fork_while_draining(qwen):
    """A spread breach during a drain must not fork, and the scale-out
    trigger is not fed until the drain completes."""
    def scenario(P, qwen):
        trig = P.LoadSpreadTrigger(threshold=0.2, patience=1, min_load=0.5,
                                   max_fires=5)
        je = plane(P, qwen, "colo=2", policy="round_robin",
                   scaler=P.FastScaler(P.DRAMPageCache()), trigger=trig)
        prompt = prompts(1)[0]
        rids = [je.submit(list(prompt), sampling=sp(P, 24))
                for _ in range(4)]
        je.step()
        je.drain("te-colo1")
        b0 = trig.breach_steps
        while any(h.state is P.TEState.DRAINING for h in je.handles):
            je.step()
            assert trig.breach_steps == b0, "trigger fed during a drain"
            assert je.steps < 300
        je.run_to_completion()
        assert trig.armed and trig.fires == 0
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert "fork" not in [e[0] for e in t["scale_events"]]


# ---------------------------------------------------------------------------
# scale-out: fork trees and the warm pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fan_out", [True, False])
def test_fork_tree_then_serving(qwen, fan_out):
    """scale_to(4) from one TE: rounds of 1 and 2 forks (fan-out) or 3
    rounds of one (serial); then round-robin serving over every TE."""
    plans = {}

    def scenario(P, qwen):
        je = plane(P, qwen, "colo=1", policy="round_robin")
        plan = je.scale_to(4, fan_out=fan_out)
        plans[P.name] = ([len(r["tes"]) for r in plan["rounds"]],
                         [r["sources"] for r in plan["rounds"]],
                         plan["tiers"])
        je._rr = P.rr(je._handles)
        rids = serve(P, je, prompts(8))
        assert all(e.decode_steps > 0 for e in je.engines)
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert plans["torch"] == plans["jax"]
    assert plans["torch"][0] == ([1, 2] if fan_out else [1, 1, 1])


def test_release_to_warm_pool_then_warm_scale_out(qwen):
    """A drained TE's weights land in the warm pool; scale_to(3) then
    brings up one TE by fork and one from the pool, and all serve."""
    plans = {}

    def scenario(P, qwen):
        pool = P.WarmPool()
        je = plane(P, qwen, "colo=2", policy="round_robin", warm_pool=pool)
        rids = serve(P, je, prompts(1))
        je.drain("te-colo1")
        je.run_to_completion()
        assert pool.hit(je._asset_name())
        plan = je.scale_to(3)
        plans[P.name] = (len(plan["rounds"]), plan["tiers"],
                         pool.stats()["hits"])
        je._rr = P.rr(je._handles)
        return je, rids + serve(P, je, prompts(4, seed0=30))
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert plans["torch"] == plans["jax"] \
        == (1, {"fork": 1, "warm": 1, "cold": 0}, 1)


def test_fork_owns_a_copy_and_warm_upload_is_new_storage(qwen):
    """The port's fork copies every parameter into new storage (where the
    reference's single-device fork aliases), equal bit for bit; a
    released TE's host copy and a warm TE's upload are new storage too."""
    _, _, cfg, tp = qwen
    je = plane(TORCH, qwen, "colo=1", warm_pool=TS.WarmPool())
    try:
        je.scale_to(2)
        src, fork = je.engines
        from repro_torch.engine.distflow import tree_leaves
        a = tree_leaves(src.runner.params)
        b = tree_leaves(fork.runner.params)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
        host = fork.release_params()
        assert not fork.fork_ready and fork.runner.layers is None
        warm = FlowServe.from_warm(cfg, host, TORCH.EngineConfig(**SHARED),
                                   name="te-w", device="cpu")
        c = tree_leaves(warm.runner.params)
        for x, y in zip(a, c):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    finally:
        je.close()


def test_from_warm_rejects_mismatch_before_allocating(qwen, monkeypatch):
    _, _, cfg, tp = qwen
    from repro_torch.core import scaling

    def no_upload(*a, **kw):
        raise AssertionError("uploaded a mismatched entry")
    monkeypatch.setattr(scaling, "copy_to_device", no_upload)
    ecfg = TORCH.EngineConfig(**SHARED)
    with pytest.raises(TS.WarmPoolMismatchError, match="does not match"):
        FlowServe.from_warm(cfg, {"not_the_model": torch.zeros(4, 4)},
                            ecfg, name="te-bad", device="cpu")
    wrong = [dict(tp, embed=torch.zeros(3, 3))]
    with pytest.raises(TS.WarmPoolMismatchError):
        FlowServe.from_warm(cfg, wrong, ecfg, name="te-bad", device="cpu")
    monkeypatch.undo()
    assert FlowServe.from_warm(cfg, [tp], ecfg, name="te-good",
                               device="cpu").fork_ready
