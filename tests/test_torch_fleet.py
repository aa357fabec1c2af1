"""The port's fleet control plane, on the CPU, without live engines but
one: the
pure-Python pieces against the JAX package's on the same inputs, and the
port's own executor, warm pool and window allocator.

  * ``TopologySpec.parse`` (M:N groups, errors) as the reference parses;
  * ``FleetExecutor`` submit/collect, per-unit pinning, quarantine of a
    failing unit, and a finished job's closure released by its worker;
  * ``LoadSpreadTrigger`` / ``DrainTrigger`` decisions on seeded load
    series, ``tier_seconds``, ``backoff_s``, ``FaultPlan`` firings and
    victims for seeds 0-9, ``ClusterManager`` autoscale and health: equal
    to the JAX package's;
  * ``WarmPool`` hit / miss / LRU / oversize / tag mismatch with host
    copies of torch tensors (pinned on a card: the gpu-marked tests);
  * the window allocator under a monkeypatched device count: a thread
    hammer, a reserved free-list entry, and the window returned when a
    bring-up fails;
  * at tp 2 a paged arch's plane serves (a 2-layer smoke TE, the one live
    engine here) and its weights fork onto a tp-2 mesh, while a slot
    arch's is refused, naming its ROADMAP item.
"""
import dataclasses
import gc
import sys
import threading
import types
import weakref

import numpy as np
import pytest
import torch

import repro.core.cluster as JC
import repro.core.faults as JF
import repro.core.scaling as JS
import repro.core.serving_plane as JP
import repro_torch.core.cluster as TC
import repro_torch.core.faults as TF
import repro_torch.core.scaling as TS
import repro_torch.core.serving_plane as TP
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.fleet import FleetExecutor, TEState
from repro_torch.engine import EngineConfig, SamplingParams
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

SPECS = ["pd=2,colo=2", "pd=1p2d,colo=1", "pd=2p3d,colo=0", "pd=1,colo=1,tp=2",
         "colo=3", "pd=1p2d,pd=1,colo=0"]
BAD = ["pd=0,colo=0", "pp=3", "pd=0p2d", "colo", "pd=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_topology_parse_as_reference(spec):
    t, j = TP.TopologySpec.parse(spec), JP.TopologySpec.parse(spec)
    assert (t.pd, t.colo, t.tp, t.groups(), t.n_engines()) \
        == (j.pd, j.colo, j.tp, j.groups(), j.n_engines())


@pytest.mark.parametrize("spec", BAD)
def test_topology_parse_errors_as_reference(spec):
    with pytest.raises(ValueError):
        JP.TopologySpec.parse(spec)
    with pytest.raises(ValueError):
        TP.TopologySpec.parse(spec)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_plane_refuses_tensor_parallelism(arch):
    """(The name is from when the plane refused tp > 1.) At ``tp=2`` a
    paged arch and a slot arch (smoke, 2 layers) are each served on a
    tp-2 TE, and ``npu_fork_live`` forks the weights onto a tp-2 mesh,
    every shard its rank's slice of the source in new storage."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), n_layers=2)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    je = TP.ServingJobEngine(
        cfg, params, TP.TopologySpec(colo=1, tp=2), heatmap=None,
        prefill_lens=[], decode_ratios=[], policy="round_robin",
        ecfg=EngineConfig(n_pages=32, page_size=8, n_slots=2, max_len=64),
        device="cpu")
    try:
        te = je.engines[0]
        assert te.ecfg.tp == 2 and len(te.runner.params) == 2
        rids = [je.submit([1, 5, 9, 7], sampling=SamplingParams(
            temperature=0.0, max_new_tokens=4, stop_on_eos=False))
            for _ in range(2)]
        done = {c.req_id: c.tokens for c in je.run_to_completion()}
        assert all(len(done[r]) == 4 for r in rids)
    finally:
        je.close()
    forked, lr = TS.npu_fork_live([params], cfg,
                                  make_engine_mesh(2, 0, "cpu"))
    # a column-split projection of each: attention's wq, rwkv's wr
    pick = (lambda t: t["blocks"]["attn"]["wq"]) if "attn" in \
        params["blocks"] else (lambda t: t["blocks"]["tm"]["wr"])
    wq = pick(params)
    half = wq.shape[-1] // 2
    for r, tree in enumerate(forked):
        got = pick(tree)
        assert torch.equal(got, wq[..., r * half:(r + 1) * half])
        assert got.data_ptr() != wq.data_ptr()
    assert lr.bytes_moved == TS._nbytes(params)


# ---------------------------------------------------------------------------
# FleetExecutor
# ---------------------------------------------------------------------------


def test_executor_submit_collect_and_pinning():
    ex = FleetExecutor(2)
    seen = {}

    def work(unit, i):
        seen.setdefault(unit, set()).add(threading.current_thread().name)
        return unit, i

    try:
        for rep in range(3):
            for unit in ("a", "b", "c"):          # 3 units share 2 workers
                ex.submit(unit, lambda u=unit, r=rep: work(u, r))
            done, failed = ex.collect(3)
            assert failed == []
            assert sorted(done) == [(u, (u, rep)) for u in "abc"]
        assert all(len(names) == 1 for names in seen.values())
    finally:
        ex.close()
    with pytest.raises(RuntimeError):
        ex.submit("a", lambda: 0)
    with pytest.raises(ValueError):
        FleetExecutor(0)


def test_executor_quarantines_a_failure():
    ex = FleetExecutor(2)
    ran = []

    def boom():
        raise RuntimeError("unit exploded")
    try:
        ex.submit("ok", lambda: ran.append(1) or "fine")
        ex.submit("bad", boom)
        done, failed = ex.collect(2)
    finally:
        ex.close()
    assert done == [("ok", "fine")] and ran == [1]
    (tag, exc), = failed
    assert tag == "bad" and "unit exploded" in str(exc)


def test_executor_drops_a_finished_job():
    """A worker must not keep the last job's closure (it holds the unit's
    engines) while it waits for the next."""
    class Unit:
        pass
    unit = Unit()
    ref = weakref.ref(unit)
    ex = FleetExecutor(1)
    try:
        ex.submit("u", lambda u=unit: id(u))
        ex.collect(1)
        del unit
        gc.collect()
        assert ref() is None
    finally:
        ex.close()


def test_executor_many_threads_stress():
    """More units than threads, a short switch interval: every event comes
    back exactly once and per-unit order holds."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ex = FleetExecutor(4)
    order = {u: [] for u in range(16)}
    try:
        for rnd in range(20):
            for u in order:
                ex.submit(u, lambda u=u, r=rnd: order[u].append(r) or r)
            done, failed = ex.collect(len(order))
            assert not failed and len(done) == len(order)
    finally:
        ex.close()
        sys.setswitchinterval(old)
    assert all(v == list(range(20)) for v in order.values())
    assert all(not w.thread.is_alive() for w in ex._workers)


# ---------------------------------------------------------------------------
# triggers, tier costs, backoff: equal to the reference's
# ---------------------------------------------------------------------------


def _series(seed, n=200, width=3):
    rs = np.random.RandomState(seed)
    scale = rs.choice([0.0, 0.5, 4.0, 40.0], size=n)
    return [list(rs.rand(width) * s) for s in scale]


@pytest.mark.parametrize("seed", range(4))
def test_triggers_decide_as_reference(seed):
    kw = dict(threshold=0.4, patience=3, min_load=1.0, max_fires=6,
              te_capacity=10.0)
    tl, jl = TS.LoadSpreadTrigger(**kw), JS.LoadSpreadTrigger(**kw)
    dkw = dict(low_watermark=2.0, patience=4, min_serving=1, max_fires=5)
    td, jd = TS.DrainTrigger(**dkw), JS.DrainTrigger(**dkw)
    got, want = [], []
    for i, loads in enumerate(_series(seed)):
        got.append((tl.observe(loads), td.observe(loads, 3),
                    td.resurgent(loads)))
        want.append((jl.observe(loads), jd.observe(loads, 3),
                     jd.resurgent(loads)))
        if i % 17 == 16:
            td.rearm()
            jd.rearm()
    assert got == want
    assert any(g[0] for g in got) and any(g[1] for g in got)


def test_tier_seconds_and_backoff_as_reference():
    for n_bytes, tp in ((16_400_000_000, 1), (3_200_000_000, 1), (7e9, 2)):
        ta, ja = TS.ModelAsset("m", n_bytes, tp), JS.ModelAsset("m", n_bytes, tp)
        tiers = [TS.tier_seconds(ta, t) for t in ("fork", "warm", "cold")]
        assert tiers == [JS.tier_seconds(ja, t)
                         for t in ("fork", "warm", "cold")]
        assert tiers[0] < tiers[1] < tiers[2]     # the ladder's order
    assert [TF.backoff_s(a) for a in range(-1, 8)] \
        == [JF.backoff_s(a) for a in range(-1, 8)]
    assert TF.backoff_s(20) == 0.1


# ---------------------------------------------------------------------------
# FaultPlan: firings and victims
# ---------------------------------------------------------------------------


def _engine(name, steps=0, queued=False):
    sched = types.SimpleNamespace(
        queued_seqs=lambda: [object()] if queued else [])
    return types.SimpleNamespace(
        name=name, steps=steps, scheduler=sched, fault_plan=None,
        distflow=types.SimpleNamespace(fault_hook=None))


def _drive(F, seed):
    """One scripted run of hooks over a seeded plan; returns what fired."""
    fp = F.FaultPlan(seed=seed)
    names = [f"te-colo{i}" for i in range(4)] + ["te-pd0-p", "te-pd0-d"]
    victim = fp.choose_victim(names)
    fp.add(F.FaultSpec("te_crash", te=victim, at_step=2 + seed % 3))
    fp.add(F.FaultSpec("te_crash", te="te-pd0", phase="prefill"))
    fp.add(F.FaultSpec("xfer_fail", te="te-pd0-p", count=2))
    fp.add(F.FaultSpec("fork_fail", count=1))
    fp.add(F.FaultSpec("te_crash", te="te-colo3", phase="migration"))
    events = []
    for step in range(6):
        for i, name in enumerate(names):
            eng = _engine(name, step, queued=(step + i) % 2 == 0)
            for hook in (lambda: fp.on_step(eng),
                         lambda: fp.on_migration(eng, "dst"),
                         lambda: fp.on_fork(eng),
                         lambda: fp.xfer_hook(name, "te-x", 64)):
                try:
                    hook()
                except (F.TEFailureError, F.ForkFault,
                        F.TransferFault) as exc:
                    events.append((step, name, type(exc).__name__,
                                   getattr(exc, "te", None)))
    return victim, events, fp.injected


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_fires_as_reference(seed):
    victim, events, injected = _drive(TF, seed)
    assert (victim, events, injected) == _drive(JF, seed)
    assert any(e[2] == "TEFailureError" for e in events)


def test_fault_plan_attach_and_unknown_kind():
    eng = _engine("te-0")
    fp = TF.FaultPlan()
    fp.attach(eng)
    assert eng.fault_plan is fp and eng.distflow.fault_hook == fp.xfer_hook
    with pytest.raises(ValueError):
        TF.FaultPlan(specs=[TF.FaultSpec("meteor")])
    assert TF.TransferFault is __import__(
        "repro_torch.engine.distflow", fromlist=["x"]).TransferFault


# ---------------------------------------------------------------------------
# ClusterManager
# ---------------------------------------------------------------------------


def _cluster(C, S):
    cm = C.ClusterManager(S.FastScaler(S.DRAMPageCache()),
                          S.ModelAsset("qwen3-8b", 16_400_000_000),
                          C.AutoscalerConfig(cooldown_s=1.0, max_tes=6),
                          heartbeat_timeout=5.0)
    cm.register_te(C.TaskExecutor("te-ext", "colocated"))
    return cm


def test_cluster_manager_as_reference():
    tc, jc = _cluster(TC, TS), _cluster(JC, JS)
    loads = [(0.9, 0.0), (0.95, 0.1), (0.1, 0.0), (0.5, 0.2), (0.05, 0.0),
             (0.05, 0.0), (0.99, 0.0), (0.1, 0.0), (0.1, 0.0)]
    got, want = [], []
    for i, (load, slo) in enumerate(loads):
        got.append(tc.autoscale(load, slo, now=10.0 + 2 * i))
        want.append(jc.autoscale(load, slo, now=10.0 + 2 * i))
    assert got == want and any(d > 0 for d in got) and any(d < 0 for d in got)
    assert list(tc.tes) == list(jc.tes)
    assert [(e["dir"], e.get("path"), e.get("te_id")) for e in tc.scale_log] \
        == [(e["dir"], e.get("path"), e.get("te_id")) for e in jc.scale_log]
    for cm in (tc, jc):
        te = next(iter(cm.tes.values()))
        te.fail()
        te.last_heartbeat -= 100
    assert tc.check_health() == jc.check_health()
    assert all(te.state is TEState.SERVING and te.healthy
               for te in tc.tes.values())


# ---------------------------------------------------------------------------
# WarmPool
# ---------------------------------------------------------------------------


def test_warm_pool_hit_miss_lru_oversize_and_tags():
    pool = TS.WarmPool(capacity_bytes=3000)
    a = {"w": torch.ones(8, 8)}                  # 256 B
    assert pool.put("a", a, tag="qwen")
    assert pool.entries["a"]["w"].data_ptr() != a["w"].data_ptr()
    assert torch.equal(pool.entries["a"]["w"], a["w"])   # a host copy
    assert pool.get("b") is None                       # miss
    assert pool.get("a", tag="qwen") is pool.entries["a"]
    with pytest.raises(TS.WarmPoolMismatchError):
        pool.get("a", tag="llama")
    with pytest.raises(TS.WarmPoolMismatchError):
        pool.put("a", a, host_copy=False, tag="llama")
    assert pool.put("b", [torch.zeros(500)], host_copy=False)   # 2000 B
    pool.get("a")                                       # a is now newest
    assert pool.put("c", {"x": torch.zeros(200)})       # 800 B: evicts b
    assert not pool.hit("b") and pool.hit("a") and pool.hit("c")
    assert not pool.put("big", {"w": torch.zeros(1000)})    # 4000 B > cap
    assert pool.stats() == {"hits": 2, "misses": 1, "evictions": 1,
                            "bytes_evicted": 2000, "resident": 2,
                            "used_bytes": 1056}


# ---------------------------------------------------------------------------
# device windows
# ---------------------------------------------------------------------------


def _window_plane(monkeypatch, n_devices):
    """A plane skeleton exposing only the window allocator, its device
    count monkeypatched."""
    monkeypatch.setattr(TP, "_device_count", lambda device: n_devices)
    je = TP.ServingJobEngine.__new__(TP.ServingJobEngine)
    je.device = torch.device("cpu")
    je.topology = TP.TopologySpec(colo=1)
    je._offset_cursor = 0
    je._free_windows, je._window_of = [], {}
    je._window_lock = threading.Lock()
    je._reserved_windows = set()
    return je


def test_window_thread_hammer(monkeypatch):
    je = _window_plane(monkeypatch, 8)
    errors = []

    def hammer(tid):
        rng = np.random.RandomState(tid)
        try:
            for i in range(40):
                off, owned = je._alloc_window()
                if rng.rand() < 0.5:
                    je._abort_window(off, owned)
                else:
                    name = f"te-{tid}-{i}"
                    je._commit_window(name, off, owned)
                    if owned:
                        with je._window_lock:
                            je._free_windows.append(je._window_of.pop(name))
        except Exception as exc:                        # pragma: no cover
            errors.append(exc)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert je._reserved_windows == set() and not je._window_of
    got = {je._alloc_window() for _ in range(je._offset_cursor)}
    assert all(owned for _, owned in got)
    assert len(got) == je._offset_cursor


def test_window_skips_a_reserved_free_list_entry(monkeypatch):
    je = _window_plane(monkeypatch, 4)
    off, owned = je._alloc_window()
    je._free_windows.append(off)            # a release racing a bring-up
    off2, owned2 = je._alloc_window()
    assert owned and owned2 and off2 != off and off not in je._free_windows
    # past the device count every TE shares window 0, unowned
    assert [je._alloc_window() for _ in range(3)][-1] == (0, False)
    je._commit_window("te-fallback", 0, False)
    assert 0 in je._reserved_windows        # the real claim survives


def test_failed_bring_up_returns_its_window(monkeypatch):
    """A TE whose construction raises gives its window back."""
    je = _window_plane(monkeypatch, 2)
    je._base_ecfg = TP.EngineConfig()
    je.cfg = je.params = None
    je.fault_plan, je.engines = None, []

    def broken(*a, **kw):
        raise RuntimeError("bring-up failed")
    monkeypatch.setattr(TP, "FlowServe", broken)
    with pytest.raises(RuntimeError, match="bring-up failed"):
        je._spawn("te-x", "colocated")
    assert je._reserved_windows == set() and je._free_windows == [0]
    assert je._alloc_window() == (0, True)
