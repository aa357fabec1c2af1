"""Fault recovery of the port's serving plane against the JAX plane, on
the CPU (the helpers, weights and JAX program sharing of
``tests/test_torch_plane.py``).

Each case injects the same seeded ``FaultPlan`` into both planes and holds
the same summary exactly (greedy tokens in submission order, decisions,
lifecycle log, scale events, restarts per request, transfer retries,
rejections):

  * the seed-7 kill of ``benchmarks/bench_fault_recovery.py``: three
    colocated TEs, 12 requests, the seeded victim crashed at step 3, the
    fleet repaired by ``scale_to(3)``: 12/12 complete, none lost or
    duplicated, the tokens of the no-fault run; the port also with three
    executor threads;
  * a source that dies mid-migration (after the destination imported)
    restarts nothing twice;
  * a transient transfer fault on a PD hand-off retries with backoff;
  * a transient fork fault retries from another source, and a fork source
    that dies mid-fork is quarantined;
  * a drain and its cancel racing a concurrent failure;
  * admission shedding under capacity loss, reopening after repair.
"""
import pytest

from test_torch_plane import (PD_HEAT, TORCH, assert_same, both, plane,
                              prompts, qwen, serve, sp, summary)
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fixtures import share_jax_programs  # noqa: F401 (autouse)

pytestmark = pytest.mark.faults

# the qwen fixture comes from tests/test_torch_plane.py
__all__ = ["qwen"]

N_TES, N_REQS, KILL_STEP, SEED = 3, 12, 3, 7


def _burst(P, je, ps, max_new=24, repair_to=None):
    """Submit ``ps`` and step until no work is left; on the first TE
    failure, repair the fleet with ``scale_to(repair_to)``."""
    rids = [je.submit(list(p), sampling=sp(P, max_new)) for p in ps]
    repaired = repair_to is None
    while je.has_work():
        je.step()
        if not repaired and any(e["kind"] == "te_failure"
                                for e in je.scale_events):
            je.scale_to(repair_to)
            repaired = True
        assert je.steps < 2000
    return rids


def _kill(threads=0, fault=True):
    def scenario(P, qwen):
        fp = None
        if fault:
            fp = P.FaultPlan(seed=SEED)
            victim = fp.choose_victim([f"te-colo{i}" for i in range(N_TES)])
            fp.add(P.FaultSpec("te_crash", te=victim, at_step=KILL_STEP))
        je = plane(P, qwen, f"colo={N_TES}", policy="round_robin",
                   fault_plan=fp,
                   fleet_threads=threads if P is TORCH else 0)
        rids = _burst(P, je, prompts(N_REQS),
                      repair_to=N_TES if fault else None)
        if fault:
            assert fp.fired("te_crash") == 1
            assert je.n_serving() == N_TES
        return je, rids
    return scenario


@pytest.mark.parametrize("threads", [0, 3])
def test_seed7_kill_recovers_every_request(qwen, threads):
    j, t = both(qwen, _kill(threads), key="kill")
    assert_same(j, t)
    assert len(t["tokens"]) == N_REQS == t["n_completions"]
    assert sum(t["restarts"]) > 0
    failures = [e for e in t["scale_events"] if e[0] == "te_failure"]
    assert len(failures) == 1
    # restarted requests re-run from the prompt: the no-fault tokens
    je, rids = _kill(fault=False)(TORCH, qwen)
    try:
        assert summary(je, rids)["tokens"] == t["tokens"]
    finally:
        je.close()


def test_mid_migration_source_crash_dedupes(qwen):
    def scenario(P, qwen):
        fp = P.FaultPlan(specs=[P.FaultSpec("te_crash", te="te-colo0",
                                            phase="migration")])
        je = plane(P, qwen, "colo=2", policy="round_robin", fault_plan=fp)
        rids = [je.submit(list(p), sampling=sp(P, 40)) for p in prompts(4)]
        for _ in range(3):
            je.step()
        je.drain("te-colo0")
        je.run_to_completion()
        assert fp.fired("te_crash") == 1
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert [e[:2] for e in t["scale_events"]
            if e[0] == "te_failure"] == [("te_failure", "te-colo0")]


def test_transient_transfer_fault_retries(qwen):
    def scenario(P, qwen):
        fp = P.FaultPlan(specs=[P.FaultSpec("xfer_fail", te="te-pd0-p",
                                            count=2)])
        je = plane(P, qwen, "pd=1,colo=0", heat=PD_HEAT, fault_plan=fp)
        rids = serve(P, je, prompts(3))
        assert fp.fired("xfer_fail") == 2 and je._xfer_retry == {}
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert t["xfer_retries"] == 2


@pytest.mark.parametrize("fault", ["fork_fail", "source_crash"])
def test_fork_fault_rotates_source(qwen, fault):
    """A transient ForkFault retries from the next source; a source that
    dies mid-fork is quarantined and another source finishes the fork.
    Then the fleet serves."""
    def scenario(P, qwen):
        spec = P.FaultSpec("fork_fail", count=1) if fault == "fork_fail" \
            else P.FaultSpec("te_crash", te="te-colo0", phase="fork")
        fp = P.FaultPlan(specs=[spec])
        je = plane(P, qwen, "colo=2", fault_plan=fp)
        je._scale_out()
        assert je._reserved_windows == set()
        assert je.n_serving() == (3 if fault == "fork_fail" else 2)
        return je, serve(P, je, prompts(3, seed0=5))
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert "fork" in [e[0] for e in t["scale_events"]]


def test_drain_cancel_races_failure(qwen):
    """colo1 crashes while colo0 drains: colo1's work parks (nothing
    admits), the cancel lands, and the parked work flushes onto colo0."""
    def scenario(P, qwen):
        fp = P.FaultPlan(specs=[P.FaultSpec("te_crash", te="te-colo1",
                                            at_step=0)])
        je = plane(P, qwen, "colo=2", policy="round_robin", fault_plan=fp)
        rids = [je.submit(list(p), sampling=sp(P)) for p in prompts(6)]
        je.drain("te-colo0")
        je.step()
        assert je._parked
        je.cancel_drain("te-colo0")
        je.run_to_completion()
        assert not je._parked
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert any(r[1] == "parked" for r in t["resubmits"])


def test_admission_sheds_then_reopens_after_repair(qwen):
    def scenario(P, qwen):
        fp = P.FaultPlan(specs=[P.FaultSpec("te_crash", te="te-colo1",
                                            at_step=0)])
        je = plane(P, qwen, "colo=2", policy="round_robin", fault_plan=fp,
                   admission_limit=2)
        rids = [je.submit(list(p), sampling=sp(P)) for p in prompts(3)]
        je.step()
        assert je.n_serving() == 1
        with pytest.raises(P.AdmissionRejected):
            for p in prompts(8, seed0=50):
                rids.append(je.submit(list(p), sampling=sp(P)))
        je.scale_to(2)                        # repair: admission reopens
        rids.append(je.submit(prompts(1, seed0=90)[0], sampling=sp(P)))
        je.run_to_completion()
        return je, rids
    j, t = both(qwen, scenario)
    assert_same(j, t)
    assert len(t["rejections"]) == 1
