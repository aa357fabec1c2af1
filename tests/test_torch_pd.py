"""PD disaggregation in the port against the JAX package, on the CPU.

Both packages run identical weights (the JAX smoke init, bridged); the
torch TEs run with ``device="cpu"``, so attention and the recurrences take
the kernels' plain versions. Held here, all EXACT unless a tolerance is
stated:

  * qwen3-8b smoke (cut to ``N_LAYERS`` layers: no assertion depends on
    depth): the port's prefill TE -> decode TE pair gives the JAX P->D
    pair's greedy tokens and the JAX colocated TE's, on the ragged mix
    of ``tests/test_torch_engine.py`` at decode horizons K in {1, 8}, with
    ``load_metrics()`` of both pairs equal after every pump step; and with
    ``overlap=False``, layer chunks 1 and 2, and the v1 host round trip;
  * the D-TE's pool run equals the exported run, also after the P-TE has
    reused the migrated pages for another prompt;
  * an ``OutOfPagesError`` on import leaves the D-TE untouched and restores
    the sequence at its source; a preempted D-TE sequence drops its
    pending import;
The slot family's migrations and DistFlow's pricing twins are in
``test_torch_pd_slot.py``. One JAX engine per role is built per module and
reused, and every JAX TE points its jitted programs at one cache per
config (``share_jax_programs`` of ``test_torch_fixtures.py``), so each shape
compiles once; every case keeps both packages' traffic in step.
"""
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.kv_cache import OutOfPagesError
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import share_jax_programs  # noqa: F401 (autouse)
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

# tests/test_pd_migration.py's engine shape
SHARED = dict(n_pages=64, page_size=8, n_slots=4, max_len=96,
              max_batch_tokens=32, chunk_size=8, max_decode_batch=4)
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]
PROMPT = [1] + [int(x) for x in np.random.RandomState(7).randint(3, 200, 14)]
N_LAYERS = 2


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


def _sp(cls, max_new=6):
    return cls(temperature=0.0, max_new_tokens=max_new, stop_on_eos=False)


def _bridge(arch, n_layers=None):
    """Both packages' smoke config of ``arch`` (cut to ``n_layers``) on the
    same weights: (JAX bundle, JAX params, port config, port params)."""
    jcfg = jax_smoke_config(jax_get_config(arch))
    cfg = smoke_config(get_config(arch))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bundle = get_model(jcfg)
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


def _jpair(bundle, jp, tag):
    pe = JFlowServe(bundle, jp, JEngineConfig(mode="prefill", **SHARED),
                    name=f"{tag}-p")
    de = JFlowServe(bundle, jp, JEngineConfig(mode="decode", **SHARED),
                    name=f"{tag}-d")
    pe.distflow.link_cluster([de.distflow])
    return pe, de


def _tpair(cfg, tp, tag="t", d_kw=None):
    pe = FlowServe(cfg, tp, EngineConfig(mode="prefill", **SHARED),
                   name=f"{tag}-p", device="cpu")
    de = FlowServe(cfg, tp, EngineConfig(mode="decode",
                                         **{**SHARED, **(d_kw or {})}),
                   name=f"{tag}-d", device="cpu")
    pe.distflow.link_cluster([de.distflow])
    return pe, de


def _pump_step(pe, de, **migrate_kw):
    """One step of the reference's PD pump: P steps, every finished prefill
    migrates, D steps. Returns D's completions."""
    if pe.has_work():
        pe.step()
    for rid in pe.pop_migratable():
        pe.migrate_out(rid, de, **migrate_kw)
    return de.step() if de.has_work() else []


def _serve_pd(pair, reqs, **migrate_kw):
    pe, de = pair
    for r in reqs:
        pe.add_request(r)
    comps = {}
    for _ in range(500):
        if not (pe.has_work() or de.has_work()):
            break
        for c in _pump_step(pe, de, **migrate_kw):
            comps[c.req_id] = c.tokens
    return comps


def _treqs(tag, prompts, max_new=6):
    return [Request(prompt_tokens=p, req_id=f"{tag}{i}",
                    sampling=_sp(SamplingParams, max_new))
            for i, p in enumerate(prompts)]


def _jreqs(tag, prompts, max_new=6):
    return [JRequest(prompt_tokens=p, req_id=f"{tag}{i}",
                     sampling=_sp(JSamplingParams, max_new))
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def qwen():
    return _bridge("qwen3-8b", N_LAYERS)


@pytest.fixture(scope="module")
def jax_pair(qwen):
    bundle, jp, _, _ = qwen
    return _jpair(bundle, jp, "j")


@pytest.fixture(scope="module")
def torch_pair(qwen):
    """The port pair that mirrors ``jax_pair``: both see the same traffic
    in the same order, so their prefix caches stay in step."""
    _, _, cfg, tp = qwen
    return _tpair(cfg, tp)


@pytest.fixture(scope="module")
def colocated_ref(qwen):
    """The JAX colocated TE's greedy tokens for RAGGED and PROMPTS."""
    bundle, jp, _, _ = qwen
    te = JFlowServe(bundle, jp, JEngineConfig(**SHARED))
    for r in _jreqs("c", RAGGED + PROMPTS):
        te.add_request(r)
    out = {c.req_id: c.tokens for c in te.run_to_completion()}
    return [out[f"c{i}"] for i in range(len(RAGGED) + len(PROMPTS))]


PROMPTS = _prompts(2, length=19, seed0=40)


# ---------------------------------------------------------------------------
# paged P->D parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8])
def test_pd_pair_matches_jax_pair_and_colocated(jax_pair, torch_pair,
                                                colocated_ref, k):
    """RAGGED through both P->D pairs in lockstep at horizon K: the same
    greedy tokens as each other and as the JAX colocated TE, and the same
    ``load_metrics()`` on every TE after every pump step."""
    jpe, jde = jax_pair
    tpe, tde = torch_pair
    jde.ecfg.decode_horizon = tde.ecfg.decode_horizon = k
    tag = f"k{k}-"
    for jr, tr in zip(_jreqs(tag, RAGGED), _treqs(tag, RAGGED)):
        jpe.add_request(jr)
        tpe.add_request(tr)
    want, got = {}, {}
    for _ in range(200):
        if not (jpe.has_work() or jde.has_work() or tpe.has_work()
                or tde.has_work()):
            break
        want.update({c.req_id: c.tokens for c in _pump_step(jpe, jde)})
        got.update({c.req_id: c.tokens for c in _pump_step(tpe, tde)})
        assert tpe.load_metrics() == jpe.load_metrics()
        assert tde.load_metrics() == jde.load_metrics()
    ids = [f"{tag}{i}" for i in range(len(RAGGED))]
    assert sorted(want) == sorted(got) == sorted(ids)
    assert [got[i] for i in ids] == [want[i] for i in ids] \
        == colocated_ref[:len(RAGGED)]
    assert tpe.distflow.bytes_moved() > 0
    assert not tde._inflight and not tde._pending
    assert all(s.kv_pending is None for s in tde._seqs.values())


@pytest.mark.parametrize("kw", [dict(overlap=False), dict(layer_chunks=1),
                                dict(layer_chunks=2), dict(host_gather=True)],
                         ids=["no-overlap", "chunks1", "chunks2",
                              "host-gather"])
def test_pd_migration_variants_keep_greedy_tokens(qwen, colocated_ref, kw):
    _, _, cfg, tp = qwen
    got = _serve_pd(_tpair(cfg, tp), _treqs("v", RAGGED + PROMPTS), **kw)
    assert [got[f"v{i}"] for i in range(len(RAGGED) + len(PROMPTS))] \
        == colocated_ref


def test_pd_distflow_clocks_match_jax(qwen):
    """The same migration through both packages charges the same bytes and
    advances both endpoints' simulated clocks by the same seconds, on the
    device path and on the v1 host path."""
    bundle, jp, cfg, tp = qwen
    for kw in ({}, dict(host_gather=True)):
        jpe, jde = _jpair(bundle, jp, "jc")
        tpe, tde = _tpair(cfg, tp, "tc")
        _serve_pd((jpe, jde), _jreqs("d", [PROMPT]), **kw)
        _serve_pd((tpe, tde), _treqs("d", [PROMPT]), **kw)
        assert tpe.distflow.bytes_moved() == jpe.distflow.bytes_moved() > 0
        assert [x.sim_seconds for x in tpe.distflow.log] == \
            [x.sim_seconds for x in jpe.distflow.log]
        assert tpe.distflow.sim_clock == jpe.distflow.sim_clock
        assert tde.distflow.sim_clock == jde.distflow.sim_clock > 0


# ---------------------------------------------------------------------------
# the migrated run, page reuse, back-pressure, preemption
# ---------------------------------------------------------------------------


def _prefilled(pe, prompt, rid):
    pe.add_request(Request(prompt_tokens=prompt, req_id=rid,
                           sampling=_sp(SamplingParams)))
    while pe.has_work():
        pe.step()
    assert pe.pop_migratable() == [rid]


def test_pool_run_equals_exported_run_after_page_reuse(qwen):
    """The run the D-TE scatters equals the run the P-TE exported, bit for
    bit, although the P-TE has written another prompt into the same pages
    before the D-TE imported it (the migration released them)."""
    _, _, cfg, tp = qwen
    pe, de = _tpair(cfg, tp)
    _prefilled(pe, PROMPT, "a")
    pages = list(pe._seqs["a"].pages)
    k_exp, v_exp = (run[0].clone() for run in pe.pool.gather_device(pages))
    pe.migrate_out("a", de, layer_chunks=2, keep_prefix=False)
    handle = de._seqs["a"].kv_pending
    assert handle is not None and not handle.xfer.done
    _prefilled(pe, _prompts(1, length=len(PROMPT) - 1, seed0=9)[0], "b")
    assert set(pe._seqs["b"].pages) == set(pages)      # the pages reused
    assert not torch.equal(pe.pool.k[0][:, pages], k_exp)
    de.finish_pending_imports()
    assert handle.xfer.done and de._seqs["a"].kv_pending is None
    run = de._seqs["a"].pages[:len(pages)]
    assert torch.equal(de.pool.k[0][:, run], k_exp)
    assert torch.equal(de.pool.v[0][:, run], v_exp)


def test_import_out_of_pages_leaves_dst_untouched(qwen, colocated_ref):
    """A D-TE without pages for the run raises ``OutOfPagesError`` and
    keeps nothing of it; a mid-decode source gets its sequence back in
    ``running`` and finishes it with the colocated tokens, and a P-TE's
    prefilled sequence migrates on a retry to a D-TE with room."""
    _, _, cfg, tp = qwen
    small = FlowServe(cfg, tp, EngineConfig(mode="decode",
                                            **{**SHARED, "n_pages": 2}),
                      name="small", device="cpu")
    free = small.pool.free_page_count()
    # a mid-decode sequence of a colocated TE (a drain)
    src = FlowServe(cfg, tp, EngineConfig(**SHARED), name="src", device="cpu")
    src.add_request(_treqs("x", PROMPTS[:1])[0])
    for _ in range(3):
        src.step()
    seq = src._seqs["x0"]
    assert seq in src.scheduler.running and len(seq.pages) > free
    with pytest.raises(OutOfPagesError):
        src.migrate_out("x0", small)
    assert not small._seqs and not small.scheduler.running
    assert small.pool.free_page_count() == free
    assert seq in src.scheduler.running and "x0" in src._seqs
    done = {c.req_id: c.tokens for c in src.run_to_completion()}
    assert done["x0"] == colocated_ref[len(RAGGED)]
    # a P-TE's prefilled sequence stays for a retry
    pe, de = _tpair(cfg, tp)
    _prefilled(pe, PROMPTS[1], "y")
    with pytest.raises(OutOfPagesError):
        pe.migrate_out("y", small)
    assert "y" in pe._seqs and not small._seqs
    pe.migrate_out("y", de)
    got = {c.req_id: c.tokens for c in de.run_to_completion()}
    assert got["y"] == colocated_ref[len(RAGGED) + 1]


def test_preempted_decode_seq_drops_pending_import(qwen):
    _, _, cfg, tp = qwen
    pe, de = _tpair(cfg, tp)
    _prefilled(pe, PROMPT, "a")
    pe.migrate_out("a", de)
    seq = de._seqs["a"]
    free = de.pool.free_page_count()
    assert seq.kv_pending is not None and seq in de.scheduler.running
    de._preempt(seq)
    assert seq.kv_pending is None and not seq.pages
    assert de.pool.free_page_count() > free
    assert seq in de.scheduler.waiting
    assert de.migratable_running() == []


def test_migratable_running_skips_pending_imports(qwen):
    _, _, cfg, tp = qwen
    pe, de = _tpair(cfg, tp)
    for rid, p in (("a", PROMPT), ("b", PROMPTS[0])):
        _prefilled(pe, p, rid)
        pe.migrate_out(rid, de)
    de.finish_pending_imports()
    _prefilled(pe, PROMPTS[1], "c")
    pe.migrate_out("c", de)
    assert de.migratable_running() == ["a", "b"]
