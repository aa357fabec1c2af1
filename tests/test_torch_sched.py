"""The port's JE side (Algorithm 1, the PD heatmap, the decode-length
predictor, the TE lifecycle) against the JAX package's ``repro.core``, on
the CPU. All comparisons are EXACT unless a tolerance is stated:

  * ``HeatmapStudy.combined()`` on the reference's hardware, passed
    explicitly, equals the JAX grid bit for bit (a sub-grid: the JAX
    model prices each cell in a Python loop);
  * on a seeded stream of 200 requests over hand-fed handles (loads,
    shared prefixes, a draining TE), ``DistributedScheduler`` picks the
    same TE for every request and counts the same ``decisions``, without
    and with the bridged predictor; round-robin and ``advance`` agree;
  * the predictor: identical synthetic trace and features, the bridged
    weights give the same buckets (logits within 1e-5), and the port's
    own ``train_predictor`` reaches the 0.80 held-out accuracy of
    ``tests/test_scheduling.py``;
  * a live ``TEHandle.refresh()`` over port engines (a colocated TE and a
    P->D pair) equals the JAX one over JAX engines at the same points of
    the same traffic (qwen3-8b smoke cut to ``LIVE_LAYERS`` layers, the
    JAX TEs sharing one program cache: ``share_jax_programs`` of
    ``test_torch_plane.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core import fleet as JF
from repro.core import heatmap as JH
from repro.core import predictor as JP
from repro.core import scheduling as JS
from repro.core.perf_model import TEHardware as JTEHardware
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import fleet as F
from repro_torch.core import heatmap as H
from repro_torch.core import predictor as P
from repro_torch.core import scheduling as S
from repro_torch.core.perf_model import TEHardware
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.launch.serve import step_unit
from repro_torch.models.bridge import params_from_numpy, \
    predictor_params_from_numpy
from test_torch_fixtures import share_jax_programs  # noqa: F401 (autouse)
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

V5E = dict(n_chips=4, peak_flops=197e12, hbm_bw=819e9)


# ---------------------------------------------------------------------------
# heatmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-3-4b"])
def test_heatmap_matches_jax_on_reference_hardware(arch):
    """danube has a window, so the decode context is clamped."""
    kw = dict(prefill_lens=[256, 2048, 8192], rps_grid=[0.4, 1.2])
    got = H.HeatmapStudy(get_config(arch),
                         TEHardware(4, 197e12, 819e9, link_bw=50e9),
                         **kw).combined()
    want = JH.HeatmapStudy(jget_config(arch), JTEHardware(**V5E),
                           **kw).combined()
    assert np.array_equal(got, want)


def test_heatmap_on_one_h100():
    """The default hardware is one H100 (data-sheet rates): a grid of the
    reference's shape, pricing the KV hand-off on NVLink."""
    hs = H.HeatmapStudy(get_config("qwen3-8b"))
    assert (hs.hw.n_chips, hs.hw.peak_flops, hs.hw.hbm_bw, hs.hw.link_bw) \
        == (1, 989e12, 3.35e12, 450e9)
    g = hs.combined()
    assert g.shape == (6, 6) and np.isfinite(g).all()
    assert H.lookup(g, hs.prefill_lens, hs.decode_ratios, 8192, 400) == \
        JH.lookup(g, hs.prefill_lens, hs.decode_ratios, 8192, 400)


# ---------------------------------------------------------------------------
# Algorithm 1 on hand-fed handles
# ---------------------------------------------------------------------------


def _handles(mod):
    return [mod.TEHandle("c0", "colocated"), mod.TEHandle("c1", "colocated"),
            mod.TEHandle("p0", "pd_pair"), mod.TEHandle("p1", "pd_pair")]


def _stream(n=200, seed=0):
    """Seeded requests: prompts that share one of a few prefixes (so the
    prompt trees match), of lengths 8-9000, with predicted decodes, and a
    seeded perturbation of the hand-fed loads per request."""
    rng = np.random.RandomState(seed)
    prefixes = [list(rng.randint(3, 250, int(rng.randint(8, 64))))
                for _ in range(5)]
    out = []
    for _ in range(n):
        tail = list(rng.randint(3, 250, int(rng.randint(0, 9000))))
        tokens = [int(t) for t in prefixes[rng.randint(5)] + tail] \
            if rng.rand() < 0.6 else [int(t) for t in tail or [5]]
        out.append((tokens, int(rng.randint(1, 2000)),
                    rng.rand(4) * 3000 * (rng.rand() < 0.5),
                    int(rng.randint(0, 10))))
    return out


def _place(mod, heat, lens, ratios, predictor, stream):
    tes = _handles(mod)
    ds = mod.DistributedScheduler(tes, heat, lens, ratios,
                                  predictor=predictor)
    picks = []
    live = []
    for tokens, pdec, bump, ev in stream:
        for t, b in zip(tes, bump):
            t.load += float(b)
        if ev == 0:                 # a TE drains, or comes back
            t = tes[len(picks) % 4]
            t.state = (mod.TEState.DRAINING if t.state is mod.TEState.SERVING
                       else mod.TEState.SERVING)
        req = mod.SchedRequest(tokens=tokens, predicted_decode=pdec)
        te = ds.dist_sched(req)
        ds.commit(req, te)
        live.append((req, te))
        if ev == 1 and live:        # the oldest completes
            r, t = live.pop(0)
            ds.complete(r, t, actual_decode=pdec // 2)
        picks.append(te.te_id)
    return picks, ds.decisions, [t.load for t in tes]


def _mixed_heatmap():
    """A grid of both signs, so the PD-aware step splits the stream."""
    return np.random.RandomState(1).randn(6, 6)


def test_dist_sched_matches_jax():
    stream = _stream()
    heat = _mixed_heatmap()
    lens, ratios = H.PREFILL_LENS, H.DECODE_RATIOS
    got = _place(S, heat, lens, ratios, None, stream)
    want = _place(JS, heat, lens, ratios, None, stream)
    assert got == want
    picks, decisions, _ = got
    assert len(set(picks)) == 4
    assert all(decisions[k] > 0 for k in ("pd_disagg", "pd_colo",
                                          "locality", "load"))


@pytest.fixture(scope="module")
def jax_predictor():
    cfg = JP.PredictorConfig(steps=60)
    xs, ys, prompts = JP.synth_trace(600, cfg)
    params, _ = JP.train_predictor(cfg, xs, ys)
    return cfg, params, prompts


def test_dist_sched_with_bridged_predictor_matches_jax(jax_predictor):
    cfg, jparams, _ = jax_predictor
    tparams = predictor_params_from_numpy(jax.tree.map(np.asarray, jparams))
    tcfg = P.PredictorConfig(steps=60)
    stream = _stream(seed=3)
    heat = _mixed_heatmap()
    lens, ratios = H.PREFILL_LENS, H.DECODE_RATIOS
    got = _place(S, heat, lens, ratios,
                 P.DecodeLengthPredictor(tcfg, tparams), stream)
    want = _place(JS, heat, lens, ratios,
                  JP.DecodeLengthPredictor(cfg, jparams), stream)
    assert got == want


def test_round_robin_matches_jax():
    picks = []
    for mod in (S, JS):
        tes = _handles(mod)
        rr = mod.round_robin_scheduler(tes)
        out = [rr(mod.SchedRequest(tokens=[1])).te_id for _ in range(6)]
        tes[1].state = mod.TEState.DRAINING
        out += [rr(mod.SchedRequest(tokens=[1])).te_id for _ in range(6)]
        for t in tes:
            t.state = mod.TEState.DRAINING
        out += [rr(mod.SchedRequest(tokens=[1])).te_id for _ in range(3)]
        for t in tes:
            t.state = mod.TEState.RELEASED
        with pytest.raises(RuntimeError, match="no routable"):
            rr(mod.SchedRequest(tokens=[1]))
        picks.append(out)
    assert picks[0] == picks[1]


def test_lifecycle_matches_jax():
    for cur in F.TEState:
        for new in F.TEState:
            jcur, jnew = JF.TEState(cur.value), JF.TEState(new.value)
            try:
                JF.advance(jcur, jnew)
                legal = True
            except JF.LifecycleError:
                legal = False
            if legal:
                assert F.advance(cur, new) is new
            else:
                with pytest.raises(F.LifecycleError):
                    F.advance(cur, new)
    h = S.TEHandle("a", "colocated")
    assert h.transition(F.TEState.DRAINING) is F.TEState.DRAINING
    assert not h.admitting
    with pytest.raises(F.LifecycleError):
        h.transition(F.TEState.WARMING)


def test_global_prompt_tree_matches_jax():
    res = []
    for mod in (S, JS):
        gt = mod.GlobalPromptTree()
        gt.record([1, 2, 3, 4], "a")
        gt.record([1, 2, 9, 9, 9], "b")
        cands = [mod.TEHandle("a", "colocated"), mod.TEHandle("b",
                                                              "colocated")]
        res.append([gt.best_te(q, cands) for q in
                    ([1, 2, 3, 4, 5], [1, 2, 9], [7], [1, 2])])
    assert res[0] == res[1] and res[0][0] == ("a", 4)


# ---------------------------------------------------------------------------
# the decode-length predictor
# ---------------------------------------------------------------------------


def test_synth_trace_and_features_identical():
    for n, seed in ((300, 0), (50, 4)):
        tx, ty, tp = P.synth_trace(n, P.PredictorConfig(), seed)
        jx, jy, jp = JP.synth_trace(n, JP.PredictorConfig(), seed)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
        assert all(np.array_equal(a, b) for a, b in zip(tp, jp))


def test_bridged_predictor_buckets_match_jax(jax_predictor):
    """Logits within 1e-5 (fp32 matmuls in two libraries) and the same
    bucket for every prompt of the trace."""
    import torch
    cfg, jparams, prompts = jax_predictor
    tparams = predictor_params_from_numpy(jax.tree.map(np.asarray, jparams))
    jpred = JP.DecodeLengthPredictor(cfg, jparams)
    tpred = P.DecodeLengthPredictor(P.PredictorConfig(steps=60), tparams)
    x = np.stack([P.featurize(np.asarray(p), cfg.n_features)
                  for p in prompts])
    np.testing.assert_allclose(
        P.predictor_logits(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(JP.predictor_logits(jparams, jnp.asarray(x))), atol=1e-5)
    got = [tpred.predict_bucket(p) for p in prompts]
    assert got == [jpred.predict_bucket(p) for p in prompts]
    assert len(set(got)) > 1
    assert tpred.predict_tokens(prompts[0]) == jpred.predict_tokens(
        prompts[0])


def test_train_predictor_reaches_target():
    """§5.3.3: the paper reports 84.9%; the bar of
    tests/test_scheduling.py is 0.80 held-out accuracy."""
    cfg = P.PredictorConfig(steps=250)
    xs, ys, _ = P.synth_trace(3000, cfg)
    params, acc = P.train_predictor(cfg, xs, ys)
    assert acc >= 0.80, acc
    b = P.DecodeLengthPredictor(cfg, params).predict_bucket(
        np.asarray([123, 125, 40, 41] * 30))
    assert 0 <= b < cfg.n_buckets


def test_trace_ema_matches_jax():
    t, j = P.TraceEMAPredictor(), JP.TraceEMAPredictor()
    rng = np.random.RandomState(2)
    out = []
    for i in range(60):
        prompt = [1] * int(rng.randint(1, 3000))
        out.append((t.predict_tokens(prompt), j.predict_tokens(prompt)))
        if i % 3:
            dl = int(rng.randint(1, 900))
            t.observe(prompt, dl)
            j.observe(prompt, dl)
    assert all(a == b for a, b in out)
    assert t.n_observations() == j.n_observations() == 40


# ---------------------------------------------------------------------------
# live handles over real engines
# ---------------------------------------------------------------------------

SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
LIVE_LAYERS = 2


def _live(mod_s, engine_cls, ecfg_cls, params, tag):
    def te(mode, name):
        return engine_cls(*params, ecfg_cls(mode=mode, **SHARED),
                          name=f"{tag}-{name}")
    pe, de = te("prefill", "p"), te("decode", "d")
    pe.distflow.link_cluster([de.distflow])
    return [mod_s.TEHandle("c0", "colocated", engine=te("colocated", "c")),
            mod_s.TEHandle("pd0", "pd_pair", engine=pe, decode_engine=de)]


def test_live_refresh_matches_jax():
    bundle = get_model(dataclasses.replace(
        jsmoke_config(jget_config("qwen3-8b")), n_layers=LIVE_LAYERS))
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-8b")),
                              n_layers=LIVE_LAYERS)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    jh = _live(JS, JFlowServe, JEngineConfig, (bundle, jp), "j")
    th = _live(S, lambda c, p, e, name: FlowServe(c, p, e, name=name,
                                                  device="cpu"),
               EngineConfig, (cfg, tp), "t")
    rng = np.random.RandomState(0)
    for i in range(6):
        p = [1] + [int(x) for x in rng.randint(3, 200, int(rng.randint(3,
                                                                      30)))]
        n = int(rng.randint(2, 12))
        for hs, req, sp in ((jh, JRequest, JSamplingParams),
                            (th, Request, SamplingParams)):
            hs[i % 2].engine.add_request(req(
                prompt_tokens=p, req_id=f"r{i}",
                sampling=sp(temperature=0.0, max_new_tokens=n,
                            stop_on_eos=False)))
    seen = 0
    for _ in range(60):
        for a, b in zip(th, jh):
            assert a.refresh() == b.refresh()
            assert (a.prefill_load, a.decode_load, a.n_running) == \
                (b.prefill_load, b.decode_load, b.n_running)
            seen += a.load > 0
        if not any(e.has_work() for h in th
                   for e in (*h.prefill_members(), *h.decode_members())):
            break
        for h in th + jh:           # the launcher's pump drives both
            step_unit(h)
    assert seen > 4
    assert th[1].pick_decode_member() is th[1].decode_engine
