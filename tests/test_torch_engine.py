"""The port's colocated FLOWSERVE TE against the JAX one, on the CPU.

Both engines run identical weights (the JAX smoke init, bridged) with the
same ``EngineConfig`` values; the torch TE runs with ``device="cpu"``, so
its attention takes the kernels' plain versions. Greedy tokens must be
EXACTLY equal over the prompt mixes of ``tests/test_prefill_batching.py``
and the horizons K in {1, 4, 8} of ``tests/test_hotloop.py``, with
synchronous scheduling and with the per-sequence prefill (the
reference's switches, flipped on both engines), through prefix-cache hits
(both RTCs counting the same hits and reused tokens), and with the prefix
cache off. Also: the package never pulls in JAX or the JAX package. The
engine's behaviour alone (EOS inside a horizon, page pressure, ...) is in
``test_torch_engine_port.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


# tests/test_prefill_batching.py's ragged mix: 1-token prompt, tiny, one
# chunk exactly, chunk boundary + 1, long
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]
SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)


@pytest.fixture(scope="module")
def models():
    bundle = get_model("qwen3-8b", smoke=True)
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = smoke_config(get_config("qwen3-8b"))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


@pytest.fixture(scope="module")
def pair(models):
    """One (JAX TE, torch TE) pair on the SHARED config, reused across the
    parity tests so the JAX TE compiles its shapes once (both engines read
    ``decode_horizon``, ``async_sched`` and ``batched_prefill`` afresh at
    every step). Both TEs always see the same traffic in the same order, so
    their prefix caches stay in step."""
    bundle, jp, cfg, tp = models
    return (JFlowServe(bundle, jp, JEngineConfig(**SHARED)),
            FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu"))


def _serve_both(pair, tag, prompts, decode_horizon, max_new=8,
                stop_on_eos=False):
    jte, tte = pair
    jte.ecfg.decode_horizon = tte.ecfg.decode_horizon = decode_horizon
    ids = [f"{tag}{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        jte.add_request(JRequest(prompt_tokens=p, req_id=rid,
                                 sampling=JSamplingParams(
                                     temperature=0.0, max_new_tokens=max_new,
                                     stop_on_eos=stop_on_eos)))
        tte.add_request(Request(prompt_tokens=p, req_id=rid,
                                sampling=SamplingParams(
                                    temperature=0.0, max_new_tokens=max_new,
                                    stop_on_eos=stop_on_eos)))
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert sorted(want) == ids
    return [got.get(i) for i in ids], [want[i] for i in ids], tte


@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_parity_horizons(pair, k):
    # prompts of their own per K, so no case is served from another's
    # prefix cache
    got, want, te = _serve_both(pair, f"h{k}-", _prompts(4, seed0=100 * k),
                                decode_horizon=k)
    assert got == want
    assert te.sampler_dispatches == 0          # sampling fused into the step
    assert not te._inflight and not te._pending


def test_greedy_parity_ragged_mix(pair):
    got, want, _ = _serve_both(pair, "rag-", RAGGED, decode_horizon=8)
    assert got == want


def _ragged(seed):
    """RAGGED's lengths (1-token, tiny, one chunk, chunk + 1, long) with
    fresh ids, so no prompt is served from an earlier case's prefix."""
    rs = np.random.RandomState(seed)
    return [[int(x) for x in rs.randint(3, 200, len(p))] for p in RAGGED]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("switch", ["async_sched", "batched_prefill"])
def test_switch_off_matches_jax(pair, switch, k):
    """Each reference switch off on both engines: synchronous scheduling
    (the prepared plan ignored) and the per-sequence paged prefill (one
    pass per sequence chunk, the first token from the decode path). The
    greedy tokens equal the JAX engine's over the ragged mix; the
    per-sequence path counts one prefill pass per non-empty chunk, as the
    JAX engine's legacy path does, and never fetches a first token."""
    jte, tte = pair
    prompts = _ragged(500 + k + (50 if switch == "async_sched" else 0))
    before = [(te.prefill_dispatches, te.prefill_syncs) for te in pair]
    for te in pair:
        setattr(te.ecfg, switch, False)
    try:
        got, want, _ = _serve_both(pair, f"{switch}{k}-", prompts,
                                   decode_horizon=k)
    finally:
        for te in pair:
            setattr(te.ecfg, switch, True)
    assert got == want
    (jd, js), (td, ts) = [(te.prefill_dispatches - d, te.prefill_syncs - s)
                          for te, (d, s) in zip(pair, before)]
    if switch == "batched_prefill":
        # every prompt but the 1-token one prefills n - 1 tokens in chunks
        # of at most chunk_size
        chunks = sum(-(-(len(p) - 1) // SHARED["chunk_size"])
                     for p in prompts)
        assert td == jd >= chunks and ts == js == 0
    else:
        assert 0 < td and ts > 0               # the batched path ran


def _serve_seq(pair_or_te, tag, prompts):
    """Serve ``prompts`` one after another (each run to completion before
    the next arrives), on a (JAX, torch) pair or on one torch TE; returns
    each engine's tokens per prompt."""
    out = []
    for i, p in enumerate(prompts):
        if isinstance(pair_or_te, tuple):
            got, want, _ = _serve_both(pair_or_te, f"{tag}{i}-", [p],
                                       decode_horizon=8)
            assert got == want
            out.append(want[0])
        else:
            pair_or_te.add_request(Request(
                prompt_tokens=p, req_id=f"{tag}{i}",
                sampling=SamplingParams(temperature=0.0, max_new_tokens=8,
                                        stop_on_eos=False)))
            (c,) = pair_or_te.run_to_completion()
            out.append(c.tokens)
    return out


def _hit_prompts(seed):
    """A 30-token prompt, the same prompt again, and one sharing its first
    two pages (16 tokens) with a new tail."""
    base = _prompts(1, length=29, seed0=seed)[0]
    tail = [int(x) for x in np.random.RandomState(seed + 1).randint(3, 200, 9)]
    return [base, list(base), base[:2 * SHARED["page_size"]] + tail]


@pytest.fixture(scope="module")
def hit_runs(pair):
    """The repeated and shared-prefix prompts served one after another on
    the pair: the prompts, the JAX tokens, and each RTC's hits and reused
    tokens over the three."""
    keys = ("hits", "tokens_reused")
    before = [dict(te.rtc.stats) for te in pair]
    prompts = _hit_prompts(800)
    want = _serve_seq(pair, "hit-", prompts)
    deltas = [{k: te.rtc.stats[k] - b[k] for k in keys}
              for te, b in zip(pair, before)]
    totals = [{k: te.rtc.stats[k] for k in keys} for te in pair]
    return prompts, want, deltas, totals


def test_prefix_cache_hits_match_jax(hit_runs):
    """A repeated prompt and a shared-prefix prompt are served from the RTC
    on both engines: the greedy tokens equal the JAX engine's (checked as
    they are served), and both RTCs count the same hits and reused
    tokens."""
    prompts, _, (jd, td), (jt, tt) = hit_runs
    assert jd == td and jt == tt
    assert td["hits"] >= 2 and td["tokens_reused"] >= len(prompts[0]) // 2


def test_prefix_cache_off_gives_jax_tokens(models, hit_runs):
    """A torch TE without a prefix cache (no RTC, no DRAM tier) serves the
    repeated and shared-prefix prompts with the tokens the JAX pair gives
    through its RTC hits (the reference's greedy tokens do not depend on
    the cache: ``tests/test_system.py:108-120``), reusing nothing and
    keeping no page once it is empty."""
    _, _, cfg, tp = models
    prompts, want, _, _ = hit_runs
    te = FlowServe(cfg, tp, EngineConfig(**SHARED, enable_prefix_cache=False),
                   device="cpu")
    assert te.rtc is None and te.scheduler.rtc is None
    assert _serve_seq(te, "off-", prompts) == want
    assert te.prefix_cache_stats() == {}
    assert te.pool.free_page_count() == te.pool.n_pages - 1   # all but scratch


# ---------------------------------------------------------------------------
# guards: the port stands alone
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 20                   # the whole port was imported
    # the fleet control plane's and the fine-tune jobs' modules among them
    assert {f"repro_torch.core.{m}" for m in (
        "abstractions", "cluster", "faults", "fleet", "scaling",
        "serving_plane")} <= mods
    assert {"repro_torch.training.optimizer", "repro_torch.training.tree",
            "repro_torch.training.checkpoint",
            "repro_torch.training.train_loop", "repro_torch.data.pipeline",
            "repro_torch.models.model_factory",
            "repro_torch.launch.train"} <= mods


def test_port_source_has_no_reference_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + [
        ROOT / "examples" / f"{name}_torch.py"
        for name in ("finetune", "quickstart", "pd_disaggregation",
                     "autoscale_demo")]
    assert len(files) > 20
    for f in ("core/serving_plane.py", "training/train_loop.py",
              "data/pipeline.py", "models/model_factory.py",
              "launch/train.py"):
        assert ROOT / "src" / "repro_torch" / f in files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
