"""The port's colocated FLOWSERVE TE against the JAX one, on the CPU.

Both engines run identical weights (the JAX smoke init, bridged) with the
same ``EngineConfig`` values; the torch TE runs with ``device="cpu"``, so
its attention takes the kernels' plain versions. Greedy tokens must be
EXACTLY equal over the prompt mixes of ``tests/test_prefill_batching.py``
and the horizons K in {1, 4, 8} of ``tests/test_hotloop.py``. Also: an
EOS inside a horizon and page pressure (preemption) keep the greedy
tokens, a stochastic mix serves valid tokens, a step costs at most one
prefill pass, and the package never pulls in JAX or the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.engine.flowserve as TFS_MOD
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.models.bridge import params_from_numpy

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
    ``decode_horizon`` afresh at every step). Both TEs always see the same
    traffic in the same order, so their prefix caches stay in step."""
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


def _serve(models, prompts, max_new, stop_on_eos=False, **kw):
    _, _, cfg, tp = models
    te = FlowServe(cfg, tp, EngineConfig(**{**SHARED, **kw}), device="cpu")
    for i, p in enumerate(prompts):
        te.add_request(Request(prompt_tokens=p, req_id=f"r{i}",
                               sampling=SamplingParams(
                                   max_new_tokens=max_new,
                                   stop_on_eos=stop_on_eos)))
    comps = {c.req_id: c.tokens for c in te.run_to_completion()}
    return [comps[f"r{i}"] for i in range(len(prompts))], te


def test_eos_mid_horizon_matches_per_step_path(models, monkeypatch):
    """An EOS sampled inside a horizon stops the sequence there and the
    tokens sampled after it in the same block are discarded: the fused
    path equals the legacy per-step path (the JAX suite's own check of
    its fused path, test_hotloop.py::test_all_eos_mid_horizon_terminates)."""
    free, _ = _serve(models, _prompts(2), 12)
    fake_eos = free[0][5]
    monkeypatch.setattr(TFS_MOD, "EOS_ID", fake_eos)
    want, _ = _serve(models, _prompts(2), 12, stop_on_eos=True,
                     fused_decode=False)
    got, te = _serve(models, _prompts(2), 12, stop_on_eos=True,
                     decode_horizon=4)
    assert got == want and len(got[0]) == free[0].index(fake_eos) + 1
    assert not te._inflight and not te._pending


def test_page_pressure_keeps_greedy_tokens(models):
    """9 pages for 4 sequences that need 4 each: preemption, re-prefill and
    the legacy decode fallback all run, and the greedy tokens equal the
    unpressured run's (which the parity tests hold against JAX)."""
    want, _ = _serve(models, _prompts(4), 16)
    got, te = _serve(models, _prompts(4), 16, n_pages=9)
    assert got == want
    assert te.sampler_dispatches > 0           # the legacy path did run


def test_stochastic_mix_serves_valid_tokens(models):
    _, _, cfg, tp = models
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    for i, p in enumerate(_prompts(4)):
        t = 0.9 if i % 2 else 0.0
        te.add_request(Request(prompt_tokens=p, req_id=f"r{i}",
                               sampling=SamplingParams(
                                   temperature=t, top_p=0.9, max_new_tokens=6,
                                   stop_on_eos=False)))
    comps = te.run_to_completion()
    assert len(comps) == 4
    for c in comps:
        assert len(c.tokens) == 6
        assert all(0 <= t < cfg.vocab_size for t in c.tokens)


def test_one_prefill_pass_per_step(models):
    _, _, cfg, tp = models
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    for i, p in enumerate(RAGGED):
        te.add_request(Request(prompt_tokens=p, req_id=f"r{i}",
                               sampling=SamplingParams(max_new_tokens=4,
                                                       stop_on_eos=False)))
    per_step = []
    while te.has_work():
        before = te.prefill_dispatches
        te.step()
        per_step.append(te.prefill_dispatches - before)
    assert max(per_step) == 1 and sum(per_step) >= 2
    assert 1 <= te.prefill_syncs <= sum(per_step)   # first-token fetches
    # prefill samples the first token of every prompt but the 1-token one,
    # whose prefill is vacuous: decode samples the other 4 * 5 - 4
    assert te.decode_tokens == 4 * len(RAGGED) - (len(RAGGED) - 1)


def test_warmups_leave_live_state_alone(models):
    _, _, cfg, tp = models
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    free = te.pool.free_page_count()
    assert te.warmup_prefill(max_pages=2) == len([1, 2, 4, 8, 16, 32, 64]) * 2
    assert te.warmup_decode(max_pages=2, horizons=[1, 2]) == 2 * 3 * 2
    assert te.pool.free_page_count() == free
    scratch = te.pool.scratch_page()
    live = [p for p in range(te.pool.n_pages) if p != scratch]
    assert not te.pool.k[0][:, live].any() and not te.pool.v[0][:, live].any()


def test_dram_tier_round_trip(models):
    """RTC Copy then Populate: a preserved prefix swapped to pinned-host
    DRAM comes back into fresh pages bit for bit, and a new request that
    shares it resumes from the populated pages."""
    from repro_torch.engine.rtc import RTCCostModel
    _, _, cfg, tp = models
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    te.rtc.cost = RTCCostModel(fetch_bw_bytes=1e15)   # always fetch
    prompt = _prompts(1, length=30)[0]
    te.add_request(Request(prompt_tokens=prompt, req_id="a",
                           sampling=SamplingParams(max_new_tokens=2,
                                                   stop_on_eos=False)))
    te.run_to_completion()
    (entry,) = [leaf.payload for leaf in te.rtc.tree.leaves_by_lru()]
    pages = list(entry.pages)
    k_before = te.pool.k[0][:, pages].clone()
    te.rtc.copy_to_dram(entry)
    assert entry.location == "dram" and entry.pages is None
    te.add_request(Request(prompt_tokens=prompt + [5], req_id="b",
                           sampling=SamplingParams(max_new_tokens=2,
                                                   stop_on_eos=False)))
    te.run_to_completion()
    assert entry.location == "npu" and te.rtc.stats["populates"] == 1
    # populate allocates only the pages that hold the entry's tokens
    n = len(entry.pages)
    assert n == -(-entry.n_tokens // SHARED["page_size"]) <= len(pages)
    assert torch.equal(te.pool.k[0][:, entry.pages], k_before[:, :n])


def test_flowserve_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, cfg, tp = models
    with pytest.raises(RuntimeError, match="cuda"):
        FlowServe(cfg, tp, EngineConfig(**SHARED))


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
    files += [ROOT / "chip_smoke.py", ROOT / "examples" / "finetune_torch.py"]
    assert len(files) > 20
    for f in ("core/serving_plane.py", "training/train_loop.py",
              "data/pipeline.py", "models/model_factory.py",
              "launch/train.py"):
        assert ROOT / "src" / "repro_torch" / f in files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
