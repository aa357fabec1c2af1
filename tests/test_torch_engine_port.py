"""The port's colocated FLOWSERVE TE on its own, on the CPU (its parity
with the JAX TE is ``test_torch_engine.py``, whose fixtures and helpers
this file uses): an EOS inside a horizon and page pressure (preemption)
keep the greedy tokens, a stochastic mix serves valid tokens, a step costs
at most one prefill pass, the warmups leave live state alone, the DRAM
tier round-trips a prefix, and the default device is the card."""
import pytest
import torch

import repro_torch.engine.flowserve as TFS_MOD
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from test_torch_engine import RAGGED, SHARED, _prompts, models  # noqa: F401
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


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
