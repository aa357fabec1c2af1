"""The port's slot family (rwkv6, recurrentgemma) against the JAX package,
on the CPU.

Both sides run identical weights: the JAX smoke init (fp32), bridged. The
torch side runs with ``device="cpu"``, so its recurrences take the WKV6
and RG-LRU kernels' plain versions. The configs, the bridge, the blocks
and the towers' logits are held in ``test_torch_slot_models.py``; here,
on the engine, with the tolerance stated in the test:

  * the port's ``FlowServe`` against the JAX ``FlowServe`` on the setup of
    ``tests/test_prefill_batching.py`` (4 slots, max_len 64, chunk 8):
    EXACT greedy tokens on ``RAGGED[:4]`` and ``_prompts(3)``, through a
    state-checkpoint prefix hit, on reused slots (stale state must not
    leak), with the raw-length prefill and the unfused decode on both
    engines (the reference's ``bucket_prefill=False`` and
    ``fused_decode=False``), and with the prefix cache off (no
    checkpoint kept).
One JAX TE per model serves every engine case, so its shapes compile
once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.launch.mesh import one_rank
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
CPU = one_rank(torch.device("cpu"))     # one weights tree on one rank
SHARED = dict(n_slots=4, max_len=64, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


# tests/test_prefill_batching.py's ragged mix: 1-token prompt, tiny, one
# chunk exactly, chunk boundary + 1
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12))]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        bundle = get_model(arch, smoke=True)
        jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
        cfg = smoke_config(get_config(arch))
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        out[arch] = (bundle, jp, cfg, tp)
    return out


@pytest.fixture(scope="module")
def pairs(models):
    """One (JAX TE, torch TE) pair per model, reused by every engine case.
    Both TEs always see the same traffic in the same order, so their slot
    assignments and state-checkpoint caches stay in step."""
    return {arch: (JFlowServe(bundle, jp, JEngineConfig(**SHARED)),
                   FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu"))
            for arch, (bundle, jp, cfg, tp) in models.items()}


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _sp(cls, max_new=8):
    return cls(temperature=0.0, max_new_tokens=max_new, stop_on_eos=False)


def _serve_both(pair, tag, prompts, max_new=8):
    jte, tte = pair
    ids = [f"{tag}{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        jte.add_request(JRequest(prompt_tokens=p, req_id=rid,
                                 sampling=_sp(JSamplingParams, max_new)))
        tte.add_request(Request(prompt_tokens=p, req_id=rid,
                                sampling=_sp(SamplingParams, max_new)))
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert sorted(want) == sorted(ids)
    return [got.get(i) for i in ids], [want[i] for i in ids]


# ---------------------------------------------------------------------------
# the engine: exact greedy tokens against the JAX FlowServe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mix", ["ragged", "prompts"])
def test_flowserve_greedy_parity(pairs, arch, mix):
    prompts = RAGGED if mix == "ragged" else _prompts(3)
    got, want = _serve_both(pairs[arch], f"{mix}-", prompts)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_state_checkpoint_prefix_hit(pairs, arch):
    """A finished request leaves a state checkpoint keyed by the tokens it
    covered; a later prompt that extends that key resumes from it (on both
    engines) and gives the JAX TE's tokens exactly."""
    jte, tte = pairs[arch]
    base = _prompts(1, length=13, seed0=70)[0]
    (first,), _ = _serve_both(pairs[arch], "ckpt-a", [base])
    ext = base + first + [9, 4, 11]
    n_hits = []
    for te, req in ((jte, JRequest), (tte, Request)):
        sp = _sp(JSamplingParams if te is jte else SamplingParams)
        te.add_request(req(prompt_tokens=ext, req_id="ckpt-b", sampling=sp))
        n_hits.append(te._seqs["ckpt-b"].n_cached)
    assert n_hits[0] == n_hits[1] == len(base) + len(first) - 1
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert got == want and len(got["ckpt-b"]) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slots_do_not_leak_state(models, pairs, arch):
    """Fill every slot, then serve new prompts on the freed (stale) slots:
    the tokens equal the JAX TE's and a fresh TE's."""
    _serve_both(pairs[arch], "fill-", _prompts(4, seed0=40))
    prompts = _prompts(4, length=9, seed0=50)
    got, want = _serve_both(pairs[arch], "reuse-", prompts)
    _, _, cfg, tp = models[arch]
    fresh = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    for i, p in enumerate(prompts):
        fresh.add_request(Request(prompt_tokens=p, req_id=f"f{i}",
                                  sampling=_sp(SamplingParams)))
    comps = {c.req_id: c.tokens for c in fresh.run_to_completion()}
    assert got == want == [comps[f"f{i}"] for i in range(len(prompts))]


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_length_prefill_and_unfused_decode_match_jax(pairs, arch):
    """``bucket_prefill=False`` and ``fused_decode=False`` on both engines
    (``tests/test_prefill_batching.py:207-216`` sets the same pair): the
    chunks run at their raw lengths (T 2, 7, 8, 3: no WKV6 chunk
    multiple), every decode step's logits are sampled on the host,
    and the greedy tokens equal the JAX TE's."""
    jte, tte = pairs[arch]
    before = (tte.sampler_dispatches, tte.decode_steps, tte.host_syncs)
    for te in pairs[arch]:
        te.runner.bucket_prefill = False
        te.ecfg.fused_decode = False
    rs = np.random.RandomState(60)
    fresh = [[int(x) for x in rs.randint(3, 200, len(p))] for p in RAGGED]
    try:
        got, want = _serve_both(pairs[arch], "raw-",
                                fresh + _prompts(2, seed0=60))
    finally:
        for te in pairs[arch]:
            te.runner.bucket_prefill = True
            te.ecfg.fused_decode = True
    assert got == want
    sampler, steps, syncs = (a - b for a, b in zip(
        (tte.sampler_dispatches, tte.decode_steps, tte.host_syncs), before))
    assert sampler == steps == syncs > 0      # one host sampler per step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_off_keeps_no_checkpoint(models, pairs, arch):
    """A slot TE with ``enable_prefix_cache=False`` keeps no state
    checkpoint: a prompt that extends a finished one prefills from scratch
    and still gives the tokens the JAX pair gives through its checkpoint
    hit."""
    _, _, cfg, tp = models[arch]
    base = _prompts(1, length=13, seed0=75)[0]
    _, (first,) = _serve_both(pairs[arch], "off-a", [base])
    ext = base + first + [9, 4, 11]
    _, (want,) = _serve_both(pairs[arch], "off-b", [ext])
    te = FlowServe(cfg, tp, EngineConfig(**SHARED, enable_prefix_cache=False),
                   device="cpu")
    assert te._state_cache is None
    got = []
    for rid, p in (("a", base), ("b", ext)):
        te.add_request(Request(prompt_tokens=p, req_id=rid,
                               sampling=_sp(SamplingParams)))
        assert te._seqs[rid].n_cached == 0 and te._seqs[rid].state is None
        got += [c.tokens for c in te.run_to_completion()]
    assert got == [first, want]
    assert te._state_cache is None


# ---------------------------------------------------------------------------
# engine behaviour of the port alone
# ---------------------------------------------------------------------------


def test_slot_engine_counts_and_limits(models):
    """Stochastic rows serve valid tokens; decode samples one token per
    live slot per step with one host fetch; the paged warmups do nothing
    here; a request longer than a slot is refused."""
    _, _, cfg, tp = models["recurrentgemma-2b"]
    te = FlowServe(cfg, tp, EngineConfig(**SHARED), device="cpu")
    assert te.warmup_decode() == 0 and te.warmup_prefill() == 0
    assert te.pool is None and te.rtc is None
    for i, p in enumerate(_prompts(4)):
        te.add_request(Request(prompt_tokens=p, req_id=f"s{i}",
                               sampling=SamplingParams(
                                   temperature=0.9 if i % 2 else 0.0,
                                   top_p=0.9, max_new_tokens=6,
                                   stop_on_eos=False)))
    comps = te.run_to_completion()
    assert len(comps) == 4
    for c in comps:
        assert len(c.tokens) == 6
        assert all(0 <= t < cfg.vocab_size for t in c.tokens)
    # slot prefill covers n_prompt - 1 tokens; decode samples all 6
    assert te.decode_tokens == 4 * 6
    assert te.host_syncs == te.decode_steps
    assert sorted(te.runner.free_slots) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="max_len"):
        te.add_request(Request(prompt_tokens=[1] * 60,
                               sampling=SamplingParams(max_new_tokens=8)))
