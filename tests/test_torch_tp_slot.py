"""Tensor parallelism of the port's slot family against the JAX package, on
the CPU.

A tp > 1 slot TE of the port keeps one controller: its weights are a list
of rank trees and its dense caches a list of rank caches, every rank here
on ``cpu``. The JAX TE runs on a 1 x tp mesh of the simulated host devices
that ``tests/conftest.py`` forces (``repro/engine/runners/slot.py:51-60``).
Both sides run the JAX smoke init (fp32) bridged; the cross towers with
non-zero modality inputs and (the VLM) non-zero gates. Held here:

  * the split dimension of every slot-cache leaf of the four slot archs
    at tp 2 and 4, at the smoke shapes and the full ones, equals the axis
    where ``"model"`` stands in the JAX ``engine_cache_shardings`` (shapes
    only: ``jax.eval_shape``), and the TE's rank caches have those splits;
  * the prefill-final and first-decode logits of rwkv6, recurrentgemma,
    seamless-m4t and llama-3.2-vision at tp 2 within rtol = atol = 1e-4 of
    the JAX tp-2 TE's; rwkv6 also at tp 4 (one head per rank);
  * greedy tokens equal to the JAX tp-2 TE's on the ragged mix, and from
    a state checkpoint (a repeated prompt's prefix).
One module-scoped JAX tp-2 TE per arch serves every case, so its shapes
compile once. This file holds the recurrent archs; ``slot_tp_suite`` makes
the same checks of the cross towers in ``test_torch_tp_cross.py`` (a file
of its own, so ``--dist loadfile`` can put it on another worker).
Everything else at tp > 1 is held against the port's own tp-1 TE
(``tests/test_torch_tp_fleet.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.engine.model_runner import SequenceState as JSequenceState
from repro.launch import sharding as JSH
from repro.launch.mesh import make_engine_mesh as jmake_engine_mesh
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.runners.base import SequenceState
from repro_torch.launch import sharding as SH
from repro_torch.models import serving as S
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

RWKV, RGEMMA = "rwkv6-1.6b", "recurrentgemma-2b"
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [RWKV, RGEMMA]
SHARED = dict(n_slots=4, max_len=64, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
# one 8-token chunk: the ragged mix's largest bucket, compiled once
PROMPT = [1, 5, 9, 200, 41, 33, 77, 150]
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12))]


def _mem(cfg, seed):
    """A request's seeded modality inputs ({} for a model without
    modality memory), fp32 numpy in the engine's keys and shapes."""
    rs = np.random.RandomState(seed)
    return {k: rs.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in S.extra_inputs(cfg, 1, torch.float32, "cpu").items()}


def _bridge(arch):
    bundle = get_model(arch, smoke=True)
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    if "gate_attn" in jp.get("cross_blocks", {}):
        n = jp["cross_blocks"]["gate_attn"].shape[0]
        jp["cross_blocks"]["gate_attn"] = jnp.linspace(0.6, 0.9, n)
        jp["cross_blocks"]["gate_mlp"] = jnp.linspace(-0.7, -0.4, n)
    cfg = smoke_config(get_config(arch))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


# ---------------------------------------------------------------- specs
def _jax_cache_dims(bundle, n_slots, max_len, tp):
    """key -> the dim where "model" stands in each cache leaf's JAX
    sharding (inside a tuple of axes too), or None."""
    like = jax.eval_shape(lambda: bundle.init_cache(n_slots, max_len,
                                                    jnp.float32))
    sh = JSH.engine_cache_shardings(bundle.cfg, like, jmake_engine_mesh(tp),
                                    n_slots, max_len)
    out = {}
    for k, s in sh.items():
        dims = [i for i, ax in enumerate(tuple(s.spec))
                if ax == "model" or (isinstance(ax, tuple) and "model" in ax)]
        out[k] = dims[0] if dims else None
    return out


# ---------------------------------------------------------------- logits
def _jax_raw(te, extra):
    """(prefill-final, first-decode) logits straight off a JAX TE's slot
    runner: PROMPT as one chunk, then a decode step of token 17, on a slot
    it gives back."""
    seq = JSequenceState("s0", tokens=list(PROMPT), n_prompt=len(PROMPT),
                         extra=dict(extra))
    assert te.runner.alloc_slot(seq)
    pre = np.asarray(te.runner.prefill_chunk(seq, list(PROMPT)))
    seq.tokens.append(17)
    dec = np.asarray(te.runner.decode([seq])[0])
    te.runner.free_slot(seq)
    return pre, dec


def _port_raw(te, extra):
    """The same two passes on the port's slot runner (the decode step is
    ``serving.decode_step`` over every slot, as the JAX runner's)."""
    rt = te.runner
    seq = SequenceState("s0", tokens=list(PROMPT), n_prompt=len(PROMPT),
                        extra=dict(extra))
    assert rt.alloc_slot(seq)
    pre = rt.prefill_chunk(seq, list(PROMPT)).numpy()
    tokens = torch.zeros((rt.n_slots,), dtype=torch.int64)
    tokens[seq.slot] = 17
    with torch.no_grad():
        logits, _ = S.decode_step(te.cfg, rt.params, tokens, rt.caches,
                                  rt.mesh)
    dec = logits[seq.slot].numpy()
    rt.free_slot(seq)
    return pre, dec


def slot_tp_suite(archs):
    """The tp-2 checks of this file for ``archs``, as the members a test
    module binds (``globals().update(slot_tp_suite(...))``): its
    ``models`` and ``pairs`` fixtures and its tests, each parametrized
    over ``archs``."""

    @pytest.fixture(scope="module")
    def models():
        return {arch: _bridge(arch) for arch in archs}

    @pytest.fixture(scope="module")
    def pairs(models):
        """One (JAX tp-2 TE, port tp-2 TE) pair per arch, reused by every
        engine case; both always see the same traffic in the same order, so
        their slots and state checkpoints stay in step."""
        return {arch: (JFlowServe(bundle, jp, JEngineConfig(tp=2, **SHARED)),
                       FlowServe(cfg, tp, EngineConfig(tp=2, **SHARED),
                                 device="cpu"))
                for arch, (bundle, jp, cfg, tp) in models.items()}

    @pytest.mark.parametrize("arch", archs)
    def test_cache_split_dims_match_jax_model_axis(arch):
        for smoke, n_slots, max_len in ((True, 4, 64), (False, 8, 2048)):
            bundle = get_model(arch, smoke=smoke)
            cfg = get_config(arch)
            cfg = smoke_config(cfg) if smoke else cfg
            like = S.cache_like(cfg, n_slots, max_len, torch.float32)
            for tp in (2, 4):
                want = _jax_cache_dims(bundle, n_slots, max_len, tp)
                assert SH.engine_cache_specs(cfg, like, tp) == want, \
                    (arch, smoke, tp)

    @pytest.mark.parametrize("arch", archs)
    def test_te_rank_caches_have_the_splits(pairs, arch):
        """Each rank's part of a split leaf is storage of its own with 1/tp of
        the split dim; a replicated leaf is one tensor every rank refers to."""
        te = pairs[arch][1]
        caches = te.runner.caches
        full = S.cache_like(te.cfg, SHARED["n_slots"], SHARED["max_len"],
                            torch.float32)
        specs = te.runner.cache_specs
        assert len(caches) == 2 and any(d is not None for d in specs.values())
        for k, t in full.items():
            a, b = caches[0][k], caches[1][k]
            if specs[k] is None:
                assert a is b and a.shape == t.shape
            else:
                shape = list(t.shape)
                shape[specs[k]] //= 2
                assert list(a.shape) == list(b.shape) == shape
                assert a.data_ptr() != b.data_ptr()

    @pytest.mark.parametrize("arch", archs)
    def test_tp2_logits_match_jax_tp2(pairs, arch):
        jte, tte = pairs[arch]
        extra = _mem(tte.cfg, 7)
        jpre, jdec = _jax_raw(jte, extra)
        pre, dec = _port_raw(tte, extra)
        np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dec, jdec, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("arch", archs)
    def test_tp2_greedy_tokens_equal_jax_tp2(pairs, arch):
        got, want = _serve_both(pairs[arch], "rag-", RAGGED, 100)
        assert got == want

    @pytest.mark.parametrize("arch", archs)
    def test_tp2_state_checkpoint_reuse_matches_jax_tp2(pairs, arch):
        """A finished request leaves a state checkpoint (each rank's part of
        its slot); a prompt that extends it resumes from it on both TEs and
        gives the JAX tp-2 TE's tokens."""
        jte, tte = pairs[arch]
        base = [1] + [int(x) for x in np.random.RandomState(70).randint(3, 200,
                                                                        13)]
        (first,), _ = _serve_both(pairs[arch], "ck-a", [base], 400)
        ext = base + first + [9, 4, 11]
        hits = []
        for te, req, spc in ((jte, JRequest, JSamplingParams),
                             (tte, Request, SamplingParams)):
            _submit(te, req, spc, "ck-b", ext, _mem(tte.cfg, 400))
            hits.append(te._seqs["ck-b"].n_cached)
        assert hits[0] == hits[1] == len(base) + len(first) - 1
        want = {c.req_id: c.tokens for c in jte.run_to_completion()}
        got = {c.req_id: c.tokens for c in tte.run_to_completion()}
        assert got["ck-b"] == want["ck-b"] and len(got["ck-b"]) == 6

    return {k: v for k, v in locals().items()
            if k.startswith("test_") or k in ("models", "pairs")}


globals().update(slot_tp_suite(ARCHS))


def test_rwkv6_tp4_logits_match_jax_tp4(models):
    """Four ranks of the smoke model's four heads: one head, one state
    part and a quarter of every split product per rank."""
    bundle, jp, cfg, tp = models[RWKV]
    jte = JFlowServe(bundle, jp, JEngineConfig(tp=4, **SHARED))
    tte = FlowServe(cfg, tp, EngineConfig(tp=4, **SHARED), device="cpu")
    assert [c["state"].shape[2] for c in tte.runner.caches] == [1] * 4
    assert tte.runner.params[3]["blocks"]["tm"]["wr"].shape[-1] \
        == cfg.d_model // 4
    jpre, jdec = _jax_raw(jte, {})
    pre, dec = _port_raw(tte, {})
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dec, jdec, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- tokens
def _submit(te, req_cls, sp_cls, rid, prompt, extra, max_new=6):
    te.add_request(req_cls(prompt_tokens=prompt, req_id=rid,
                           sampling=sp_cls(temperature=0.0,
                                           max_new_tokens=max_new,
                                           stop_on_eos=False),
                           extra=dict(extra)))


def _serve_both(pair, tag, prompts, seed0):
    jte, tte = pair
    ids = [f"{tag}{i}" for i in range(len(prompts))]
    for i, (rid, p) in enumerate(zip(ids, prompts)):
        extra = _mem(tte.cfg, seed0 + i)
        _submit(jte, JRequest, JSamplingParams, rid, p, extra)
        _submit(tte, Request, SamplingParams, rid, p, extra)
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert sorted(want) == sorted(ids)
    return [got.get(i) for i in ids], [want[i] for i in ids]
