"""The prefill programs and the unfused decode step (``engine/programs.py``)
on the CPU, where each program runs its body over its static inputs: the
reference's prefill program counts (``tests/test_prefill_batching.py:
180-194``: the warmup builds 7 x 4 ragged programs and serving builds
none; ``:219-228``: the bucketed slot prefill builds fewer than the raw
one), one per-sequence chunk program per (c, npages) and one unfused step
per (B, maxp), the slot prefill program (a device ``n_valid``, the slot's
rows staged through a batch-1 cache) equal to the int path on the slot's
own rows bit for bit for every length in a bucket and on two slots, with
the other slots untouched, prefill and decode programs interleaved giving
the eager engine's tokens, no program left after ``release_params`` and
the staging storage never moving. The port against itself (seeded
weights, 2 smoke layers): no JAX. The captured graphs run in
``tests/test_torch_prefill_programs_gpu.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.runners.base import SequenceState
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

SP = SamplingParams(temperature=0.0, max_new_tokens=8, stop_on_eos=False)
# the reference's ragged prompts and engine config
# (tests/test_prefill_batching.py:66-67, :182-184)
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]
RAGGED_ECFG = dict(n_pages=64, page_size=8, max_batch_tokens=32,
                   chunk_size=8, max_decode_batch=4, max_prefill_seqs=4)
# the reference's slot config (tests/test_prefill_batching.py:205-206)
SLOT_ECFG = dict(n_slots=4, max_len=64, max_batch_tokens=32, chunk_size=8,
                 max_decode_batch=4)


@pytest.fixture(scope="module")
def weights():
    """Seeded fp32 weights of each arch's smoke config at 2 layers."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                      n_layers=2)
            if cfg.encoder is not None:
                cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                    cfg.encoder, n_layers=1))
            gen = torch.Generator().manual_seed(0)
            out[arch] = (cfg, T.init_params(cfg, gen, torch.float32, "cpu"))
        return out[arch]
    return get


def _te(weights, arch="qwen3-8b", **kw):
    cfg, params = weights(arch)
    return FlowServe(cfg, params, EngineConfig(**kw), device="cpu")


def _prompts(n, seed=0, lo=3, hi=30):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(3, 200, int(rs.randint(lo, hi)))]
            for _ in range(n)]


def _serve(te, prompts, sps=None, tag="r"):
    sps = sps or [SP] * len(prompts)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        te.add_request(Request(prompt_tokens=p, sampling=sp,
                               req_id=f"{tag}{i}"))
    comps = {c.req_id: c.tokens for c in te.run_to_completion()}
    assert len(comps) == len(prompts)
    return [comps[f"{tag}{i}"] for i in range(len(prompts))]


def _eager(te):
    """Serve ``te`` through every eager form (the comparison only)."""
    rt = te.runner
    pre, dec = rt.prefill, rt.decoder
    pre.prefill_chunk = pre.prefill_chunk_eager
    dec.decode = dec.decode_step_eager
    if te.pool is not None:
        pre.prefill_ragged_host = pre.prefill_ragged_host_eager
        rt.decode_fused = dec.decode_eager
    else:
        rt.decode_sample = dec.decode_sample_eager
    return te


def test_warmup_prefill_builds_the_grid_and_serving_builds_none(weights):
    """As the reference's test_warmup_prefill_precompiles_grid: token
    buckets pow2s(32 + 4) = 7 x page buckets pow2s(8) = 4 programs at
    warmup, none while serving the ragged prompts."""
    te = _te(weights, **RAGGED_ECFG)
    assert te.prefill_jit_compiles == 0
    assert te.warmup_prefill(max_pages=8) == 7 * 4
    progs = te.runner.programs.prefill_programs
    assert te.prefill_jit_compiles == 28 == len(progs)
    assert {k[0] for k in progs} == {"ragged"} and all(k[-1] for k in progs)
    assert len(_serve(te, RAGGED)) == len(RAGGED)
    assert te.prefill_jit_compiles == 28 and te.prefill_dispatches > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_slot_bucketed_prefill_builds_fewer_programs(weights, arch):
    """As the reference's test_slot_bucketed_prefill_parity: the same
    tokens bucketed and at raw lengths (with the unfused step), the
    bucketed run building fewer prefill programs; a second pass over the
    same lengths builds none either way."""
    runs = []
    for bucket in (False, True):
        te = _te(weights, arch, fused_decode=False, **SLOT_ECFG)
        te.runner.bucket_prefill = bucket
        toks = _serve(te, RAGGED[:4])
        n = te.prefill_jit_compiles
        again = [[t + 1 for t in p] for p in RAGGED[:4]]
        _serve(te, again, tag="s")
        assert te.prefill_jit_compiles == n
        assert te.jit_compiles == 1              # the ("step",) program
        runs.append((toks, n))
    (raw, n_raw), (bucketed, n_bucketed) = runs
    assert bucketed == raw
    assert 0 < n_bucketed < n_raw


def test_per_sequence_chunk_and_unfused_step_one_program_per_key(weights):
    """``batched_prefill=False`` builds one chunk program per distinct
    (c, npages) the serve gives it, ``fused_decode=False`` one step
    program per distinct (B, maxp), unbucketed as in the reference; the
    tokens are the eager forms'."""
    runs = []
    for make in (lambda te: te, _eager):
        te = make(_te(weights, batched_prefill=False, fused_decode=False,
                      **RAGGED_ECFG))
        rt = te.runner
        seen = {"chunk": set(), "step": set()}
        chunk, step = rt.prefill.prefill_chunk, rt.decoder.decode

        def record_chunk(seq, toks, chunk=chunk):
            seen["chunk"].add(("chunk", len(toks), len(seq.pages)))
            return chunk(seq, toks)

        def record_step(seqs, step=step):
            seen["step"].add(("step", len(seqs),
                              max(len(s.pages) for s in seqs)))
            return step(seqs)
        rt.prefill.prefill_chunk, rt.decoder.decode = record_chunk, \
            record_step
        runs.append((_serve(te, RAGGED + _prompts(3, seed=2, hi=50)), te,
                     seen))
    (got, te, seen), (want, te_eager, _) = runs
    assert got == want
    progs = te.runner.programs
    assert set(progs.prefill_programs) == seen["chunk"]
    assert te.prefill_jit_compiles == len(seen["chunk"]) > 1
    assert set(progs.programs) == seen["step"]
    assert te.jit_compiles == len(seen["step"]) > 1
    assert te_eager.prefill_jit_compiles == te_eager.jit_compiles == 0


def _slot_rows(rt, slot):
    return [t[slot:slot + 1].clone() if k == "length" else
            t[:, slot:slot + 1].clone()
            for c in rt.caches for k, t in sorted(c.items())]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_slot_prefill_program_equals_int_path(weights, arch):
    """For every real length of the 16-token bucket, on two different
    slots: the program (``n_valid`` a device operand, the slot's rows
    staged through the batch-1 cache) gives the int path's logits and
    slot rows bit for bit, over a prefix already in the slot, and leaves
    the other slots' rows as they were. One program serves them all."""
    cfg, _ = weights(arch)
    rs = np.random.RandomState(1)
    tes = [_te(weights, arch, **SLOT_ECFG) for _ in range(2)]
    for te in tes:                  # the same state in every slot
        for c in te.runner.caches:
            for k, t in c.items():
                if t.is_floating_point():
                    t.copy_(torch.from_numpy(np.random.RandomState(
                        len(k)).standard_normal(tuple(t.shape))).to(
                            t.dtype))
            c["length"].copy_(torch.tensor([3, 5, 2, 4], dtype=torch.int32))
    extra = {k: rs.standard_normal(tuple(v.shape)).astype("float32")
             for k, v in S.extra_inputs(cfg, 1, torch.float32,
                                        "cpu").items()}
    for n_valid in range(9, 17):
        for slot in (1, 3):
            chunk = [int(t) for t in rs.randint(3, 200, n_valid)]
            out = []
            for te, eager in zip(tes, (False, True)):
                rt = te.runner
                seq = SequenceState(seq_id=f"q{n_valid}{slot}",
                                    tokens=chunk, n_prompt=n_valid,
                                    slot=slot, extra=dict(extra))
                others = [_slot_rows(rt, s) for s in range(4) if s != slot]
                run = rt.prefill.prefill_chunk_eager if eager \
                    else rt.prefill_chunk
                logits = run(seq, chunk)
                rt.extra_dev.pop(seq.seq_id)
                after = [_slot_rows(rt, s) for s in range(4) if s != slot]
                assert all(torch.equal(a, b) for x, y in zip(others, after)
                           for a, b in zip(x, y))
                out.append((logits, _slot_rows(rt, slot)))
            (got, got_rows), (want, want_rows) = out
            assert torch.equal(got, want), (n_valid, slot)
            assert all(torch.equal(a, b) for a, b in zip(got_rows,
                                                         want_rows))
    progs = tes[0].runner.programs.prefill_programs
    assert tes[0].prefill_jit_compiles == 1 == len(progs)
    (key,) = progs
    assert key[:2] == ("slot_prefill", 16)
    assert key[2:] == ((tuple(sorted(extra)),) if extra else ())


def test_a_tensor_n_valid_is_never_read_on_the_host(weights):
    """``serving.prefill`` over a bucket with ``n_valid`` a 0-d tensor
    reads no tensor on the host (every host read raises here) and gives
    the int path's logits and cache bit for bit."""
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        cfg, params = weights(arch)
        te = _te(weights, arch, **SLOT_ECFG)
        caches = [S.init_cache(cfg, 1, 64, torch.float32, te.mesh)
                  for _ in range(2)]
        toks = torch.randint(3, 200, (1, 16), generator=torch.Generator(
        ).manual_seed(3))
        want, _ = S.prefill(cfg, te.runner.params, toks, caches[0], te.mesh,
                            n_valid=11)

        def refuse(*a, **kw):
            raise AssertionError("a host read on the prefill path")
        with pytest.MonkeyPatch.context() as mp:
            for name in ("__bool__", "__int__", "__index__", "__float__",
                         "item", "tolist", "numpy"):
                mp.setattr(torch.Tensor, name, refuse)
            got, _ = S.prefill(cfg, te.runner.params, toks, caches[1],
                               te.mesh, n_valid=torch.tensor(11))
        assert torch.equal(got, want)
        for a, b in zip(caches[0][0].values(), caches[1][0].values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_interleaved_prefill_and_decode_programs_give_eager_tokens(
        weights, arch):
    """Requests arriving while others decode, greedy and sampled (the
    same generator draws on the CPU), chunked over several steps: the
    prefill and decode programs, interleaved step by step in one pool,
    give the eager engine's tokens and end with the same pool or slot
    caches."""
    prompts = _prompts(6, seed=5, lo=5, hi=40)
    sps = [SP, dataclasses.replace(SP, temperature=0.8, top_p=0.9)] * 3
    runs = []
    for make in (lambda te: te, _eager):
        te = make(_te(weights, arch, decode_horizon=2, **RAGGED_ECFG,
                      n_slots=4, max_len=64))
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            te.add_request(Request(prompt_tokens=p, sampling=sp,
                                   req_id=f"r{i}"))
            if i % 2:
                te.step()
        comps = {c.req_id: c.tokens for c in te.run_to_completion()}
        state = te.pool.k + te.pool.v if te.pool is not None else [
            t for c in te.runner.caches for t in c.values()]
        runs.append(([comps[f"r{i}"] for i in range(6)], state,
                     te.prefill_jit_compiles, te.jit_compiles))
    (got, got_state, n_pf, n_dec), (want, want_state, *eager_n) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))
    assert n_pf > 0 and n_dec > 0 and eager_n == [0, 0]


def test_release_params_leaves_no_prefill_program(weights):
    for arch in ("qwen3-8b", "rwkv6-1.6b"):
        te = _te(weights, arch, **RAGGED_ECFG, n_slots=4, max_len=64)
        _serve(te, RAGGED[2:])
        progs = te.runner.programs
        assert progs.prefill_programs and te.prefill_jit_compiles >= 1
        te.release_params(to_host=False)
        assert not progs.all() and progs.pool_id is None
        with pytest.raises(RuntimeError, match="prefill program .*released"):
            progs.get(("chunk", 1, 1), lambda: None, "prefill")


def test_slot_staging_storage_never_moves(weights):
    """A captured graph holds raw addresses: serving, a state-checkpoint
    hit, slots reused and a modality input per request leave the slot
    caches, the staging cache and every program's static inputs in their
    storage."""
    te = _te(weights, "seamless-m4t-large-v2", n_slots=2, max_len=96,
             max_batch_tokens=32, chunk_size=8, max_decode_batch=2)
    rt = te.runner
    prompts = _prompts(3, seed=7, lo=10, hi=30)
    _serve(te, prompts[:2])

    def ptrs():
        progs = {(p.kind, p.key): [t.data_ptr() for t in p.inputs.values()]
                 for p in rt.programs.all()}
        return ([t.data_ptr() for c in rt.caches + rt.prefill._stage
                 for t in c.values()], progs)
    caches, progs = ptrs()
    _serve(te, [prompts[0] + [5, 6, 7], prompts[2], prompts[1]], tag="s")
    caches_after, progs_after = ptrs()
    assert caches_after == caches
    assert all(progs_after[k] == v for k, v in progs.items())
    assert te._state_cache and te.prefill_jit_compiles == sum(
        k[0] == "slot_prefill" for k in rt.programs.prefill_programs)
