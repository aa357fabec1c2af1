"""The decode hot loop's device programs (``engine/programs.py``) on the
CPU, where each program runs its body over its static inputs: the
reference's program counts (``tests/test_hotloop.py:138-188``: a warmup
builds every bucket's program, serving inside the grid builds none, one
dispatch per K-step horizon), a program reused when its bucket comes
back, storage that never moves under the captured addresses, no program
left after ``release_params``, the slot family's greedy and sampled
programs, and the program path equal to the eager body, paged and slot.
The port against itself (seeded weights, 2 smoke layers): no JAX. The
captured graphs themselves run in ``tests/test_torch_programs_gpu.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.distflow import tree_leaves
from repro_torch.engine.programs import ProgramCache
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

GREEDY = SamplingParams(temperature=0.0, max_new_tokens=10,
                        stop_on_eos=False)
# the reference's engine config of test_warmup_precompiles_all_buckets
WARM_ECFG = dict(n_pages=64, page_size=16, max_batch_tokens=32,
                 chunk_size=8, max_decode_batch=4, decode_horizon=2)


def _cfg(arch, n_layers=2):
    return dataclasses.replace(smoke_config(get_config(arch)),
                               n_layers=n_layers)


@pytest.fixture(scope="module")
def weights():
    """Seeded fp32 weights of each arch's smoke config, made once."""
    out = {}

    def get(arch, n_layers=2):
        if (arch, n_layers) not in out:
            cfg = _cfg(arch, n_layers)
            gen = torch.Generator().manual_seed(0)
            out[arch, n_layers] = (cfg, T.init_params(cfg, gen,
                                                      torch.float32, "cpu"))
        return out[arch, n_layers]
    return get


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


def _te(weights, arch="qwen3-8b", **kw):
    cfg, params = weights(arch)
    return FlowServe(cfg, params, EngineConfig(**kw), device="cpu")


def _submit(te, prompts, sps, tag="r"):
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        te.add_request(Request(prompt_tokens=p, sampling=sp,
                               req_id=f"{tag}{i}"))


def _serve(te, prompts, sps):
    _submit(te, prompts, sps)
    comps = {c.req_id: c.tokens for c in te.run_to_completion()}
    assert len(comps) == len(prompts)
    return [comps[f"r{i}"] for i in range(len(prompts))]


def test_warmup_builds_every_bucket_and_serving_builds_none(weights):
    """As the reference's test_warmup_precompiles_all_buckets: bb {1,2,4}
    x pb {1,2} x K {1,2} programs at warmup, none while serving."""
    te = _te(weights, **WARM_ECFG)
    assert te.jit_compiles == 0
    assert te.warmup_decode(max_pages=2) == 3 * 2 * 2
    assert te.jit_compiles == 12 == len(te.runner.programs.programs)
    assert len(_serve(te, _prompts(3), [GREEDY] * 3)) == 3
    assert te.jit_compiles == 12


def test_steady_state_counters(weights):
    """As the reference's test_steady_state_counters: in steady decode no
    program is built, four steps run 4K decode iterations in four
    dispatches (one per horizon)."""
    k = 4
    te = _te(weights, n_pages=16, page_size=64, max_batch_tokens=32,
             chunk_size=8, max_decode_batch=4, decode_horizon=k)
    _submit(te, _prompts(3), [dataclasses.replace(GREEDY,
                                                  max_new_tokens=48)] * 3)
    for _ in range(50):
        te.step()
        if not (te.scheduler.waiting or te.scheduler.ready
                or te.scheduler.prefilling) and te.decode_steps >= 2 * k:
            break
    compiles0, disp0, dsteps0 = (te.jit_compiles, te.host_dispatches,
                                 te.decode_steps)
    for _ in range(4):
        te.step()
    assert te.jit_compiles == compiles0
    assert te.decode_steps - dsteps0 == 4 * k
    assert te.host_dispatches - disp0 == 4


def test_program_reused_after_bucket_shrinks_and_grows(weights):
    """Four sequences, two of them short: the batch bucket shrinks to 2
    when they finish and grows back to 4 when two more arrive; the
    horizon then runs the same program objects it built before."""
    te = _te(weights, n_pages=64, page_size=16, max_batch_tokens=64,
             chunk_size=16, max_decode_batch=4, decode_horizon=1)
    short = dataclasses.replace(GREEDY, max_new_tokens=3)
    long = dataclasses.replace(GREEDY, max_new_tokens=40)
    _submit(te, _prompts(4), [short, short, long, long])
    seen, bbs = {}, []
    while te.has_work():
        te.step()
        hot = te._hot
        if hot is not None and hot.bb:
            bbs.append(hot.bb)
            seen.setdefault(hot.bb, dict(te.runner.programs.programs))
        if te.steps == 12:
            _submit(te, _prompts(2, seed0=7), [long, long], tag="late")
    assert 2 in bbs and bbs.index(2) < len(bbs) - 1 - bbs[::-1].index(4)
    progs = te.runner.programs.programs
    for key, prog in seen[4].items():
        assert progs[key] is prog
    assert te.jit_compiles == len(progs)


def _ptrs(te):
    """Addresses of every tensor a program reads besides its inputs."""
    rt = te.runner
    out = [t.data_ptr() for t in tree_leaves(rt.params)]
    if te.pool is not None:
        out += [t.data_ptr() for t in te.pool.k + te.pool.v]
    else:
        out += [t.data_ptr() for c in rt.caches for t in c.values()]
    return out


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_storage_never_moves_across_a_mixed_serve(weights, arch):
    """A captured graph holds raw addresses: prefill, finish (evict),
    a prefix hit (the paged RTC's pages, the slot family's restored
    state checkpoint), bucket rebuilds and page growth leave every
    weight, the pool and the slot caches in their storage."""
    te = _te(weights, arch, n_pages=64, page_size=8, n_slots=4, max_len=96,
             max_batch_tokens=32, chunk_size=8, max_decode_batch=4,
             decode_horizon=4)
    before = _ptrs(te)
    prompts = _prompts(3, length=17)
    _serve(te, prompts, [GREEDY, dataclasses.replace(
        GREEDY, max_new_tokens=3), dataclasses.replace(
            GREEDY, temperature=0.8, top_p=0.9)])
    _submit(te, [prompts[0] + [5, 6, 7]], [GREEDY], tag="hit")
    te.run_to_completion()
    assert _ptrs(te) == before
    assert te.jit_compiles >= 2


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_release_params_leaves_no_program(weights, arch):
    te = _te(weights, arch, n_pages=64, page_size=8, n_slots=4, max_len=64)
    _serve(te, _prompts(2), [GREEDY] * 2)
    assert te.runner.programs.programs and te.jit_compiles >= 1
    te.release_params(to_host=False)
    progs = te.runner.programs
    assert not progs.programs and progs.pool_id is None
    with pytest.raises(RuntimeError, match="released its weights"):
        progs.get((1,), lambda: None)


def test_slot_builds_one_greedy_program_and_one_sampled(weights):
    """The reference's slot runner builds one decode program
    (``runners/slot.py:236``); the port keys it by the all-greedy flag, so
    an all-greedy run builds one and a sampled request one more."""
    te = _te(weights, "recurrentgemma-2b", n_slots=4, max_len=64)
    _serve(te, _prompts(2), [GREEDY] * 2)
    assert te.jit_compiles == 1
    te.add_request(Request(prompt_tokens=_prompts(1, seed0=5)[0],
                           req_id="s", sampling=dataclasses.replace(
                               GREEDY, temperature=0.9, top_p=0.9)))
    (c,) = te.run_to_completion()
    assert te.jit_compiles == 2 and len(c.tokens) == 10
    assert set(te.runner.programs.programs) == {(True,), (False,)}


def _eager(te):
    """Serve ``te`` through the eager bodies (the comparison only)."""
    rt = te.runner
    if te.pool is not None:
        rt.decode_fused = rt.decoder.decode_eager
    else:
        rt.decode_sample = rt.decoder.decode_sample_eager
    return te


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m",
                                  "rwkv6-1.6b", "recurrentgemma-2b"])
def test_program_path_equals_eager_body(weights, arch):
    """Greedy and sampled requests (the same generator draws on the CPU)
    through the programs give the eager body's tokens, and the pool or the
    slot caches end bit for bit the same."""
    prompts = _prompts(4, length=13)
    sps = [GREEDY, dataclasses.replace(GREEDY, temperature=0.8, top_p=0.9),
           dataclasses.replace(GREEDY, max_new_tokens=6), GREEDY]
    kw = dict(n_pages=64, page_size=8, n_slots=4, max_len=64,
              max_batch_tokens=32, chunk_size=8, max_decode_batch=4,
              decode_horizon=4)
    runs = []
    for make in (lambda te: te, _eager):
        te = make(_te(weights, arch, **kw))
        toks = _serve(te, prompts, sps)
        state = te.pool.k + te.pool.v if te.pool is not None else [
            t for c in te.runner.caches for t in c.values()]
        runs.append((toks, state, te.jit_compiles))
    (got, got_state, n), (want, want_state, n_eager) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))
    assert n > 0 and n_eager == 0


def test_a_te_over_several_devices_keeps_the_eager_body():
    """Programs capture on one device: a TE's mesh over several devices
    keeps the eager horizon (decided when the runner is built); tp ranks
    sharing one device capture."""
    assert ProgramCache(make_engine_mesh(2, 0, "cpu")).enabled
    assert not ProgramCache(EngineMesh([torch.device("cuda", 0),
                                        torch.device("cuda", 1)])).enabled
