"""The decode hot loop's device programs captured as CUDA graphs, on the
card: replayed greedy tokens equal the eager body's (qwen3-8b and
granite-moe smoke in bf16, rwkv6 and recurrentgemma), steady replays make
no blocking device call, a replay counts the launches its capture
tallied, programs of several buckets replayed out of their capture order
give the eager tokens, a released TE gives its memory back with programs
captured, the threaded plane with captures made lazily on its worker
threads gives the serial tokens, and a capture that fails raises. Every
test is marked ``gpu`` and skips without a CUDA card; this file imports
no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_programs_gpu.py
"""
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (_failures, _fleet, _fleet_prompts,
                                    _greedy, _live_bytes, _pool_bytes, cuda)

ARCHS = [("qwen3-8b", torch.bfloat16),
         ("granite-moe-3b-a800m", torch.bfloat16),
         ("rwkv6-1.6b", torch.float32), ("recurrentgemma-2b", torch.float32)]


def _te(dev, arch, dtype=torch.float32, **kw):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine import EngineConfig, FlowServe
    from repro_torch.models import transformer as T
    cfg = smoke_config(get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    ecfg = dict(n_pages=64, page_size=16, n_slots=4, max_len=96,
                max_decode_batch=4, decode_horizon=4, dtype=dtype)
    return FlowServe(cfg, T.init_params(cfg, gen, dtype, dev),
                     EngineConfig(**{**ecfg, **kw}), device=dev)


def _eager(te):
    """Serve ``te`` through the eager bodies (the comparison only)."""
    rt = te.runner
    if te.pool is not None:
        rt.decode_fused = rt.decoder.decode_eager
    else:
        rt.decode_sample = rt.decoder.decode_sample_eager
    return te


def _prompts(n, seed=0, lo=9, hi=40):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(3, 200, int(rs.randint(lo, hi)))]
            for _ in range(n)]


def _serve(te, prompts, max_new=20):
    """Greedy tokens of ``prompts`` served on ``te``, in request order."""
    from repro_torch.engine import Request, SamplingParams
    for i, p in enumerate(prompts):
        te.add_request(Request(prompt_tokens=p, req_id=f"r{i}",
                               sampling=SamplingParams(
                                   max_new_tokens=max_new,
                                   stop_on_eos=False)))
    comps = {c.req_id: c.tokens for c in te.run_to_completion()}
    assert len(comps) == len(prompts)
    return [comps[f"r{i}"] for i in range(len(prompts))]


def _state(te):
    return te.pool.k + te.pool.v if te.pool is not None else [
        t for c in te.runner.caches for t in c.values()]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", ARCHS, ids=[a for a, _ in ARCHS])
def test_replayed_greedy_tokens_equal_eager(cuda, arch, dtype):
    """Greedy requests through the captured programs give the eager
    body's tokens bit for bit (the same kernels, the same arithmetic), and
    the pool or the slot caches end bit for bit the same."""
    runs = []
    for make in (lambda te: te, _eager):
        te = make(_te(cuda, arch, dtype))
        runs.append((_serve(te, _prompts(4)), _state(te), te.jit_compiles))
    (got, got_state, n), (want, want_state, n_eager) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))
    assert n > 0 and n_eager == 0


def _running(te, temperatures, seed=0):
    """``te`` with one running sequence per temperature, prefill done."""
    from repro_torch.engine import Request, SamplingParams
    for i, (p, t) in enumerate(zip(_prompts(len(temperatures), seed),
                                   temperatures)):
        te.add_request(Request(prompt_tokens=p, req_id=f"r{i}",
                               sampling=SamplingParams(
                                   temperature=t, top_p=0.9,
                                   max_new_tokens=40, stop_on_eos=False)))
    while te.scheduler.waiting or te.scheduler.prefilling \
            or len(te.scheduler.running) < len(temperatures):
        te.step()
    return list(te.scheduler.running)


def _fixed_key_calls(te, live, temperature):
    """Three decode calls of one program key at ``temperature``: a paged
    horizon of 4 (pages for all of them allocated first, the hot state
    rebuilt from these rows) or a slot step. Returns the call."""
    if te.pool is None:
        temps = np.zeros((4,), np.float32)
        top_ps = np.ones((4,), np.float32)
        for s in live:
            temps[s.slot], top_ps[s.slot] = temperature, 0.9
        return lambda: te.runner.decode_sample(live, temps, top_ps, te._gen)
    hot = te._hot_state()
    for s in live:
        te._ensure_pages_no_preempt(s, len(s.tokens) + 12)
    hot.reset()
    hot.sync([(s.seq_id, s.pages, len(s.tokens), s.tokens[-1], temperature,
               0.9) for s in live])
    return lambda: te.runner.decode_fused(hot, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_steady_replays_never_sync(cuda, arch):
    """Once its program is captured, a paged horizon or a slot decode
    step, greedy and sampled, replays with no blocking device call
    (sync-debug "error") and gives valid ids."""
    te = _te(cuda, arch)
    live = _running(te, [0.0, 0.0, 0.0])
    for temperature in (0.0, 0.8):
        call = _fixed_key_calls(te, live, temperature)
        for n in range(3):           # the first call builds the program
            torch.cuda.synchronize()
            if n:
                torch.cuda.set_sync_debug_mode("error")
            try:
                toks = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert int(toks.max()) < te.cfg.vocab_size
    keys = set(te.runner.programs.programs)
    assert {k[-1] for k in keys} == {True, False}
    assert all(p.graph is not None
               for p in te.runner.programs.programs.values())


@pytest.mark.gpu
def test_replay_counts_the_captured_tally(cuda):
    """A capture launches nothing: the build counts one body's launches
    (its eager run) and every replay adds the tally its capture counted,
    n_layers x K paged_attention launches, to the totals and to the
    stepping thread's tally."""
    from repro_torch.kernels import counts, ops
    te = _te(cuda, "qwen3-8b")
    live = _running(te, [0.0, 0.0])
    call = _fixed_key_calls(te, live, 0.0)
    per = te.cfg.n_layers * 4
    for _ in range(3):
        ops.reset_launches()
        before = counts.thread_tally()["paged_attention"]
        call()
        assert ops.launch_counts()["paged_attention"] == per
        assert counts.thread_tally()["paged_attention"] - before == per
    hot = te._hot
    prog = te.runner.programs.programs[(4, hot.bb, hot.pb, True)]
    assert prog.graph is not None
    assert prog.launches == {"paged_attention": per}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m"])
def test_programs_replayed_out_of_capture_order(cuda, arch):
    """The programs of a warmed grid (captured in sorted key order, all
    in one pool) replayed as a ragged serve walks the buckets up and down
    give the eager body's tokens."""
    runs = []
    for make in (lambda te: te, _eager):
        te = make(_te(cuda, arch, max_batch_tokens=64, chunk_size=16))
        te.warmup_decode(max_pages=8)
        toks = _serve(te, _prompts(6, seed=4, lo=3, hi=100), max_new=24)
        runs.append((toks, te.jit_compiles))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == 3 * 4 * 3       # bb x pb x K, all at the warmup


@pytest.mark.gpu
def test_memory_returns_after_a_release_with_programs(cuda):
    """A forked TE that served (its programs captured into its own graph
    pool) gives back its pool, its weights and its programs when it is
    drained and released."""
    from repro_torch.engine.distflow import _nbytes
    je = _fleet(cuda, "colo=1", policy="round_robin")
    try:
        je.scale_to(2)
        fork = je.engines[1]
        for p in _fleet_prompts(4, 5):
            je.submit(p, _greedy())
        je.run_to_completion()
        assert fork.jit_compiles > 0
        assert fork.runner.programs.pool_id is not None
        owned = _pool_bytes(fork) + _nbytes(fork.runner.params)
        del fork
        before = _live_bytes()
        je.drain("te-scale0")
        je.step()
        assert je.n_serving() == 1 and not _failures(je)
        returned = before - _live_bytes()
        assert abs(returned - owned) <= 2 * 2**20, (returned, owned)
    finally:
        je.close()


@pytest.mark.gpu
def test_threaded_plane_with_lazy_captures_gives_serial_tokens(cuda):
    """Three executor threads, each TE capturing its programs on its
    worker thread as the serve reaches each key, give the serial plane's
    greedy tokens at 2 fp32 layers of full width, on the kernels."""
    runs = []
    for threads in (0, 3):
        je = _fleet(cuda, "pd=1,colo=1", n_layers=2, fleet_threads=threads)
        try:
            rids = [je.submit(p, _greedy(16)) for p in _fleet_prompts(8, 3)]
            je.run_to_completion()
            assert not _failures(je), _failures(je)
            assert sum(e.jit_compiles for e in je.engines) > 0
            toks = {c.req_id: c.tokens for c in je.completions}
            runs.append([toks[r] for r in rids])
        finally:
            je.close()
    assert runs[0] == runs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_a_capture_failure_raises(cuda, arch):
    """A body that cannot be captured (here: it reads a value on the host)
    makes the step raise, naming the program's key; no token is served
    from the eager run that precedes the capture."""
    from repro_torch.models import serving as S
    from repro_torch.models import transformer as T
    te = _te(cuda, arch)
    mod, name = (T, "unembed") if te.pool is not None else (S, "decode_step")
    orig = getattr(mod, name)

    def reads_host(*a, **kw):
        out = orig(*a, **kw)
        float((out[0] if isinstance(out, tuple) else out).sum())
        return out
    from repro_torch.engine import Request, SamplingParams
    te.add_request(Request(prompt_tokens=_prompts(1)[0], req_id="r0",
                           sampling=SamplingParams(max_new_tokens=8,
                                                   stop_on_eos=False)))
    while te.scheduler.prefilling or te.scheduler.waiting \
            or not te.scheduler.running:
        te.step()
    n_tokens = len(te.scheduler.running[0].tokens)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, name, reads_host)
        with pytest.raises(RuntimeError, match="decode program"):
            for _ in range(4):
                te.step()
    assert len(te.scheduler.running[0].tokens) == n_tokens
    torch.cuda.synchronize()
