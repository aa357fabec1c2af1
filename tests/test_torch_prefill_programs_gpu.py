"""The prefill programs and the unfused decode step captured as CUDA graphs,
on the card: replayed prefill logits and first tokens equal the eager
prefill's bit for bit (qwen3-8b and granite-moe smoke in bf16, rwkv6,
recurrentgemma, seamless with frames, the VLM with patches), steady
prefill replays make no blocking device call, a replay counts the
``flash_prefill`` launches its capture tallied, programs replayed out of
their capture order and on other slots give the eager tokens, RG-LRU's
streamed body replayed over the TMA maps encoded at capture equals its
eager run, a released TE with prefill programs gives its memory back, and
a prefill capture that fails raises. Every test is marked ``gpu`` and
skips without a CUDA card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu \\
        tests/test_torch_prefill_programs_gpu.py
"""
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (_failures, _fleet, _fleet_prompts,
                                    _greedy, _live_bytes, _pool_bytes, cuda)

ARCHS = [("qwen3-8b", torch.bfloat16),
         ("granite-moe-3b-a800m", torch.bfloat16),
         ("rwkv6-1.6b", torch.float32), ("recurrentgemma-2b", torch.float32),
         ("seamless-m4t-large-v2", torch.float32),
         ("llama-3.2-vision-11b", torch.float32)]


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


def _eager_prefill(te):
    """Serve ``te``'s prefill through the eager forms (the comparison
    only); decode stays on its programs."""
    pre = te.runner.prefill
    pre.prefill_chunk = pre.prefill_chunk_eager
    if te.pool is not None:
        pre.prefill_ragged_host = pre.prefill_ragged_host_eager
    return te


def _recorded(te):
    """Copies of every prefill output ``te`` serves: each ragged pass's
    (Sb, Vp) logits and first tokens, or every slot cache after each slot
    chunk (the engine's chunks stop short of the last prompt token, whose
    logits come from decode)."""
    rec = []
    pre = te.runner.prefill
    if te.pool is not None:
        run = pre.prefill_ragged_host

        def ragged(*a, **kw):
            logits, toks = run(*a, **kw)
            rec.append((logits.clone(), toks.clone()))
            return logits, toks
        pre.prefill_ragged_host = ragged
    else:
        run = pre.prefill_chunk

        def chunk(seq, toks):
            out = run(seq, toks)
            rec.append(tuple(t.clone() for c in te.runner.caches
                             for t in c.values()))
            return out
        pre.prefill_chunk = chunk
    return rec


def _prompts(n, seed=0, lo=9, hi=60):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(3, 200, int(rs.randint(lo, hi)))]
            for _ in range(n)]


def _serve(te, prompts, tag="r", max_new=12, seed=0):
    """Greedy tokens of ``prompts`` on ``te`` in request order, each
    request with seeded modality inputs where the model takes them."""
    from repro_torch.engine import Request, SamplingParams
    from repro_torch.models import serving as S
    rs = np.random.RandomState(seed)
    for i, p in enumerate(prompts):
        extra = {k: rs.standard_normal(tuple(v.shape)).astype("float32")
                 for k, v in S.extra_inputs(te.cfg, 1, torch.float32,
                                            "cpu").items()}
        te.add_request(Request(prompt_tokens=p, req_id=f"{tag}{i}",
                               extra=extra, sampling=SamplingParams(
                                   max_new_tokens=max_new,
                                   stop_on_eos=False)))
    comps = {c.req_id: c.tokens for c in te.run_to_completion()}
    assert len(comps) == len(prompts)
    return [comps[f"{tag}{i}"] for i in range(len(prompts))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", ARCHS, ids=[a for a, _ in ARCHS])
def test_replayed_prefill_equals_eager(cuda, arch, dtype):
    """Two passes of the same lengths (the second replays every key the
    first captured): the prefill programs' logits and first tokens (the
    slot caches after every chunk for the slot family) and the greedy
    tokens equal the eager prefill's bit for bit, and the second pass
    builds no prefill program."""
    prompts = _prompts(5, seed=1)
    again = [[t + 1 for t in p] for p in prompts]
    runs = []
    for make in (lambda te: te, _eager_prefill):
        te = make(_te(cuda, arch, dtype))
        rec = _recorded(te)
        toks = _serve(te, prompts)
        n = te.prefill_jit_compiles
        toks += _serve(te, again, tag="s", seed=1)
        assert te.prefill_jit_compiles == n
        runs.append((toks, rec, n))
    (got, got_rec, n), (want, want_rec, n_eager) = runs
    assert got == want
    assert len(got_rec) == len(want_rec) > 0
    for a, b in zip(got_rec, want_rec):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert n > 0 and n_eager == 0


@pytest.mark.gpu
def test_steady_prefill_replays_never_sync(cuda):
    """Once captured, a ragged prefill program (an all-padding plan on
    the scratch page) and a slot prefill chunk (the rows staged in and
    out, ``n_valid`` uploaded) replay with no blocking device call
    (sync-debug "error"); the first tokens are fetched outside."""
    from repro_torch.engine.runners.base import SequenceState
    from repro_torch.kernels import flash_prefill as FP
    for arch in ("qwen3-8b", "rwkv6-1.6b"):
        te = _te(cuda, arch)
        rt = te.runner
        if te.pool is not None:
            s = rt.pool.scratch_page()
            cu = [0] * 5
            arrays = (np.zeros(16), np.zeros(16), np.full(16, s),
                      np.zeros(16), cu, np.full((4, 2), s), np.zeros(4),
                      FP.build_tiles(cu, 16), np.zeros(4))
            temps = np.zeros((4,), np.float32)

            def call():
                return rt.prefill_ragged_host(arrays, temps,
                                              np.ones_like(temps), te._gen)
        else:
            seq = SequenceState(seq_id="q", tokens=list(range(3, 15)),
                                n_prompt=1000)
            assert rt.alloc_slot(seq)

            def call():
                return rt.prefill_chunk(seq, seq.tokens)
        for n in range(3):
            torch.cuda.synchronize()
            if n:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if te.pool is not None:
            assert int(out[1].max()) < te.cfg.vocab_size
        assert all(p.graph is not None
                   for p in rt.programs.prefill_programs.values())


@pytest.mark.gpu
def test_prefill_replay_counts_the_captured_tally(cuda):
    """A ragged prefill replay adds its capture's tally: one
    ``flash_prefill`` launch per layer, to the totals and to the stepping
    thread's tally."""
    from repro_torch.kernels import counts, ops
    te = _te(cuda, "qwen3-8b")
    assert te.warmup_prefill(max_tokens=8, max_pages=2) == 5 * 2
    n_layers = te.cfg.n_layers
    for prog in te.runner.programs.prefill_programs.values():
        assert prog.graph is not None
        assert prog.launches == {"flash_prefill": n_layers}
    for _ in range(3):
        ops.reset_launches()
        before = counts.thread_tally()["flash_prefill"]
        assert te.warmup_prefill(max_tokens=8, max_pages=2) == 10
        assert ops.launch_counts()["flash_prefill"] == 10 * n_layers
        assert counts.thread_tally()["flash_prefill"] - before \
            == 10 * n_layers
    assert te.prefill_jit_compiles == 10


@pytest.mark.gpu
def test_prefill_programs_out_of_capture_order_and_on_other_slots(cuda):
    """qwen3-8b's warmed ragged grid (captured in sorted key order, all in
    one pool beside the decode programs) replayed as a ragged serve walks
    the buckets, and recurrentgemma's slot prefill programs replayed on
    every slot in turn (more requests than slots), give the eager
    prefill's tokens."""
    for arch, dtype in (("qwen3-8b", torch.bfloat16),
                        ("recurrentgemma-2b", torch.float32)):
        runs = []
        for make in (lambda te: te, _eager_prefill):
            te = make(_te(cuda, arch, dtype, max_batch_tokens=64,
                          chunk_size=16))
            if te.pool is not None:
                te.warmup_prefill(max_pages=8)
                te.warmup_decode(max_pages=8)
            runs.append(_serve(te, _prompts(7, seed=4, lo=3, hi=90),
                               max_new=16))
        assert runs[0] == runs[1], arch


@pytest.mark.gpu
def test_rglru_streamed_body_replays_over_its_captured_maps(cuda):
    """RG-LRU at the slot prefill's shape (1, 256, 2560) fp32 takes its
    streamed TMA body; captured in a graph (the maps encoded for the
    static inputs' and the pool's addresses) and replayed over new values,
    it gives the eager run's result bit for bit."""
    from repro_torch.kernels import rglru as RG
    assert RG.plan(256, 2560, 4, True)["channels"]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def inputs():
        return (torch.rand((1, 256, 2560), generator=gen, device=cuda),
                torch.randn((1, 256, 2560), generator=gen, device=cuda),
                torch.randn((1, 2560), generator=gen, device=cuda))
    a, b, h0 = inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        RG.rglru(a, b, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h, h_last = RG.rglru(a, b, h0)
    for _ in range(2):
        new = inputs()
        for dst, src in zip((a, b, h0), new):
            dst.copy_(src)
        graph.replay()
        want, want_last = RG.rglru(*(t.clone() for t in new))
        assert torch.equal(h, want) and torch.equal(h_last, want_last)


@pytest.mark.gpu
def test_memory_returns_after_a_release_with_prefill_programs(cuda):
    """A forked TE whose prefill and decode programs were captured into
    its own graph pool gives back its pool, its weights and its programs
    when it is drained and released."""
    from repro_torch.engine.distflow import _nbytes
    je = _fleet(cuda, "colo=1", policy="round_robin")
    try:
        je.scale_to(2)
        fork = je.engines[1]
        for p in _fleet_prompts(4, 5):
            je.submit(p, _greedy())
        je.run_to_completion()
        assert fork.prefill_jit_compiles > 0 and fork.jit_compiles > 0
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
def test_a_prefill_capture_failure_raises(cuda):
    """A prefill body that cannot be captured (here: it reads a value on
    the host) makes the step raise, naming the prefill program's key; no
    first token is served from the eager run that precedes the capture."""
    from repro_torch.engine import Request, SamplingParams
    from repro_torch.models import serving as S
    from repro_torch.models import transformer as T
    for arch in ("qwen3-8b", "rwkv6-1.6b"):
        te = _te(cuda, arch)
        mod, name = (T, "unembed") if te.pool is not None \
            else (S, "prefill")
        orig = getattr(mod, name)

        def reads_host(*a, orig=orig, **kw):
            out = orig(*a, **kw)
            float((out[0] if isinstance(out, tuple) else out).sum())
            return out
        te.add_request(Request(prompt_tokens=_prompts(1)[0], req_id="r0",
                               sampling=SamplingParams(max_new_tokens=8,
                                                       stop_on_eos=False)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, name, reads_host)
            with pytest.raises(RuntimeError, match="prefill program"):
                for _ in range(4):
                    te.step()
        seq = te._seqs["r0"]
        assert len(seq.tokens) == seq.n_prompt
        torch.cuda.synchronize()
