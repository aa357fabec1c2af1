"""The train program (``training/train_loop.py::TrainProgram``) captured
as a CUDA graph on the card: replays equal the eager ``make_train_step``
body bit for bit for each family in fp32 and bf16 and launch no
hand-written kernel (the capture of the backward in the thread-local
mode included), ``train`` gives its graph pool back when it returns, and
a body that reads the host fails its capture, naming the kind and the
key. Every test is marked ``gpu`` and skips without a CUDA card; this
file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_programs_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import _live_bytes, cuda  # noqa: F401

ARCHS = ["qwen3-8b", "granite-moe-3b-a800m", "rwkv6-1.6b",
         "recurrentgemma-2b", "seamless-m4t-large-v2"]
B, S = 4, 32


def _setup(dev, arch, dtype, microbatches=1):
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import OptimizerConfig, TrainConfig
    b = get_model(arch, smoke=True)
    b = get_model(dataclasses.replace(
        b.cfg, n_layers=3 if arch == "recurrentgemma-2b" else 2))
    params = b.init_params(torch.Generator(device=dev).manual_seed(0),
                           dtype, dev)
    return b, params, TrainConfig(microbatches=microbatches, opt=(
        OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)))


def _batch(cfg, seed, b=B, s=S):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, cfg.vocab_size, (b, s)).astype(np.int32),
            rs.randint(1, cfg.vocab_size, (b, s)).astype(np.int32),
            (rs.rand(b, s) > 0.2).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_equal_eager_body(cuda, arch, dtype):
    """4 steps (the first eager, then the capture, then 3 replays) from
    the same params and batches as the eager body: every metric, param
    and moment and the step equal bit for bit; one program, a graph of
    some nodes; no kernel launch counted."""
    from repro_torch.kernels import ops
    from repro_torch.training import (TrainProgram, init_opt_state,
                                      make_train_step)
    from repro_torch.training import tree as TR
    bundle, p0, tcfg = _setup(cuda, arch, dtype,
                              microbatches=2 if arch == "qwen3-8b" else 1)
    pe, oe = TR.unflatten(p0, [a.clone() for a in TR.leaves(p0)]), \
        init_opt_state(p0)
    pp, op = TR.unflatten(p0, [a.clone() for a in TR.leaves(p0)]), \
        init_opt_state(p0)
    step = make_train_step(bundle, tcfg)
    prog = TrainProgram(bundle, tcfg, pp, op)
    extra = prog.extra(B)
    ops.reset_launches()
    for i in range(4):
        batch = _batch(bundle.cfg, i)
        pe, oe, me = step(pe, oe, *(torch.from_numpy(a).to(cuda)
                                    for a in batch), extra)
        mp = prog(*batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(mp[k], me[k]), (i, k, mp[k], me[k])
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert prog.builds == 1
    (p,) = prog.programs.all()
    assert p.graph is not None and p.nodes > 0
    for tp, te in ((pp, pe), (op["m"], oe["m"]), (op["v"], oe["v"]),
                   (op["step"], oe["step"])):
        for (path, a), b in zip(TR.flatten_with_paths(tp), TR.leaves(te)):
            assert torch.equal(a, b), path
    prog.release()


def _graph_pools():
    """Bytes by graph pool id of the caching allocator's segments."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg["segment_pool_id"])
        if pid != (0, 0):
            out[pid] = out.get(pid, 0) + seg["total_size"]
    return out


@pytest.mark.gpu
def test_train_gives_its_pool_back(cuda):
    """``train`` on the card captures one program into a graph pool of
    its own; once it returns and its result is dropped, no segment of that
    pool is left and the live bytes are those before it (up to the side
    stream's cuBLAS workspace)."""
    from repro_torch.training import train
    bundle, params, tcfg = _setup(cuda, "qwen3-8b", torch.float32)
    tcfg = dataclasses.replace(tcfg, steps=3, log_every=1, ckpt_every=100)
    base, pools0 = _live_bytes(), set(_graph_pools())
    held = {}

    def log(line):
        if line.startswith("step 3:"):
            held.update({k: v for k, v in _graph_pools().items()
                         if k not in pools0})
    got, stats = train(bundle, params, iter([_batch(bundle.cfg, i, 16, 128)
                                             for i in range(3)]), tcfg,
                       log=log)
    (cap,) = stats["capture"]
    assert stats["programs"] == 1 and cap["capture_ms"] > 0
    assert len(held) == 1 and min(held.values()) > 0, held
    del got
    after = _live_bytes()
    assert not set(held) & set(_graph_pools())
    assert 0 <= after - base <= 64 * 2**20, (after, base)


@pytest.mark.gpu
def test_capture_that_reads_the_host_raises(cuda, monkeypatch):
    """A loss that reads a device value on the host runs eagerly on the
    first call, then fails its capture: the error names the train kind
    and the key, and nothing is replayed or run eagerly after it."""
    from repro_torch.training import TrainProgram, init_opt_state
    from repro_torch.training import train_loop as TL
    bundle, params, tcfg = _setup(cuda, "qwen3-8b", torch.float32)
    real = TL.cross_entropy

    def host_read(logits, targets, mask, vocab):
        if float(mask.sum()) < 0:                 # a host read
            raise AssertionError
        return real(logits, targets, mask, vocab)
    monkeypatch.setattr(TL, "cross_entropy", host_read)
    prog = TrainProgram(bundle, tcfg, params, init_opt_state(params))
    with pytest.raises(RuntimeError, match=r"train program \(4, 32, 1"):
        prog(*_batch(bundle.cfg, 0))
    (p,) = prog.programs.all()
    assert p.graph is None
    prog.release()
