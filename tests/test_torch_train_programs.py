"""The train program (``training/train_loop.py::TrainProgram``, a kind
"train" program of ``engine/programs.py``) on the CPU, where it runs its
body over its static inputs: the port against itself, no JAX.

Held here:

  * the program path equals the eager ``make_train_step`` body bit for
    bit over 3 AdamW steps (loss, grad norm, lr; every leaf of the params,
    of ``m`` and ``v``, and ``step``) for a dense, an MoE, an rwkv, a
    hybrid and an enc-dec model (the last with its modality input), at 1
    and 2 microbatches;
  * one program per (B, S, microbatches, modality inputs): N steps at one
    shape build one, each new B or S one more, an old shape none, and a
    config of another microbatch count a program of its own;
  * the storage the program updates never moves (``data_ptr`` of every
    leaf of the params and of the optimizer state), ``train`` leaves the
    caller's params as they were and returns the program's storage, and a
    released program refuses a new shape.

The captured graphs run in ``tests/test_torch_train_programs_gpu.py``;
``train`` against the reference's in ``tests/test_torch_train_state.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models.model_factory import get_model
from repro_torch.training import (OptimizerConfig, TrainConfig,
                                  TrainProgram, init_opt_state,
                                  make_train_step, train)
from repro_torch.training import tree as TR
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6)
B, S = 4, 16


def _bundle(arch, n_layers=2):
    b = get_model(arch, smoke=True)
    return get_model(dataclasses.replace(b.cfg, n_layers=n_layers))


def _params(bundle):
    return bundle.init_params(torch.Generator().manual_seed(0),
                              torch.float32, "cpu")


def _batch(cfg, seed, b=B, s=S):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(1, cfg.vocab_size, (b, s)).astype(np.int32)
    targets = rs.randint(1, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = (rs.rand(b, s) > 0.2).astype(np.float32)
    return tokens, targets, mask


def _clone(tree):
    return TR.unflatten(tree, [a.clone() for a in TR.leaves(tree)])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m",
                                  "rwkv6-1.6b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_program_equals_eager_body(arch, microbatches):
    """3 steps from the same params and batches: the program's metrics,
    params and optimizer state equal the eager body's exactly."""
    bundle = _bundle(arch, 3 if arch == "recurrentgemma-2b" else 2)
    tcfg = TrainConfig(microbatches=microbatches, opt=OPT)
    p0 = _params(bundle)
    pe, oe = _clone(p0), init_opt_state(p0)
    pp, op = _clone(p0), init_opt_state(p0)
    step = make_train_step(bundle, tcfg)
    prog = TrainProgram(bundle, tcfg, pp, op)
    extra = prog.extra(B)
    assert set(extra) == set(bundle.extra_inputs(1, device="cpu"))
    for i in range(3):
        batch = _batch(bundle.cfg, i)
        pe, oe, me = step(pe, oe, *(torch.from_numpy(a) for a in batch),
                          extra)
        mp = prog(*batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(mp[k], me[k]), (i, k, mp[k], me[k])
    assert prog.builds == 1
    assert int(op["step"]) == int(oe["step"]) == 3
    for tree_p, tree_e in ((pp, pe), (op["m"], oe["m"]), (op["v"], oe["v"])):
        for (path, a), b in zip(TR.flatten_with_paths(tree_p),
                                TR.leaves(tree_e)):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    moved = [path for (path, a), b in zip(TR.flatten_with_paths(pp),
                                          TR.leaves(p0)) if torch.equal(a, b)]
    assert not moved, moved


def test_one_program_per_batch_shape():
    """N steps at one shape build one program; each new B or S builds one
    more; a shape seen before builds none. The microbatch count is the
    config's, part of the key: a program of another config over the same
    params builds one program of its own."""
    bundle = _bundle("qwen3-8b", 1)
    p = _params(bundle)
    opt = init_opt_state(p)
    prog = TrainProgram(bundle, TrainConfig(opt=OPT), p, opt)
    for i in range(4):
        prog(*_batch(bundle.cfg, i))
    assert prog.builds == 1
    builds = []
    for b, s in [(2, S), (B, 8), (B, S), (2, S), (B, 8)]:
        prog(*_batch(bundle.cfg, 9, b, s))
        builds.append(prog.builds)
    assert builds == [2, 3, 3, 3, 3]
    assert sorted(k[:3] for k in prog.programs.by_kind["train"]) == [
        (2, S, 1), (B, 8, 1), (B, S, 1)]
    assert prog.programs.builds == prog.programs.prefill_builds == 0
    two = TrainProgram(bundle, TrainConfig(microbatches=2, opt=OPT), p, opt)
    for i in range(3):
        two(*_batch(bundle.cfg, i))
    assert two.builds == 1 and prog.builds == 3
    assert [k[:3] for k in two.programs.by_kind["train"]] == [(B, S, 2)]


def test_storage_stays_and_caller_params_unchanged():
    """The params and optimizer state keep their storage over the steps;
    ``train`` returns the storage it updated, not the caller's tensors,
    and leaves the caller's values as they were; a released program
    builds nothing more."""
    bundle = _bundle("qwen3-8b", 1)
    p = _params(bundle)
    opt = init_opt_state(p)
    prog = TrainProgram(bundle, TrainConfig(opt=OPT), p, opt)
    ptrs = [a.data_ptr() for a in TR.leaves({"p": p, "o": opt})]
    before = [a.clone() for a in TR.leaves(p)]
    for i in range(3):
        prog(*_batch(bundle.cfg, i))
    assert [a.data_ptr() for a in TR.leaves({"p": p, "o": opt})] == ptrs
    assert int(opt["step"]) == 3
    assert not any(torch.equal(a, b) for a, b in zip(TR.leaves(p), before))
    prog.release()
    with pytest.raises(RuntimeError, match="released"):
        prog(*_batch(bundle.cfg, 0, 2, 8))

    caller = _params(bundle)
    kept = [a.clone() for a in TR.leaves(caller)]
    batches = iter([_batch(bundle.cfg, i) for i in range(3)])
    logs = []
    got, stats = train(bundle, caller, batches,
                       TrainConfig(steps=3, log_every=1, ckpt_every=100,
                                   opt=OPT), log=logs.append)
    for a, b in zip(TR.leaves(caller), kept):
        assert torch.equal(a, b)
    assert not {a.data_ptr() for a in TR.leaves(got)} & \
        {a.data_ptr() for a in TR.leaves(caller)}
    assert stats["programs"] == 1 and len(stats["losses"]) == 3
    assert stats["loss_first"] == stats["losses"][0]
    assert len(stats["grad_norms"]) == len(logs) == 3
    assert stats["capture"] == [{"key": [B, S, 1], "capture_ms": 0.0,
                                 "instantiate_ms": 0.0, "nodes": None}]
