"""The port's fine-tune state against the JAX package, on the CPU: the data
pipeline, ``train()`` over several AdamW steps, checkpoints written by
either package and restored by the other, and resume after a crash.

Held here, with the tolerances stated in each test:

  * the packed batches equal the reference's exactly (several sequence
    lengths, batch sizes and data-parallel splits, two epochs), and the
    synthetic corpus string for string;
  * ``train()`` for qwen3-8b and rwkv6-1.6b at smoke (fp32, bridged
    weights, 4 AdamW steps at lr 1e-3 on the packed corpus): the first
    loss within 1e-5 relative; for qwen3 the loss history within 1e-5
    relative and every param within atol 1e-4 (a sign flip in Adam's
    first step moves a weight by 2e-3), also at ``microbatches=2``
    against the reference's; for rwkv6, whose loss is steep by step 3,
    2e-4 and 2.5e-4 (the reason is at the test);
  * checkpoints: the reference's round trip (keep, gc, async, the step
    chosen) on the port; the port's manifest equal to the reference's for
    the same tree but for ``treedef``; a JAX-written {"params", "opt"}
    state restored by the port and a port-written one restored by JAX,
    both bit for bit, bf16 leaves included;
  * resume equivalence as ``tests/test_system.py`` holds it (danube
    smoke: 8 steps straight against 4 + checkpoint + resume 4, params
    within atol 1e-5), port against port.
The launcher, ``launch/train.py``, is run in ``test_torch_launchers.py``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import PackedDataset as JPackedDataset
from repro.data import synthetic_corpus as jsynthetic_corpus
from repro.models import get_model as jget_model
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_opt_state as jinit_opt_state
from repro.training import train as jtrain
from repro_torch.data import DataConfig, PackedDataset, synthetic_corpus
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_factory import get_model
from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                  TrainConfig, init_opt_state, train)
from repro_torch.training import tree as TR
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,batch,dp_rank,dp_size", [
    (16, 2, 0, 1), (33, 5, 0, 1), (24, 3, 1, 2), (8, 4, 2, 3)])
def test_packed_batches_equal_reference(seq, batch, dp_rank, dp_size):
    kw = dict(seq_len=seq, batch_size=batch, n_docs=96, seed=3,
              dp_rank=dp_rank, dp_size=dp_size)
    got, want = PackedDataset(DataConfig(**kw)), \
        JPackedDataset(JDataConfig(**kw))
    np.testing.assert_array_equal(got.windows, want.windows)
    assert len(got) == len(want) > 0
    pairs = list(zip(got.batches(epochs=2), want.batches(epochs=2)))
    assert len(pairs) == 2 * len(want)
    for g, w in pairs:
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synthetic_corpus_equal_reference():
    cfg = dict(n_docs=300, seed=11)
    assert list(synthetic_corpus(DataConfig(**cfg))) == \
        list(jsynthetic_corpus(JDataConfig(**cfg)))


# ---------------------------------------------------------------------------
# train() against the reference
# ---------------------------------------------------------------------------


def _bridged(arch):
    jb = jget_model(arch, smoke=True)
    jp = jb.init_params(jax.random.PRNGKey(0), jnp.float32)
    tb = get_model(arch, smoke=True)
    return jb, jp, tb, params_from_numpy(tb.cfg, jax.tree.map(np.asarray,
                                                              jp), "cpu")


def _logged_losses(lines):
    return [float(s.split("loss=")[1].split()[0]) for s in lines
            if "loss=" in s]


# rwkv6's loss is steep by its third step (grad norm ~1500 before the
# clip), so fp32 rounding grows: the reference's own two WKV forms (the
# chunked one its train step runs, the sequential one the port's plain
# version is) end 4 steps 1.0e-5 apart in loss (3e-5 at step 3) and 4.7e-5
# in params; the port ends 2.3e-5 (9.5e-5 at step 3) and 1.2e-4 from the
# reference. Its bounds are set above that and still show a sign flip in
# Adam's first step (2e-3).
@pytest.mark.parametrize("arch,microbatches,rtol,atol", [
    ("qwen3-8b", 1, 1e-5, 1e-4), ("rwkv6-1.6b", 1, 2e-4, 2.5e-4),
    ("qwen3-8b", 2, 1e-5, 1e-4)])
def test_train_matches_reference(arch, microbatches, rtol, atol):
    """4 AdamW steps at lr 1e-3: the loss history within ``rtol`` (the
    logged losses also within their printed precision), every param
    within ``atol``."""
    jb, jp, tb, tp = _bridged(arch)
    dkw = dict(seq_len=16, batch_size=4, n_docs=64)
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    tkw = dict(steps=4, log_every=1, ckpt_every=100,
               microbatches=microbatches)
    jlog, tlog = [], []
    jparams, jstats = jtrain(
        jb, jp, JPackedDataset(JDataConfig(**dkw)).batches(epochs=10),
        JTrainConfig(opt=JOptimizerConfig(**okw), **tkw), log=jlog.append)
    tparams, tstats = train(
        tb, tp, PackedDataset(DataConfig(**dkw)).batches(epochs=10),
        TrainConfig(opt=OptimizerConfig(**okw), **tkw), log=tlog.append)
    for key in ("loss_first", "loss_last"):
        assert abs(tstats[key] - jstats[key]) <= rtol * abs(jstats[key]), \
            (key, tstats[key], jstats[key])
    assert abs(tstats["loss_first"] - jstats["loss_first"]) \
        <= 1e-5 * jstats["loss_first"]
    assert jstats["loss_last"] < jstats["loss_first"]
    want = np.array(_logged_losses(jlog))
    assert len(want) == 4
    np.testing.assert_allclose(_logged_losses(tlog), want, rtol=0,
                               atol=rtol * want.max() + 1e-4)
    jflat = {jax.tree_util.keystr(p): np.asarray(a)
             for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    for path, a in TR.flatten_with_paths(tparams):
        np.testing.assert_allclose(a.numpy(), jflat[path], rtol=0,
                                   atol=atol, err_msg=path)
    # the caller's params are not changed
    for a, b in zip(TR.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_system.py::test_checkpoint_roundtrip`` on the port, plus
    the on-disk layout: no temporary directory left, shards round-robin,
    bf16 stored as fp32."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}
    cm = CheckpointManager(str(tmp_path), n_shards=2, keep=2)
    cm.save(1, tree)
    cm.save(2, TR.unflatten(tree, [a * 2 if a.dtype != torch.int32 else a
                                   for a in TR.leaves(tree)]),
            blocking=False)
    cm.wait()
    assert cm.list_steps() == [1, 2]
    restored = cm.restore(tree)                 # latest = step 2
    np.testing.assert_allclose(restored["a"].numpy(), tree["a"].numpy() * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert int(restored["b"]["step"]) == 7
    r1 = cm.restore(tree, step=1)
    np.testing.assert_allclose(r1["a"].numpy(), tree["a"].numpy())
    # gc keeps only the last `keep`
    cm.save(3, tree)
    assert cm.list_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert [(m["path"], m["key"], m["shard"], m["dtype"])
            for m in manifest["leaves"]] == [
        ("['a']", "leaf_0", 0, "float32"),
        ("['b']['c']", "leaf_1", 1, "bfloat16"),
        ("['b']['step']", "leaf_2", 0, "int32")]
    with np.load(tmp_path / "step_3" / "shard_1.npz") as sh:
        assert sh["leaf_1"].dtype == np.float32
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def _jax_state():
    """A {"params", "opt"} state of the qwen3 smoke model as the JAX train
    loop holds it: bf16 weights with fp32 norms, fp32 moments (non-zero),
    an int32 step."""
    jb = jget_model("qwen3-8b", smoke=True)
    jp = jb.init_params(jax.random.PRNGKey(1), jnp.bfloat16)
    opt = jinit_opt_state(jp)
    opt = {"m": jax.tree.map(lambda a: a.astype(jnp.float32) * 0.5, jp),
           "v": jax.tree.map(lambda a: jnp.square(a.astype(jnp.float32)),
                             jp),
           "step": opt["step"] + 5}
    return {"params": jp, "opt": opt}


def _port_like(jstate):
    """Zeros of the port's dtypes and shapes for the same tree."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
    return TR.unflatten(jstate, [
        torch.zeros(a.shape, dtype=dt[str(a.dtype)])
        for a in TR.leaves(jstate)])


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    jstate = _jax_state()
    JCheckpointManager(str(tmp_path), n_shards=3).save(5, jstate)
    got = CheckpointManager(str(tmp_path), n_shards=3).restore(
        _port_like(jstate))
    assert int(got["opt"]["step"]) == 5
    n_bf16 = 0
    for (path, a), b in zip(TR.flatten_with_paths(got),
                            TR.leaves(jstate)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        n_bf16 += a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
    assert n_bf16 > 0


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    """The port writes the manifest the reference writes for the same tree
    (but for ``treedef``, the port's own text), and JAX restores it."""
    jstate = _jax_state()
    tstate = TR.unflatten(jstate, [
        torch.tensor(_f32(a)).to(t.dtype)
        for a, t in zip(TR.leaves(jstate), TR.leaves(_port_like(jstate)))])
    CheckpointManager(str(tmp_path / "port"), n_shards=3).save(5, tstate)
    JCheckpointManager(str(tmp_path / "jax"), n_shards=3).save(5, jstate)
    manifests = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "step_5" / "manifest.json") as f:
            m = json.load(f)
        manifests.append((m["step"], m["leaves"]))
    assert manifests[0] == manifests[1]
    got = JCheckpointManager(str(tmp_path / "port"), n_shards=3).restore(
        jstate)
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        b = jstate
        for k in path:
            b = b[k.key]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b),
                                      err_msg=jax.tree_util.keystr(path))


def test_train_resume_equivalence(tmp_path):
    """Crash after step 4 and resume == an uninterrupted run
    (``tests/test_system.py::test_train_resume_equivalence`` on the
    port)."""
    bundle = get_model("h2o-danube-3-4b", smoke=True)
    params0 = bundle.init_params(torch.Generator().manual_seed(0),
                                 torch.float32, "cpu")
    dcfg = DataConfig(seq_len=16, batch_size=2, n_docs=64)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def data():
        return PackedDataset(dcfg).batches(epochs=100)

    quiet = lambda s: None  # noqa: E731
    p_full, _ = train(bundle, params0, data(),
                      TrainConfig(steps=8, log_every=100, ckpt_every=100,
                                  opt=opt), log=quiet)
    ck = CheckpointManager(str(tmp_path))
    train(bundle, params0, data(),
          TrainConfig(steps=4, log_every=100, ckpt_every=4, opt=opt),
          ckpt=ck, log=quiet)
    it = data()
    for _ in range(4):
        next(it)
    logs = []
    p_res, _ = train(bundle, params0, it,
                     TrainConfig(steps=8, log_every=100, ckpt_every=100,
                                 opt=opt), ckpt=ck, resume=True,
                     log=logs.append)
    assert logs == ["resumed from step 4"]
    assert ck.list_steps() == [4, 8]
    for (path, a), b in zip(TR.flatten_with_paths(p_full),
                            TR.leaves(p_res)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=path)
    state = ck.restore({"params": p_res, "opt": init_opt_state(p_res)})
    assert int(state["opt"]["step"]) == 8
