"""The production-mesh dry run of the port (``launch/dryrun.py``,
``probes.py``, ``roofline.py``, ``meta_count.py``, the spec layer of
``launch/sharding.py``) against the JAX package on the CPU, shapes only:
no JAX TE and no 256-device compile (the JAX side is ``jax.eval_shape``
trees, its spec functions and ``NamedSharding.shard_shape`` on an
``AbstractMesh``)."""
import functools
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.core import heatmap as JH
from repro.engine import flowserve as JFS
from repro.launch import roofline as JRF
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models import serving as JS
from repro.models import transformer as JT
from repro_torch.configs.base import (SHAPES, ShapeConfig, get_config,
                                      list_configs, shape_applicable,
                                      smoke_config)
from repro_torch.core import heatmap as H
from repro_torch.engine import flowserve as FS
from repro_torch.kernels import counts, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import work as W
from repro_torch.launch import dryrun as DR
from repro_torch.launch import probes as PR
from repro_torch.launch import roofline as RF
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (ProductionMesh, dp_axes,
                                     make_production_mesh)
from repro_torch.launch.meta_count import MetaCount
from repro_torch.models import moe as M
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _Mesh:
    """The one attribute ``prune_unsplittable`` reads of a JAX mesh."""

    def __init__(self, sizes):
        self.shape = sizes


def _norm(spec, ndim):
    """A spec (JAX's or the port's) as one tuple of axis tuples per dim."""
    dims = list(spec) + [None] * (ndim - len(spec))
    return tuple(() if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in dims)


def _jax_flat(spec_tree, like):
    specs = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    leaves = jax.tree_util.tree_flatten_with_path(like)[0]
    return {jax.tree_util.keystr(kp): _norm(s, leaf.ndim)
            for (kp, s), (_, leaf) in zip(specs, leaves)}


def _port_flat(specs, like):
    out = {}
    SH._zip_map(lambda sp, ls: out.__setitem__(len(out), _norm(
        sp, ls[0].dim())), specs, [like])
    paths = []
    SH.walk(like, lambda path, _: paths.append(path))
    return dict(zip(paths, out.values()))


@functools.lru_cache(maxsize=None)
def _jlike(arch):
    jcfg = jget_config(arch)
    return jcfg, jax.eval_shape(lambda: JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_spec_layer_matches_jax_on_the_production_mesh(mesh_name):
    """param_specs (train and serve), cache_specs of every shape,
    batch_spec, block_param_specs and prune_unsplittable, leaf by leaf,
    for all ten configs at full width."""
    shape, names = MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    dp = dp_axes(make_production_mesh(mesh_name == "multi"))
    assert dp == tuple(n for n in names if n != "model")
    for arch in list_configs():
        cfg = get_config(arch)
        jcfg, jlike = _jlike(arch)
        like = PR.Cell(cfg, SHAPES["train_4k"],
                       make_production_mesh(mesh_name == "multi")).like
        for mode in ("train", "serve"):
            js = JSH.param_specs(jcfg, jlike, mode, dp)
            ps = SH.param_specs(cfg, like, mode, dp)
            assert _port_flat(ps, like) == _jax_flat(js, jlike), (arch, mode)
            assert _port_flat(SH.prune_unsplittable(ps, like, sizes), like) \
                == _jax_flat(JSH.prune_unsplittable(js, jlike, _Mesh(sizes)),
                             jlike), (arch, mode)
            jb = JSH.block_param_specs(jcfg, jlike, mode, dp)
            pb = SH.block_param_specs(cfg, like, mode, dp)
            assert sorted(jb) == sorted(pb)
            for tower in jb:
                jl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                    a.shape[1:], a.dtype), jlike[tower])
                pl = PR._first(like[tower])
                assert _port_flat(pb[tower], pl) == _jax_flat(jb[tower], jl)
        for name, shp in SHAPES.items():
            for nd in (1, 2, 3):
                assert _norm(SH.batch_spec(shp, dp, nd), nd) == _norm(
                    JSH.batch_spec(JSHAPES[name], dp, nd), nd)
            if not shape_applicable(cfg, shp)[0]:
                continue
            jc = jax.eval_shape(lambda: JS.init_cache(
                jcfg, shp.global_batch, shp.seq_len, jnp.bfloat16))
            pc = PR.Cell(cfg, shp, make_production_mesh(
                mesh_name == "multi")).cache_like()
            assert _port_flat(SH.cache_specs(cfg, pc, shp, dp), pc) == \
                _jax_flat(JSH.cache_specs(jcfg, jc, JSHAPES[name], dp), jc)


def _jax_arg_bytes(arch, shape_name, multi):
    """The bytes of one device's blocks of the reference dry run's
    arguments (``dryrun.py:144-187``), from JAX's specs and shard
    shapes."""
    jcfg, jlike = _jlike(arch)
    shape = JSHAPES[shape_name]
    sizes, names = MESHES["multi" if multi else "single"]
    amesh = AbstractMesh(sizes, names)
    dp = tuple(n for n in names if n != "model")
    mode = "train" if shape.kind == "train" else "serve"

    def nbytes(specs, tree):
        leaves = jax.tree.leaves(tree)
        sps = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        return sum(math.prod(NamedSharding(amesh, sp).shard_shape(
            leaf.shape)) * leaf.dtype.itemsize
            for sp, leaf in zip(sps, leaves))
    ps = JSH.param_specs(jcfg, jlike, mode, dp)
    total = nbytes(ps, jlike)
    batch = JST.example_batch(jcfg, shape, jnp.bfloat16)
    for k, v in batch.items():
        total += nbytes(JSH.batch_spec(shape, dp, v.ndim), v)
    if shape.kind == "train":
        f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            a.shape, jnp.float32), jlike)
        total += 2 * nbytes(ps, f32) + 4
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: JS.init_cache(
            jcfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
        total += nbytes(JSH.cache_specs(jcfg, cache, shape, dp), cache)
    return total


def test_argument_bytes_of_every_cell_match_jax():
    for arch in list_configs():
        cfg = get_config(arch)
        for name, shp in SHAPES.items():
            if not shape_applicable(cfg, shp)[0]:
                continue
            for multi in (False, True):
                cell = PR.Cell(cfg, shp, make_production_mesh(multi))
                assert DR.tree_bytes(cell.args()) == _jax_arg_bytes(
                    arch, name, multi), (arch, name, multi)


def test_model_flops_and_the_terms_match_the_reference():
    for arch in list_configs():
        for name in SHAPES:
            assert RF.model_flops_for(get_config(arch), SHAPES[name]) == \
                JRF.model_flops_for(jget_config(arch), JSHAPES[name])
    # the terms at the card's figures; a 16-wide model axis crosses nodes
    mesh = make_production_mesh(False)
    assert (mesh.link("model"), mesh.link("data")) == ("ib", "ib")
    assert ProductionMesh((4, 8), ("data", "model")).link("model") == \
        "nvlink"
    cost = RF.CellCost(flops=1e12, bytes_hbm=3.35e9,
                       coll={"all-reduce@model": 1e9, "all-gather@data": 1e9},
                       flops_by_unit={"bf16": 9.89e14, "fp32": 6.7e10})
    t = RF.make_terms(cost, 256, 1e14, mesh)
    assert t.compute_s == pytest.approx(1.0 + 1e-3)
    assert t.memory_s == pytest.approx(1e-3)
    assert t.collective_s == pytest.approx(3e9 / RF.IB_BW)
    assert t.dominant == "compute" and t.step_time == t.compute_s


SMOKE_MESHES = (ProductionMesh((2, 2), ("data", "model")),
                ProductionMesh((2, 2, 4), ("pod", "data", "model")))
SMOKE_SHAPES = (ShapeConfig("t", "train", 32, 16),
                ShapeConfig("p", "prefill", 32, 16),
                ShapeConfig("d", "decode", 64, 16),
                ShapeConfig("l", "decode", 256, 1))


def _sum_and_whole(cell):
    run, inputs, dm = PR.step_program(cell, "meta")
    whole = DR._cost(DR.count(run, inputs, dm, PR.step_analytic(
        cell, inputs["params"])))
    total = RF.CellCost()
    for p in PR.build_probes(cell):
        r, i, m = p.build("meta", 0, "auto")
        total.add(DR._cost(DR.count(r, i, m, p.analytic)), p.mult)
    return total, whole


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_step_is_the_sum_of_its_probes(kind):
    """Σ mult x probe + outer = the whole step's count on meta, exactly
    (operations, bytes, collectives), for every family at smoke size on a
    (2, 2) and a (2, 2, 4) mesh: serve steps, and train steps at one
    microbatch (the reference's probes take the whole batch)."""
    shapes = SMOKE_SHAPES[:1] if kind == "train" else SMOKE_SHAPES[1:]
    for mesh in SMOKE_MESHES:
        for arch in list_configs():
            cfg = smoke_config(get_config(arch))
            for shape in shapes:
                total, whole = _sum_and_whole(PR.Cell(cfg, shape, mesh))
                assert total.flops == whole.flops, (arch, shape)
                assert total.coll == whole.coll, (arch, shape)
                assert total.bytes_hbm == whole.bytes_hbm, (arch, shape)


def test_matmul_flops_are_2mnk_of_the_block_products():
    """A serve attention block's counted products: q, k, v, o and the
    MLP at the device's share (rank 0's column and row slices)."""
    mesh = ProductionMesh((2, 4), ("data", "model"))
    for arch in ("qwen3-8b", "nemotron-4-15b"):
        cfg = smoke_config(get_config(arch))
        shape = ShapeConfig("p", "prefill", 32, 4)
        cell = PR.Cell(cfg, shape, mesh)
        probe = next(p for p in PR.build_probes(cell)
                     if p.name == "block_attn_global")
        r, i, m = probe.build("meta", 0, "auto")
        with MetaCount() as c:
            r(**i)
        split = SH.attn_shardable(cfg, 4)
        heads = cfg.n_heads // (4 if split else 1)
        kv = cfg.n_kv_heads // (4 if split else 1)
        tokens, d, hd = cell.rows * shape.seq_len, cfg.d_model, cfg.head_dim
        proj = 2 * tokens * d * hd * (2 * heads + 2 * kv)
        mlp = 2 * tokens * d * cfg.d_ff // 4 * (
            3 if cfg.mlp_act in ("swiglu", "geglu") else 2)
        attn = 2 * 2 * cell.rows * heads * shape.seq_len ** 2 * hd
        assert c.matmul_flops == proj + mlp + attn, arch


@pytest.mark.parametrize("tp", [2, 4])
def test_model_axis_collectives_are_what_the_specs_imply(tp):
    """A decode step at the device's share, collectives counted at the
    ``DeviceMesh`` calls, against the bytes the specs imply: the
    embedding's vocab split (an all-reduce of the rows' embeddings), the
    attention heads' split (an all-reduce of each layer's output
    projection; the K/V and query heads gathered for the cache) or, when
    the KV heads do not divide, the attention weights gathered from their
    storage split, the FFN's split (an all-reduce a layer), the head's
    vocab split (the logits gathered); a MoE layer all-reduces its
    experts' (E, capacity, D) partials. And FSDP's in a train step, from
    the specs: per leaf an all-gather over data (twice for a remat'd
    layer's) and a reduce-scatter of its gradient."""
    mesh = ProductionMesh((2, tp), ("data", "model"))
    for arch in ("qwen3-8b", "granite-moe-3b-a800m", "gemma2-9b"):
        cfg = smoke_config(get_config(arch))
        shape = ShapeConfig("d", "decode", 64, 16)
        cell = PR.Cell(cfg, shape, mesh)
        run, inputs, dm = PR.step_program(cell, "meta")
        DR.count(run, inputs, dm)
        b, d, es = cell.rows, cfg.d_model, 2
        layers = cfg.n_layers
        ffn = b * d * es
        if cfg.moe is not None:
            cap = min(M.moe_capacity(b, cfg.moe), b)
            ffn = cfg.moe.n_experts * cap * d * es
        want_ar = b * d * es * (1 + layers * int(SH.attn_shardable(cfg, tp))) \
            + layers * ffn
        want_ag = b * cfg.padded_vocab * es
        if SH.attn_shardable(cfg, tp):
            want_ag += layers * b * cfg.head_dim * es * (
                2 * cfg.n_kv_heads + cfg.n_heads)
        gathered = {}
        SH._zip_map(lambda sp, ls: gathered.__setitem__(len(gathered), (
            sp, ls[0], ls[1])), cell.specs, [cell.like, cell.dims])
        for sp, leaf, dim in gathered.values():
            if "model" in sum((SH._axes(a) for a in sp), ()) and dim is None:
                want_ag += leaf.numel() * leaf.element_size()
        got = dm.collectives
        assert got.get("all-reduce@model", 0) == want_ar, arch
        assert got.get("all-gather@model", 0) == want_ag, arch
        # a train step at one microbatch: FSDP gathers each leaf over
        # data (a remat'd tower's leaf again for the backward's recompute)
        # and reduce-scatters its gradient once
        cell = PR.Cell(cfg, ShapeConfig("t", "train", 32, 16), mesh)
        run, inputs, dm = PR.step_program(cell, "meta")
        DR.count(run, inputs, dm)
        want = {}
        for key in cell.like:
            leaves = []
            SH._zip_map(lambda sp, ls: leaves.append((sp, *ls)),
                        cell.specs[key], [cell.like[key], cell.dims[key]])
            for sp, leaf, dim in leaves:
                if not any("data" in SH._axes(a) for a in sp):
                    continue
                nb = leaf.numel() * leaf.element_size() // (
                    tp if dim is not None else 1)
                axes = "data,model" if dim is None and any(
                    "model" in SH._axes(a) for a in sp) else "data"
                times = 2 if key in PR.TOWERS else 1
                for kind, n in (("all-gather", times), ("reduce-scatter", 1)):
                    k = f"{kind}@{axes}"
                    want[k] = want.get(k, 0) + n * nb
        got = {k: v for k, v in dm.collectives.items() if "data" in k}
        assert got == want, arch


def test_stability_and_jct_match_jax():
    kw = dict(prefill_lens=[256, 2048, 8192], rps_grid=[0.4, 1.2, 2.0])
    for arch in ("qwen3-8b", "h2o-danube-3-4b"):
        got = H.HeatmapStudy(get_config(arch), **kw)
        want = JH.HeatmapStudy(jget_config(arch), **kw)
        want.cost.hw.__dict__.update(got.cost.hw.__dict__)
        assert got.stability() == want.stability()
    a = dict(req_id="r", tokens=[1, 2, 3], ttft=0.25, finish=3.5,
             arrival=1.25, n_prompt=7)
    assert FS.Completion(**a).jct == JFS.Completion(**a).jct == 2.25


def test_meta_route_records_work_and_runs_nothing():
    """On meta each entry returns empty outputs of the right shapes and
    dtypes and records its kernel's work (kernels/work.py), launching
    nothing and running no plain arithmetic; the CPU route is the plain
    version and a CUDA tensor routes to the kernel as before."""
    def boom(*a, **kw):
        raise AssertionError("reached")
    mp = pytest.MonkeyPatch()
    for mod, names in ((R, ("paged_attention_ref", "paged_prefill_ref",
                            "flash_prefill_ref", "wkv6_ref", "rglru_ref")),
                       (ops.PA, ("paged_attention",)),
                       (ops.FP, ("paged_prefill", "flash_prefill")),
                       (ops.WKV, ("wkv6",)), (ops.RG, ("rglru",))):
        for n in names:
            mp.setattr(mod, n, boom)
    got = []
    counts.reset()
    try:
        def meta(*shape, dt=torch.bfloat16):
            return torch.empty(shape, dtype=dt, device="meta")
        with W.recording(lambda n, w: got.append((n, w))):
            for impl in ("auto", "ref"):
                o = ops.flash_prefill(meta(2, 64, 8, 32), meta(2, 64, 2, 32),
                                      meta(2, 64, 2, 32), None, 16, impl=impl)
                assert (o.shape, o.dtype, o.device.type) == (
                    (2, 64, 8, 32), torch.bfloat16, "meta")
            st = meta(2, 4, 16, 16, dt=torch.float32)
            y, s2 = ops.wkv6(*(meta(2, 8, 4, 16) for _ in range(4)),
                             meta(4, 16, dt=torch.float32), st)
            assert y.shape == (2, 8, 4, 16) and s2 is st
            h, hl = ops.rglru(meta(2, 8, 32, dt=torch.float32),
                              meta(2, 8, 32, dt=torch.float32),
                              meta(2, 32, dt=torch.float32))
            assert hl.dtype == torch.float32 and h.shape == (2, 8, 32)
            o = ops.paged_attention(meta(2, 8, 32), meta(9, 16, 2, 32),
                                    meta(9, 16, 2, 32),
                                    meta(2, 4, dt=torch.int32),
                                    meta(2, dt=torch.int32))
            assert o.shape == (2, 8, 32)
    finally:
        mp.undo()
    assert [n for n, _ in got] == ["flash_prefill", "flash_prefill", "wkv6",
                                   "rglru", "paged_attention"]
    assert got[0][1] == W.flash_prefill(2, 64, 8, 2, 32, 16)
    assert got[2][1] == W.wkv6(2, 8, 4, 16, True)
    assert got[3][1] == W.rglru(2, 8, 32)
    assert got[4][1] == W.paged_attention(2, 8, 2, 32, 2 * 64, 8)
    assert counts.totals() == dict.fromkeys(counts.NAMES, 0)
    # CPU: the plain versions; a CUDA tensor: the kernel route
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, h, 16, generator=g) for h in (4, 2, 2))
    assert torch.equal(ops.flash_prefill(q, k, v, None, 8),
                       R.flash_prefill_ref(q, k, v, window=8))

    class Cuda:
        device = torch.device("cuda")
    assert ops._route(Cuda, "auto") == "cuda"
    assert ops._route(Cuda, "ref") == "ref"
    assert ops._route(q, "auto") == "ref" and ops._route(q, "scan") == "scan"
    assert ops._route(q.to("meta"), "scan") == "scan"


def test_work_formulas_give_the_bounds_chip_smoke_gave():
    """The formulas moved out of chip_smoke.py: each against the
    expression it replaced, at the main-path shapes of PERF.md §6."""
    hbm, bf16, tf32, fp32 = 3.35e12, 989e12, 495e12, 67e12
    lengths = [2048] + [1500] * 7
    wk = W.paged_attention(8, 32, 8, 128, sum(lengths), 8 * 128)
    nb = 2 * (2 * 8 * 32 * 128) + 2 * 2 * sum(lengths) * 8 * 128 \
        + 4 * (8 * 128 + 8)
    assert (wk.nbytes, wk.flops) == (nb, 4 * 32 * 128 * sum(lengths))
    assert wk.bound() == (max(nb / hbm, wk.flops / bf16) * 1e3, "bytes")
    starts, lens = [768, 0, 256, 992], [256, 128, 96, 32]
    wk = W.paged_prefill(32, 8, 128, starts, lens, None, 4 * 80)
    pairs = sum(sum(s + j + 1 for j in range(n)) for s, n in zip(starts,
                                                                  lens))
    assert wk.flops == 4 * 32 * 128 * pairs
    for s, win in ((32768, None), (8192, 4096)):
        w = s if win is None else win
        wk = W.flash_prefill(1, s, 32, 8, 128, win)
        assert wk.flops == 4 * 32 * 128 * sum(min(i + 1, w) for i in range(s))
        assert wk.nbytes == 2 * (2 * s * 32 * 128) + 2 * 2 * s * 8 * 128
    n = 1 * 256 * 32 * 64
    wk = W.wkv6(1, 256, 32, 64, True)
    fl = 256 * 32 * (5 * 64 * 64 + 3 * 64)
    assert (wk.nbytes, wk.flops, wk.issued) == (
        5 * 2 * n + 4 * 32 * 64 + 2 * 4 * 32 * 64 * 64, fl, 3 * fl)
    assert wk.bound()[0] == max(wk.nbytes / hbm, 3 * fl / tf32) * 1e3
    wk = W.wkv6(8, 1, 32, 64, False)
    assert wk.bound()[0] == max(wk.nbytes / hbm, wk.flops / fp32) * 1e3
    wk = W.rglru(1, 256, 2560)
    assert (wk.nbytes, wk.flops) == (3 * 4 * 256 * 2560 + 2 * 4 * 2560,
                                     2 * 256 * 2560)


def test_cli_writes_a_record_without_jax(tmp_path):
    out = tmp_path / "d.jsonl"
    code = ("import sys, runpy, json; sys.argv = ['dryrun', '--arch', "
            "'qwen3-8b', '--shape', 'decode_32k', '--mesh', 'single', "
            f"'--probes', '--out', {str(out)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__'); assert 'jax' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300, capture_output=True)
    import json
    rec, = [json.loads(line) for line in out.read_text().splitlines()]
    for key in ("arch", "shape", "mesh", "n_chips", "dtype", "status",
                "argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_device_bytes", "full_artifact",
                "probes", "bytes_scale", "roofline"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["peak_device_bytes"] == rec["argument_bytes"] + \
        rec["output_bytes"] + rec["temp_bytes"] - rec["alias_bytes"]
    assert rec["argument_bytes"] == _jax_arg_bytes("qwen3-8b",
                                                   "decode_32k", False)
    assert rec["roofline"]["decomposition_gap"] == {
        "flops": 0.0, "bytes": 0.0, "wire_bytes": 0.0}
    skipped = DR.compile_cell("qwen3-8b", "long_500k", True)
    assert skipped["status"] == "skipped" and skipped["reason"] == \
        shape_applicable(jget_config("qwen3-8b"), JSHAPES["long_500k"])[1]
    assert np.isfinite(rec["roofline"]["step_s"])
