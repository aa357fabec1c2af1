"""One device's share of a dry-run cell, and its per-block probes (the port
of ``repro/launch/probes.py``).

The device program. One device of the production mesh holds its block of
every argument under the reference's specs (``sharding.param_specs``,
``cache_specs``, ``batch_spec``): the storage layout, whose bytes the dry
run reports. It computes as rank 0 of the port's tensor parallelism at the
model axis's width: the weights split by the engine's rule
(``sharding.engine_param_specs``: attention only when query and KV heads
both divide, the FFN, vocab and recurrence widths), the activations on
rank 0 (``launch.mesh.DeviceMesh``, whose collectives return what rank 0
holds after them and are counted where the port makes them). Where the
storage splits a leaf more than the computation does (FSDP's ``data``
split in train; the heads of an arch whose KV heads do not divide the
model axis), the program gathers it first (``gather``: counted as an
all-gather over those axes, in train again for a remat'd layer's
recompute and its backward as a reduce-scatter), and the train step's
AdamW runs on the storage blocks, as FSDP runs it. The rows are the device's (``batch_spec``), the decode
cache its block (the sequence over the model axis, or over data x model
at a batch under 16).

A probe is one block of that program at that share: its storage slices,
the device's rows of activations and the block's cache, run by the same
layer body the step runs (``steps.prefill_attn_layer``,
``serving.decode_attn_layer``, ``serving._rwkv_layer`` / ``_rglru_layer``
/ ``_cross_after``, ``transformer.layer_bodies`` /
``encoder_layer`` in train, with remat, the gradients and the AdamW of
the block's leaves). ``outer`` is the step at depth 0 (embedding, final
norm, head, the cache's bookkeeping, the loss and its AdamW in train).
The port has no scan to undercount, so the whole step on meta is exact:

    step(cell) = Σ_kind mult_kind x probe_kind + outer

is a check of the decomposition, not a correction (exact for a train
step of one microbatch: the reference's probes take the whole batch). A
probe runs on meta (counted, ``launch/dryrun.py``) and on a card (timed,
``chip_smoke.py`` phase 13) alike: ``Probe.build(device, ...)`` makes its
function and arguments there."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import DeviceMesh, dp_axes
from repro_torch.models import layers as L
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.models.model_factory import get_model
from repro_torch.training import optimizer as O
from repro_torch.training import tree as TR
from repro_torch.training.train_loop import TrainConfig

DTYPE = torch.bfloat16
_OPT = O.OptimizerConfig()


# ------------------------------------------------------------ the cell
class Cell:
    """One device's share of (cfg, shape) on ``mesh`` (a
    ``ProductionMesh``). ``mode``: "train" (FSDP storage) or "serve"."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 mode: Optional[str] = None, microbatches: int = 1,
                 ring: bool = False):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.dp = dp_axes(mesh)
        self.sizes = dict(mesh.shape)
        self.model = self.sizes["model"]
        self.mode = mode or ("train" if shape.kind == "train" else "serve")
        self.microbatches = microbatches
        self.ring = ring
        self.like = T.init_params(cfg, torch.Generator(), DTYPE, "meta")
        self.specs = SH.param_specs(cfg, self.like, self.mode, self.dp,
                                    self.model)
        self.dims = SH.engine_param_specs(cfg, self.like, self.model)
        b = shape.global_batch
        self.rows = b // math.prod(self.sizes[a] for a in self.dp) \
            if b >= 16 else b
        self.steps = 1 if shape.kind == "decode" else shape.seq_len

    # ------------------------------------------------------ shapes
    def shard(self, like, specs):
        """Each leaf of ``like`` as this device's block under ``specs``,
        on the meta device."""
        return SH._zip_map(lambda sp, ls: torch.empty(
            SH.shard_shape(ls[0].shape, sp, self.sizes), dtype=ls[0].dtype,
            device="meta"), specs, [like])

    def cache_like(self):
        """The whole decode cache (the reference's ``init_cache``)."""
        return S.cache_like(self.cfg, self.shape.global_batch,
                            self.shape.seq_len, DTYPE, ring=self.ring)

    def cache_specs(self, like=None):
        return SH.cache_specs(self.cfg, like or self.cache_like(),
                              self.shape, self.dp, self.model)

    def batch(self) -> Dict[str, torch.Tensor]:
        """The cell's inputs, each as this device's block (meta)."""
        full = ST.example_batch(self.cfg, self.shape, DTYPE)
        return {k: torch.empty(SH.shard_shape(
            v.shape, SH.batch_spec(self.shape, self.dp, v.dim()),
            self.sizes), dtype=v.dtype, device="meta")
            for k, v in full.items()}

    def args(self) -> Dict[str, Any]:
        """Every argument of the step as this device's block (meta): the
        reference's argument list (``dryrun.py:144-187``)."""
        params = self.shard(self.like, self.specs)
        out: Dict[str, Any] = {"params": params}
        if self.shape.kind == "train":
            out["opt"] = O.init_opt_state(params)
        elif self.shape.kind == "decode":
            like = self.cache_like()
            out["cache"] = self.shard(like, self.cache_specs(like))
        out.update(self.batch())
        return out

    # ------------------------------------------------------ the program
    def gather(self, tree, specs, dims, dmesh: DeviceMesh,
               regather: bool = False):
        """Storage blocks -> the blocks rank 0 computes on: each dim cut
        more ways than the computation cuts it is joined (the gathered
        tensor's stand-in, ``DeviceMesh.all_gather``'s), counted as one
        all-gather over those axes and, under autograd, a reduce-scatter
        of its gradient. ``regather``: a remat'd layer's weights, which
        FSDP gathers again for the backward's recompute (counted, not
        run: the port's program keeps them)."""
        def one(spec, ls):
            t, dim = ls
            axes = []
            entries = list(spec) + [None] * (t.dim() - len(spec))
            for i, ax in enumerate(entries):
                ways = SH._ways(ax, self.sizes)
                want = self.model if i == dim else 1
                if ways < want:
                    raise ValueError(f"dim {i} of {tuple(t.shape)} is "
                                     f"stored {ways}-way and computed "
                                     f"{want}-way")
                if ways > want:
                    t = torch.cat([t] * (ways // want), i)
                    axes += [a for a in SH._axes(ax)
                             if not (i == dim and a == "model")]
            if axes:
                axis = ",".join(a for a in self.mesh.axis_names if a in axes)
                t = dmesh.collective("all-gather", t, axis)
                if regather:
                    dmesh.record("all-gather", t, axis)
            return t
        return SH._zip_map(one, specs, [tree, dims])

    def dmesh(self, device) -> DeviceMesh:
        return DeviceMesh(device, self.model)


def materialize(tree, device, gen: torch.Generator, cfg: ModelConfig):
    """A meta tree's leaves as tensors on ``device`` drawn from ``gen``:
    floats N(0, 0.02) in the leaf's dtype, integers as valid token ids
    (< vocab)."""
    def make(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 device=device, dtype=t.dtype)
        x = torch.randn(t.shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02
        return x.to(t.dtype)
    return _map(make, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


# ------------------------------------------------------------ probes
@dataclasses.dataclass
class Probe:
    """One block of the device program, ``mult`` times a step.
    ``build(device, seed, impl)`` -> (run, inputs, DeviceMesh): the block
    as ``run(**inputs)`` on that device, its arguments drawn from
    ``seed``, ``impl`` routing its kernels (``kernels/ops.py``).
    ``kernel``: the kernel its serve form launches on a card (None: none).
    ``analytic``: its collectives that the specs imply ({kind@axis:
    bytes})."""
    name: str
    mult: int
    build: Callable[[Any, int, str], tuple]   # (device, seed, impl) -> ...
    kernel: Optional[str] = None
    analytic: Dict[str, float] = dataclasses.field(default_factory=dict)


def _counts(cfg: ModelConfig) -> Dict[str, int]:
    kinds = cfg.layer_kinds()
    return {k: sum(1 for x in kinds if x == k)
            for k in ("attn_global", "attn_local", "rwkv", "rglru")}


def _stack_one(tree):
    """A stacked tower's per-layer tree as a tower of one layer."""
    return _map(lambda t: t[None], tree)


def _first(tree):
    return _map(lambda t: t[0], tree)


def _tower(cfg: ModelConfig, kind: str):
    """(the tower key of ``kind``'s layers, whether its layers are a list
    of trees rather than stacked)."""
    if kind in ("attn_global", "attn_local"):
        return ("attn_blocks", True) if cfg.attn_kind == "hybrid_rglru" \
            else ("blocks", False)
    return {"rwkv": ("blocks", False), "rglru": ("rglru_blocks", True),
            "cross": ("cross_blocks", False),
            "enc": ("enc_blocks", False)}[kind]


def block_like(cell: Cell, kind: str, stacked: bool = False):
    """(one layer's tree of ``kind``, its storage specs, its compute
    dims), meta; with ``stacked``, a stacked tower's layer as a tower of
    one (the train step unbinds its towers, ``transformer.layers``).
    "attn_cross": {"dec": ..., "cross": ...} of a decoder layer and the
    cross block after it."""
    if kind == "attn_cross":
        parts = {k: block_like(cell, k2, stacked)
                 for k, k2 in (("dec", "attn_global"), ("cross", "cross"))}
        return tuple({k: v[i] for k, v in parts.items()} for i in range(3))
    key, listed = _tower(cell.cfg, kind)
    like, specs, dims = (cell.like[key], cell.specs[key], cell.dims[key])
    if listed:
        return like[0], specs[0], dims[0]
    if stacked:
        return _map(lambda t: t[:1], like), specs, dims
    return (_first(like), SH.walk(specs, lambda _, sp: sp[1:]),
            _map_dims(dims))


def _map_dims(dims):
    if isinstance(dims, dict):
        return {k: _map_dims(v) for k, v in dims.items()}
    return None if dims is None else dims - 1


def build_probes(cell: Cell) -> List[Probe]:
    """The probes of ``cell`` (module docstring); Σ mult x probe + outer
    is the step."""
    cfg, shape = cell.cfg, cell.shape
    counts = _counts(cfg)
    wins = {"attn_global": T.GLOBAL_WINDOW,
            "attn_local": cfg.window or T.GLOBAL_WINDOW}
    probes: List[Probe] = []
    n_cross = len(cfg.cross_attn_layers()) if cfg.vision is not None \
        else cfg.n_layers if cfg.encoder is not None else 0
    if shape.kind == "train" and n_cross:
        # a decoder layer and the cross block after it are one remat unit
        # (``transformer.layer_bodies``'s "dec"): their recompute is
        # additive only as a unit
        counts["attn_global"] -= n_cross
    for kind in ("attn_global", "attn_local", "rwkv", "rglru"):
        if counts[kind]:
            probes.append(_block_probe(cell, kind, counts[kind],
                                       wins.get(kind)))
    if n_cross:
        probes.append(_block_probe(
            cell, "attn_cross" if shape.kind == "train" else "cross",
            n_cross, T.GLOBAL_WINDOW))
    if cfg.encoder is not None and shape.kind == "prefill":
        probes.append(_block_probe(cell, "enc", cfg.encoder.n_layers, None))
    if cfg.encoder is not None and shape.kind == "train":
        # the first encoder layer reads the frames, which take no gradient
        if cfg.encoder.n_layers > 1:
            probes.append(_block_probe(cell, "enc", cfg.encoder.n_layers - 1,
                                       None))
        probes.append(_block_probe(cell, "enc", 1, None, grad_x=False))
        probes.append(_junction_probe(cell))
    wins = sorted({wins[k] for k in wins if counts[k]})
    if shape.kind == "decode" and wins:
        probes.append(_mask_probe(cell, wins))
    probes.append(_outer_probe(cell))
    return probes


def _junction_probe(cell: Cell) -> Probe:
    """An enc-dec train step's encoder-to-decoder junction: the encoder's
    frame positions (made once a step) and final norm over its last
    layer's output, the memory's gradient summed over the cross blocks as
    autograd sums it (one add per block after the first), the norm's
    backward, and its leaves' gradient norm part and AdamW. The outer
    probe of such a step has no encoder."""
    cfg = cell.cfg
    key = "enc_final_norm"
    like, specs, dims = ({key: t[key]} for t in (cell.like, cell.specs,
                                                   cell.dims))
    storage_like = cell.shard(like, specs)
    b, f = cell.rows, cfg.encoder.n_frames

    def build(device, seed, impl):
        gen = _generator(device, seed)
        dmesh = cell.dmesh(device)
        storage = storage_like if _is_meta(device) else \
            materialize(storage_like, device, gen, cfg)
        inputs = {"params": storage, "x": _act(gen, (b, f, cfg.d_model),
                                               device),
                  "gs": [_act(gen, (b, f, cfg.d_model), device)
                         for _ in range(cfg.n_layers)],
                  "opt": O.init_opt_state(storage)}
        coeffs = _coefficients(device)

        def run(params, x, gs, opt):
            torch.arange(f, device=x.device)
            flat = [p.detach().requires_grad_() for p in TR.leaves(params)]
            xg = x.detach().requires_grad_()
            lp = cell.gather(TR.unflatten(params, flat), specs, dims, dmesh)
            mem = L.apply_norm(xg, lp[key], cfg.norm)
            acc = gs[0]
            for g in gs[1:]:
                acc = acc + g
            grads = torch.autograd.grad(mem, flat + [xg], acc,
                                        materialize_grads=True)
            gp = grads[:len(flat)]
            sq = [gi.float().square().sum() for gi in gp]
            new = [O._updated(_OPT, p, gi, m, v, *coeffs)
                   for p, gi, m, v in zip(TR.leaves(params), gp,
                                          TR.leaves(opt["m"]),
                                          TR.leaves(opt["v"]))]
            return grads[-1], sq, new
        return run, inputs, dmesh
    return Probe("junction", 1, build, None,
                 dp_grad_bytes(cell, storage_like, specs))


def _mask_probe(cell: Cell, wins: List[int]) -> Probe:
    """A decode step's attention masks: one per window, made once and
    shared by every attention layer of that window
    (``serving._mask``)."""
    def build(device, seed, impl):
        dmesh = cell.dmesh(device)
        cache = _decode_block_cache(cell, "attn_global", device,
                                    _generator(device, seed))
        plan = S._decode_plan(cell.cfg, [cache],
                              cache["length"][:, None], dmesh)

        def run(plan):
            return [S._mask(part, w) for part in plan for w in wins]
        return run, {"plan": plan}, dmesh
    return Probe("masks", 1, build)


def _kernel_of(cell: Cell, kind: str) -> Optional[str]:
    if cell.shape.kind == "train":
        return None
    if kind == "rwkv":
        return "wkv6"
    if kind == "rglru":
        return "rglru"
    if kind.startswith("attn") and cell.shape.kind == "prefill" \
            and cell.shape.seq_len > T.FLASH_SWITCH:
        return "flash_prefill"
    return None


def _block_probe(cell: Cell, kind: str, mult: int, win,
                 grad_x: bool = True) -> Probe:
    cfg, shape = cell.cfg, cell.shape
    lp_like, lp_specs, lp_dims = block_like(cell, kind,
                                            shape.kind == "train")
    storage_like = cell.shard(lp_like, lp_specs)
    b, s, d = cell.rows, cell.steps, cfg.d_model
    mem_len = None
    if kind in ("cross", "enc"):
        mem_len = cfg.vision.n_patches if cfg.vision is not None \
            else cfg.encoder.n_frames

    def build(device, seed, impl):
        gen = _generator(device, seed)
        dmesh = cell.dmesh(device)
        storage = materialize(storage_like, device, gen, cfg) \
            if not _is_meta(device) else storage_like
        xs = s if kind != "enc" else mem_len
        x = _act(gen, (b, xs, d), device)
        inputs = {"params": storage, "x": x}
        if shape.kind == "train":
            return _train_block(cell, kind, dmesh, inputs, lp_specs,
                                lp_dims, win, gen, device, grad_x)
        gathered = functools.partial(cell.gather, specs=lp_specs,
                                     dims=lp_dims, dmesh=dmesh)
        pos = torch.arange(s, device=device).expand(b, s)
        if shape.kind == "decode":
            cache = _decode_block_cache(cell, kind, device, gen)
            inputs["cache"] = cache
            positions = cache["length"][:, None] if "length" in cache \
                else None
            if "k" in cache:
                plan = S._decode_plan(cfg, [cache], positions, dmesh)
                for part in plan:       # the step's, made once: "masks"
                    S._mask(part, win)

            def run(params, x, cache):
                lp = gathered(params)
                if kind.startswith("attn"):
                    return S.decode_attn_layer(cfg, [lp], x, positions,
                                               plan, 0, win, dmesh)
                return _serve_layer(cell, kind, lp, x, cache, dmesh, impl)
            return run, inputs, dmesh
        if kind == "cross":
            inputs["mem"] = _act(gen, (b, mem_len, d), device)
        if kind == "enc":
            pos = torch.arange(mem_len, device=device).expand(b, mem_len)
        mode = "naive" if s <= T.FLASH_SWITCH else "flash"
        groups = T.moe_groups(b * s)
        parts = _layer_cache_parts(cell, kind, b, s, dmesh)

        def run(params, x, mem=None):
            lp = gathered(params)
            if kind.startswith("attn"):
                kv = {key: [torch.zeros((1, b, s, cfg.n_kv_heads,
                                         cfg.head_dim), dtype=DTYPE,
                                        device=x.device)]
                      for key in ("k", "v")}
                return ST.prefill_attn_layer(cfg, [lp], x, [pos], kv, 0,
                                             win, mode, impl, False, dmesh,
                                             groups)
            if kind == "enc":
                return T.encoder_layer(cfg, [pos], dmesh, "flash", x, [lp])
            cache = {k: torch.zeros(shp, dtype=dt, device=x.device)
                     for k, (shp, dt) in parts.items()}
            if kind == "cross":
                S.fill_cross_cache(cfg, [{"cross_blocks": _stack_one(lp)}],
                                   mem, cache, dmesh)
            return _serve_layer(cell, kind, lp, x, cache, dmesh, impl)
        return run, inputs, dmesh

    return Probe(f"block_{kind}" + ("" if grad_x else "_first"), mult,
                 build, _kernel_of(cell, kind),
                 _analytic(cell, kind, storage_like, lp_specs))


_CACHE_KEYS = {"attn_global": ("k", "v"), "attn_local": ("k", "v"),
               "rwkv": ("state", "last_tm", "last_cm"),
               "rglru": ("h", "conv"), "cross": ("cross_k", "cross_v")}


def _layer_cache_parts(cell: Cell, kind: str, b: int, s: int,
                       dmesh: DeviceMesh) -> Dict[str, tuple]:
    """{leaf: (shape, dtype)} of one layer of ``kind``'s prefill cache as
    the step's ``init_cache`` holds it on ``dmesh`` (its length aside)."""
    if kind.startswith("attn") or kind == "enc":
        return {}
    cfg1 = _one_layer(cell.cfg, kind)
    like = S.cache_like(cfg1, b, s, DTYPE)
    specs = SH.mesh_cache_specs(cfg1, like, dmesh)
    out = {}
    for k, t in like.items():
        if k not in _CACHE_KEYS[kind]:
            continue
        shp = list(t.shape)
        if specs[k] is not None:
            shp[specs[k]] //= dmesh.ways
        out[k] = (tuple(shp), t.dtype)
    return out


def _one_layer(cfg: ModelConfig, kind: str) -> ModelConfig:
    """A config whose cache holds one layer of ``kind``."""
    if kind == "rwkv":
        return dataclasses.replace(cfg, n_layers=1)
    if kind == "rglru":
        return dataclasses.replace(cfg, n_layers=1, rglru=dataclasses.replace(
            cfg.rglru, recurrent_per_attn=1))
    if kind == "cross":
        if cfg.vision is not None:
            return dataclasses.replace(cfg, n_layers=1, vision=dataclasses
                                       .replace(cfg.vision,
                                                cross_attn_every=1))
        return dataclasses.replace(cfg, n_layers=1)
    raise KeyError(kind)


def _serve_layer(cell, kind, lp, x, cache, dmesh, impl):
    cfg = cell.cfg
    if kind == "rwkv":
        return S._rwkv_layer(cfg, [{"blocks": _stack_one(lp)}], x, [cache],
                             0, dmesh, None, impl)
    if kind == "rglru":
        return S._rglru_layer(cfg, [lp], x, [cache], 0, dmesh, None, impl)
    return S._cross_after(cfg, [{"cross_blocks": _stack_one(lp)}],
                          (0, cfg.vision is not None), x, cache, dmesh)


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _generator(device, seed: int):
    if _is_meta(device):
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _act(gen, shape, device):
    if _is_meta(device):
        return torch.empty(shape, dtype=DTYPE, device="meta")
    return torch.randn(shape, generator=gen, device=device).to(DTYPE)


def _decode_block_cache(cell: Cell, kind: str, device, gen):
    """The device's block of one layer of ``kind``'s decode cache (and the
    lengths, all at the cell's last position)."""
    cfg = cell.cfg
    like = cell.cache_like()
    specs = cell.cache_specs(like)
    keys = _CACHE_KEYS[kind]
    out = {}
    for k in keys:
        shp = SH.shard_shape(like[k].shape, specs[k], cell.sizes)
        out[k] = torch.empty((1,) + shp[1:], dtype=like[k].dtype,
                             device="meta")
    if kind.startswith("attn"):
        out["length"] = torch.empty(SH.shard_shape(
            like["length"].shape, specs["length"], cell.sizes),
            dtype=torch.int32, device="meta")
    if _is_meta(device):
        return out
    made = materialize(out, device, gen, cfg)
    if "length" in made:
        made["length"].fill_(cell.shape.seq_len - 1)
    return made


def _train_block(cell, kind, dmesh, inputs, specs, dims, win, gen, device,
                 grad_x=True):
    """A train probe: the block's layer body under remat, its gradients
    for the given upstream gradient (its input's too, unless
    ``grad_x`` is False), the gradient-norm part and AdamW of the block's
    storage leaves."""
    cfg = cell.cfg
    b, s = cell.rows, cell.steps
    pos = torch.arange(s, device=device).expand(b, s)
    body = T.layer_bodies(cfg, dmesh, pos, "auto", "scan", True)
    storage = inputs["params"]
    inputs["opt"] = O.init_opt_state(storage)
    inputs["g"] = _act(gen, inputs["x"].shape, device)
    if kind == "attn_cross":
        mem_len = cfg.vision.n_patches if cfg.vision is not None \
            else cfg.encoder.n_frames
        inputs["mem"] = _act(gen, (b, mem_len, cfg.d_model), device)
    coeffs = _coefficients(device)
    unbind = functools.partial(_unbind, cfg)
    fpos = None
    if kind == "enc":
        f = inputs["x"].shape[1]
        fpos = [torch.arange(f, device=device).expand(b, f)]

    def run(params, x, opt, g, mem=None):
        flat = [p.detach().requires_grad_() for p in TR.leaves(params)]
        xg = x.detach().requires_grad_(grad_x)
        lp = cell.gather(TR.unflatten(params, flat), specs, dims, dmesh,
                         regather=True)
        wrt = flat + ([xg] if grad_x else [])
        if kind == "attn_cross":
            if cfg.encoder is not None:     # the encoder's output: trained
                mem = mem.detach().requires_grad_()
                wrt.append(mem)
            out = T._maybe_remat(body["dec"], True)(
                xg, unbind("attn_global", lp["dec"]), win,
                unbind("cross", lp["cross"]), cfg.vision is not None, mem)
        elif kind == "enc":
            fn = functools.partial(T.encoder_layer, cfg, fpos, dmesh, "auto")
            out = T._maybe_remat(fn, True)(xg, [unbind(kind, lp)])
        elif kind == "rwkv" or kind == "rglru":
            lp = unbind(kind, lp)
            out = T._maybe_remat(body[kind], True)(xg, lp)
        elif cfg.attn_kind == "hybrid_rglru":
            out = T._maybe_remat(body["attn"], True)(xg, lp)
        else:
            out = T._maybe_remat(body["dec"], True)(xg, unbind(kind, lp),
                                                     win)
        grads = torch.autograd.grad(out, wrt, g, materialize_grads=True)
        gp = grads[:len(flat)]
        sq = [gi.float().square().sum() for gi in gp]
        new = [O._updated(_OPT, p, gi, m, v, *coeffs) for p, gi, m, v in zip(
            TR.leaves(params), gp, TR.leaves(opt["m"]), TR.leaves(opt["v"]))]
        return grads[len(flat):], sq, new
    return run, inputs, dmesh


def _unbind(cfg: ModelConfig, kind: str, lp):
    """A stacked tower's one-layer tree as the train step reads it
    (``transformer.layers``); a listed tower's tree as it is."""
    if _tower(cfg, kind)[1]:
        return lp
    return T.layers({"tower": lp}, "tower")[0]


def _coefficients(device):
    """AdamW's step scalars (clip scale, lr, bias corrections) as the
    step makes them, outside the counted block."""
    one = torch.ones((), device=device)
    return one, one * _OPT.lr, one * 0.1, one * 0.05


def _analytic(cell: Cell, kind: str, storage, specs) -> Dict[str, float]:
    """The collectives of a probe that the specs imply rather than the
    program's calls: the data-parallel gradients of its leaves in train
    (``dp_grad_bytes``), and in decode the log-sum-exp combine of an
    attention block's sequence-split keys (o in fp32 and lse, gathered
    over the parts: the reference's flash-decode psum)."""
    out: Dict[str, float] = {}
    if cell.shape.kind == "train":
        out.update(dp_grad_bytes(cell, storage, specs))
    if cell.shape.kind == "decode" and kind.startswith("attn"):
        ax = cell.cache_specs()["k"][2]
        parts = SH._ways(ax, cell.sizes)
        if parts > 1:
            key = "all-gather@" + ",".join(
                a for a in cell.mesh.axis_names if a in SH._axes(ax))
            out[key] = parts * cell.rows * cell.cfg.n_heads * (
                cell.cfg.head_dim + 1) * 4
    return out


def dp_grad_bytes(cell: Cell, storage, specs) -> Dict[str, float]:
    """The data-parallel gradient traffic of a train step over the
    storage blocks ``storage`` (specs ``specs``): every leaf's gradient
    all-reduced over ``pod`` (the pod axis is pure data parallelism), and
    over ``data`` where FSDP does not split it (FSDP's reduce-scatter is
    counted at the gather)."""
    out: Dict[str, float] = {}
    pairs = []
    SH._zip_map(lambda sp, ts: pairs.append((sp, ts[0])), specs, [storage])
    for sp, t in pairs:
        nb = t.numel() * t.element_size()
        if "pod" in cell.sizes:
            out["all-reduce@pod"] = out.get("all-reduce@pod", 0.0) + nb
        if not any("data" in SH._axes(a) for a in sp):
            out["all-reduce@data"] = out.get("all-reduce@data", 0.0) + nb
    return out


def step_analytic(cell: Cell, params) -> Dict[str, float]:
    """The whole step's collectives that the specs imply: a train step's
    data-parallel gradients over every leaf of ``params`` (its storage
    blocks), a decode step's combine in every attention layer."""
    if cell.shape.kind == "train":
        return dp_grad_bytes(cell, params, cell.specs)
    out: Dict[str, float] = {}
    for p in build_probes(cell):
        if p.name.startswith("block_attn"):
            for k, v in p.analytic.items():
                out[k] = out.get(k, 0.0) + v * p.mult
    return out


# ------------------------------------------------------------ outer and step
def depth0(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with no layers: its step is the outer probe."""
    kw: Dict[str, Any] = {"n_layers": 0}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=0)
    return dataclasses.replace(cfg, **kw)


OUTER_KEYS = ("embed", "final_norm", "lm_head", "enc_final_norm")
TOWERS = ("blocks", "enc_blocks", "cross_blocks", "rglru_blocks",
          "attn_blocks")


def _outer_probe(cell: Cell) -> Probe:
    keys = [k for k in OUTER_KEYS if k in cell.like]
    sub = Cell.__new__(Cell)
    sub.__dict__.update(cell.__dict__)
    sub.cfg = depth0(cell.cfg)
    if cell.cfg.encoder is not None and cell.shape.kind == "train":
        # the junction probe holds the encoder's final norm
        sub.cfg = dataclasses.replace(sub.cfg, encoder=None)
        keys.remove("enc_final_norm")
    sub.like = {k: cell.like[k] for k in keys}
    sub.specs = {k: cell.specs[k] for k in keys}
    sub.dims = {k: cell.dims[k] for k in keys}
    storage_like = sub.shard(sub.like, sub.specs)

    def build(device, seed, impl):
        return step_program(sub, device, seed, impl)
    analytic = dp_grad_bytes(cell, storage_like, sub.specs) \
        if cell.shape.kind == "train" else {}
    return Probe("outer", 1, build, None, analytic)


def step_program(cell: Cell, device, seed: int = 0, impl: str = "auto"):
    """The whole step of the device program: (run, inputs, DeviceMesh).
    Train: ``steps.build_train_step`` (``make_train_step``'s body) over
    the storage blocks, its forward reading them through ``gather``;
    prefill: ``steps.build_prefill_step`` on the gathered tree; decode:
    ``serving.decode_step`` over the device's cache block (the builder's
    host-side room check reads values, which meta has not)."""
    cfg, shape = cell.cfg, cell.shape
    dmesh = cell.dmesh(device)
    args = cell.args()
    if not _is_meta(device):
        gen = _generator(device, seed)
        args = {k: (v if k == "opt" else materialize(v, device, gen, cfg))
                for k, v in args.items()}
        if "opt" in args:
            args["opt"] = O.init_opt_state(args["params"])
        if "cache" in args:
            args["cache"]["length"].fill_(shape.seq_len - 1)
    extra = {k: args[k] for k in ("vision_embeds", "frames") if k in args}

    # a decode step reads no encoder weight: it gathers none
    skip = ("enc_blocks", "enc_final_norm") if shape.kind == "decode" else ()

    def gathered(params):
        out = {}
        for remat in (False, True):     # train: the towers are remat'd
            keep = [k for k in params if k not in skip and
                    (k in TOWERS) == remat]
            out.update(cell.gather({k: params[k] for k in keep},
                                   {k: cell.specs[k] for k in keep},
                                   {k: cell.dims[k] for k in keep}, dmesh,
                                   regather=remat and shape.kind == "train"))
        return out

    if shape.kind == "train":
        base = get_model(cfg)

        def forward(cfg_, params, tokens, **kw):
            return T.forward(cfg_, gathered(params), tokens, mesh=dmesh, **kw)
        bundle = dataclasses.replace(base, forward=forward)
        step = ST.build_train_step(bundle, TrainConfig(
            microbatches=cell.microbatches, remat=True))

        def run(params, opt, tokens, targets, mask, **extra):
            return step(params, opt, tokens, targets, mask, extra)
        inputs = {k: args[k] for k in ("params", "opt", "tokens", "targets",
                                        "mask")}
        inputs.update(extra)
        return run, inputs, dmesh
    if shape.kind == "prefill":
        step = ST.build_prefill_step(cfg, impl=impl, mesh=dmesh)

        def run(params, tokens, **extra):
            return step([gathered(params)], tokens, extra)
        inputs = {"params": args["params"], "tokens": args["tokens"]}
        inputs.update(extra)
        return run, inputs, dmesh

    def run(params, token, cache):
        return S.decode_step(cfg, [gathered(params)], token, [cache], dmesh,
                             impl)
    return run, {"params": args["params"], "token": args["token"],
                 "cache": args["cache"]}, dmesh
