"""Production-mesh dry run on H100 terms (the port of
``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell, the step of one
device (``launch/probes.py``'s device program: the reference's storage
layout, the port's rank-0 program over the device's rows and cache) runs
on the meta device under a dispatch mode that counts
(``launch/meta_count.py``): the port's counterpart of the reference's
``jit(...).lower(...).compile()`` on 512 fake CPU devices and its
``memory_analysis`` / ``cost_analysis``. No JAX, no card, no memory: a
full-width step at full depth takes seconds. The record has the
reference's keys:

  * ``argument_bytes``: the device's blocks of the arguments under the
    reference's specs (params, optimizer state and batch in train; params
    and batch in prefill; params, token and cache in decode);
  * ``output_bytes``: what the step returns; ``alias_bytes``: the donated
    arguments (params and optimizer state in train, the cache in decode);
    ``temp_bytes``: the most the step holds at once beyond them;
    ``peak_device_bytes`` = argument + output + temp - alias, as the
    reference sums them (``dryrun.py:51-60``); ``fits``: at most the
    card's 80 GB;
  * ``full_artifact``: the whole step's count (operations by unit, bytes,
    collectives by kind and axis);
  * ``roofline``: the three terms at the card's peaks
    (``launch/roofline.py``), of the whole step's count (``source``
    "step": the port has no scan to undercount) or, with ``--probes``, of
    Σ mult x probe + outer ("probes", the reference's source), then with
    ``decomposition_gap``: that sum's relative difference from the whole
    step's count (0 where the step is additive in its blocks; a train
    step over microbatches gathers its FSDP weights once a microbatch,
    where the reference's probes, at the whole batch, gather once);
  * ``probes`` (``--probes``): each block's count and multiplier;
    ``bytes_scale`` is 1.0 (meta counts bf16 directly).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # 80 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --mesh single --probes
Records append to artifacts/dryrun.jsonl (one JSON object per cell).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (SHAPES, get_config, list_configs,
                                      shape_applicable)
from repro_torch.core import perf_model as PM
from repro_torch.launch import probes as PR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meta_count import MetaCount
from repro_torch.launch.roofline import CellCost, make_terms, model_flops_for
from repro_torch.launch.steps import default_microbatches
from repro_torch.models import perf_flags as PF


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, each distinct storage once."""
    seen: Dict[int, int] = {}
    for t in _leaves(tree):
        seen[t.untyped_storage()._cdata] = t.numel() * t.element_size()
    return sum(seen.values())


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def count(run, inputs, dmesh, analytic: Optional[Dict[str, float]] = None
          ) -> Dict[str, Any]:
    """Run ``run(**inputs)`` on meta under ``MetaCount``: its operations,
    bytes, collectives and memory."""
    in_keys = {t.untyped_storage()._cdata for t in _leaves(inputs)}
    with MetaCount() as c:
        out = run(**inputs)
        outs = _leaves(out)
        out_bytes = tree_bytes(outs)
        fresh = sum(t.numel() * t.element_size() for t in {
            t.untyped_storage()._cdata: t for t in outs
            if t.untyped_storage()._cdata not in in_keys}.values())
        peak = c.peak
    coll = dict(dmesh.collectives)
    for k, v in (analytic or {}).items():
        coll[k] = coll.get(k, 0.0) + v
    return {"flops": dict(c.flops), "matmul_flops": c.matmul_flops,
            "bytes": c.bytes, "collectives": coll, "kernels": c.kernels,
            "output_bytes": out_bytes, "fresh_output_bytes": fresh,
            "peak_live_bytes": peak}


def _cost(rec: Dict[str, Any]) -> CellCost:
    return CellCost(flops=sum(rec["flops"].values()),
                    bytes_hbm=rec["bytes"], coll=dict(rec["collectives"]),
                    flops_by_unit=dict(rec["flops"]))


def compile_cell(arch: str, shape_name: str, multi_pod: bool,
                 run_probes: bool = False,
                 opt_flags: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """One cell's record (module docstring). ``opt_flags`` (the
    reference's hillclimb knobs the port expresses):
      microbatches: int — gradient-accumulation override
      perf: dict       — ``models.perf_flags`` fields
      fsdp: bool       — False = params and optimizer state split over
                         ``model`` alone, replicated over ``data``
    """
    opt_flags = dict(opt_flags or {})
    unknown = set(opt_flags) - {"microbatches", "perf", "fsdp"}
    if unknown:
        raise NotImplementedError(
            f"opt flags {sorted(unknown)} pin GSPMD activation layouts "
            f"(models/actsharding.py), which the port's explicit ranks do "
            f"not express")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single",
                           "n_chips": 512 if multi_pod else 256,
                           "dtype": "bf16"}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    if opt_flags.get("perf"):
        PF.set_flags(**opt_flags["perf"])
    try:
        return _compile(rec, cfg, shape, multi_pod, run_probes, opt_flags)
    finally:
        PF.reset()


def _compile(rec, cfg, shape, multi_pod, run_probes, opt_flags):
    mesh = make_production_mesh(multi_pod)
    mode = "train" if shape.kind == "train" else "serve"
    if not opt_flags.get("fsdp", True):
        mode = "serve"
    rec["opt_flags"] = {k: v for k, v in opt_flags.items() if k != "perf"}
    if opt_flags.get("perf"):
        rec["opt_flags"]["perf"] = dict(opt_flags["perf"])
    mb = opt_flags.get("microbatches", default_microbatches(cfg)) \
        if shape.kind == "train" else 1
    ring = (shape.kind == "decode" and PF.get().ring_buffer_decode
            and cfg.attn_kind in ("swa", "hybrid_rglru"))
    cell = PR.Cell(cfg, shape, mesh, mode=mode, microbatches=mb, ring=ring)
    if shape.kind == "train":
        rec["microbatches"] = mb
    t0 = time.monotonic()
    run, inputs, dmesh = PR.step_program(cell, "meta")
    arg = tree_bytes(inputs)
    full = count(run, inputs, dmesh, PR.step_analytic(cell, inputs["params"]))
    alias = 0
    if shape.kind == "train":
        alias = tree_bytes([inputs["params"], inputs["opt"]])
    elif shape.kind == "decode":
        alias = tree_bytes(inputs["cache"])
    temp = max(0, full["peak_live_bytes"] - full["fresh_output_bytes"])
    rec["compile_s"] = round(time.monotonic() - t0, 1)
    rec["status"] = "ok"
    rec.update({"argument_bytes": arg, "output_bytes": full["output_bytes"],
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_device_bytes": arg + full["output_bytes"] + temp
                - alias})
    rec["fits"] = rec["peak_device_bytes"] <= PM.HBM_BYTES
    rec["full_artifact"] = {
        "flops_per_chip": sum(full["flops"].values()),
        "flops_by_unit": full["flops"], "matmul_flops": full["matmul_flops"],
        "bytes_per_chip": full["bytes"], "collectives": full["collectives"],
        "kernels": full["kernels"]}
    rec["rows_per_chip"] = cell.rows

    whole = _cost(full)
    total = whole
    if run_probes:
        total = CellCost()
        probe_recs = []
        for p in PR.build_probes(cell):
            tp = time.monotonic()
            prun, pin, pmesh = p.build("meta", 0, "auto")
            args = tree_bytes(pin)      # before the run: a plan caches masks
            c = count(prun, pin, pmesh, p.analytic)
            total.add(_cost(c), p.mult)
            probe_recs.append({
                "name": p.name, "mult": p.mult, "kernel": p.kernel,
                "flops_per_chip": sum(c["flops"].values()),
                "flops_by_unit": c["flops"],
                "matmul_flops": c["matmul_flops"],
                "bytes_per_chip": c["bytes"], "collectives": c["collectives"],
                "argument_bytes": args,
                "peak_live_bytes": c["peak_live_bytes"],
                "compile_s": round(time.monotonic() - tp, 1)})
        rec["probes"] = probe_recs
    rec["bytes_scale"] = 1.0
    terms = make_terms(total, rec["n_chips"], model_flops_for(cfg, shape),
                       mesh)
    rec["roofline"] = {
        "source": "probes" if run_probes else "step",
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "step_s": terms.step_time, "model_flops": terms.model_flops,
        "hlo_flops_global": terms.hlo_flops_global,
        "useful_ratio": terms.useful_flops_ratio,
        "wire_bytes_per_chip": total.wire_bytes()}
    if run_probes:
        rec["roofline"]["decomposition_gap"] = {
            "flops": _gap(total.flops, whole.flops),
            "bytes": _gap(total.bytes_hbm, whole.bytes_hbm),
            "wire_bytes": _gap(total.wire_bytes(), whole.wire_bytes())}
    return rec


def _gap(parts: float, whole: float) -> float:
    return (parts - whole) / whole if whole else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun.jsonl")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already recorded in --out")
    args = ap.parse_args()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              bool(r.get("probes"))))

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = "multi" if multi else "single"
                if (arch, shape, tag, args.probes) in done:
                    print(f"[dryrun] skip (done) {arch} x {shape} x {tag}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {tag} ...", flush=True)
                try:
                    rec = compile_cell(arch, shape, multi,
                                       run_probes=args.probes)
                except Exception as e:  # noqa: BLE001 — record and go on
                    rec = {"arch": arch, "shape": shape, "mesh": tag,
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                status = rec.get("status")
                extra = (f"count={rec.get('compile_s')}s peak="
                         f"{rec.get('peak_device_bytes', 0) / 1e9:.2f}GB/chip"
                         f" fits={rec.get('fits')}"
                         if status == "ok"
                         else rec.get("reason", rec.get("error", "")))
                print(f"[dryrun]   -> {status} {extra}", flush=True)


if __name__ == "__main__":
    main()
