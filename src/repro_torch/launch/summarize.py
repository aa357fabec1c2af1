"""Tables of the dry run and the roofline from artifacts/*.jsonl, printed
(the port of ``repro/launch/summarize.py`` and of
``finalize_experiments.py``'s ``hillclimb_rows`` / ``fmt_variant``; the
reference writes them into EXPERIMENTS.md, which this repository does
not have).

    PYTHONPATH=src python -m repro_torch.launch.summarize"""
from __future__ import annotations

import json
import os
from collections import OrderedDict

from repro_torch.core import perf_model as PM

ART_DIR = "artifacts"
HBM_BUDGET = PM.HBM_BYTES       # one H100 SXM
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter")


def load(path):
    cells = OrderedDict()
    if not os.path.exists(path):
        return cells
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            cells[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return cells             # the last record of a cell wins


def _by_kind(coll) -> str:
    tot = {k: 0.0 for k in COLLECTIVES}
    for key, v in coll.items():
        kind = key.split("@")[0]
        tot[kind] = tot.get(kind, 0.0) + v
    return "/".join(f"{tot[k] / 1e6:.0f}" for k in COLLECTIVES)


def dryrun_table(path=os.path.join(ART_DIR, "dryrun.jsonl")) -> str:
    out = ["| arch | shape | mesh | status | count s | peak GB/device | "
           f"fits {HBM_BUDGET / 1e9:.0f} GB | dominant | step s | useful "
           "ratio | collectives MB (ag/ar/rs) |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in load(path).items():
        if r["status"] == "skipped":
            out.append(f"| {arch} | {shape} | {mesh} | skipped: "
                       f"{r['reason'][:40]} | | | | | | | |")
            continue
        if r["status"] == "error":
            out.append(f"| {arch} | {shape} | {mesh} | ERROR "
                       f"{r['error'][:40]} | | | | | | | |")
            continue
        rf = r["roofline"]
        fits = "yes" if r["peak_device_bytes"] <= HBM_BUDGET else "NO"
        coll = _by_kind(r["full_artifact"]["collectives"])
        out.append(f"| {arch} | {shape} | {mesh} | ok | {r['compile_s']} | "
                   f"{r['peak_device_bytes'] / 1e9:.2f} | {fits} | "
                   f"{rf['dominant']} | {rf['step_s']:.3e} | "
                   f"{rf['useful_ratio']:.3f} | {coll} |")
    return "\n".join(out)


def roofline_table(path=os.path.join(ART_DIR, "dryrun_probes.jsonl")) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL_FLOPS | useful ratio | roofline frac | move-the-needle |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in load(path).items():
        if r.get("status") != "ok" or "roofline" not in r or mesh != "single":
            continue
        rf = r["roofline"]
        step = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        ideal = rf["model_flops"] / (r["n_chips"] * PM.PEAK_FLOPS)
        frac = ideal / step if step else 0.0
        hint = {
            "compute": "cut non-useful FLOPs (remat/attention masking)",
            "memory": "shrink bytes touched (dtype, fusion, cache layout)",
            "collective": "re-shard to cut wire bytes / overlap collectives",
        }[rf["dominant"]]
        out.append(f"| {arch} | {shape} | {rf['compute_s']:.2e} | "
                   f"{rf['memory_s']:.2e} | {rf['collective_s']:.2e} | "
                   f"{rf['dominant']} | {rf['model_flops']:.2e} | "
                   f"{rf['useful_ratio']:.2f} | {frac:.3f} | {hint} |")
    return "\n".join(out)


def hillclimb_rows(path=os.path.join(ART_DIR, "hillclimb.jsonl")) -> dict:
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") == "ok" and "roofline" in r:
                out[r["variant"]] = r
    return out


def fmt_variant(r, base) -> str:
    rf, bf = r["roofline"], base["roofline"]
    step_b = max(bf["compute_s"], bf["memory_s"], bf["collective_s"])
    step_o = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    ideal = rf["model_flops"] / (r["n_chips"] * PM.PEAK_FLOPS)
    return (f"compute {bf['compute_s']:.2e}→{rf['compute_s']:.2e}, "
            f"memory {bf['memory_s']:.2e}→{rf['memory_s']:.2e}, "
            f"collective {bf['collective_s']:.2e}→{rf['collective_s']:.2e}; "
            f"step {step_b:.2e}→{step_o:.2e} s (×{step_b / step_o:.2f}); "
            f"roofline frac {ideal / step_b:.4f}→{ideal / step_o:.4f}")


def main() -> None:
    print("## Dry run\n")
    print(dryrun_table())
    print("\n## Roofline\n")
    print(roofline_table())
    base = load(os.path.join(ART_DIR, "dryrun_probes.jsonl"))
    hc = hillclimb_rows()
    if hc:
        from repro_torch.launch.hillclimb import VARIANTS
        print("\n## Hillclimb\n")
        for name, arch, shape, _ in VARIANTS:
            b = base.get((arch, shape, "single"))
            if name not in hc or b is None or "roofline" not in b:
                print(f"* `{name}`: (not recorded)")
                continue
            print(f"* **{name}** — {fmt_variant(hc[name], b)}")


if __name__ == "__main__":
    main()
