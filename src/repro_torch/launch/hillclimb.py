"""Hillclimb driver: the reference's focus cells re-probed under the
optimisations the port expresses (the port of
``repro/launch/hillclimb.py``), each record tagged with its variant and
appended to artifacts/hillclimb.jsonl. Baselines: the dry run's records
with ``--probes`` (artifacts/dryrun_probes.jsonl).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only NAME ...]

The reference's variants with ``cp_attention``, ``moe_cshard`` and
``act: batch_all`` pin GSPMD activation layouts
(``repro/models/actsharding.py``); the port's explicit rank lists have no
body for them, so they are not listed here (ROADMAP.md)."""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch import dryrun as DR

# (variant name, arch, shape, opt_flags)
VARIANTS = [
    # mixtral decode_32k: windowed decode, then the ring buffer
    ("mixtral_decode_windowed", "mixtral-8x7b", "decode_32k",
     {"perf": {"windowed_decode": True}}),
    ("mixtral_long500k_windowed", "mixtral-8x7b", "long_500k",
     {"perf": {"windowed_decode": True}}),
    # rwkv6 train_4k: ZeRO-2 (weights and moments split over model alone)
    ("rwkv6_train_zero2", "rwkv6-1.6b", "train_4k", {"fsdp": False}),
    ("mixtral_decode_ring", "mixtral-8x7b", "decode_32k",
     {"perf": {"ring_buffer_decode": True}}),
    ("mixtral_long500k_ring", "mixtral-8x7b", "long_500k",
     {"perf": {"ring_buffer_decode": True}}),
    # banded sliding-window prefill
    ("danube_prefill_banded", "h2o-danube-3-4b", "prefill_32k",
     {"perf": {"banded_swa_prefill": True}}),
    ("mixtral_prefill_banded", "mixtral-8x7b", "prefill_32k",
     {"perf": {"banded_swa_prefill": True}}),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--out", default="artifacts/hillclimb.jsonl")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for name, arch, shape, flags in VARIANTS:
        if args.only and name not in args.only:
            continue
        print(f"[hillclimb] {name}: {arch} x {shape} flags={flags}",
              flush=True)
        try:
            rec = DR.compile_cell(arch, shape, multi_pod=False,
                                  run_probes=True, opt_flags=flags)
        except Exception as e:  # noqa: BLE001 — record and go on
            rec = {"status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-1500:]}
        rec["variant"] = name
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        rf = rec.get("roofline", {})
        print(f"[hillclimb]   -> {rec.get('status')} "
              f"dom={rf.get('dominant')} comp={rf.get('compute_s', 0):.3e} "
              f"mem={rf.get('memory_s', 0):.3e} "
              f"coll={rf.get('collective_s', 0):.3e}", flush=True)


if __name__ == "__main__":
    main()
