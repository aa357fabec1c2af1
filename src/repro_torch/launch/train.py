"""Training launcher of the port (fine-tune jobs, the TRAINING job kind):
AdamW over packed synthetic batches, with sharded checkpoints and resume.

    # full width on the card (bf16 weights, fp32 moments); a full-width
    # qwen3-8b does not fit one 80 GB card with its optimizer state, so
    # cut its depth
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --layers 8 --steps 10 --seq-len 256 --batch 8

    # a smoke config on the CPU (fp32), checkpointed, then resumed
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4 --ckpt-dir /tmp/ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 8 --ckpt-dir /tmp/ckpt --resume

Every step runs through ``training.train``'s train program: on the card
one CUDA graph per batch shape, captured at its first step and replayed
after (the launcher prints how many were built). The train step runs the
plain versions of the recurrences (the CUDA kernels have no backward), so
it launches no hand-written kernel."""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import list_configs
from repro_torch.data import DataConfig, PackedDataset
from repro_torch.models.model_factory import get_model
from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                  TrainConfig, train)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_configs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (fp32) instead of full "
                         "width (bf16)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    bundle = get_model(args.arch, smoke=args.smoke)
    if args.layers:
        bundle = get_model(dataclasses.replace(bundle.cfg,
                                               n_layers=args.layers))
    dtype = torch.float32 if args.smoke else torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = bundle.init_params(gen, dtype, dev)
    cfg = bundle.cfg
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e6:.1f}M params, {dtype}, on {dev}")
    ds = PackedDataset(DataConfig(seq_len=args.seq_len,
                                  batch_size=args.batch, n_docs=2048,
                                  seed=args.seed))
    tcfg = TrainConfig(
        steps=args.steps, log_every=10, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
        opt=OptimizerConfig(lr=args.lr,
                            warmup_steps=min(20, args.steps // 5),
                            total_steps=args.steps))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    _, stats = train(bundle, params, ds.batches(epochs=1000), tcfg,
                     ckpt=ckpt, resume=args.resume)
    print(f"done: loss {stats['loss_first']:.3f} -> {stats['loss_last']:.3f} "
          f"in {stats['wall']:.1f}s; train programs built: "
          f"{stats['programs']}")


if __name__ == "__main__":
    main()
