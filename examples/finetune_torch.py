"""Fine-tune example on the PyTorch port — the FINE_TUNE request kind
(§3): preprocess -> train -> evaluate jobs on a ~100M-param dense model,
with checkpointing (the twin of ``examples/finetune.py``).

    PYTHONPATH=src python examples/finetune_torch.py --steps 200
    PYTHONPATH=src python examples/finetune_torch.py --small --steps 20 \\
        --device cpu
(--small trains a ~10M variant; the default device is the card.)
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import DataConfig, PackedDataset  # noqa: E402
from repro_torch.models.model_factory import get_model  # noqa: E402
from repro_torch.training import (CheckpointManager,  # noqa: E402
                                  OptimizerConfig, TrainConfig, train)


def model_100m(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(name="tiny-12m", family="dense", n_layers=4,
                           d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                           d_ff=1024, vocab_size=8192, tie_embeddings=True)
    return ModelConfig(name="dense-100m", family="dense", n_layers=12,
                       d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
                       d_ff=2560, vocab_size=32000, tie_embeddings=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = model_100m(args.small)
    print(f"[finetune] model {cfg.name}: {cfg.param_count() / 1e6:.1f}M "
          f"params, on {dev}")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0),
                                torch.float32, dev)

    # preprocess job: tokenize + pack the corpus
    ds = PackedDataset(DataConfig(seq_len=args.seq_len, batch_size=args.batch,
                                  n_docs=4096))
    print(f"[finetune] preprocess job: {len(ds.windows)} packed windows")

    ckdir = tempfile.mkdtemp(prefix="deepserve_ft_")
    ck = CheckpointManager(ckdir, keep=2)
    tcfg = TrainConfig(steps=args.steps, log_every=20,
                       ckpt_every=max(args.steps // 4, 10),
                       opt=OptimizerConfig(lr=6e-4, warmup_steps=20,
                                           total_steps=args.steps))
    params, stats = train(bundle, params, ds.batches(epochs=1000), tcfg,
                          ckpt=ck)
    print(f"[finetune] training job done: loss {stats['loss_first']:.3f} -> "
          f"{stats['loss_last']:.3f} in {stats['wall']:.1f}s; "
          f"checkpoints at {ckdir}: steps {ck.list_steps()}")

    # evaluation job: held-out perplexity (no autograd: the forward's
    # default route, the kernels on the card)
    ev = PackedDataset(DataConfig(seq_len=args.seq_len, batch_size=args.batch,
                                  n_docs=256, seed=99))
    tokens, targets, mask = (torch.from_numpy(a).to(dev)
                             for a in next(ev.batches()))
    with torch.no_grad():
        loss = float(bundle.loss_fn(params, tokens, targets, mask))
    print(f"[finetune] evaluation job: held-out loss {loss:.3f} "
          f"(ppl {torch.exp(torch.tensor(loss)).item():.1f})")


if __name__ == "__main__":
    main()
