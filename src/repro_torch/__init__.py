"""PyTorch + CUDA port of the DeepServe reproduction (FLOWSERVE on one GPU).

The JAX package ``repro`` beside this one is the reference; this package
imports ``torch`` and nothing of ``repro`` or ``jax``. Its first slice is the
colocated paged main path: ``engine.FlowServe`` serving a paged-family model
(qwen3-8b) through two hand-written Hopper kernels in ``csrc/``.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry point's
    default) raises when no card is visible — the port never carries on
    silently on the CPU; the CPU is used only when the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain reference path")
    return dev
