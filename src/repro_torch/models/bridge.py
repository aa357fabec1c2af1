"""Weight bridge: the JAX package's ``init_params`` pytree, handed over as
nested dicts of numpy arrays, becomes the port's parameter dict — the way
both sides run identical weights with nothing downloaded. The layouts
already agree (stacked ``blocks``, ``enc_blocks`` and ``cross_blocks``,
per-kind lists of the hybrid tower, ``x @ w`` weights), so the bridge
only converts leaves."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

# leaves that stay fp32 whatever the weight dtype (the reference keeps its
# norm scales, the MoE router, the recurrences' lerp/decay/bonus/gate
# constants and the VLM cross blocks' gates in fp32)
_FP32_KEYS = ("ln", "ln1", "ln2", "ln1_post", "ln2_post", "final_norm",
              "enc_final_norm", "q_norm", "k_norm", "router", "mix_base",
              "decay_base", "bonus_u", "ln_x", "cm_mix", "lambda_p",
              "gate_attn", "gate_mlp")


def _leaf(a, device, dtype: Optional[torch.dtype], keep_fp32: bool):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":           # ml_dtypes: no torch bridge
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))    # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(torch.float32 if keep_fp32 else dtype)
    return t.to(device)


def params_from_numpy(cfg: ModelConfig, tree: Any, device="cuda",
                      dtype: Optional[torch.dtype] = None):
    """Convert a nested dict of numpy arrays (the JAX pytree after
    ``np.asarray`` on every leaf) to torch tensors on ``device``. With
    ``dtype`` set, weight matrices are cast to it and norm scales kept
    fp32; without it every leaf keeps its dtype."""
    dev = resolve_device(device)
    towers = {"rwkv": ("blocks",),
              "hybrid_rglru": ("rglru_blocks", "attn_blocks")}
    need = list(towers.get(cfg.attn_kind, ("blocks",)))
    if cfg.vision is not None or cfg.encoder is not None:
        need.append("cross_blocks")
    if cfg.encoder is not None:
        need += ["enc_blocks", "enc_final_norm"]
    # a tree must carry exactly the towers its config names: a tower the
    # config lacks would be dropped without a word
    carried = {"cross_blocks", "enc_blocks", "enc_final_norm"} & set(tree)
    if cfg.attn_kind not in ("global", "swa", "local_global", *towers) \
            or any(k not in tree for k in need) \
            or not carried <= set(need):
        raise NotImplementedError(
            f"bridge covers the towers a config names (dense, MoE, rwkv, "
            f"hybrid_rglru, enc-dec, VLM); the tree does not match "
            f"{cfg.name!r}")

    def conv(t, keep_fp32=False):
        if isinstance(t, dict):
            return {k: conv(v, keep_fp32 or k in _FP32_KEYS)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, keep_fp32) for v in t]
        return _leaf(t, dev, dtype, keep_fp32)

    return conv(tree)


def predictor_params_from_numpy(tree) -> dict:
    """The JAX decode-length predictor's weights (a dict of numpy arrays)
    as the port's predictor parameters: fp32 host tensors, the predictor
    running on the host."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}
