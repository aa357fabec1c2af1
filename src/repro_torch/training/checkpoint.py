"""Sharded checkpoint save / restore with async writes (fault tolerance),
in the reference's on-disk format (``repro/training/checkpoint.py``), so a
checkpoint written by either package restores in the other:

    <dir>/step_<N>/
        manifest.json   — {"step", "treedef", "leaves": [{"path", "key",
                          "shard", "shape", "dtype"}]}
        shard_<i>.npz   — the leaves, assigned round-robin in JAX's leaf
                          order (``training/tree.py``)

``path`` is the leaf's ``jax.tree_util.keystr`` path, ``key`` is
``leaf_<i>``; bf16 leaves are stored losslessly as fp32 with ``"dtype":
"bfloat16"`` (npz has no bf16). ``treedef`` is the port's own text of the
structure; a restore reads only the leaves by path. A step's directory
is written as ``.tmp_step_<N>`` and renamed when complete, so a crash
mid-write leaves the last complete step to resume from. ``save`` copies
every leaf to host memory before it returns, so the caller may go on
changing its tensors while a background thread writes them."""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.training import tree as TR


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, bf16 widened to fp32 (lossless); a
    copy even for a CPU tensor, which the caller may change in place."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


class CheckpointManager:
    def __init__(self, directory: str, n_shards: int = 4, keep: int = 3):
        self.dir = directory
        self.n_shards = n_shards
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True) -> None:
        self.wait()
        # snapshot to host memory synchronously, write on a thread
        named = [(k, _dtype_name(v), _host(v))
                 for k, v in TR.flatten_with_paths(tree)]
        treedef = _structure(tree)

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            shards: List[Dict[str, np.ndarray]] = [
                dict() for _ in range(self.n_shards)]
            manifest = {"step": step, "treedef": treedef, "leaves": []}
            for i, (k, dtype, arr) in enumerate(named):
                si = i % self.n_shards
                key = f"leaf_{i}"
                shards[si][key] = arr
                manifest["leaves"].append(
                    {"path": k, "key": key, "shard": si,
                     "shape": list(arr.shape), "dtype": dtype})
            for si, sh in enumerate(shards):
                np.savez(os.path.join(tmp, f"shard_{si}.npz"), **sh)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic completeness marker
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- load
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None, device=None):
        """Restore into the structure and dtypes of ``like_tree`` (the
        latest step when ``step`` is None), each leaf on ``device`` or, if
        that is None, on its ``like_tree`` leaf's device."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dev = None if device is None else resolve_device(device)
        shard_files = {}
        leaves_np = {}
        try:
            for meta in manifest["leaves"]:
                si = meta["shard"]
                if si not in shard_files:
                    shard_files[si] = np.load(
                        os.path.join(d, f"shard_{si}.npz"))
                leaves_np[meta["path"]] = shard_files[si][meta["key"]]
        finally:
            for npz in shard_files.values():
                npz.close()
        restored = []
        for k, ref in TR.flatten_with_paths(like_tree):
            arr = leaves_np[k]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{k}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            restored.append(torch.from_numpy(arr).to(
                dev if dev is not None else ref.device, ref.dtype))
        return TR.unflatten(like_tree, restored)
