"""Counting a program on the meta device: the port's counterpart of
reading XLA's estimates off a compiled artifact (``compiled.cost_analysis``
and ``memory_analysis``, ``repro/launch/roofline.py:70-78``,
``dryrun.py:51-60``).

A meta tensor has shapes, dtypes and strides and no values, so the port's
own step runs on it at full size with no memory and no device. Under
``MetaCount`` (a dispatch mode) every aten operation is counted as it
runs:

  * ``flops``: the products' operations (``torch.utils.flop_counter``'s
    formulas: 2·M·N·K a matmul) by the units that run them (bf16 / fp16
    inputs on the tensor cores, fp32 ones on the CUDA cores), plus each
    kernel's operations from ``kernels/work.py`` (the kernels' meta route
    records them); elementwise work is priced by its bytes alone;
  * ``bytes``: every distinct tensor an operation touches, once (each
    input read, each output written; a broadcast dim counts once), plus
    each kernel's bytes from its formula. A view costs nothing, nor does
    a 0-d operand (a scalar);
  * live bytes: each storage an operation allocates is live until its
    last reference dies (a finalizer on the storage), so views, autograd's
    saved tensors and the caller's references keep it; ``peak`` is the
    most live at once, over what existed before the count.

What the mode cannot see: the allocator's rounding and fragmentation,
and work done by a kernel beyond its formula (a kernel's scratch)."""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work as W

_ALLOC_ONLY = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.new_empty_strided.default}
_ALIASES = {torch.ops.aten._unsafe_view.default}
_TENSOR_CORE = {torch.bfloat16, torch.float16}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: its element size times the sizes of the dims
    it does not broadcast (stride 0); a 0-d operand (a scalar the units
    read once) none."""
    if t.dim() == 0:
        return 0
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


class MetaCount(TorchDispatchMode):
    """Counts what runs inside ``with MetaCount() as c:`` (module
    docstring). ``flops`` {unit: operations}, ``matmul_flops``,
    ``bytes``, ``live`` / ``peak`` (bytes allocated inside the block,
    now and at most), ``kernels`` {name: {"calls", "flops", "bytes"}}."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._storages: Dict[int, int] = {}
        self._sink = None

    # ------------------------------------------------------------- counting
    def _kernel(self, name: str, work: W.Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.issued
        k["bytes"] += work.nbytes
        self.flops[work.unit] += work.issued
        self.bytes += work.nbytes

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def __enter__(self):
        self._sink = W.recording(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            unit = "bf16" if ins and ins[0].dtype in _TENSOR_CORE else "fp32"
            self.flops[unit] += f
            self.matmul_flops += f
        if getattr(func, "is_view", False) or func in _ALIASES:
            return out
        if func not in _ALLOC_ONLY:
            seen = {}
            for t in ins + outs:
                seen.setdefault(id(t), t)
            self.bytes += sum(tensor_bytes(t) for t in seen.values())
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in in_keys:
                self._track(t)
        return out

    def summary(self) -> dict:
        return {"flops": dict(self.flops), "matmul_flops": self.matmul_flops,
                "bytes": self.bytes, "peak_bytes": self.peak,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}
