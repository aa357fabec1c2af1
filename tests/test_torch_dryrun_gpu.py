"""The dry run's probes on the card (``launch/probes.py``): one probe per
block kind that launches a kernel, at a small cell (smoke widths on a
(2, 2) mesh; 2,304 prefill tokens, so attention takes the dense
``flash_prefill`` entry past the 2,048-key switch), timed with CUDA events;
each kernel call's output held against the plain version's (impl "ref")
at chip_smoke.py's main-path tolerances (attention 4e-3 plus one bf16
step of the plain output, WKV6 in bf16 2e-2 + 1e-2 |plain|, RG-LRU in
fp32 2e-4). Every test is marked ``gpu`` and skips without a CUDA card.
This file imports no JAX:
    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dryrun_gpu.py
"""
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import probes as PR
from repro_torch.launch.mesh import ProductionMesh
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

CASES = [("qwen3-8b", "block_attn_global", "flash_prefill"),
         ("rwkv6-1.6b", "block_rwkv", "wkv6"),
         ("recurrentgemma-2b", "block_rglru", "rglru")]
TOLS = {"self_attention": (4e-3, 2.0 ** -7), "wkv6": (2e-2, 1e-2),
        "rglru": (2e-4, 0.0)}


def _kernel_outputs(run, inputs, mp):
    """The output of each kernel entry ``run`` calls (self-attention, WKV6,
    RG-LRU), in call order."""
    got = []
    for mod, name in ((T, "self_attention"), (ops, "wkv6"),
                      (ops, "rglru")):
        def rec(*a, _orig=getattr(mod, name), _name=name, **kw):
            out = _orig(*a, **kw)
            got.append((_name, (out[0] if isinstance(out, tuple)
                                else out).clone()))
            return out
        mp.setattr(mod, name, rec)
    run(**inputs)
    mp.undo()
    return got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,name,kernel", CASES)
def test_probe_on_the_card_matches_its_plain_version(cuda, arch, name,
                                                     kernel):
    cell = PR.Cell(smoke_config(get_config(arch)),
                   ShapeConfig("p", "prefill", 2304, 2),
                   ProductionMesh((2, 2), ("data", "model")))
    probe = next(p for p in PR.build_probes(cell) if p.name == name)
    assert probe.kernel == kernel
    run, inputs, _ = probe.build(cuda, 3, "auto")
    ops.reset_launches()
    with torch.no_grad():
        got = _kernel_outputs(run, inputs, pytest.MonkeyPatch())
        assert ops.launch_counts()[kernel] > 0
        prun, pin, _ = probe.build(cuda, 3, "ref")
        want = _kernel_outputs(prun, pin, pytest.MonkeyPatch())
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(**inputs)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    assert got and [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        atol, rtol = TOLS[name]
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs()
        assert (err <= atol + rtol * w.float().abs()).all(), \
            (name, float(err.max()))
    assert sorted(times)[2] > 0
