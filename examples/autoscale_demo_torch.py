"""Fast-scaling demo on the PyTorch port (§6; the twin of
``examples/autoscale_demo.py``): the AUTOSCALER reacts to a load spike
using pre-warmed pods/TEs + DRAM preload + NPU-fork, then scales back
down. The cost models are the port's copies of the reference's; the last
step forks a real weights tree on the device through the same
``ModelLoader.npu_fork`` entry point (its live path).

    PYTHONPATH=src python examples/autoscale_demo_torch.py
    PYTHONPATH=src python examples/autoscale_demo_torch.py --smoke \\
        --device cpu
(the live fork copies full-width qwen3-8b bf16 weights on the card by
default; ``--smoke`` takes the reduced config.)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import (AutoscalerConfig, ClusterManager,  # noqa: E402
                              DRAMPageCache, FastScaler, ModelAsset,
                              ModelLoader, TaskExecutor)
from repro_torch.engine.distflow import DistFlow  # noqa: E402
from repro_torch.launch.mesh import make_engine_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help="the model whose weights the live fork copies")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config instead of full width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = resolve_device(args.device)

    asset = ModelAsset("llama3-8b", n_bytes=16e9, tp=1)
    dram = DRAMPageCache()
    scaler = FastScaler(dram, n_prewarm_pods=16, n_prewarm_tes=16)
    print(f"[autoscale] predictive preload of {asset.name} into DRAM page "
          f"cache: {dram.preload(asset)}")
    cm = ClusterManager(scaler, asset,
                        AutoscalerConfig(cooldown_s=0.0, max_tes=64))
    cm.register_te(TaskExecutor("te-0", "colocated"))

    # load spike: 0.3 -> 0.95 -> 0.98 -> cool-down
    t = 0.0
    for load in (0.3, 0.95, 0.98, 0.97, 0.4, 0.1, 0.1):
        t += 10.0
        delta = cm.autoscale(load=load, slo_violations=0.0, now=t)
        print(f"[autoscale] t={t:5.0f}s load={load:.2f} -> delta={delta:+d} "
              f"TEs={len(cm.tes)}")
    for ev in scaler.events:
        steps = " ".join(f"{k}={v:.2f}s" for k, v in ev.steps.items())
        print(f"  scale event {ev.te_id}: total={ev.total:.2f}s via "
              f"{ev.path} ({steps})")

    # NPU-fork burst: clone weights from a running TE to 32 new TEs
    loader = ModelLoader(dram)
    src = DistFlow("running-te")
    targets = [DistFlow(f"new-te-{i}") for i in range(32)]
    src.link_cluster(targets)
    r = loader.npu_fork(asset, src, targets, link="ici")
    print(f"[autoscale] NPU-fork x32 over ICI: {r.seconds:.2f}s "
          f"({r.bytes_moved / 1e9:.0f} GB total)")
    r2 = loader.local_load(asset)
    print(f"[autoscale] vs DRAM-hit local load: {r2.seconds:.2f}s — "
          f"fork is {'faster' if r.seconds < r2.seconds else 'slower'} and "
          f"scales to N targets in one broadcast")

    # the live fork: a real weights tree copied into new storage on the
    # device, priced on the source's DistFlow as the simulation prices it
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype, dev)
    live_src = DistFlow("running-te-live")
    live_dst = DistFlow("new-te-live")
    live_src.link_cluster([live_dst])
    t0 = time.monotonic()
    lr = loader.npu_fork(ModelAsset(cfg.name, n_bytes=0, tp=1), live_src,
                         [live_dst], payload=[params], cfg=cfg,
                         dst_mesh=make_engine_mesh(1, 0, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    print(f"[autoscale] live NPU-fork of {cfg.name} on {dev}: "
          f"{lr.bytes_moved / 1e9:.3f} GB copied in {wall * 1e3:.1f} ms wall "
          f"(DistFlow prices {lr.seconds * 1e3:.2f} ms over ICI)")


if __name__ == "__main__":
    main()
