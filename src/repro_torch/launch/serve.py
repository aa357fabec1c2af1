"""Serving launcher of the port: one colocated FLOWSERVE TE on one device.

    # full-width qwen3-8b, random bf16 weights, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 8 --max-new 32

    # the slot family: rwkv6-1.6b or recurrentgemma-2b at full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b

    # the cross-attention towers (slot family), with the engine's default
    # zero modality inputs: seamless-m4t-large-v2, llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b

    # the other paged archs: granite-moe-3b-a800m, gemma2-9b,
    # h2o-danube-3-4b, nemotron-4-15b; mixtral-8x7b (93 GB of bf16
    # weights) fits one 80 GB card only with its depth cut
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --layers 16

    # a smoke config on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu --requests 4 --max-new 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.kernels import ops
from repro_torch.models import transformer as T


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_configs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config instead of full width")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.monotonic()
    params = T.init_params(cfg, gen, dtype, dev)
    ecfg = EngineConfig(n_pages=2048 if not args.smoke else 256,
                        page_size=16, n_slots=8, max_len=2048,
                        max_batch_tokens=512, chunk_size=256,
                        max_decode_batch=8, decode_horizon=8, dtype=dtype,
                        seed=args.seed)
    te = FlowServe(cfg, params, ecfg, device=dev)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{dtype}, on {dev} (init {time.monotonic() - t0:.2f} s)")

    rng = np.random.RandomState(args.seed)
    sp = SamplingParams(temperature=0.0, max_new_tokens=args.max_new,
                        stop_on_eos=False)
    for i in range(args.requests):
        n = int(rng.randint(16, 257))
        te.add_request(Request(
            prompt_tokens=[int(t) for t in rng.randint(3, cfg.vocab_size, n)],
            sampling=sp, req_id=f"r{i}"))
    ops.reset_launches()
    t0 = time.monotonic()
    comps = te.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    for c in sorted(comps, key=lambda c: c.req_id):
        print(f"{c.req_id}: prompt {c.n_prompt} -> {len(c.tokens)} tokens, "
              f"ttft {c.ttft * 1e3:.1f} ms, tpot {c.tpot * 1e3:.2f} ms")
    print(f"{len(comps)} requests, {n_tok} tokens in {wall:.2f} s; "
          f"steps {te.steps}, prefill passes {te.prefill_dispatches}, "
          f"decode iterations {te.decode_steps}; kernel launches "
          f"{ops.launch_counts()}")


if __name__ == "__main__":
    main()
