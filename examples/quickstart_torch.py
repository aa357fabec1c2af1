"""Quickstart on the PyTorch port — the end-to-end serving driver (the
twin of ``examples/quickstart.py``).

Boots one PD-colocated FLOWSERVE TE of the port, submits a batch of chat
requests, and prints completions, the prefix cache's counters and the
engine's stats. The weights are random, drawn from a seed: full width in
bf16 on the card, or the reduced smoke config (``--smoke``).

    PYTHONPATH=src python examples/quickstart_torch.py [--arch qwen3-8b]
    PYTHONPATH=src python examples/quickstart_torch.py --smoke --device cpu
(the default device is the card.)
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
from repro_torch.engine import (EngineConfig, FlowServe,  # noqa: E402
                                Request, SamplingParams)
from repro_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config instead of full width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    print(f"[quickstart] loading {cfg.name} ({cfg.n_layers} layers, "
          f"{dtype}, random weights) on {dev}")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype, dev)
    tok = ByteTokenizer(max(cfg.vocab_size, 259))
    eng = FlowServe(cfg, params, EngineConfig(
        mode="colocated", n_pages=256, page_size=8, n_slots=8, max_len=256,
        max_batch_tokens=64, chunk_size=16, max_decode_batch=8,
        dtype=dtype), device=dev)

    prompts = [
        "what is a serverless llm platform?",
        "explain prefill decode disaggregation",
        "how does a radix prefix cache work?",
        "what is a relational tensor cache?",
        "why pre-warm pods for fast scaling?",
        "what does npu-fork do?",
    ][: args.requests]
    sp = SamplingParams(temperature=0.8, top_p=0.95,
                        max_new_tokens=args.max_new, stop_on_eos=False)

    ops.reset_launches()
    t0 = time.monotonic()
    ids = {}
    for p in prompts:
        rid = eng.add_request(Request(prompt_tokens=tok.encode(p),
                                      sampling=sp))
        ids[rid] = p
    comps = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0

    total_tokens = sum(len(c.tokens) for c in comps)
    print(f"[quickstart] {len(comps)} completions, {total_tokens} tokens "
          f"in {wall:.2f}s ({total_tokens / wall:.1f} tok/s)")
    for c in comps:
        print(f"  - {ids[c.req_id][:36]!r:40s} ttft={c.ttft * 1e3:6.0f}ms "
              f"tpot={c.tpot * 1e3:6.1f}ms gen={tok.decode(c.tokens)[:32]!r}")
    print(f"[quickstart] prefix cache: {eng.prefix_cache_stats()}")
    print(f"[quickstart] engine steps: {eng.steps}, "
          f"scheduler critical-path: {eng.scheduler.sched_time * 1e3:.1f}ms "
          f"total; kernel launches {ops.launch_counts()}")
    assert len(comps) == len(prompts)


if __name__ == "__main__":
    main()
