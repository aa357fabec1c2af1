"""Where the card's time goes in a serving window of the port.

    # full-width qwen3-8b (36 layers, random bf16 weights), one H100
    PYTHONPATH=src python -m repro_torch.launch.profile
    # the slot family: --arch rwkv6-1.6b or --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch rwkv6-1.6b
    # an MoE arch: its MoE layers' device time is a group of its own
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch granite-moe-3b-a800m
    # the cross-attention towers (zero modality inputs, as the launcher's);
    # seamless's encoder, run again at every prefill chunk, is a group
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch seamless-m4t-large-v2

One colocated TE serves a warm-up batch (untimed: it builds the kernels
and warms the allocator), then traffic of the same shape under
``torch.profiler`` with CUDA activity only, so every recorded event is a
kernel or a copy on the card, then the same traffic again (fresh prompts)
without the profiler. Prints one JSON line: for the traced window its
wall time, the device's busy time and kernel count by kernel group (the
paged decode is two kernels per call when it splits: the split kernel and
the merge), the idle share (an upper bound: the profiler's own host cost
sits inside the window) and the top kernels; for both windows the mean
TPOT, the median TTFT and the blocking fetches the engine counted
(``host_syncs``: a horizon's commit that found its token block not yet on
the host, or a slot step's token fetch); then the card's name and power
limit. Host-clock figures spread between processes: compare versions
inside one chip call, in turns.

For an MoE arch the traced window also records host activity, with every
``moe_apply`` call inside a ``moe dispatch`` range, and the kernels
launched inside those ranges (routing, gather, the experts' batched
products, scatter-add) are moved from their kernel groups to a group of
their own; for an enc-dec arch the same holds for every ``encode`` call
(an ``encoder`` range). The host tracing adds its own cost to that
window's wall time, so its idle share and TPOT read higher than the
untraced window's. The cross-attention towers' requests carry the
engine's default (zero) modality inputs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

MOE_RANGE = "moe dispatch"
ENCODER_RANGE = "encoder"


def _group(name: str) -> str:
    low = name.lower()
    # csrc/paged_attention.cu: the split kernel and the merge of its splits
    if "decode_split_kernel" in low or "combine_kernel" in low:
        return "paged_attention kernel"
    if "prefill_bf16_kernel" in low or "prefill_f32_kernel" in low:
        return "flash_prefill kernel"
    # csrc/wkv6.cu and csrc/rglru_scan.cu: both bodies of each
    if "wkv6_kernel" in low or "wkv6_chunk_kernel" in low:
        return "wkv6 kernel"
    if "rglru_kernel" in low or "rglru_stream_kernel" in low:
        return "rglru kernel"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                              "splitk", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other kernels"


def _submit(te, cfg, rng, tag, n, prompt_len, max_new):
    sp = SamplingParams(temperature=0.0, max_new_tokens=max_new,
                        stop_on_eos=False)
    for i in range(n):
        te.add_request(Request(
            prompt_tokens=[int(t) for t in rng.randint(3, cfg.vocab_size,
                                                       prompt_len)],
            sampling=sp, req_id=f"{tag}{i}"))


def _latency(comps, syncs) -> dict:
    ttft = sorted(c.ttft * 1e3 for c in comps)
    return dict(tpot_ms_mean=sum(c.tpot for c in comps) * 1e3 / len(comps),
                ttft_ms_p50=ttft[len(ttft) // 2], host_syncs=syncs)


def timed_window(te, cfg, requests=8, prompt_len=256, max_new=24,
                 seed=1) -> dict:
    """The same traffic as ``profile_window`` without the profiler: wall
    time, TPOT and TTFT on the host's clock."""
    _submit(te, cfg, np.random.RandomState(seed), "u", requests, prompt_len,
            max_new)
    torch.cuda.synchronize()
    syncs0 = te.host_syncs
    t0 = time.monotonic()
    comps = te.run_to_completion()
    torch.cuda.synchronize()
    out = dict(window_ms=(time.monotonic() - t0) * 1e3)
    out.update(_latency(comps, te.host_syncs - syncs0))
    return out


def _range_targets(cfg):
    """(module, function, range name) of the calls whose kernels form a
    group of their own for ``cfg``."""
    out = []
    if cfg.moe is not None:
        out.append((M, "moe_apply", MOE_RANGE))
    if cfg.encoder is not None:
        out.append((T, "encode", ENCODER_RANGE))
    return out


@contextlib.contextmanager
def _ranges(targets):
    """Every call of each target function inside its profiler range."""
    origs = [getattr(mod, fn) for mod, fn, _ in targets]

    def wrap(orig, name):
        def ranged(*a, **kw):
            with torch.profiler.record_function(name):
                return orig(*a, **kw)
        return ranged

    for (mod, fn, name), orig in zip(targets, origs):
        setattr(mod, fn, wrap(orig, name))
    try:
        yield
    finally:
        for (mod, fn, _), orig in zip(targets, origs):
            setattr(mod, fn, orig)


def _range_kernels(prof, name):
    """(kernel name, us) of every kernel launched inside a range called
    ``name``, from the host events' tree."""
    from torch.autograd import DeviceType
    out = []

    def walk(e, inside):
        inside = inside or e.name == name
        if inside:
            out.extend((k.name, k.duration) for k in e.kernels)
        for c in e.cpu_children:
            walk(c, inside)

    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, False)
    return out


def profile_window(te, cfg, requests=8, prompt_len=256, max_new=24,
                   seed=1) -> dict:
    """Serve ``requests`` greedy requests under the profiler on a warm TE
    and return the device split of that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(seed)
    _submit(te, cfg, rng, "t", requests, prompt_len, max_new)
    torch.cuda.synchronize()
    steps0, syncs0 = te.steps, te.host_syncs
    targets = _range_targets(cfg)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if targets
                                      else [])
    with _ranges(targets), profile(activities=acts) as prof:
        t0 = time.monotonic()
        comps = te.run_to_completion()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    groups, launches, top = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + us
        launches[g] = launches.get(g, 0) + e.count
        top.append((us, e.count, e.key[:70]))
    for _, _, rng in targets:
        # the ranged calls' kernels leave their name groups for their own
        for name, us in _range_kernels(prof, rng):
            g = _group(name)
            groups[g] -= us
            launches[g] -= 1
            groups[rng] = groups.get(rng, 0.0) + us
            launches[rng] = launches.get(rng, 0) + 1
    busy = sum(groups.values())
    if busy <= 0:
        raise RuntimeError("the profiler saw no CUDA kernel time")
    return dict(
        **_latency(comps, te.host_syncs - syncs0),
        window_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=max(0.0, 1.0 - busy / wall_us),
        steps=te.steps - steps0, groups_ms={k: v / 1e3 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        kernels_by_group=launches,
        top_kernels=[dict(ms=us / 1e3, count=n, name=nm)
                     for us, n, nm in sorted(top, reverse=True)[:8]])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = full)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    te = FlowServe(cfg, params, EngineConfig(
        n_pages=2048, page_size=16, n_slots=8, max_len=2048,
        max_batch_tokens=512, chunk_size=256,
        max_decode_batch=8, decode_horizon=8, dtype=torch.bfloat16,
        seed=args.seed), device=dev)
    _submit(te, cfg, np.random.RandomState(args.seed + 1000), "w",
            args.requests, args.prompt_len, args.max_new)
    te.run_to_completion()                          # warm-up, untimed
    # fresh prompts for each window: a repeated prompt would hit the paged
    # family's prefix cache and skip its prefill
    out = profile_window(te, cfg, args.requests, args.prompt_len,
                         args.max_new, seed=args.seed + 1)
    out["untraced"] = timed_window(te, cfg, args.requests, args.prompt_len,
                                   args.max_new, seed=args.seed + 2)
    out.update(arch=cfg.name, layers=cfg.n_layers, requests=args.requests,
               prompt_len=args.prompt_len, max_new=args.max_new,
               decode_programs=getattr(te, "jit_compiles", None),
               prefill_programs=getattr(te, "prefill_jit_compiles", None))
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
        .stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
