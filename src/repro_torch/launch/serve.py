"""Serving launcher of the port: FLOWSERVE TEs on one device, in one of
three modes, or a live fleet under the serving plane (``--topology``).

  * ``colocated`` — one TE runs prefill and decode.
  * ``pd``        — a prefill TE hands each prefilled request to a decode
                    TE over DistFlow (PD disaggregation, §4.5): the pump
                    steps the P-TE, migrates what it finished, steps the
                    D-TE.
  * ``scheduled`` — Algorithm 1 (§5) places each request on one of two
                    colocated TEs or a live PD pair, from the PD heatmap
                    of the full config on one H100's cost model and a
                    decode-length predictor trained on a synthetic trace;
                    every unit is then stepped by the same pump.

  * ``--topology pd=N,colo=N`` (or ``pd=NpXd`` for an M:N group) — the
                    serving plane (``core/serving_plane.py``): a JE over a
                    live fleet, Algorithm 1 (``--policy dist_sched``) or
                    round-robin placement, optionally a mass scale-out
                    through the cold-start ladder first (``--scale-to N``:
                    fork rounds, then the warm pool, then cold), and the
                    fleet's units stepped on executor threads
                    (``--fleet-threads N``, N > 1). Prints completions,
                    decisions, scale events, the fleet's metrics and the
                    scale-out plan's rounds and tiers.

Every TE of a run (the initial fleet's, under the plane) shares one
weights dict; a forked TE owns its copy.

    # full-width qwen3-8b, random bf16 weights, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 8 --max-new 32

    # PD-disaggregated, and Algorithm 1 over 2 colocated TEs + 1 PD pair
    PYTHONPATH=src python -m repro_torch.launch.serve --mode pd
    PYTHONPATH=src python -m repro_torch.launch.serve --mode scheduled

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

    # the serving plane: a PD pair and a colocated TE, scaled out to 3
    # serving units by fork first, stepped on 3 executor threads
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --topology pd=1,colo=1 --scale-to 3 --fleet-threads 3

    # tensor parallelism (the paged family): each TE over 2 ranks, which
    # share the one card here; alone or under the plane
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 \
        --topology pd=1,colo=1

    # the decode baselines: one step per iteration (--horizon 1), and the
    # unfused step whose logits the host samples (--no-fused-decode)
    PYTHONPATH=src python -m repro_torch.launch.serve --horizon 1 \
        --no-fused-decode

    # a smoke config on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu --requests 4 --max-new 8 --mode pd
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.core import (DecodeLengthPredictor, DistributedScheduler,
                              DRAMPageCache, DrainTrigger, FastScaler,
                              HeatmapStudy, LoadSpreadTrigger,
                              PredictorConfig, SchedRequest, ServingJobEngine,
                              TEHandle, TopologySpec, WarmPool, synth_trace,
                              train_predictor)
from repro_torch.engine import (Completion, EngineConfig, FlowServe, Request,
                                SamplingParams)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T


def engine_config(mode: str, dtype, smoke: bool = False, seed: int = 0,
                  tp: int = 1, horizon: int = 8,
                  fused: bool = True) -> EngineConfig:
    return EngineConfig(mode=mode, tp=tp,
                        n_pages=2048 if not smoke else 256,
                        page_size=16, n_slots=8, max_len=2048,
                        max_batch_tokens=512, chunk_size=256,
                        max_decode_batch=8, fused_decode=fused,
                        decode_horizon=horizon, dtype=dtype, seed=seed)


def build_te(cfg, params, mode: str, name: str, device, dtype,
             smoke: bool = False, seed: int = 0, tp: int = 1,
             horizon: int = 8, fused: bool = True) -> FlowServe:
    return FlowServe(cfg, params,
                     engine_config(mode, dtype, smoke, seed, tp, horizon,
                                   fused),
                     name=name, device=device)


def step_unit(handle: TEHandle) -> List[Completion]:
    """One step of a placement unit. A PD pair pumps its hand-off: its
    prefill members step, each finished prefill migrates to the
    least-loaded decode member, its decode members step. A colocated TE
    steps."""
    out: List[Completion] = []
    if handle.te_type != "pd_pair":
        if handle.engine.has_work():
            out.extend(handle.engine.step())
        return out
    for pe in handle.prefill_members():
        if pe.has_work():
            pe.step()
        for rid in pe.pop_migratable():
            pe.migrate_out(rid, handle.pick_decode_member())
    for de in handle.decode_members():
        if de.has_work():
            out.extend(de.step())
    return out


def run_units(handles: List[TEHandle], max_steps: int = 100000
              ) -> List[Completion]:
    """Step every unit in turn until no engine has work left."""
    out: List[Completion] = []
    for _ in range(max_steps):
        if not any(e.has_work() for h in handles
                   for e in (*h.prefill_members(), *h.decode_members())):
            return out
        for h in handles:
            out.extend(step_unit(h))
    raise RuntimeError(f"serving did not finish in {max_steps} steps")


def pd_pair(cfg, params, name: str, device, dtype, smoke: bool = False,
            seed: int = 0, tp: int = 1, horizon: int = 8,
            fused: bool = True) -> TEHandle:
    """A live PD pair: a P-TE and a D-TE linked by DistFlow."""
    pe = build_te(cfg, params, "prefill", f"{name}-p", device, dtype, smoke,
                  seed, tp, horizon, fused)
    de = build_te(cfg, params, "decode", f"{name}-d", device, dtype, smoke,
                  seed, tp, horizon, fused)
    pe.distflow.link_cluster([de.distflow])
    return TEHandle(name, "pd_pair", engine=pe, decode_engine=de)


def _print_meshes(engines: List[FlowServe]) -> None:
    """Each TE's mesh: its tp and every rank's device."""
    for e in engines:
        print(f"{e.name}: tp={e.mesh.tp}, ranks on "
              f"{[str(d) for d in e.mesh.devices]}")


def _report(comps: List[Completion], wall: float) -> None:
    n_tok = sum(len(c.tokens) for c in comps)
    for c in sorted(comps, key=lambda c: c.req_id):
        print(f"{c.req_id}: prompt {c.n_prompt} -> {len(c.tokens)} tokens, "
              f"ttft {c.ttft * 1e3:.1f} ms, tpot {c.tpot * 1e3:.2f} ms")
    print(f"{len(comps)} requests, {n_tok} tokens in {wall:.2f} s; kernel "
          f"launches {ops.launch_counts()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_configs())
    ap.add_argument("--mode", default="colocated",
                    choices=["colocated", "pd", "scheduled"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config instead of full width")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks per TE (tensor parallelism, the paged "
                         "family): rank r on card (r mod the visible "
                         "count), every rank on the one card here")
    ap.add_argument("--horizon", type=int, default=8,
                    help="max fused multi-step decode horizon K "
                         "(DESIGN.md §8; 1 disables multi-step)")
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="legacy v1 decode path (per-step host block tables "
                         "+ standalone sampler dispatch)")
    ap.add_argument("--topology", default=None,
                    help="serve through the serving plane over this fleet: "
                         "'pd=N,colo=N' (N PD pairs and N colocated TEs) or "
                         "'pd=NpXd,colo=N' (an M:N group); overrides --mode")
    ap.add_argument("--policy", default="dist_sched",
                    choices=["dist_sched", "round_robin"],
                    help="the plane's placement: Algorithm 1 or round-robin")
    ap.add_argument("--scale-to", type=int, default=0,
                    help="with --topology: scale out to N serving units "
                         "before serving (fork rounds, warm pool, cold)")
    ap.add_argument("--fleet-threads", type=int, default=0,
                    help="with --topology: step the fleet's units on this "
                         "many executor threads (> 1); 0 or 1 = serially")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = smoke_config(full) if args.smoke else full
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.monotonic()
    params = T.init_params(cfg, gen, dtype, dev)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{dtype}, on {dev}, mode {args.mode}, decode horizon "
          f"{args.horizon}, {'unfused' if args.no_fused_decode else 'fused'} "
          f"decode (init {time.monotonic() - t0:.2f} s)")

    def requests() -> List[Request]:
        """The run's requests, made (and so timed from) once every TE is
        up."""
        rng = np.random.RandomState(args.seed)
        sp = SamplingParams(temperature=0.0, max_new_tokens=args.max_new,
                            stop_on_eos=False)
        return [Request(prompt_tokens=[int(t) for t in rng.randint(
                    3, cfg.vocab_size, int(rng.randint(16, 257)))],
                        sampling=sp, req_id=f"r{i}")
                for i in range(args.requests)]

    fused = not args.no_fused_decode

    def te(mode, name):
        return build_te(cfg, params, mode, name, dev, dtype, args.smoke,
                        args.seed, args.tp, args.horizon, fused)

    if args.topology:
        serve_plane(args, cfg, full, params, dev, dtype, requests)
        return
    if args.mode == "colocated":
        handles = [TEHandle("te-0", "colocated", engine=te("colocated",
                                                            "te-0"))]
        for r in requests():
            handles[0].engine.add_request(r)
    elif args.mode == "pd":
        handles = [pd_pair(cfg, params, "te-pd0", dev, dtype, args.smoke,
                           args.seed, args.tp, args.horizon, fused)]
        for r in requests():
            handles[0].engine.add_request(r)
    else:
        # the heatmap of the full config on one H100's cost model, the
        # predictor trained on a synthetic trace (both on the host)
        hs = HeatmapStudy(full)
        pcfg = PredictorConfig()
        xs, ys, _ = synth_trace(2000, pcfg)
        pparams, acc = train_predictor(pcfg, xs, ys)
        handles = [TEHandle("te-c0", "colocated",
                            engine=te("colocated", "te-c0")),
                   TEHandle("te-c1", "colocated",
                            engine=te("colocated", "te-c1")),
                   pd_pair(cfg, params, "te-pd0", dev, dtype, args.smoke,
                           args.seed, args.tp, args.horizon, fused)]
        ds = DistributedScheduler(handles, hs.combined(), hs.prefill_lens,
                                  hs.decode_ratios,
                                  predictor=DecodeLengthPredictor(pcfg,
                                                                  pparams))
        for r in requests():
            sreq = SchedRequest(tokens=r.prompt_tokens)
            h = ds.dist_sched(sreq)
            ds.commit(sreq, h)
            h.engine.add_request(r)
            print(f"{r.req_id} ({len(r.prompt_tokens)} tokens) -> {h.te_id}")
        print(f"predictor held-out accuracy {acc:.3f}; "
              f"decisions {ds.decisions}")

    _print_meshes([e for h in handles
                   for e in (*h.prefill_members(), *h.decode_members())])
    ops.reset_launches()
    t0 = time.monotonic()
    comps = run_units(handles)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _report(comps, time.monotonic() - t0)
    for h in handles:
        if h.te_type == "pd_pair":
            df = h.engine.distflow
            print(f"{h.te_id}: {len(df.log)} migrations, KV moved "
                  f"{df.bytes_moved() / 1e6:.2f} MB, DistFlow simulated "
                  f"{df.sim_clock * 1e3:.3f} ms")


def serve_plane(args, cfg, full, params, dev, dtype, requests) -> None:
    """The serving plane over ``--topology``: a JE with a warm pool, the
    scale-out and drain triggers and the heatmap of the full config on
    one H100's cost model; optionally ``scale_to`` first; then every
    request through ``submit`` and ``run_to_completion``."""
    topo = TopologySpec.parse(args.topology)
    if args.tp > 1:
        # the reference launcher's check (repro/launch/serve.py:95-99)
        if topo.tp > 1 and topo.tp != args.tp:
            raise SystemExit(f"conflicting tp: --tp {args.tp} vs "
                             f"--topology ...,tp={topo.tp}")
        topo.tp = args.tp
    hs = HeatmapStudy(full)
    warm = WarmPool()
    je = ServingJobEngine(
        cfg, params, topo,
        heatmap=hs.combined(), prefill_lens=hs.prefill_lens,
        decode_ratios=hs.decode_ratios, policy=args.policy,
        ecfg=engine_config("colocated", dtype, args.smoke, args.seed,
                           horizon=args.horizon,
                           fused=not args.no_fused_decode),
        scaler=FastScaler(DRAMPageCache(), warm=warm),
        trigger=LoadSpreadTrigger(), drain_trigger=DrainTrigger(),
        warm_pool=warm, fleet_threads=args.fleet_threads, device=dev)
    try:
        if args.scale_to > je.n_serving():
            plan = je.scale_to(args.scale_to)
            print(f"scale_to({args.scale_to}): {len(plan['rounds'])} rounds "
                  f"in {plan['wall_s']:.2f} s, tiers {plan['tiers']}, "
                  f"serving {plan['n_serving']}")
            for r in plan["rounds"]:
                print(f"  round {r['round']}: {r['tes']} from "
                      f"{r['sources'] or ['-']} ({r['wall_s']:.3f} s)")
        _print_meshes(je.engines)
        ops.reset_launches()
        t0 = time.monotonic()
        for r in requests():
            je.submit(r.prompt_tokens, sampling=r.sampling)
        comps = je.run_to_completion()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _report(comps, time.monotonic() - t0)
        print(f"serving plane [{args.policy}] {args.topology}, "
              f"fleet_threads={args.fleet_threads}: decisions "
              f"{je.scheduler.decisions}")
        for e in je.scale_events:
            print(f"  scale event: {e['kind']} {e['te_id']} at step "
                  f"{e['step']}" + (f" from {e['source']}"
                                    if e.get("source") else ""))
        for te_id, m in je.fleet_metrics().items():
            print(f"  {te_id}: {m}")
        for eng in je.engines:
            print(f"  {eng.name} launches {eng.kernel_launches}")
    finally:
        je.close()


if __name__ == "__main__":
    main()
