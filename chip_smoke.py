#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port builds, is right and serves.

    python3 chip_smoke.py               # needs one CUDA card; a few minutes
    python3 chip_smoke.py --only pd     # phases 1 and 5 alone
    python3 chip_smoke.py --only fleet  # phases 1 and 6 alone
    python3 chip_smoke.py --only tp     # phases 1 and 7 alone
    python3 chip_smoke.py --only train  # phases 1 and 8 alone
    python3 chip_smoke.py --only long   # phases 1 and 9 alone
    python3 chip_smoke.py --only switches  # phases 1 and 10 alone
    python3 chip_smoke.py --only programs  # phases 1 and 11 alone
    python3 chip_smoke.py --only prefill-programs  # phases 1 and 12 alone

Phases, in order; any failure raises and the script exits non-zero:
  1. build    — nvcc compiles every kernel in src/repro_torch/csrc/ (one
                process per source, in parallel) for sm_90a.
  2. kernels  — each kernel against its plain PyTorch version on the card:
                the tests/test_kernels.py sweep shapes (plus the decode
                shapes of the other paged archs: G 2-6, hd 120 and 256,
                softcap 50 with a window; one long split decode sequence;
                the tensor-core prefill at G = 3, 6, 8, hd 120 and 256),
                the engine's paged varlen prefill form, WKV6 and RG-LRU
                with a state carried in and out (WKV6 also with decays at
                the -30 log-decay clamp and with T no multiple of its
                16-token chunk), and the main-path shapes at full width
                (qwen3-8b attention in bf16, rwkv6-1.6b WKV6 in bf16,
                recurrentgemma-2b RG-LRU in fp32, prefill and decode), with
                kernel / plain / library times (scaled_dot_product_attention
                on a gathered dense copy for attention; no single PyTorch
                call computes either recurrence), eager and
                CUDA-graph-replayed (device time), each recurrence's other
                body at the same shape in the same run, the card's least
                time for the same work, the decode split count and its
                effect, and the ptxas lines of the main-path attention
                kernels. Then both attention kernels at the attention
                shape of each other paged arch (granite-moe-3b-a800m,
                gemma2-9b, h2o-danube-3-4b, nemotron-4-15b, mixtral-8x7b),
                timed the same way; the windowed archs' rows run past
                their 4096-token window, so it masks keys.
  3. serving  — full-width TEs (random bf16 weights from a seed) serve
                through the entry points a user calls: qwen3-8b (36
                layers) 8 greedy + 2 sampled requests, then rwkv6-1.6b (24
                layers), recurrentgemma-2b (26 layers), granite-moe-3b-
                a800m (32), gemma2-9b (42), h2o-danube-3-4b (24),
                nemotron-4-15b (32) and mixtral-8x7b (16 of its 32 layers:
                all 32 do not fit the card) 6 + 2 each, then the
                cross-attention towers at full depth on the slot path,
                6 + 2 each, every request with seeded random modality
                inputs: llama-3.2-vision-11b (40 layers, 8 gated cross
                blocks; patch embeddings (1, 1601, 4096)) and
                seamless-m4t-large-v2 (24 encoder + 24 decoder layers;
                frames (1, 4096, 1024), encoded again at every prefill
                chunk, as the reference does). Every request must
                complete with valid ids, and each path must have launched
                its kernels (counts reset just before it): one launch of
                each attention kernel per layer per decode iteration /
                prefill pass, 24 WKV6 and 18 RG-LRU launches per decode
                step / prefill dispatch; the cross towers' path has no
                hand-written kernel (the reference's runs no Pallas
                kernel there) and must launch none.
  4. parity   — at full width cut to a few layers in fp32 (qwen3 2,
                rwkv6 2, recurrentgemma 3 = 2 RG-LRU + 1 attention, each
                other paged arch 2; gemma2's are one local and one global
                layer), the TE on the kernels and the TE on the plain
                versions give identical greedy tokens. The cross towers
                (llama-3.2-vision 5 layers = one cross block, seamless 2
                decoder + 2 encoder layers; non-zero gates, seeded
                modality inputs) are held instead against the greedy
                oracle of the port's teacher-forced ``forward``.
  5. PD       — PD disaggregation through the entry points
                (``FlowServe`` in modes prefill / decode, ``migrate_out``):
                a prefill TE and a decode TE on one weights dict serve
                qwen3-8b at full width (8 greedy + 2 sampled) and
                rwkv6-1.6b (6 + 2), every request completing with valid
                ids. Launch counts are zeroed before each pair runs and
                read around each TE's own step: the qwen3 P-TE launches
                only flash_prefill (36 per pass), its D-TE only
                paged_attention (36 per iteration), a migration nothing;
                both rwkv6 TEs launch only WKV6 (24 per dispatch / step).
                One exported page run equals the D-TE's pool run bit for
                bit after the import lands, and one migration's device
                time is taken by CUDA events. Then Algorithm 1 (the
                launcher's entry points) places 8 qwen3 requests over two
                colocated TEs and a live PD pair on the card, every one
                completing; and at 2 fp32 layers the PD pair gives the
                colocated TE's greedy tokens (both on the kernels; the
                smallest top-2 logit gap is printed).
  6. fleet    — the fleet control plane through ``ServingJobEngine``
                (each fleet sized from ``mem_get_info`` first): qwen3-8b
                ``pd=1,colo=1`` (full width, bf16, one weights tree)
                serves the phase-3 requests under Algorithm 1 and
                round-robin, each TE launching only its kernels (read on
                its own stepping thread; the P-TE's migrations counted),
                then three executor threads
                against serial stepping in turns, two runs a side; the
                cold-start ladder: ``scale_to(3)`` by two forks (device
                time by CUDA events, weights bit-equal in new storage),
                both forks drained and released (the first into the
                warm pool: pin, D2H), ``scale_to(3)`` again by a fork and
                a warm upload, a warm upload alone (H2D), a cold start
                from zero; a seeded kill of one of three TEs (12
                requests, FaultPlan seed 7 at step 3: all complete once,
                the victim's pool returned within 64 MiB, repaired by
                ``scale_to(3)``) and a drain under load (decodes migrate,
                queued prefills restart, the pool returned); the
                rwkv6-1.6b fork tree 1 -> 8 in rounds of 1, 2 and 4, a
                request served on each TE; then at 2 fp32 layers the
                threaded plane gives the serial plane's tokens and
                decisions, the killed and drained runs the undisturbed
                runs' tokens up to near-ties (a top-2 gap below 1e-4,
                both runs greedy against the teacher-forced forward, at
                most one near-tie taken in a run). Every plane checks
                that no unit failed (the plane quarantines a unit that
                raises, so only its scale events would show it) but the
                planned victim, and that its TEs are the ones expected.
  7. tp       — tensor parallelism of the paged family (every rank on
                the one card): both attention kernels at one rank's
                shape (qwen3-8b at tp 2: H 16 / Hkv 4; granite-moe-3b-
                a800m at tp 4: H 6 / Hkv 2), timed as phase 2 times them;
                both archs serving the phase-3 requests at full width
                (each decode iteration and prefill pass launching each
                kernel n_layers x tp times; TTFT, TPOT, launches per step
                and each rank's pool bytes printed); at 2 fp32 layers the
                tp-2 TE on the kernels gives its plain versions' tokens
                exactly, and the tp-2 and tp-16 TEs (tp 16: Hkv 8 does not
                split, so attention and the pool replicate) give the tp-1
                TE's up to near-ties, the largest logit difference
                printed; a qwen3-8b P-TE at tp 4 hands off to a D-TE at
                tp 2 at full width (the KV heads re-split in flight; the
                migrated run bit-identical, one migration's device time)
                and, at 2 fp32 layers, gives a colocated tp-2 TE's tokens
                up to near-ties; a fork of a tp-2 TE onto a new tp-2 TE
                (every shard bit-equal in new storage, its device time by
                CUDA events); the serving plane at pd=1,colo=1,tp=2, sized
                from ``mem_get_info`` (a depth cut, if any, printed),
                every request served. Then the slot family: both
                recurrences at one tp-2 rank's shape (rwkv6-1.6b WKV6 at
                16 of 32 heads, recurrentgemma-2b RG-LRU at 1280 of 2560
                channels), timed and held as phase 2 holds them; both
                archs serving the phase-3 requests at tp 2 at full width
                (each decode step and prefill dispatch launching the
                recurrence n_layers x tp times: 24 x 2 WKV6, 18 x 2
                RG-LRU; each rank's cache bytes printed); both cross
                towers at tp 2, full width and depth; at 2 (rwkv6) and 3
                (recurrentgemma) fp32 layers the tp-2 TE on the kernels
                gives its plain versions' tokens exactly and the tp-1
                TE's up to near-ties; an rwkv6-1.6b P-TE at tp 2 hands
                off to a D-TE at tp 1 at full width (the slot snapshot
                resharded at import, the migrated state bit-identical,
                one migration's device time); a fork of a tp-2 rwkv6 TE
                onto a new tp-2 TE.
  8. train    — fine-tune jobs. Each launcher, called on CUDA inputs that
                require grad, raises before it launches (its count
                unmoved); ``forward(impl="auto")`` under autograd raises on
                rwkv6 and recurrentgemma, and ``impl="ref"`` gives finite
                gradients. Then ``train()`` (the entry point of
                ``launch/train.py``) at full width in bf16 with remat, on
                packed batches of 8 x 256 at lr 1e-3: qwen3-8b cut to 8 of
                its 36 layers (12 bytes a param: bf16 weights and grads,
                fp32 moments) for 10 steps, its loss falling;
                rwkv6-1.6b and recurrentgemma-2b at every layer for 3
                steps; every loss and grad norm finite, every leaf moved,
                no kernel launched (the recurrences' plain versions, by
                name), step ms (CUDA events, median), tokens/s, the
                6·N·tokens share of 989 TFLOP/s and peak GiB printed. The
                smoke fp32 loss-and-grad on the card against the CPU's
                (qwen3, rwkv6, recurrentgemma); resume equivalence on the
                card (danube smoke, 8 steps against 4 + checkpoint +
                resume 4, params within 1e-5); an async checkpoint of an
                rwkv6 train state at full width, cut to 1 layer (~3.9 GB
                on disk), restored onto the card bit for bit, with its
                write and read GB/s.
  9. long     — the reference's long-context shapes (``SHAPES``) through
                ``launch/steps.py`` at full width: (a) the from-scratch
                prefill at 8192 tokens on the kernel (one dense
                ``flash_prefill`` launch per layer) against the plain
                blockwise function, qwen3-8b, h2o-danube-3-4b (window
                4096) and gemma2-9b (softcap; one local, one global
                layer) cut to 2 fp32 layers: logits and K/V within 1e-4
                + 1e-5 |plain|, the greedy token equal; then the dense
                entry's bf16 body against the plain blockwise function
                at qwen3's and danube's 32k layers (whole) and at
                recurrentgemma's 524,288-token layer (row blocks);
                (b) prefill_32k,
                qwen3-8b (36 layers) and h2o-danube-3-4b (24) in bf16 at
                B 1 of 32: wall and device time, launches (one
                flash_prefill per attention layer, nothing else), peak
                memory, the cache's bytes; (c) decode_32k, qwen3-8b at B
                8 of 128 (each row holding (b)'s K/V): 16 greedy steps'
                device ms over the dense cache (no kernel), and at 2 fp32
                layers the tokens after the kernel prefill equal to those
                after the plain one; (d) long_500k: rwkv6-1.6b and
                recurrentgemma-2b prefill 524,288 tokens from scratch
                (WKV6 / RG-LRU, and recurrentgemma's local attention
                through flash_prefill at window 2048), then 16 greedy
                decode steps, recurrentgemma's on a ring cache of 2304
                slots (the last positions at slot t mod 2304) with the
                tokens of a linear cache with room (up to a bf16 tie);
                mixtral and gemma2 not run, each with its bytes;
                (e) train_4k, qwen3-8b at 8 layers, 2 x 4096 tokens in 2
                microbatches, remat, through the plain blockwise flash and
                through the naive form: step ms and peak memory, no
                launch; (f) the long path on a TE of tp 2 (both ranks on
                the card) at full width cut to 2 fp32 layers
                (recurrentgemma 3: 2 RG-LRU + 1 attention): qwen3-8b's
                single-shot prefill of 8192 tokens into 8208 positions,
                danube's linear cache with the windowed decode off and on
                and its ring, gemma2's local/global cache with the
                softcap, recurrentgemma's ring with replicated attention;
                each the prefill then 16 greedy steps at tp 2 and at tp
                1: logits within 1e-4 + 1e-5 |tp 1|, greedy tokens equal,
                the joined rank caches within the same, flash_prefill
                launched once per attention layer per rank of the heads;
                then the dense entry in bf16 at one rank's heads (H / 2,
                Hkv / 2) of qwen3, danube and gemma2 over 8192 tokens
                against the plain blockwise function, with kernel /
                plain / SDPA ms and the bound; (g) qwen3-8b's prefill
                builder on a tp-2 mesh (2 fp32 layers, 32,768 tokens),
                its rank caches joined against the tp-1 builder's, each
                placed by decode_cache and decoded 16 greedy steps; (h)
                danube's long_500k at full depth (24 layers, bf16, B 1):
                the builder places each layer's K/V into a 4352-slot ring
                as it makes them (bit for bit the stacked builder cache
                placed by decode_cache, checked at 32,768 tokens), then
                524,288 tokens (24 flash_prefill launches, peak GiB, the
                ring's bytes against 48.3 GB stacked) and 16 greedy steps
                on the ring. Phase 9 runs in a process of its own whose
                allocator maps expandable segments (``phase9_process``)
                and prints its seconds.
 10. switches — the reference engine's switches through the entry points,
                at full width and depth, each against the engine's
                defaults: qwen3-8b on 8 greedy requests of 64-1024 random
                ids, 32 new tokens, with batched_prefill=False (the
                per-sequence prefill: 36 flash_prefill launches per
                sequence chunk, no first-token fetch), async_sched=False,
                enable_prefix_cache=False, fused_decode=False (36
                paged_attention launches per decode step, the host
                sampling each) and decode_horizon=1; rwkv6-1.6b and
                recurrentgemma-2b on 6 requests of 64-512 ids, each
                prefilled in one chunk of the first step, with
                fused_decode=False and the raw-length prefill
                (bucket_prefill=False: T no power of two, nor for WKV6 a
                multiple of its 16-token chunk). In bf16, after a warm-up
                run: every kernel of the path launched once per layer per
                pass, TTFT p50 and TPOT printed, the requests whose tokens
                equal the default's counted; the switches that keep the
                default's arithmetic (sync scheduling, no prefix cache,
                horizon 1, the slot family's unfused step) give its tokens
                exactly. The others change batch shapes, which bf16 rounds
                differently: in fp32 they give the default's greedy tokens
                up to near-ties, the default's the teacher-forced
                forward's. Then the RTC on qwen3-8b: a 1024-token prompt,
                the same again, one sharing its first 768 tokens, and a
                1032-token prompt twice (its repeat recomputes exactly the
                cold run's last pass): hits and tokens reused counted,
                TTFTs printed, the 1032-token hit's tokens and first logits
                the cold run's bit for bit in both dtypes, in fp32 the
                1024-token hit's tokens the cold run's. In bf16 the paged
                varlen entry is held against its plain version at every
                (start, length) the per-sequence run gave it (one entry,
                the stream unpadded), and the rounding is measured: the
                last prompt position's logits of the per-sequence and the
                batched prefill, and of the 1024-token hit and its cold
                run, against the fp32 forward of the same bf16 weights,
                each pair within twice the default path's own error.
 11. programs — the decode hot loop's device programs (each paged K-step
                horizon and each slot decode step one CUDA graph, captured
                at its key's first use and replayed after) against the
                eager horizon, at full width in bf16: qwen3-8b (36
                layers), granite-moe-3b-a800m (MoE), rwkv6-1.6b and
                recurrentgemma-2b, each served twice in one process on
                phase 3's request set and engine config, once through the
                eager horizon and once through the programs, each way in
                two passes (the requests, then the same lengths with every
                id shifted by one: the same buckets, no prefix hit). The
                greedy tokens equal bit for bit, the sampled ids valid,
                the launches per decode iteration equal (and one per
                layer), no program built in the second pass, and a steady
                replay of one program under sync-debug "error"; TPOT,
                decode tok/s, the programs' capture ms and the graph
                pool's GiB printed. Phases 3-10 run their decode through
                the programs too. ``--only programs`` then builds qwen3-8b's
                whole warmup grid (144 programs: seconds, capture ms, the
                pool's GiB) and serves inside it, building none.
 12. prefill-programs — the prefill programs (each ragged pass keyed (Tb,
                Pb, Sb, all-greedy), each slot chunk keyed by its length
                bucket with n_valid a device operand and the slot's rows
                staged through a batch-1 cache) against the eager
                prefill, at full width in bf16: phase 11's four models and
                seamless-m4t-large-v2 (seeded frames), each served with
                the eager prefill and the decode programs and with both
                kinds of program, two passes each as in phase 11. The
                greedy tokens equal bit for bit, the sampled ids valid,
                the launches per prefill dispatch and per decode
                iteration equal, no program of either kind built in the
                second pass, and steady replays of one prefill program
                under sync-debug "error"; TTFT p50 / max, TPOT, the
                engine's prefill call ms, prefill_jit_compiles, capture ms
                and the pool's GiB printed. In the whole run phases 11 and
                12 share each model's run through both kinds of program.
                Phases 3-11 prefill through the programs too (the MoE
                census of phase 3 counts through the eager forms), and
                phase 10's per-sequence, unfused and raw-length switches
                are also served through their eager forms and held to the
                same bf16 tokens and launches. ``--only prefill-programs``
                then builds qwen3-8b's whole prefill warmup grid (99
                programs: seconds, capture ms, the pool's GiB, the memory
                added) and serves inside it, building none.
The last lines are the prefill program rows ({"prefill_programs":
[...]}), the program rows ({"programs": [...]}), the switch
rows ({"switches": {...}}), the
long-context rows ({"long": {...}}), the training
rows ({"train": {...}}), the per-rank
kernel rows ({"tp_kernels": [...]}),
the other paged archs' attention rows as JSON ({"arch_kernels": [...]}),
the kernel table as JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

T0 = time.monotonic()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor peak


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times, so the host's cost per call (the
    launcher's checks and ctypes call, tens of µs) is not on the clock.
    Launches made during capture are not counted as main-path launches:
    every path's counts are zeroed just before it runs."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * iters)


def err(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def check(name, e, tol):
    ok = e <= tol
    log(f"  {name}: max_abs_err {e:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {e} > {tol}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def _tol(dtype):
    import torch
    return 2e-2 if dtype == torch.bfloat16 else 2e-4


# The main-path checks at full width: |out| is about 0.03-0.04 there (some
# 550 effective keys of N(0,1) values) and the bf16 rounding of such an
# output is below 1e-3, so a dropped page or a length off by one (about
# 2e-2 at the maximum) fails here, where the sweeps' 2e-2 would let it by.
MAIN_PATH_TOL = 4e-3
# The other paged archs' rows (arch_rows) are held to MAIN_PATH_TOL plus
# one bf16 step of the plain output (2^-7 |plain|): their packs hold rows
# over a few keys (an entry from position 0), whose outputs reach |out| >=
# 1, and there the kernel's and the plain version's fp32 sums, both right,
# may round one bf16 step apart (7.8e-3 at [1, 2)); a dropped page or a
# length off by one still moves many small outputs past MAIN_PATH_TOL.
ARCH_ROW_RTOL = 2.0 ** -7


def check_main_path(tag, got, want, arch_row) -> float:
    """The main-path check of a row: MAIN_PATH_TOL (qwen3-8b's rows), or
    with one bf16 step of the plain output on top (the other archs')."""
    if not arch_row:
        e = err(got, want)
        check(tag, e, MAIN_PATH_TOL)
        return e
    e = close(tag, got, want, MAIN_PATH_TOL, ARCH_ROW_RTOL)
    d = (got.float() - want.float()).abs().flatten()
    i = int(d.argmax())
    log(f"  {tag}: largest error at |plain| = "
        f"{float(want.flatten()[i].float().abs()):.4f}")
    return e


def rel(x, y) -> float:
    """max |x - y| / max |y|: the error against the output's own scale."""
    return err(x, y) / max(float(y.float().abs().max()), 1e-30)


def ptxas_lines(stem: str, *needles: str):
    """The ``-Xptxas -v`` lines (registers / shared memory, spills) of the
    kernels in csrc/<stem>.cu whose mangled names contain every needle."""
    from repro_torch.kernels import _build
    out, name = [], None
    for line in _build.ptxas_report.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            continue
        if name and all(n in name for n in needles) and (
                "registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


# decode shapes the other paged archs bring (tests/test_torch_kernels_gpu.py
# PAGED_SHAPES): G 2 at hd 256 (gemma2), G 3 at hd 64 (granite), G 4 at
# hd 120 (danube), G 6 at hd 128 (nemotron), and G 3 at hd 120 / G 6 at
# hd 256 (each body, each head-dim padding)
NEW_DECODE_SHAPES = [(2, 16, 8, 256, 16, 5), (3, 24, 8, 64, 16, 4),
                     (2, 32, 8, 120, 16, 5), (2, 48, 8, 128, 16, 6),
                     (2, 6, 2, 120, 16, 5), (2, 12, 2, 256, 16, 4)]


def sweep_paged_attention(gen, dev):
    import torch
    from repro_torch.kernels import ops
    for (b, h, hkv, hd, page, npages) in [(1, 4, 4, 16, 8, 3),
                                          (2, 8, 4, 32, 16, 5),
                                          (3, 8, 1, 64, 16, 4),
                                          *NEW_DECODE_SHAPES]:
        for dtype in (torch.float32, torch.bfloat16):
            for softcap, window in [(None, None), (30.0, None), (None, 20),
                                    (50.0, 40)]:
                pool = npages * b + 2
                q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
                kp = torch.randn((pool, page, hkv, hd), generator=gen,
                                 device=dev).to(dtype)
                vp = torch.randn((pool, page, hkv, hd), generator=gen,
                                 device=dev).to(dtype)
                bt = torch.randperm(pool, generator=gen, device=dev)[
                    :b * npages].view(b, npages).int()
                ln = torch.randint(1, npages * page, (b,), generator=gen,
                                   device=dev).int()
                o_k = ops.paged_attention(q, kp, vp, bt, ln, softcap, window)
                o_r = ops.paged_attention(q, kp, vp, bt, ln, softcap, window,
                                          impl="ref")
                torch.cuda.synchronize()
                check(f"paged_attention b{b} h{h}/{hkv} hd{hd} P{page} "
                      f"{str(dtype)[6:]} cap={softcap} win={window}",
                      err(o_k, o_r), _tol(dtype))
    # one long sequence (B 1): the planner splits it over many blocks
    from repro_torch.kernels import paged_attention as PA
    b, h, hkv, hd, page, npages = 1, 32, 8, 128, 16, 512
    for dtype in (torch.float32, torch.bfloat16):
        for softcap, window in [(None, None), (30.0, 1000)]:
            q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
            kp = torch.randn((npages + 1, page, hkv, hd), generator=gen,
                             device=dev).to(dtype)
            vp = torch.randn_like(kp)
            bt = torch.randperm(npages + 1, generator=gen, device=dev)[
                :npages].view(1, npages).int()
            ln = torch.tensor([8000], dtype=torch.int32, device=dev)
            o_k = ops.paged_attention(q, kp, vp, bt, ln, softcap, window)
            o_r = ops.paged_attention(q, kp, vp, bt, ln, softcap, window,
                                      impl="ref")
            torch.cuda.synchronize()
            s = PA.n_splits(b, hkv, npages, PA.sm_count(dev))
            check(f"paged_attention b1 len8000 h{h}/{hkv} hd{hd} P{page} "
                  f"S={s} {str(dtype)[6:]} cap={softcap} win={window}",
                  err(o_k, o_r), _tol(dtype))


def sweep_flash_prefill(gen, dev):
    import torch
    from repro_torch.kernels import ops
    for (b, s, h, hkv, hd) in [(1, 128, 4, 4, 16), (2, 256, 8, 2, 32),
                               (1, 64, 2, 1, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            for softcap, window in [(None, None), (50.0, 48)]:
                q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
                k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
                v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
                o_k = ops.flash_prefill(q, k, v, softcap, window)
                o_r = ops.flash_prefill(q, k, v, softcap, window, impl="ref")
                torch.cuda.synchronize()
                check(f"flash_prefill dense b{b} s{s} h{h}/{hkv} hd{hd} "
                      f"{str(dtype)[6:]} cap={softcap} win={window}",
                      err(o_k, o_r), _tol(dtype))


def ragged_pack(gen, dev, dtype, lens, starts, tb, p, hkv, hd, h, n_pool):
    """A packed ragged prefill batch as the engine builds it: entries with
    chunk lengths ``lens`` starting at positions ``starts`` (earlier
    positions are cached), a padded flat query stream of ``tb`` tokens,
    entry block tables over a shuffled pool. ``gen`` is a CPU generator."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_prefill as FP
    sb = len(lens)
    pb = max(-(-(s + n) // p) for s, n in zip(starts, lens))
    perm = torch.randperm(n_pool, generator=gen).numpy().astype(np.int32)
    ebt = perm[:sb * pb].reshape(sb, pb)
    cu = [0]
    for n in lens:
        cu.append(cu[-1] + n)
    kp = torch.randn((n_pool, p, hkv, hd), generator=gen).to(dev, dtype)
    vp = torch.randn((n_pool, p, hkv, hd), generator=gen).to(dev, dtype)
    q = torch.randn((tb, h, hd), generator=gen).to(dev, dtype)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    meta = (i32(cu), i32(ebt), i32(starts), i32(FP.build_tiles(cu, tb)))
    return q, kp, vp, meta, cu


def sweep_paged_prefill(dev):
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for softcap, window in [(None, None), (30.0, None), (None, 20)]:
            q, kp, vp, meta, _ = ragged_pack(
                gen, dev, dtype, lens=[9, 1, 33, 16], starts=[0, 40, 7, 16],
                tb=64, p=8, hkv=2, hd=32, h=8, n_pool=40)
            o_k = ops.paged_prefill(q, kp, vp, *meta, softcap, window)
            o_r = ops.paged_prefill(q, kp, vp, *meta, softcap, window,
                                    impl="ref")
            torch.cuda.synchronize()
            check(f"flash_prefill paged varlen {str(dtype)[6:]} "
                  f"cap={softcap} win={window}", err(o_k, o_r), _tol(dtype))
    # the tensor-core body at G = 8, at hd 256 (two column halves), at
    # G = 3 and 6 (a head chunk with padding heads) and at hd 120 (padded
    # to 128: the last KV head's second box reaches past the row)
    for h, hkv, hd in [(16, 2, 128), (8, 4, 256), (16, 2, 256),
                       (24, 8, 64), (48, 8, 128), (6, 2, 120), (32, 8, 120),
                       (12, 2, 256)]:
        for softcap, window in [(None, None), (30.0, 40)]:
            q, kp, vp, meta, _ = ragged_pack(
                gen, dev, torch.bfloat16, lens=[9, 1, 37, 16],
                starts=[0, 40, 7, 21], tb=64, p=16, hkv=hkv, hd=hd, h=h,
                n_pool=24)
            o_k = ops.paged_prefill(q, kp, vp, *meta, softcap, window)
            o_r = ops.paged_prefill(q, kp, vp, *meta, softcap, window,
                                    impl="ref")
            torch.cuda.synchronize()
            check(f"flash_prefill paged varlen h{h}/{hkv} hd{hd} bfloat16 "
                  f"cap={softcap} win={window}", err(o_k, o_r), _tol(torch.bfloat16))


def main_path_decode(cfg, dev, window=None, softcap=None, lens=(1024, 2048),
                     seed=2, arch_row=False):
    """Decode attention at full width of ``cfg``: Bb=8, lengths drawn from
    ``lens`` (the first at its maximum), with the layer's window and
    softcap. The qwen3-8b row (not ``arch_row``) adds the split-count
    sweep."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, h, hkv, hd, p = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    maxp = lens[1] // p
    n_pool = b * maxp + 1
    dt = torch.bfloat16
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dt)
    kp = torch.randn((n_pool, p, hkv, hd), generator=gen, device=dev).to(dt)
    vp = torch.randn((n_pool, p, hkv, hd), generator=gen, device=dev).to(dt)
    bt = torch.randperm(n_pool, generator=gen, device=dev)[:b * maxp] \
        .view(b, maxp).int()
    ln = torch.randint(lens[0], lens[1] + 1, (b,), generator=gen,
                       device=dev).int()
    ln[0] = lens[1]

    def kernel():
        return ops.paged_attention(q, kp, vp, bt, ln, softcap, window)

    o_k = kernel()
    o_r = ops.paged_attention(q, kp, vp, bt, ln, softcap, window, impl="ref")
    torch.cuda.synchronize()
    tag = (f"paged_attention main path {cfg.name} B{b} H{h}/{hkv} hd{hd} "
           f"P{p} len {lens[0]}..{lens[1]} cap={softcap} win={window} bf16")
    e = check_main_path(tag, o_k, o_r, arch_row)
    log(f"  {tag}: max_abs_err / max|plain| {rel(o_k, o_r):.3e}")
    lengths = ln.tolist()
    # the library yardstick: SDPA on a gathered dense copy (set-up untimed;
    # it has no softcap, so with one it is a yardstick, not the same
    # function)
    lmax = max(lengths)
    kd = kp[bt.long()].reshape(b, maxp * p, hkv, hd)[:, :lmax]
    vd = vp[bt.long()].reshape(b, maxp * p, hkv, hd)[:, :lmax]
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(h // hkv, 1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(h // hkv, 1).contiguous()
    key = torch.arange(lmax, device=dev)[None]
    mask = key < ln[:, None]
    if window:
        mask &= key >= ln[:, None] - window
    mask = mask[:, None, None]
    qd = q[:, :, None]

    from repro_torch.kernels import paged_attention as PA
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, ln, softcap,
                                                   window, impl="ref"))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    kernel_graph = graph_ms(kernel)
    library_graph = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    n_keys = sum(min(n, window or n) for n in lengths)   # keys read
    nbytes = 2 * (2 * b * h * hd) + 2 * 2 * n_keys * hkv * hd \
        + 4 * (b * maxp + b)
    flops = 4 * h * hd * n_keys
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    splits = PA.n_splits(b, hkv, maxp, PA.sm_count(dev))
    log(f"  {tag}: splits S={splits} (grid {b}x{hkv}x"
        f"{splits} = {b * hkv * splits} blocks on {PA.sm_count(dev)} SMs); "
        f"kernel_ms {kernel_ms:.4f} eager / {kernel_graph:.4f} graph-replayed;"
        f" plain_ms {plain_ms:.4f}; library_ms {library_ms:.4f} eager / "
        f"{library_graph:.4f} graph-replayed; bound_ms {bound:.4f} ({by}: "
        f"{nbytes} B, {flops} flop); bound / graph time "
        f"{bound / kernel_graph:.3f}")
    extra = {}
    if softcap:
        # what the softcap costs at this shape
        extra["graph_ms_without_softcap"] = graph_ms(
            lambda: ops.paged_attention(q, kp, vp, bt, ln, None, window))
        log(f"  {tag}: without the softcap "
            f"{extra['graph_ms_without_softcap']:.4f} graph-replayed")
    gb = 4 if h // hkv <= 4 else 8
    hdp = next(x for x in (16, 32, 64, 128, 256) if hd <= x)
    if not arch_row:
        # the split count's effect at this shape (not a choice made at run
        # time: n_splits depends on shapes only)
        sweep = {sp: graph_ms(lambda: PA.paged_attention(
            q, kp, vp, bt, ln, softcap, window, splits=sp))
            for sp in sorted({1, 2, 4, splits, 8, 16, 32})}
        log("  paged_attention main path, graph-replayed ms by split count: "
            + ", ".join(f"S={sp} {t:.4f}" for sp, t in sweep.items()))
    for line in ptxas_lines("paged_attention", "bfloat16",
                            f"Li{hdp}ELi{gb}E"):
        log(f"  ptxas {cfg.name}: {line}")
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:87",
                max_abs_err=e, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                graph_ms=kernel_graph, library_graph_ms=library_graph,
                splits=splits, **extra,
                shape=f"B={b} H={h} Hkv={hkv} hd={hd} P={p} "
                      f"len {min(lengths)}..{max(lengths)} softcap={softcap} "
                      f"window={window} bf16")


def main_path_prefill(cfg, dev, window=None, softcap=None,
                      lens=(256, 128, 96, 32), starts=(768, 0, 256, 992),
                      seed=3, arch_row=False):
    """Ragged paged prefill at full width of ``cfg``: Tb=512 over 4 entries
    (chunks ``lens`` after cached prefixes ``starts``) with the layer's
    window and softcap."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    h, hkv, hd, p = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    lens, starts = list(lens), list(starts)
    tb = 512
    sb = len(lens)
    pb = max(-(-(s + n) // p) for s, n in zip(starts, lens))
    q, kp, vp, meta, cu = ragged_pack(gen, dev, torch.bfloat16, lens, starts,
                                      tb, p, hkv, hd, h,
                                      n_pool=max(512, sb * pb))

    def kernel():
        return ops.paged_prefill(q, kp, vp, *meta, softcap, window)

    o_k = kernel()
    o_r = ops.paged_prefill(q, kp, vp, *meta, softcap, window, impl="ref")
    torch.cuda.synchronize()
    tag = (f"flash_prefill main path {cfg.name} Tb{tb} entries {lens} from "
           f"{starts} H{h}/{hkv} hd{hd} P{p} cap={softcap} win={window} bf16")
    e = check_main_path(tag, o_k, o_r, arch_row)
    log(f"  {tag}: max_abs_err / max|plain| {rel(o_k, o_r):.3e}")
    # library yardstick: one SDPA over the entries padded to dense (no
    # softcap, as for decode)
    smax, kmax = max(lens), max(s + n for s, n in zip(starts, lens))
    cu_t, ebt = meta[0], meta[1]
    qd = torch.zeros((sb, h, smax, hd), dtype=q.dtype, device=dev)
    kd = torch.zeros((sb, h, kmax, hd), dtype=q.dtype, device=dev)
    vd = torch.zeros_like(kd)
    mask = torch.zeros((sb, 1, smax, kmax), dtype=torch.bool, device=dev)
    for i, (s, n) in enumerate(zip(starts, lens)):
        qd[i, :, :n] = q[cu[i]:cu[i] + n].transpose(0, 1)
        nk = s + n
        run = ebt[i, :-(-nk // p)].long()
        kr = kp[run].reshape(-1, hkv, hd)[:nk].transpose(0, 1)
        vr = vp[run].reshape(-1, hkv, hd)[:nk].transpose(0, 1)
        kd[i, :, :nk] = kr.repeat_interleave(h // hkv, 0)
        vd[i, :, :nk] = vr.repeat_interleave(h // hkv, 0)
        qpos = s + torch.arange(n, device=dev)
        key = torch.arange(nk, device=dev)[None]
        m = key <= qpos[:, None]
        if window:
            m &= key > qpos[:, None] - window
        mask[i, 0, :n, :nk] = m
        mask[i, 0, n:, 0] = True        # padding rows: any one key
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ops.paged_prefill(q, kp, vp, *meta, softcap,
                                                 window, impl="ref"), iters=5)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    kernel_graph = graph_ms(kernel)
    library_graph = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    win = window or 2 ** 62
    pairs = sum(sum(min(s + j + 1, win) for j in range(n))
                for s, n in zip(starts, lens))
    keys_read = sum(s + n - max(0, s - win + 1) for s, n in zip(starts, lens))
    n_tok = sum(lens)
    nbytes = 2 * (2 * n_tok * h * hd) + 2 * 2 * keys_read * hkv * hd \
        + 4 * (ebt.numel() + 3 * sb + 1)
    flops = 4 * h * hd * pairs
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    log(f"  {tag}: kernel_ms {kernel_ms:.4f} eager / "
        f"{kernel_graph:.4f} graph-replayed; plain_ms {plain_ms:.4f}; "
        f"library_ms {library_ms:.4f} eager / {library_graph:.4f} "
        f"graph-replayed; bound_ms {bound:.4f} ({by}: {nbytes} B, {flops} "
        f"flop); bound / graph time {bound / kernel_graph:.3f}; "
        f"{flops / kernel_graph / 1e9:.1f} TFLOP/s")
    extra = {}
    if softcap:
        extra["graph_ms_without_softcap"] = graph_ms(
            lambda: ops.paged_prefill(q, kp, vp, *meta, None, window))
        log(f"  {tag}: without the softcap "
            f"{extra['graph_ms_without_softcap']:.4f} graph-replayed")
    hdp = next(x for x in (16, 32, 64, 128, 256) if hd <= x)
    for line in ptxas_lines("flash_prefill", "prefill_bf16", f"ILi{hdp}E"):
        log(f"  ptxas {cfg.name}: {line}")
    return dict(name="flash_prefill", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill.py:76",
                max_abs_err=e, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                graph_ms=kernel_graph, library_graph_ms=library_graph,
                **extra,
                shape=f"Tb={tb} entries={lens} starts={starts} H={h} "
                      f"Hkv={hkv} hd={hd} P={p} softcap={softcap} "
                      f"window={window} bf16")


# The other paged archs' attention rows: a windowed arch's rows run past
# its window (decode lengths 4097-8192, prefill chunks after prefixes up
# to 8000), with the window and softcap of its local layers, so the
# window masks keys; a global arch's rows take qwen3-8b's lengths.
LONG_DECODE = (4097, 8192)
LONG_PREFILL = dict(lens=(256, 128, 96, 32), starts=(6144, 0, 4352, 8000))


def arch_rows(cfg, dev):
    """Both attention kernels at ``cfg``'s attention shape; each row names
    its arch (a softcapped row is also timed without its softcap)."""
    window, softcap = cfg.window, cfg.attn_logit_softcap
    dec_lens = LONG_DECODE if window else (1024, 2048)
    pre = LONG_PREFILL if window else {}
    rows = [main_path_decode(cfg, dev, window, softcap, dec_lens, seed=12,
                             arch_row=True),
            main_path_prefill(cfg, dev, window, softcap, seed=13,
                              arch_row=True, **pre)]
    for r in rows:
        r["arch"] = cfg.name
    return rows


# --------------------------------------------------------------------------
# phase 2, the slot family: WKV6 and RG-LRU against their plain versions
# --------------------------------------------------------------------------

FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 on the tensor cores (dense)


def close(name, got, want, atol, rtol=0.0) -> float:
    """Elementwise |got - want| <= atol + rtol |want|; returns the max abs
    error."""
    g, w = got.float(), want.float()
    bad = ((g - w).abs() > atol + rtol * w.abs()).sum().item()
    e = err(g, w)
    log(f"  {name}: max_abs_err {e:.3e} (tol {atol:g} + {rtol:g}|ref|) "
        f"{'ok' if not bad else f'FAIL at {bad} elements'}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements out of tolerance")
    return e


def _wkv6_inputs(gen, dev, b, t, h, hd, dtype, random_state):
    """tests/test_kernels.py::test_wkv6's distributions."""
    import torch
    r, k, v = (torch.randn((b, t, h, hd), generator=gen, device=dev) * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, hd), generator=gen,
                                         device=dev) * 0.5 - 1.0))
    u = torch.randn((h, hd), generator=gen, device=dev) * 0.3
    s0 = torch.randn((b, h, hd, hd), generator=gen, device=dev) * 0.5 \
        if random_state else torch.zeros((b, h, hd, hd), device=dev)
    return [x.to(dtype) for x in (r, k, v, w)] + [u, s0]


# y: fp32 sums in another order (2e-4, as the other sweeps); in bf16 both
# sides round an fp32 value, and one next to a rounding boundary may round
# one ulp (2^-7 |y|) apart, hence the relative term. The state is fp32.
def _wkv6_tols(dtype):
    import torch
    return (2e-2, 1e-2) if dtype == torch.bfloat16 else (2e-4, 0.0)


WKV6_STATE_TOL = 1e-4


def sweep_wkv6(gen, dev):
    import torch
    from repro_torch.kernels import ops
    for (b, t, h, hd) in [(1, 64, 2, 16), (2, 128, 3, 32), (1, 96, 1, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            for random_state in (False, True):
                r, k, v, w, u, s0 = _wkv6_inputs(gen, dev, b, t, h, hd,
                                                 dtype, random_state)
                s_k, s_r = s0.clone(), s0.clone()
                y_k, _ = ops.wkv6(r, k, v, w, u, s_k)
                y_r, _ = ops.wkv6(r, k, v, w, u, s_r, impl="ref")
                torch.cuda.synchronize()
                tag = (f"wkv6 b{b} t{t} h{h} hd{hd} {str(dtype)[6:]} "
                       f"state={'random' if random_state else 'zero'}")
                close(tag + " y", y_k, y_r, *_wkv6_tols(dtype))
                close(tag + " state", s_k, s_r, WKV6_STATE_TOL)


def edges_wkv6(gen, dev):
    """The chunked body's edges against the plain version: log-decays at
    the -30 clamp (half of the w's, or all of them, at e^-30), and T that
    is no multiple of the chunk (the padded tail), from a random state."""
    import math
    import torch
    from repro_torch.kernels import ops
    for (b, t, h, hd, clamp) in [(1, 64, 2, 64, "half"), (2, 48, 2, 32, "all"),
                                 (1, 37, 2, 64, None), (1, 257, 2, 64, None),
                                 (2, 5, 3, 16, None), (1, 100, 1, 128, "half")]:
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v, w, u, s0 = _wkv6_inputs(gen, dev, b, t, h, hd, dtype,
                                             True)
            if clamp:
                at = torch.full_like(w, math.exp(-30.0))
                if clamp == "half":
                    at = torch.where(torch.rand(w.shape, generator=gen,
                                                device=dev) < 0.5, at, w)
                w = at.to(dtype)
            s_k, s_r = s0.clone(), s0.clone()
            y_k, _ = ops.wkv6(r, k, v, w, u, s_k)
            y_r, _ = ops.wkv6(r, k, v, w, u, s_r, impl="ref")
            torch.cuda.synchronize()
            tag = (f"wkv6 b{b} t{t} h{h} hd{hd} {str(dtype)[6:]} "
                   f"{'w at the clamp (' + clamp + ')' if clamp else 'ragged T'}")
            close(tag + " y", y_k, y_r, *_wkv6_tols(dtype))
            close(tag + " state", s_k, s_r, WKV6_STATE_TOL)


def sweep_rglru(gen, dev):
    import torch
    from repro_torch.kernels import ops
    for (b, t, w) in [(1, 128, 128), (2, 256, 256), (1, 64, 384),
                      (3, 37, 200), (2, 300, 2560)]:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.sigmoid(torch.randn((b, t, w), generator=gen,
                                          device=dev)).to(dtype)
            bb = (torch.randn((b, t, w), generator=gen, device=dev)
                  * 0.2).to(dtype)
            h0 = torch.randn((b, w), generator=gen, device=dev) * 0.5
            h_k, l_k = ops.rglru(a, bb, h0)
            h_r, l_r = ops.rglru(a, bb, h0, impl="ref")
            torch.cuda.synchronize()
            # the kernel rounds its multiply and its add as the plain
            # version does: the fp32 carry agrees exactly
            tag = f"rglru b{b} t{t} w{w} {str(dtype)[6:]}"
            close(tag + " h", h_k, h_r, _tol(dtype))
            close(tag + " h_last", l_k, l_r, 0.0)


def _bound(nbytes, flops, peak):
    b, f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(b, f) * 1e3, ("bytes" if b >= f else "operations")


def main_path_wkv6(cfg, dev):
    """WKV6 at full rwkv6-1.6b width in bf16: a 256-token prefill chunk of
    one sequence (1, 256, 32, 64) and a decode step of 8 slots
    (8, 1, 32, 64), each from a random fp32 state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as WKV
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    res = {}
    for phase, (b, t) in (("prefill", (1, 256)), ("decode", (8, 1))):
        r, k, v, w, u, s0 = _wkv6_inputs(gen, dev, b, t, h, hd,
                                         torch.bfloat16, True)
        s_k, s_r = s0.clone(), s0.clone()
        y_k, _ = ops.wkv6(r, k, v, w, u, s_k)
        y_r, _ = ops.wkv6(r, k, v, w, u, s_r, impl="ref")
        torch.cuda.synchronize()
        tag = f"wkv6 main path {phase} ({b},{t},{h},{hd}) bf16"
        e = close(tag + " y", y_k, y_r, *_wkv6_tols(torch.bfloat16))
        e = max(e, close(tag + " state", s_k, s_r, WKV6_STATE_TOL))
        log(f"  {tag}: y max_abs_err / max|plain| {rel(y_k, y_r):.3e}")
        # timing advances the (scratch) state in place call after call
        kernel_ms = time_ms(lambda: ops.wkv6(r, k, v, w, u, s_k))
        device_ms = graph_ms(lambda: ops.wkv6(r, k, v, w, u, s_k))
        plain_ms = time_ms(lambda: ops.wkv6(r, k, v, w, u, s_r, impl="ref"),
                           iters=5)
        # both bodies at the same shape, in the same call (the prefill ran
        # on the per-token body before the chunked one)
        pl = WKV.plan(t, hd)
        bodies = {sp: graph_ms(lambda: WKV._launch(r, k, v, w, u, s_k, sp))
                  for sp in (0, hd // WKV.V_COLS)}
        other_ms = bodies[0 if pl["chunked"] else hd // WKV.V_COLS]
        n = b * t * h * hd
        nbytes = 5 * 2 * n + 4 * h * hd + 2 * 4 * b * h * hd * hd
        flops = b * t * h * (5 * hd * hd + 3 * hd)
        # the operations at the peak of the units the planned body runs
        # them on: the chunked body's products on the tensor cores as three
        # TF32 products each (its split precision), the per-token body on
        # the CUDA cores in fp32
        if pl["chunked"]:
            ops_n, peak, unit = 3 * flops, TF32_FLOPS, "TF32 flop (3 x split)"
        else:
            ops_n, peak, unit = flops, FP32_FLOPS, "fp32 flop"
        bound, by = _bound(nbytes, ops_n, peak)
        log(f"  {tag}: {pl}; kernel_ms {kernel_ms:.4f} (graph-replayed "
            f"{device_ms:.4f}; by body, splits=0 per token: "
            + ", ".join(f"splits={sp} {ms:.4f}" for sp, ms in bodies.items())
            + ") "
            f"plain_ms {plain_ms:.4f} library_ms none (no single PyTorch "
            f"call computes WKV6) bound_ms {bound:.4f} ({by}: {nbytes} B, "
            f"{ops_n} {unit}; at the fp32 CUDA-core peak the operations "
            f"alone take {flops / FP32_FLOPS * 1e3:.4f}); bound / graph "
            f"time {bound / device_ms:.3f}")
        res[phase] = dict(max_abs_err=e, ms=kernel_ms, graph_ms=device_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          other_body_graph_ms=other_ms)
    p, d = res["prefill"], res["decode"]
    return dict(name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
                replaces="src/repro/kernels/rwkv6_wkv.py:63",
                max_abs_err=max(p["max_abs_err"], d["max_abs_err"]),
                ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                bound_by=p["bound_by"], library_ms=None,
                graph_ms=p["graph_ms"], decode_graph_ms=d["graph_ms"],
                decode_ms=d["ms"], decode_plain_ms=d["plain_ms"],
                decode_bound_ms=d["bound_ms"], decode_bound_by=d["bound_by"],
                per_token_body_prefill_graph_ms=p["other_body_graph_ms"],
                chunked_body_decode_graph_ms=d["other_body_graph_ms"],
                shape=f"prefill (1,256,{h},{hd}), decode (8,1,{h},{hd}); "
                      f"bf16, fp32 state")


def main_path_rglru(cfg, dev):
    """RG-LRU at full recurrentgemma-2b width in fp32 (the coefficients are
    fp32): a 256-token prefill chunk (1, 256, 2560) and a decode step of 8
    slots (8, 1, 2560)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as RG
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    wd = cfg.rglru.lru_width
    res = {}
    for phase, (b, t) in (("prefill", (1, 256)), ("decode", (8, 1))):
        a = torch.sigmoid(torch.randn((b, t, wd), generator=gen, device=dev))
        bb = torch.randn((b, t, wd), generator=gen, device=dev) * 0.2
        h0 = torch.randn((b, wd), generator=gen, device=dev) * 0.5
        h_k, l_k = ops.rglru(a, bb, h0)
        h_r, l_r = ops.rglru(a, bb, h0, impl="ref")
        torch.cuda.synchronize()
        tag = f"rglru main path {phase} ({b},{t},{wd}) fp32"
        e = max(close(tag + " h", h_k, h_r, 0.0),
                close(tag + " h_last", l_k, l_r, 0.0))
        kernel_ms = time_ms(lambda: ops.rglru(a, bb, h0))
        device_ms = graph_ms(lambda: ops.rglru(a, bb, h0))
        plain_ms = time_ms(lambda: ops.rglru(a, bb, h0, impl="ref"), iters=5)
        # both bodies at the same shape, in the same call
        pl = RG.plan(t, wd, 4)
        bodies = {ch: graph_ms(lambda: RG._launch(a, bb, h0, ch))
                  for ch in (0, RG.CHANNELS)}
        other_ms = bodies[0 if pl["channels"] else RG.CHANNELS]
        nbytes = 3 * 4 * b * t * wd + 2 * 4 * b * wd
        flops = 2 * b * t * wd
        bound, by = _bound(nbytes, flops, FP32_FLOPS)
        log(f"  {tag}: {pl}; kernel_ms {kernel_ms:.4f} (graph-replayed "
            f"{device_ms:.4f}; by body, channels=0 per thread: "
            + ", ".join(f"channels={ch} {ms:.4f}" for ch, ms in bodies.items())
            + ") "
            f"plain_ms {plain_ms:.4f} library_ms none (no single PyTorch "
            f"call computes the recurrence) bound_ms {bound:.4f} ({by}: "
            f"{nbytes} B, {flops} fp32 flop); bound / graph time "
            f"{bound / device_ms:.3f}")
        res[phase] = dict(max_abs_err=e, ms=kernel_ms, graph_ms=device_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          other_body_graph_ms=other_ms)
    p, d = res["prefill"], res["decode"]
    return dict(name="rglru", route="cuda",
                source="src/repro_torch/csrc/rglru_scan.cu",
                replaces="src/repro/kernels/rglru_scan.py:40",
                max_abs_err=max(p["max_abs_err"], d["max_abs_err"]),
                ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
                bound_by=p["bound_by"], library_ms=None,
                graph_ms=p["graph_ms"], decode_graph_ms=d["graph_ms"],
                decode_ms=d["ms"], decode_plain_ms=d["plain_ms"],
                decode_bound_ms=d["bound_ms"], decode_bound_by=d["bound_by"],
                per_thread_body_prefill_graph_ms=p["other_body_graph_ms"],
                streamed_body_decode_graph_ms=d["other_body_graph_ms"],
                shape=f"prefill (1,256,{wd}), decode (8,1,{wd}); fp32")


# --------------------------------------------------------------------------
# phases 3 and 4: the main paths
# --------------------------------------------------------------------------

# The kernels each serving path must launch, and how many launches one
# decode step / one prefill dispatch of that path makes (one per layer of
# the kernel's kind; the paged family's prefill pass and decode iteration).
PAGED = ("paged_attention", "flash_prefill")
PATH_KERNELS = {"qwen3-8b": PAGED, "granite-moe-3b-a800m": PAGED,
                "gemma2-9b": PAGED, "h2o-danube-3-4b": PAGED,
                "nemotron-4-15b": PAGED, "mixtral-8x7b": PAGED,
                "rwkv6-1.6b": ("wkv6",), "recurrentgemma-2b": ("rglru",),
                "llama-3.2-vision-11b": (), "seamless-m4t-large-v2": ()}
# the paged archs after qwen3-8b, served at full width; mixtral-8x7b's 93
# GB of bf16 weights do not fit the card's 80 GB, so it serves 16 of its
# 32 layers (about 47 GB)
NEW_ARCHS = ("granite-moe-3b-a800m", "gemma2-9b", "h2o-danube-3-4b",
             "nemotron-4-15b", "mixtral-8x7b")
DEPTH_CUT = {"mixtral-8x7b": 16}
# the cross-attention towers, served at full width and full depth
CROSS_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")


def modality(cfg, rs):
    """Seeded random modality inputs of one request of ``cfg`` ({} for a
    model without modality memory), in the keys and shapes of the
    engine's default zeros: patch embeddings (VLM) or frames (enc-dec),
    (1, P, d_model) fp32 numpy."""
    import torch
    from repro_torch.models import serving as S
    return {k: rs.standard_normal(tuple(v.shape)).astype("float32")
            for k, v in S.extra_inputs(cfg, 1, torch.float32, "cpu").items()}


def _engine_config(cfg, dtype, kernel_impl="auto", mode="colocated",
                   tp=1):
    """One EngineConfig for either family: the paged family reads the page
    fields, the slot family the slot fields."""
    from repro_torch.engine import EngineConfig
    return EngineConfig(mode=mode, tp=tp, n_pages=2048, page_size=16,
                        n_slots=8,
                        max_len=2048, max_batch_tokens=512, chunk_size=256,
                        max_decode_batch=8, decode_horizon=8, dtype=dtype,
                        seed=0, kernel_impl=kernel_impl)


def serve(cfg, dev, n_greedy, n_sampled, tp=1):
    """A full-width TE of ``cfg`` (random bf16 weights from a seed; at
    ``tp`` > 1 a tensor-parallel TE whose ranks share the card) serves
    ``n_greedy`` greedy + ``n_sampled`` sampled (T=0.8, top_p=0.9)
    requests, prompts of 64-1024 random ids, 32 new tokens each, each with
    its own seeded modality inputs where the model takes them. Launch
    counts are zeroed just before the requests arrive and read just after
    the last completes."""
    import numpy as np
    import torch
    from repro_torch.engine import FlowServe, Request, SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    te = FlowServe(cfg, params, _engine_config(cfg, torch.bfloat16, tp=tp),
                   device=dev)
    torch.cuda.synchronize()
    log(f"  TE mesh: tp={tp}, ranks on {[str(d) for d in te.mesh.devices]}")
    log(f"  TE up: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, bf16, {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated ({time.monotonic() - t0:.2f} s)")
    rng = np.random.RandomState(0)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=32,
                            stop_on_eos=False)
    sampled = SamplingParams(temperature=0.8, top_p=0.9, max_new_tokens=32,
                             stop_on_eos=False)
    mem_rs = np.random.RandomState(1)
    reqs = []
    for i in range(n_greedy + n_sampled):
        n = int(rng.randint(64, 1025))
        reqs.append(Request(
            prompt_tokens=[int(t) for t in rng.randint(3, cfg.vocab_size, n)],
            sampling=greedy if i < n_greedy else sampled, req_id=f"r{i}",
            extra=modality(cfg, mem_rs)))
    ops.reset_launches()                    # this path's run starts here
    t0 = time.monotonic()
    for r in reqs:
        te.add_request(r)
    steps, comps = [], []
    while te.has_work():
        assert te.steps < 2000, "serving did not converge"
        before = (te.prefill_dispatches, te.decode_steps, te.decode_tokens,
                  sum(ops.launch_counts().values()))
        ts = time.monotonic()
        comps += te.step()
        after = (te.prefill_dispatches, te.decode_steps, te.decode_tokens,
                 sum(ops.launch_counts().values()))
        steps.append((time.monotonic() - ts,
                      *(a - b for a, b in zip(after, before))))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    assert len(comps) == len(reqs), f"{len(comps)} of {len(reqs)} completed"
    for c in comps:
        assert len(c.tokens) == 32, (c.req_id, len(c.tokens))
        assert all(0 <= t < cfg.vocab_size for t in c.tokens), c.req_id
    for name in PATH_KERNELS[cfg.name]:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the {cfg.name} path"
    ttft = sorted(c.ttft * 1e3 for c in comps)
    tpot = [c.tpot * 1e3 for c in comps]
    gen_tok = sum(len(c.tokens) for c in comps)
    # decode rate over the steps that ran no prefill pass: the tokens their
    # decode iterations sampled over their wall time (mixed steps are left
    # out of both); the output rate is every token over the whole window
    decode_only = [w for w, pf, _, _, _ in steps if pf == 0]
    dec_tok = sum(t for _, pf, _, t, _ in steps if pf == 0)
    out = dict(
        model=cfg.name, requests=len(comps),
        prompt_tokens=sum(c.n_prompt for c in comps),
        generated_tokens=gen_tok, wall_s=wall, steps=te.steps,
        prefill_passes=te.prefill_dispatches, decode_iterations=te.decode_steps,
        ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
        tpot_ms_mean=sum(tpot) / len(tpot),
        output_tok_per_s=gen_tok / wall,
        decode_tok_per_s=dec_tok / max(sum(decode_only), 1e-9),
        decode_only_steps=len(decode_only),
        decode_tokens_in_decode_only_steps=dec_tok,
        prefill_step_ms_mean=1e3 * _mean([w for w, pf, _, _, _ in steps
                                          if pf]),
        decode_step_ms_mean=1e3 * _mean(decode_only),
        decode_iterations_per_decode_step=_mean(
            [dec for _, pf, dec, _, _ in steps if pf == 0]),
        launches=launches,
        launches_per_step=sum(launches.values()) / te.steps,
        jit_compiles=te.jit_compiles,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card_line())
    if te.pool is None:
        out.update(tp=tp, cache_bytes_per_rank=_cache_bytes_per_rank(te))
    if not PATH_KERNELS[cfg.name]:
        # a cross-attention tower: plain PyTorch on the slot path, no
        # hand-written kernel launched; what its slots and checkpoints hold
        assert not any(launches.values()), launches
        snaps = list(te._state_cache.values())
        out["snapshot_bytes"] = snaps[0].nbytes
        out["state_cache_entries"] = len(snaps)
        out["state_cache_gib"] = out["snapshot_bytes"] * len(snaps) / 2**30
        if cfg.encoder is not None:
            # the encoder alone over one request's frames: what each
            # prefill chunk spends before its decoder layers
            frames = torch.from_numpy(modality(cfg, mem_rs)["frames"]).to(
                dev, torch.bfloat16)
            with torch.no_grad():
                out["encode_ms"] = time_ms(
                    lambda: T.encode(cfg, te.runner.params, frames,
                                     te.mesh), iters=5,
                    warmup=1)
    elif PATH_KERNELS[cfg.name] == PAGED:
        # one launch of each attention kernel per layer and attention rank
        # (tp of them when attention splits): per decode iteration, and
        # per prefill pass
        ranks = _ranks(te)
        out.update(tp=tp, attention_ranks=ranks, pool_bytes_per_rank=[
            te.pool.k[r].nbytes + te.pool.v[r].nbytes
            for r in range(tp)])
        out["paged_attention_per_decode_iteration"] = (
            launches["paged_attention"] / max(te.decode_steps, 1))
        out["flash_prefill_per_prefill_pass"] = (
            launches["flash_prefill"] / max(te.prefill_dispatches, 1))
        assert launches["paged_attention"] == \
            cfg.n_layers * ranks * te.decode_steps \
            and launches["flash_prefill"] == \
            cfg.n_layers * ranks * te.prefill_dispatches, \
            (launches, cfg.n_layers, ranks, te.decode_steps,
             te.prefill_dispatches)
    else:
        # one launch per recurrent layer and rank holding a part of the
        # state, for every prefill dispatch and every decode step: read
        # both from the steps that ran only one of the two, and hold the
        # total to it
        (name,) = PATH_KERNELS[cfg.name]
        out["kernel_ranks"] = _ranks(te)
        per = out["kernel_ranks"] * sum(
            k == ("rwkv" if name == "wkv6" else "rglru")
            for k in cfg.layer_kinds())
        out[f"{name}_per_decode_step"] = _mean(
            [n / dec for _, pf, dec, _, n in steps if pf == 0 and dec])
        out[f"{name}_per_prefill_dispatch"] = _mean(
            [n / pf for _, pf, dec, _, n in steps if dec == 0 and pf])
        assert launches[name] == per * (te.prefill_dispatches
                                        + te.decode_steps), \
            (launches[name], per, te.prefill_dispatches, te.decode_steps)
        assert out[f"{name}_per_decode_step"] == per \
            == out[f"{name}_per_prefill_dispatch"], out
    if cfg.moe is not None:
        out["moe_census"] = moe_census(te, cfg, rng)
    log("  serving: " + json.dumps(out))
    del te, params
    _release()
    return out


def moe_census(te, cfg, rng, n=8):
    """What the full-width capacity drops: ``n`` more greedy requests like
    the served ones (fresh prompts, 2 new tokens) through the same TE,
    after its timed window, with every MoE call's routing counted on the
    device and read once at the end: the routed (token, expert)
    assignments and the kept ones, over a prefill pass's real rows and
    over all its rows (its bucket's padding rows are routed too, and take
    capacity). A decode iteration (at most 8 rows) keeps every token: its
    capacity is its row count. The census counts in Python around every
    MoE call, so the TE serves it through its eager forms (a program's
    replay calls no Python)."""
    import torch
    from repro_torch.engine import Request, SamplingParams
    from repro_torch.engine.runners.paged import PagedPrefillRunner
    from repro_torch.models import moe as M
    _eager_decode(te)
    _eager_prefill(te)
    calls = []
    n_real = []                     # the pass's real rows (device scalar)
    orig, orig_pf = M.moe_apply, PagedPrefillRunner.prefill_ragged_eager

    def counted(ps, x, mcfg, act, mesh, groups=1):
        t = x.shape[0] * x.shape[1]
        tg = t // groups
        w_te, _, sel_tok, keep = M.moe_route(
            ps[0], x.reshape(groups, tg, -1), mcfg,
            min(M.moe_capacity(tg, mcfg), tg))
        real = n_real[-1] if n_real else t
        rows = torch.arange(tg, device=x.device)[None, :, None] \
            + tg * torch.arange(groups, device=x.device)[:, None, None]
        routed = w_te > 0
        sel = sel_tok + tg * torch.arange(groups, device=x.device)[:, None,
                                                                  None]
        calls.append((t, routed.sum(), keep.sum(),
                      (routed & (rows < real)).sum(),
                      (keep & (sel < real)).sum(), torch.as_tensor(real)))
        return orig(ps, x, mcfg, act, mesh, groups)

    def prefill(self, tokens, positions, pages, slots, cu_tokens, *a, **kw):
        n_real.append(cu_tokens[-1])
        try:
            return orig_pf(self, tokens, positions, pages, slots, cu_tokens,
                           *a, **kw)
        finally:
            n_real.pop()

    sp = SamplingParams(temperature=0.0, max_new_tokens=2, stop_on_eos=False)
    for i in range(n):
        te.add_request(Request(
            prompt_tokens=[int(t) for t in rng.randint(
                3, cfg.vocab_size, int(rng.randint(64, 1025)))],
            sampling=sp, req_id=f"census{i}"))
    M.moe_apply, PagedPrefillRunner.prefill_ragged_eager = counted, prefill
    try:
        te.run_to_completion()
    finally:
        M.moe_apply, PagedPrefillRunner.prefill_ragged_eager = orig, orig_pf
    out = {}
    for phase, sel in (("prefill", lambda t: t > 8),
                       ("decode", lambda t: t <= 8)):
        mine = [[int(v) for v in c[1:]] + [c[0]] for c in calls
                if sel(c[0])]
        routed, kept, r_real, k_real = (sum(c[i] for c in mine)
                                        for i in range(4))
        out[phase] = dict(
            moe_calls=len(mine), passes=len(mine) // cfg.n_layers,
            rows_per_pass=[c[5] for c in mine[::cfg.n_layers]],
            real_rows_per_pass=[c[4] for c in mine[::cfg.n_layers]],
            assignments_real=r_real, dropped_real=r_real - k_real,
            dropped_share_real=(r_real - k_real) / max(r_real, 1),
            assignments_all=routed, dropped_all=routed - kept,
            dropped_share_all=(routed - kept) / max(routed, 1))
    return out


def _ranks(te):
    """The ranks of a TE that launch its path's kernel in a pass: a paged
    TE's attention ranks (tp when its pool splits, one when it
    replicates: rank 0 runs it), a slot TE's ranks holding a part of its
    recurrent state (tp when the heads or the width split); one for a
    cross tower, which launches none."""
    from repro_torch.launch import sharding as SH
    if te.pool is not None:
        return len(te.pool.ranks)
    caches = te.runner.caches
    keys = [k for k in ("state", "h") if k in caches[0]]
    return len(SH.held([c[keys[0]] for c in caches])) if keys else 1


def _cache_bytes_per_rank(te):
    """Each rank's bytes of a slot TE's dense caches: its parts of the
    split leaves, and on rank 0 also the replicated leaves (stored once,
    there)."""
    specs = te.runner.cache_specs
    return [sum(t.nbytes for k, t in c.items()
                if specs[k] is not None or r == 0)
            for r, c in enumerate(te.runner.caches)]


def _release():
    """Return a dropped TE's memory before the next phase: the runners hold
    reference cycles, so collect them first."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def parity(cfg, dev, n_layers):
    """Full width cut to ``n_layers`` layers, fp32: the TE on the kernels
    and the TE on their plain versions give identical greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.engine import FlowServe, Request, SamplingParams
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = T.init_params(cfg2, gen, torch.float32, dev)
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(3, cfg.vocab_size,
                                            int(rng.randint(40, 600)))]
               for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16,
                        stop_on_eos=False)
    toks = {}
    for impl in ("auto", "ref"):
        te = FlowServe(cfg2, params, _engine_config(cfg2, torch.float32,
                                                    impl), device=dev)
        for i, pr in enumerate(prompts):
            te.add_request(Request(prompt_tokens=pr, sampling=sp,
                                   req_id=f"p{i}"))
        toks[impl] = {c.req_id: c.tokens for c in te.run_to_completion()}
        del te
        _release()
    same = toks["auto"] == toks["ref"]
    log(f"  parity {cfg.name} x{n_layers} layers: kernel path "
        f"{toks['auto']['p0'][:8]}... plain path {toks['ref']['p0'][:8]}... "
        f"identical={same}")
    assert len(toks["auto"]) == 4 and same, "kernel and plain paths differ"
    del params
    _release()


def oracle_parity(cfg, dev, n_layers, n_enc_layers=None):
    """Full width cut to ``n_layers`` decoder layers (and
    ``n_enc_layers`` encoder layers), fp32, non-zero cross gates: the
    TE's greedy tokens for 4 requests with seeded modality inputs equal
    the greedy oracle of the port's teacher-forced ``forward``. One
    forward over prompt + the TE's tokens gives the oracle's next token
    after every prefix (causal), so the tokens agree exactly when each
    of the TE's tokens is that position's argmax.

    As in ``tests/test_system.py::test_engine_matches_oracle``, every
    prompt prefills in one chunk of the first step, before any decode:
    the slot family's all-slot decode step also advances a slot whose
    prompt is still mid-prefill (a reference defect the port keeps for
    parity; ``tests/test_torch_crossattn.py`` shows it), so a request
    prefilled across decode steps is not held to the oracle."""
    import numpy as np
    import torch
    from repro_torch.engine import FlowServe, Request, SamplingParams
    from repro_torch.models import transformer as T
    enc = cfg.encoder and dataclasses.replace(cfg.encoder,
                                              n_layers=n_enc_layers)
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, encoder=enc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = T.init_params(cfg2, gen, torch.float32, dev)
    if cfg2.vision is not None:
        n = len(cfg2.cross_attn_layers())
        params["cross_blocks"]["gate_attn"].copy_(torch.linspace(0.6, 0.9, n))
        params["cross_blocks"]["gate_mlp"].copy_(torch.linspace(-0.7, -0.4,
                                                                n))
    rng = np.random.RandomState(5)
    reqs = [Request(prompt_tokens=[int(t) for t in rng.randint(
                3, cfg.vocab_size, int(rng.randint(40, 121)))],
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=16,
                                            stop_on_eos=False),
                    req_id=f"o{i}", extra=modality(cfg2, rng))
            for i in range(4)]
    te = FlowServe(cfg2, params, _engine_config(cfg2, torch.float32),
                   device=dev)
    for r in reqs:
        te.add_request(r)
    got = {c.req_id: c.tokens for c in te.run_to_completion()}
    assert te.prefill_dispatches == len(reqs), te.prefill_dispatches
    del te
    _release()
    same, margin = len(got) == 4, float("inf")
    for r in reqs:
        seq = r.prompt_tokens + got[r.req_id][:-1]
        with torch.no_grad():
            logits = T.forward(
                cfg2, params, torch.tensor([seq], device=dev),
                **{k: torch.from_numpy(v).to(dev)
                   for k, v in r.extra.items()})
        lg = logits[0, len(r.prompt_tokens) - 1:, :cfg.vocab_size]
        want = lg.argmax(-1).tolist()
        top2 = lg.topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        same = same and want == got[r.req_id]
        del logits
    log(f"  oracle {cfg.name} x{n_layers} layers"
        f"{'' if enc is None else f' + {n_enc_layers} encoder layers'}: "
        f"engine {got['o0'][:8]}... identical to the forward's greedy "
        f"tokens={same} (smallest top-2 logit gap {margin:.3e})")
    assert same, "engine and teacher-forced greedy tokens differ"
    del params
    _release()


# --------------------------------------------------------------------------
# phase 5: PD disaggregation and Algorithm 1
# --------------------------------------------------------------------------

# the kernel each TE of a PD pair must launch: the P-TE's per prefill pass
# (paged) or dispatch (slot), the D-TE's per decode iteration / step
PD_KERNELS = {"qwen3-8b": ("flash_prefill", "paged_attention"),
              "rwkv6-1.6b": ("wkv6", "wkv6")}


def _pd_pair(cfg, params, dev, dtype, impl="auto", tag="pd", tp=(1, 1)):
    """A P-TE and a D-TE on one weights dict, linked by DistFlow; ``tp``
    is (the P-TE's, the D-TE's) tensor-parallel width."""
    from repro_torch.engine import FlowServe
    pe, de = (FlowServe(cfg, params,
                        _engine_config(cfg, dtype, impl, mode, tp=t),
                        name=f"{tag}-{mode}", device=dev)
              for mode, t in zip(("prefill", "decode"), tp))
    pe.distflow.link_cluster([de.distflow])
    return pe, de


def _requests(cfg, n_greedy, n_sampled, seed=0, tag="r"):
    """Prompts of 64-1024 random ids, 32 new tokens; greedy, then sampled
    (T=0.8, top_p=0.9)."""
    import numpy as np
    from repro_torch.engine import Request, SamplingParams
    rng = np.random.RandomState(seed)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=32,
                            stop_on_eos=False)
    sampled = SamplingParams(temperature=0.8, top_p=0.9, max_new_tokens=32,
                             stop_on_eos=False)
    return [Request(prompt_tokens=[int(t) for t in rng.randint(
                3, cfg.vocab_size, int(rng.randint(64, 1025)))],
                    sampling=greedy if i < n_greedy else sampled,
                    req_id=f"{tag}{i}")
            for i in range(n_greedy + n_sampled)]


def _check_comps(comps, reqs, cfg):
    assert len(comps) == len(reqs), f"{len(comps)} of {len(reqs)} completed"
    for c in comps:
        assert len(c.tokens) == 32, (c.req_id, len(c.tokens))
        assert all(0 <= t < cfg.vocab_size for t in c.tokens), c.req_id


def serve_pd(cfg, params, dev, n_greedy, n_sampled, tp=(1, 1)):
    """A P-TE and a D-TE of ``cfg`` (full width, bf16, one weights dict)
    serve ``n_greedy`` + ``n_sampled`` requests through the PD pump: the
    P-TE steps, every finished prefill migrates over DistFlow (device to
    device in 4 layer chunks, landed by the D-TE just before its first
    decode), the D-TE steps. Launch counts are zeroed just before the
    requests arrive and read around each TE's own step: the P-TE must
    launch only its prefill kernel, the D-TE only its decode kernel, one
    per layer per pass / step, and a migration none."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    pe, de = _pd_pair(cfg, params, dev, torch.bfloat16, tp=tp)
    reqs = _requests(cfg, n_greedy, n_sampled)
    zero = {k: 0 for k in ops.launch_counts()}
    per = {"prefill": dict(zero), "migrate": dict(zero),
           "decode": dict(zero)}
    ops.reset_launches()                    # this path's run starts here
    t0 = time.monotonic()
    for r in reqs:
        pe.add_request(r)
    # per pump iteration: (P-TE passes, P step s, migrate s, D step s,
    # D decode iterations, D tokens)
    comps, its, migrated = [], [], 0
    while pe.has_work() or de.has_work():
        assert de.steps < 2000, "PD serving did not converge"
        t = [time.monotonic()]
        marks = [ops.launch_counts()]
        passes, iters, tok0 = (pe.prefill_dispatches, de.decode_steps,
                               de.decode_tokens)
        if pe.has_work():
            pe.step()
        t.append(time.monotonic())
        marks.append(ops.launch_counts())
        for rid in pe.pop_migratable():
            migrated += pe._seqs[rid].n_cached
            pe.migrate_out(rid, de)
        t.append(time.monotonic())
        marks.append(ops.launch_counts())
        if de.has_work():
            comps += de.step()
        t.append(time.monotonic())
        marks.append(ops.launch_counts())
        for phase, a, b in zip(per, marks, marks[1:]):
            for k in b:
                per[phase][k] += b[k] - a[k]
        its.append((pe.prefill_dispatches - passes,
                    *(b - a for a, b in zip(t, t[1:])),
                    de.decode_steps - iters, de.decode_tokens - tok0))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    _check_comps(comps, reqs, cfg)
    pk, dk = PD_KERNELS[cfg.name]
    n_kind = sum(k.startswith("rwkv" if pk == "wkv6" else "attn")
                 for k in cfg.layer_kinds())
    n_pe, n_de = _ranks(pe), _ranks(de)
    assert per["prefill"] == {**zero, pk: n_kind * n_pe
                              * pe.prefill_dispatches}, \
        (per["prefill"], pe.prefill_dispatches)
    assert per["decode"] == {**zero, dk: n_kind * n_de
                             * de.decode_steps}, \
        (per["decode"], de.decode_steps)
    assert per["migrate"] == zero, per["migrate"]
    assert pe.decode_steps == 0 and de.prefill_dispatches == 0
    ttft = sorted(c.ttft * 1e3 for c in comps)
    tpot = [c.tpot * 1e3 for c in comps]
    gen_tok = sum(len(c.tokens) for c in comps)
    pf = [i for i in its if i[0]]          # iterations with a prefill pass
    dec = [i for i in its if not i[0]]
    out = dict(
        model=cfg.name, tp=list(tp), requests=len(comps),
        prompt_tokens=sum(c.n_prompt for c in comps),
        generated_tokens=gen_tok, wall_s=wall,
        prefill_passes=pe.prefill_dispatches,
        decode_iterations=de.decode_steps,
        ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
        tpot_ms_mean=sum(tpot) / len(tpot),
        output_tok_per_s=gen_tok / wall,
        decode_tok_per_s=sum(i[5] for i in dec)
        / max(sum(sum(i[1:4]) for i in dec), 1e-9),
        # where a pump iteration's host time goes, with and without a
        # prefill pass: the P-TE's step, the migrations, the D-TE's step
        # (which waits for the horizon it commits) and its iterations
        pump_iterations_with_prefill=len(pf),
        prefill_te_step_ms_mean=1e3 * _mean([i[1] for i in pf]),
        migrate_ms_mean=1e3 * _mean([i[2] for i in pf]),
        decode_te_step_ms_mean_with_prefill=1e3 * _mean([i[3] for i in pf]),
        decode_iterations_per_step_with_prefill=_mean([i[4] for i in pf]),
        pump_iterations_decode_only=len(dec),
        decode_te_step_ms_mean_decode_only=1e3 * _mean([i[3] for i in dec]),
        decode_iterations_per_step_decode_only=_mean([i[4] for i in dec]),
        migrations=len(pe.distflow.log), migrated_tokens=migrated,
        kv_bytes_moved=pe.distflow.bytes_moved(),
        distflow_sim_s=pe.distflow.sim_clock,
        distflow_sim_s_decode_te=de.distflow.sim_clock,
        launches_prefill_te=per["prefill"], launches_decode_te=per["decode"],
        launches_migrations=per["migrate"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card_line())
    out[f"{pk}_per_prefill_pass"] = (per["prefill"][pk]
                                     / max(pe.prefill_dispatches, 1))
    out[f"{dk}_per_decode_iteration"] = (per["decode"][dk]
                                         / max(de.decode_steps, 1))
    out.update(migration_check(cfg, pe, de, dev) if pe.pool is not None
               else slot_migration_check(cfg, pe, de))
    log("  pd serving: " + json.dumps(out))
    del pe, de
    _release()
    return out


def _heads(runs, dim):
    """Per-rank pools or runs joined on their head split (the one tensor
    of a replicated or tp-1 pool or run)."""
    import torch
    return torch.cat(runs, dim) if dim is not None else runs[0]


def migration_check(cfg, pe, de, dev):
    """One more greedy request through the pair's default path, after the
    timed window: its page run, cloned on the P-TE before ``migrate_out``,
    equals the D-TE's pool over the migrated tokens bit for bit after the
    D-TE's step that lands it. Then the device time of one migration of
    that run (the P-TE's gather, DistFlow's 4 chunks and events, the
    scatter into pages of the D-TE), by CUDA events."""
    import torch
    from repro_torch.engine.distflow import DistFlow
    (req,) = _requests(cfg, 1, 0, seed=11, tag="m")
    pe.add_request(req)
    while pe.has_work():
        pe.step()
    (rid,) = pe.pop_migratable()
    seq = pe._seqs[rid]
    pages, n = list(seq.pages), seq.n_cached
    k_exp, v_exp = (_heads([t.clone() for t in run], pe.pool.spec)
                    for run in pe.pool.gather_device(pages))
    pe.migrate_out(rid, de)
    dseq = de._seqs[rid]
    assert dseq.kv_pending is not None
    for _ in range(2):      # the first step may run the plan made before
        de.step()           # the arrival; the next lands the run, decodes
    assert dseq.kv_pending is None
    run = dseq.pages[:len(pages)]

    def toks(x):                            # (L, NP, P, ...) -> first n
        return x.reshape(x.shape[0], -1, *x.shape[3:])[:, :n]
    got_k, got_v = (_heads([t[:, run] for t in pool], de.pool.spec)
                    for pool in (de.pool.k, de.pool.v))
    same = (torch.equal(toks(got_k), toks(k_exp))
            and torch.equal(toks(got_v), toks(v_exp)))
    assert same, "the D-TE's pool run differs from the exported run"
    de.run_to_completion()
    dst = de.pool.alloc(len(pages))
    bench = DistFlow("bench")

    def migrate():
        k, v = pe.pool.gather_device(pages)
        h = bench.transfer_sharded({"k": k, "v": v}, de.name,
                                   src_dim=pe.pool.spec,
                                   dst=de.pool.run_sharding(),
                                   src_tp=pe.ecfg.tp, dst_tp=de.ecfg.tp,
                                   layer_chunks=4)
        for i in range(len(h.chunks)):
            l0, kc, vc = h.wait_chunk(i)
            de.pool.scatter_run(dst, kc, vc, layer_start=l0)
    ms = time_ms(migrate, iters=10, warmup=2)
    de.pool.release(dst)
    run_bytes = k_exp.nbytes + v_exp.nbytes
    return dict(check_run_tokens=n, check_run_pages=len(pages),
                check_run_bit_identical=same,
                kv_bytes_per_token=run_bytes // (len(pages)
                                                 * de.pool.page_size),
                migration_ms=ms, migration_run_bytes=run_bytes,
                migration_gb_per_s=run_bytes / ms / 1e6,
                migration_hbm_gb_per_s=4 * run_bytes / ms / 1e6)


def _joined(snap):
    """A slot snapshot's leaves as whole tensors: a split leaf's parts
    joined on its split, a replicated leaf's one copy."""
    import torch
    return {k: torch.cat([r[k] for r in snap.ranks], d)
            if d is not None and len(snap.ranks) > 1 else snap.ranks[0][k]
            for k, d in snap.splits.items()}


def slot_migration_check(cfg, pe, de):
    """One more greedy request through a slot pair, after the timed window:
    its slot snapshot on the P-TE, joined over the ranks, equals the
    D-TE's slot after ``migrate_out`` (resharded at import when the two
    tp differ) bit for bit. Before it, the device time of one migration
    of that slot (the P-TE's snapshot of every rank, the D-TE's reshard
    and copy into a slot of its own, the length read back included), by
    CUDA events."""
    import torch
    from repro_torch.engine.runners import SequenceState
    (req,) = _requests(cfg, 1, 0, seed=11, tag="m")
    pe.add_request(req)
    while pe.has_work():
        pe.step()
    (rid,) = pe.pop_migratable()
    pseq = pe._seqs[rid]
    want = {k: t.clone() for k, t in
            _joined(pe.runner.snapshot_state(pseq)).items()}
    scratch = SequenceState(seq_id="scratch", tokens=[0], n_prompt=1)
    assert de.runner.alloc_slot(scratch)
    ms = time_ms(lambda: de.runner.import_kv(pe.runner.export_kv(pseq),
                                             scratch), iters=10, warmup=2)
    de.runner.free_slot(scratch)
    pe.migrate_out(rid, de)
    got = _joined(de.runner.snapshot_state(de._seqs[rid]))
    same = got.keys() == want.keys() and all(torch.equal(got[k], want[k])
                                             for k in want)
    assert same, "the D-TE's slot differs from the exported snapshot"
    de.run_to_completion()
    nbytes = sum(t.nbytes for t in want.values())
    return dict(check_state_tokens=pseq.n_cached,
                check_state_bit_identical=same, migration_ms=ms,
                migration_state_bytes=nbytes,
                migration_gb_per_s=nbytes / ms / 1e6)


def pd_parity(cfg, dev, n_layers, tp=(1, 1)):
    """Full width cut to ``n_layers`` layers, fp32, both on the kernels:
    the PD pair (widths ``tp``) gives the colocated TE's (the D-TE's
    width) greedy tokens: exactly when the two widths agree; across widths
    up to near-ties (``_same_tokens``), since the P-TE's projections then
    run at other shapes. The smallest top-2 logit gap over the generated
    positions comes from the port's teacher-forced ``forward`` over
    prompt + tokens."""
    import numpy as np
    import torch
    from repro_torch.engine import FlowServe, Request, SamplingParams
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = T.init_params(cfg2, gen, torch.float32, dev)
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(3, cfg.vocab_size,
                                            int(rng.randint(40, 600)))]
               for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16,
                        stop_on_eos=False)

    def reqs():
        return [Request(prompt_tokens=p, sampling=sp, req_id=f"q{i}")
                for i, p in enumerate(prompts)]
    te = FlowServe(cfg2, params, _engine_config(cfg2, torch.float32,
                                                tp=tp[1]), device=dev)
    for r in reqs():
        te.add_request(r)
    colo = {c.req_id: c.tokens for c in te.run_to_completion()}
    del te
    pe, de = _pd_pair(cfg2, params, dev, torch.float32, tag="par", tp=tp)
    for r in reqs():
        pe.add_request(r)
    pd = {}
    while pe.has_work() or de.has_work():
        pe.step()
        for rid in pe.pop_migratable():
            pe.migrate_out(rid, de)
        pd.update({c.req_id: c.tokens for c in de.step()})
    del pe, de
    margin = float("inf")
    for i, p in enumerate(prompts):
        with torch.no_grad():
            logits = T.forward(cfg2, params, torch.tensor(
                [p + pd[f"q{i}"][:-1]], device=dev))
        top2 = logits[0, len(p) - 1:, :cfg.vocab_size].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        del logits
    same = len(pd) == len(colo) == 4 and pd == colo
    log(f"  pd parity {cfg.name} x{n_layers} layers, tp {tp[0]} -> "
        f"{tp[1]}: PD pair {pd['q0'][:8]}... colocated {colo['q0'][:8]}... "
        f"identical={same} (smallest top-2 logit gap {margin:.3e})")
    if tp[0] == tp[1]:
        assert same, "the PD pair and the colocated TE give different tokens"
    else:
        # the P-TE's projections run at another width: up to near-ties
        assert len(pd) == len(colo) == 4
        ids = [f"q{i}" for i in range(4)]
        _same_tokens(cfg2, params, dev, reqs(), [pd[i] for i in ids],
                     [colo[i] for i in ids], f"pd tp {tp[0]}->{tp[1]}")
    del params
    _release()
    return margin


def scheduled(cfg, params, dev, n_requests=8):
    """Algorithm 1 through the launcher's entry points: two colocated TEs
    and one live PD pair of ``cfg`` (full width, bf16, one weights dict)
    on the card, placed from the PD heatmap of ``cfg`` on one H100's cost
    model and a predictor trained on ``synth_trace(2000)``; every unit
    stepped by the launcher's pump until every request completes."""
    import torch
    from repro_torch.core import (DecodeLengthPredictor,
                                  DistributedScheduler, HeatmapStudy,
                                  PredictorConfig, SchedRequest, TEHandle,
                                  synth_trace, train_predictor)
    from repro_torch.launch.serve import build_te, pd_pair, run_units
    torch.cuda.reset_peak_memory_stats()
    hs = HeatmapStudy(cfg)
    pcfg = PredictorConfig()
    xs, ys, _ = synth_trace(2000, pcfg)
    pparams, acc = train_predictor(pcfg, xs, ys)
    bf16 = torch.bfloat16
    handles = [TEHandle(n, "colocated",
                        engine=build_te(cfg, params, "colocated", n, dev,
                                        bf16)) for n in ("te-c0", "te-c1")]
    handles.append(pd_pair(cfg, params, "te-pd0", dev, bf16))
    ds = DistributedScheduler(handles, hs.combined(), hs.prefill_lens,
                              hs.decode_ratios,
                              predictor=DecodeLengthPredictor(pcfg, pparams))
    reqs = _requests(cfg, n_requests - 2, 2, seed=3, tag="s")
    placed = {}
    t0 = time.monotonic()
    for r in reqs:
        sreq = SchedRequest(tokens=r.prompt_tokens)
        h = ds.dist_sched(sreq)
        ds.commit(sreq, h)
        h.engine.add_request(r)
        placed[r.req_id] = h.te_id
    comps = run_units(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    _check_comps(comps, reqs, cfg)
    pair = handles[-1]
    out = dict(model=cfg.name, requests=len(comps), wall_s=wall,
               decisions=ds.decisions, placed=placed,
               to_pd_pair=sum(v == "te-pd0" for v in placed.values()),
               predictor_accuracy=acc,
               pd_migrations=len(pair.engine.distflow.log),
               ttft_ms_max=max(c.ttft for c in comps) * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("  scheduled: " + json.dumps(out))
    del handles, pair, ds
    _release()
    return out


def phase5(dev):
    """PD disaggregation at full width (qwen3-8b on the paged path,
    rwkv6-1.6b on the slot path), PD-vs-colocated parity at 2 fp32
    layers, and a short Algorithm-1 run over two colocated TEs and a live
    PD pair. Returns each kernel's launches on the PD path, per (arch,
    kernel), both TEs summed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    qwen, rwkv = get_config("qwen3-8b"), get_config("rwkv6-1.6b")
    launches = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(qwen, gen, torch.bfloat16, dev)
    log(f"phase 5: PD-disaggregated serving ({qwen.name}, {qwen.n_layers} "
        f"layers, bf16) [{time.monotonic() - T0:.1f} s]")
    out = serve_pd(qwen, params, dev, 8, 2)
    launches["qwen3-8b", "flash_prefill"] = \
        out["launches_prefill_te"]["flash_prefill"]
    launches["qwen3-8b", "paged_attention"] = \
        out["launches_decode_te"]["paged_attention"]
    log(f"phase 5: Algorithm 1 over 2 colocated TEs + 1 PD pair "
        f"({qwen.name}, bf16) [{time.monotonic() - T0:.1f} s]")
    scheduled(qwen, params, dev)
    del params
    _release()
    log(f"phase 5: PD-disaggregated serving ({rwkv.name}, {rwkv.n_layers} "
        f"layers, bf16) [{time.monotonic() - T0:.1f} s]")
    gen.manual_seed(0)
    params = T.init_params(rwkv, gen, torch.bfloat16, dev)
    out = serve_pd(rwkv, params, dev, 6, 2)
    launches["rwkv6-1.6b", "wkv6"] = (out["launches_prefill_te"]["wkv6"]
                                      + out["launches_decode_te"]["wkv6"])
    del params
    _release()
    log(f"phase 5: PD pair vs colocated TE ({qwen.name}, 2 layers, fp32) "
        f"[{time.monotonic() - T0:.1f} s]")
    pd_parity(qwen, dev, 2)
    # recurrentgemma's RG-LRU is not on this slice's PD path
    launches["recurrentgemma-2b", "rglru"] = None
    return launches


# --------------------------------------------------------------------------
# phase 6: the fleet control plane
# --------------------------------------------------------------------------

# short prompts (nearer 128 tokens) to the PD pair, long ones (nearer 768)
# to the colocated TE: both units busy under Algorithm 1
MIXED_HEAT = ([[1.0, 1.0], [-1.0, -1.0]], [128, 768], [0.05, 0.5])
MiB = 2 ** 20
PD_COLO = ["te-pd0-p", "te-pd0-d", "te-colo0"]    # pd=1,colo=1's TEs


def _pool_bytes(cfg, dtype_size):
    """One paged TE's KV pool (K and V) at ``_engine_config``'s shape."""
    return 2 * cfg.n_layers * 2048 * 16 * cfg.n_kv_heads * cfg.head_dim \
        * dtype_size


def _fits(need, what):
    """Size a fleet from the card's free memory before bring-up: ``need``
    is what it will allocate beyond what is resident now."""
    import torch
    _release()
    free, total = torch.cuda.mem_get_info()
    log(f"  {what}: needs ~{need / 2**30:.1f} GiB; {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB free")
    assert need <= free, f"{what} does not fit the card"


def _heat(cfg, mixed=False):
    """The plane's heatmap: the full config's on one H100's cost model
    (every qwen3-8b cell is positive: all to the PD pair), or the mixed
    one that splits short and long prompts."""
    from repro_torch.core import HeatmapStudy
    if mixed:
        import numpy as np
        return np.asarray(MIXED_HEAT[0]), MIXED_HEAT[1], MIXED_HEAT[2]
    hs = HeatmapStudy(cfg)
    return hs.combined(), hs.prefill_lens, hs.decode_ratios


def _plane(cfg, params, dev, topo, dtype, heat, **kw):
    from repro_torch.core import ServingJobEngine, TopologySpec
    je = ServingJobEngine(cfg, params, TopologySpec.parse(topo),
                          heatmap=heat[0], prefill_lens=heat[1],
                          decode_ratios=heat[2],
                          ecfg=_engine_config(cfg, dtype), device=dev, **kw)
    import torch
    torch.cuda.synchronize()
    return je


def _check_plane(je, names, victim=None, plans=()):
    """No unit of ``je`` failed, and no bring-up of ``plans``: the plane
    quarantines a unit that raises (a kernel that fails on the card
    included) and restarts its requests on the units left, so the error
    shows only in its scale events. With ``victim``, exactly that unit
    failed, once, by the injected crash. The plane's engines are
    ``names``."""
    fails = [(e["te_id"], e["error"]) for e in je.scale_events
             if e["kind"] == "te_failure"]
    if victim is None:
        assert not fails, f"a fleet unit failed: {fails}"
    else:
        assert len(fails) == 1 and fails[0][0] == victim \
            and "injected crash" in fails[0][1], fails
    forks = [e for e in je.scale_events if e["kind"] == "fork_failed"]
    assert not forks, f"a bring-up failed: {forks}"
    for plan in plans:
        bad = [r["failed"] for r in plan["rounds"] if r["failed"]]
        assert not bad, f"scale_to bring-ups failed: {bad}"
    got = sorted(e.name for e in je.engines)
    assert got == sorted(names), (got, sorted(names))


def _scaled(plan):
    """The TEs a ``scale_to`` plan brought up, in order."""
    return [te for r in plan["rounds"] for te in r["tes"]]


def _allocated():
    """Live device bytes once every dropped object is collected."""
    import torch
    _release()
    return torch.cuda.memory_allocated()


def _ev_ms(ev):
    return ev[0].elapsed_time(ev[1])


def _submit_all(je, reqs):
    return [je.submit(r.prompt_tokens, sampling=r.sampling) for r in reqs]


def _tokens(je, rids):
    got = {}
    for c in je.completions:
        assert c.req_id not in got, f"{c.req_id} completed twice"
        got[c.req_id] = c.tokens
    assert sorted(got) == sorted(rids), \
        f"{len(got)} of {len(rids)} requests completed"
    return [got[r] for r in rids]


def _check_launches(je, cfg):
    """Each TE's own launches (read on its stepping thread around its
    step): a P-TE only flash_prefill, a D-TE only paged_attention, a
    colocated TE both, one per layer per prefill pass / decode iteration;
    a slot TE WKV6 per dispatch and step. Returns them by TE."""
    from repro_torch.kernels import counts
    out = {}
    for eng in je.engines:
        n = eng.kernel_launches
        out[eng.name] = {k: v for k, v in n.items() if v}
        if cfg.attn_kind == "rwkv":
            assert n == {**dict.fromkeys(counts.NAMES, 0),
                         "wkv6": cfg.n_layers * (eng.prefill_dispatches
                                                 + eng.decode_steps)}, \
                (eng.name, n)
            continue
        want = dict.fromkeys(counts.NAMES, 0)
        want["flash_prefill"] = cfg.n_layers * _ranks(eng) \
            * eng.prefill_dispatches
        want["paged_attention"] = cfg.n_layers * _ranks(eng) \
            * eng.decode_steps
        assert n == want, (eng.name, n, want)
        if eng.ecfg.mode == "prefill":
            assert eng.decode_steps == 0, eng.name
        if eng.ecfg.mode == "decode":
            assert eng.prefill_dispatches == 0, eng.name
    return out


def fleet_serve(cfg, params, dev, policy, threads, reqs, heat,
                topo="pd=1,colo=1"):
    """A pd=1,colo=1 plane of ``cfg`` (bf16, full width, the initial TEs on
    one weights tree) serves ``reqs`` through ``submit`` and
    ``run_to_completion``. Every request completes with valid ids; each
    TE launches only its kernels. Returns the run's metrics."""
    import torch
    from repro_torch.kernels import ops
    je = _plane(cfg, params, dev, topo, torch.bfloat16, heat,
                policy=policy, fleet_threads=threads)
    try:
        ops.reset_launches()
        t0 = time.monotonic()
        rids = _submit_all(je, reqs)
        je.run_to_completion()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        total = ops.launch_counts()
        _tokens(je, rids)
        _check_comps(je.completions, reqs, cfg)
        per_te = _check_launches(je, cfg)
        summed = {k: sum(e.kernel_launches[k] for e in je.engines)
                  for k in total}
        assert summed == total, (summed, total)
        _check_plane(je, PD_COLO)
        decisions = dict(je.scheduler.decisions)
        migrations = len(je.handles[0].engine.distflow.log)
        # each TE launched its role's kernels and no others; Algorithm 1
        # on this heatmap may send every request to the PD pair
        want = {"te-pd0-p": {"flash_prefill"},
                "te-pd0-d": {"paged_attention"},
                "te-colo0": {"flash_prefill", "paged_attention"}}
        if policy == "dist_sched":
            assert migrations == decisions["pd_disagg"] > 0, \
                (migrations, decisions)
            if not decisions["pd_colo"]:
                want["te-colo0"] = set()
        assert migrations > 0
        assert {k: set(v) for k, v in per_te.items()} == want, per_te
        comps = je.completions
        ttft = sorted(c.ttft * 1e3 for c in comps)
        out = dict(policy=policy, fleet_threads=threads, topology=topo,
                   requests=len(comps), wall_s=wall,
                   output_tok_per_s=sum(len(c.tokens) for c in comps) / wall,
                   ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
                   tpot_ms_mean=_mean([c.tpot * 1e3 for c in comps]),
                   decisions=decisions, migrations=migrations,
                   plane_steps=je.steps, launches=total,
                   launches_by_te=per_te)
        log("  fleet: " + json.dumps(out))
        return out
    finally:
        je.close()
        del je
        _release()


def fleet_ladder(cfg, params, dev, weights_s):
    """The cold-start ladder on qwen3-8b: scale_to(3) from one SERVING TE
    by fork (each fork's device time and bytes; its weights equal the
    source's bit for bit, in new storage); both forks drained and
    released (the first into the warm pool: pin, D2H); scale_to(3) again
    (one fork + one warm upload: H2D); three requests, one per TE. Then a
    cold start: a one-TE plane without a warm pool drained to zero and
    scaled back to one (construction on the plane's resident weights;
    the weights' seeded init took ``weights_s``)."""
    import torch
    from repro_torch.core import WarmPool
    from repro_torch.engine import FlowServe
    from repro_torch.engine.distflow import _nbytes, tree_leaves
    bf16 = torch.bfloat16
    w = _nbytes(params)
    pool = _pool_bytes(cfg, 2)
    _fits(2 * w + 3 * pool + 2 * 2**30, "ladder (3 TEs, 2 forked copies)")
    warm = WarmPool(capacity_bytes=64e9)
    je = _plane(cfg, params, dev, "colo=1", bf16, _heat(cfg, mixed=True),
                policy="round_robin", warm_pool=warm)
    out = {"weights_bytes": w, "pool_bytes": pool}
    try:
        plan = je.scale_to(3)
        torch.cuda.synchronize()
        out["fork_plan"] = dict(
            rounds=[(r["tes"], r["sources"], r["wall_s"])
                    for r in plan["rounds"]], tiers=plan["tiers"])
        assert plan["tiers"] == {"fork": 2, "warm": 0, "cold": 0}, plan
        forked = _scaled(plan)
        _check_plane(je, ["te-colo0"] + forked, plans=[plan])
        src = je.engines[0]
        forks = []
        for eng in je.engines[1:]:
            a = tree_leaves(src.runner.params)
            b = tree_leaves(eng.runner.params)
            assert len(a) == len(b) and all(
                torch.equal(x, y) and x.data_ptr() != y.data_ptr()
                for x, y in zip(a, b)), f"{eng.name}: fork is not a copy"
            ms = _ev_ms(eng.transfer_timing["fork"])
            forks.append(dict(te=eng.name, device_ms=ms,
                              gb_per_s=w / ms / 1e6,
                              bound_ms=2 * w / HBM_BYTES_PER_S * 1e3))
        out["forks"] = forks
        out["fork_bit_equal_new_storage"] = True
        del src, eng, a, b
        # scale-in: both forked TEs drain and release; the first one's
        # weights go to the warm pool
        m0 = _allocated()
        first = je.engines[1]
        for te_id in forked:
            je.drain(te_id)
        while any(h.state.value == "draining" for h in je.handles):
            je.step()
        _check_plane(je, ["te-colo0"])
        t = first.transfer_timing
        out["release"] = dict(pin_ms=t["pin_s"] * 1e3,
                              d2h_ms=_ev_ms(t["d2h"]),
                              d2h_gb_per_s=w / _ev_ms(t["d2h"]) / 1e6)
        del first
        returned = m0 - _allocated()
        out["release"]["returned_bytes"] = returned
        assert abs(returned - 2 * (w + pool)) <= 64 * MiB, \
            (returned, 2 * (w + pool))
        assert warm.hit(je._asset_name())
        plan = je.scale_to(3)
        torch.cuda.synchronize()
        assert plan["tiers"] == {"fork": 1, "warm": 1, "cold": 0}, plan
        names = ["te-colo0"] + _scaled(plan)
        _check_plane(je, names, plans=[plan])
        # the round's fork and upload ran on two threads, both on the
        # default stream, so this event pair may hold some fork copies
        h2d = _ev_ms(next(e.transfer_timing["h2d"] for e in je.engines
                          if "h2d" in e.transfer_timing))
        out["warm_plan"] = dict(
            rounds=[(r["tes"], r["sources"], r["wall_s"])
                    for r in plan["rounds"]], tiers=plan["tiers"],
            h2d_ms_in_round=h2d)
        reqs = _requests(cfg, 3, 0, seed=21, tag="l")
        rids = _submit_all(je, reqs)
        je.run_to_completion()
        _tokens(je, rids)
        _check_plane(je, names)
        assert all(e.decode_steps > 0 for e in je.engines)
        _check_launches(je, cfg)
        entry = warm.get(je._asset_name())
    finally:
        je.close()
        del je
        _release()
    # the warm upload alone: one TE from the pool's pinned entry
    te = FlowServe.from_warm(cfg, entry, _engine_config(cfg, bf16),
                             name="te-warm", device=dev)
    torch.cuda.synchronize()
    h2d = _ev_ms(te.transfer_timing["h2d"])
    out["warm_alone"] = dict(h2d_ms=h2d, h2d_gb_per_s=w / h2d / 1e6,
                             bound_ms_pcie5=w / 64e9 * 1e3)
    del te, entry, warm
    _release()
    je = _plane(cfg, params, dev, "colo=1", bf16, _heat(cfg, mixed=True),
                policy="round_robin")
    try:
        je.drain("te-colo0")
        je.step()
        assert je.n_serving() == 0
        plan = je.scale_to(1)
        assert plan["tiers"] == {"fork": 0, "warm": 0, "cold": 1}, plan
        _check_plane(je, _scaled(plan), plans=[plan])
        out["cold"] = dict(construct_ms=plan["rounds"][0]["wall_s"] * 1e3,
                           weights_seeded_init_ms=weights_s * 1e3)
        rids = _submit_all(je, _requests(cfg, 1, 0, seed=22, tag="c"))
        je.run_to_completion()
        _tokens(je, rids)
        _check_plane(je, _scaled(plan))
        assert je.engines[0].decode_steps > 0
    finally:
        je.close()
        del je
        _release()
    log("  ladder: " + json.dumps(out))
    return out


def fleet_fork_tree(cfg, dev):
    """rwkv6-1.6b: scale_to(8) from one TE in fork rounds of 1, 2 and 4
    (each round's wall, each fork's device time); then 8 requests,
    round-robin, one per TE. Returns the run and its WKV6 launches."""
    import torch
    from repro_torch.engine.distflow import _nbytes
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    w = _nbytes(params)
    _fits(7 * w + 8 * 2**30, "rwkv6 fork tree (8 TEs, 7 forked copies)")
    je = _plane(cfg, params, dev, "colo=1", torch.bfloat16,
                _heat(cfg, mixed=True), policy="round_robin")
    try:
        plan = je.scale_to(8)
        torch.cuda.synchronize()
        assert [len(r["tes"]) for r in plan["rounds"]] == [1, 2, 4], plan
        assert plan["tiers"]["fork"] == 7
        names = ["te-colo0"] + _scaled(plan)
        _check_plane(je, names, plans=[plan])
        forks = [_ev_ms(e.transfer_timing["fork"]) for e in je.engines[1:]]
        reqs = _requests(cfg, 6, 2, seed=23, tag="t")
        ops.reset_launches()
        rids = _submit_all(je, reqs)
        je.run_to_completion()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        _tokens(je, rids)
        _check_comps(je.completions, reqs, cfg)
        assert all(e.decode_steps > 0 for e in je.engines), \
            "a forked TE served nothing"
        _check_plane(je, names)
        per_te = _check_launches(je, cfg)
        assert all(v["wkv6"] > 0 for v in per_te.values()), per_te
        out = dict(model=cfg.name, weights_bytes=w,
                   rounds=[dict(tes=r["tes"], sources=r["sources"],
                                wall_ms=r["wall_s"] * 1e3)
                           for r in plan["rounds"]],
                   fork_device_ms=forks,
                   fork_gb_per_s=[w / ms / 1e6 for ms in forks],
                   fork_bound_ms=2 * w / HBM_BYTES_PER_S * 1e3,
                   launches=launches, launches_by_te=per_te)
        log("  fork tree: " + json.dumps(out))
        return out
    finally:
        je.close()
        del je, params
        _release()


def fleet_kill(cfg, params, dev, dtype, reqs, fault=True):
    """A colo=3 plane (round-robin) serves ``reqs``; with ``fault`` the
    FaultPlan(seed=7) victim crashes at its step 3, its memory returns
    (the plane drops it, measured right after the failing step), and the
    fleet is repaired by scale_to(3) from a survivor before the burst
    finishes. Returns (tokens in submission order, run record)."""
    import torch
    from repro_torch.core import FaultPlan, FaultSpec
    from repro_torch.engine.distflow import _nbytes
    fp, victim = None, None
    if fault:
        fp = FaultPlan(seed=7)
        victim = fp.choose_victim([f"te-colo{i}" for i in range(3)])
        fp.add(FaultSpec("te_crash", te=victim, at_step=3))
    je = _plane(cfg, params, dev, "colo=3", dtype, _heat(cfg, mixed=True),
                policy="round_robin", fault_plan=fp)
    out = {}
    names = [f"te-colo{i}" for i in range(3)]
    try:
        pool = je.engines[0].pool
        pool_bytes = _nbytes([pool.k, pool.v])
        del pool
        m0 = _allocated()
        rids = _submit_all(je, reqs)
        while je.has_work():
            je.step()
            assert je.steps < 3000, "the burst did not finish"
            if fault and "returned_bytes" not in out and any(
                    e["kind"] == "te_failure" for e in je.scale_events):
                out["returned_bytes"] = m0 - _allocated()
                out["pool_bytes"] = pool_bytes
                assert abs(out["returned_bytes"] - pool_bytes) \
                    <= 64 * MiB, out
                plan = je.scale_to(3)
                assert plan["tiers"]["fork"] == 1, plan
                names = [n for n in names if n != victim] + _scaled(plan)
                _check_plane(je, names, victim=victim, plans=[plan])
                out["repair"] = dict(tiers=plan["tiers"],
                                     sources=plan["rounds"][0]["sources"])
        toks = _tokens(je, rids)
        _check_plane(je, names, victim=victim)
        if fault:
            assert fp.fired("te_crash") == 1 and je.n_serving() == 3
            restarts = je.restart_counts()
            out.update(victim=victim, completed=len(toks), lost=0,
                       duplicated=len(je.completions) - len(toks),
                       restart_counts=[restarts.get(r, 0) for r in rids],
                       failure=[e for e in je.scale_events
                                if e["kind"] == "te_failure"][0]["error"])
        return toks, out
    finally:
        je.close()
        del je
        _release()


def fleet_drain(cfg, params, dev, dtype, reqs, drain=True):
    """A colo=2 plane (round-robin) serves ``reqs``; with ``drain`` te-colo1
    drains at the first plane step where it holds decodes in flight (they
    migrate out) and prefills queued (they restart on te-colo0), reaches
    RELEASED and returns its pool. Returns (tokens, run record)."""
    import torch
    from repro_torch.engine.distflow import _nbytes
    je = _plane(cfg, params, dev, "colo=2", dtype, _heat(cfg, mixed=True),
                policy="round_robin")
    out = {}
    try:
        pool = je.engines[1].pool
        out["pool_bytes"] = _nbytes([pool.k, pool.v])
        del pool
        m0 = _allocated()
        rids = _submit_all(je, reqs)
        if drain:
            victim = je.handles[1]
            eng = victim.engine
            # drain once the victim holds both decodes and queued prefills
            while not (eng.migratable_running()
                       and eng.scheduler.queued_seqs()):
                je.step()
                assert je.steps < 40, "no step with decodes and prefills"
            out["drain_at_step"] = je.steps
            out["decoding_at_drain"] = len(eng.migratable_running())
            out["queued_at_drain"] = len(eng.scheduler.queued_seqs())
            je.drain(victim.te_id)
        je.run_to_completion()
        toks = _tokens(je, rids)
        _check_plane(je, ["te-colo0"] if drain else ["te-colo0", "te-colo1"])
        if drain:
            assert victim.state.value == "released"
            out["migrations"] = len(eng.distflow.log)
            out["migrated_bytes"] = eng.distflow.bytes_moved()
            out["resubmits"] = len(je.resubmits)
            assert out["migrations"] and out["resubmits"], out
            del eng
            out["returned_bytes"] = m0 - _allocated()
            assert abs(out["returned_bytes"] - out["pool_bytes"]) \
                <= 64 * MiB, out
        return toks, out
    finally:
        je.close()
        del je
        _release()


# fp32 products of other shapes round differently (~1e-6 of a logit):
# two runs that batch a request with other requests may take either token
# of a top-2 pair closer than this
NEAR_TIE = 1e-4


def _greedy_gaps(cfg, params, dev, prompt, toks):
    """Teacher-forced ``forward`` over prompt + toks: per generated
    position, the argmax, the top-2 tokens and their logit gap."""
    import torch
    from repro_torch.models import transformer as T
    with torch.no_grad():
        lg = T.forward(cfg, params, torch.tensor([prompt + toks[:-1]],
                                                 device=dev))
    top2 = lg[0, len(prompt) - 1:, :cfg.vocab_size].topk(2, dim=-1)
    return (top2.indices.tolist(),
            (top2.values[:, 0] - top2.values[:, 1]).tolist())


def _greedy_run(cfg, params, dev, prompt, run, what):
    """Every token of ``run`` is the teacher-forced forward's greedy
    choice after its own prefix, or the other half of a near-tie (a top-2
    gap below ``NEAR_TIE``), at most one such near-tie taken in the run."""
    top2, gaps = _greedy_gaps(cfg, params, dev, prompt, run)
    for k, tok in enumerate(run):
        assert tok == top2[k][0] or (
            tok in top2[k] and gaps[k] < NEAR_TIE), \
            (what, k, tok, top2[k], gaps[k])
    taken = [k for k, tok in enumerate(run) if tok != top2[k][0]]
    assert len(taken) <= 1, (what, taken)


def _same_tokens(cfg, params, dev, reqs, a, b, what):
    """Runs ``a`` and ``b`` (tokens per request) give the same greedy
    tokens, except where a request's first difference falls on a near-tie
    (a top-2 gap below ``NEAR_TIE`` in the teacher-forced forward); such a
    request's tokens must then be the forward's greedy choice in both runs
    (``_greedy_run``). Returns the near-ties taken, each logged."""
    ties = []
    for i, (r, x, y) in enumerate(zip(reqs, a, b)):
        if x == y:
            continue
        j = next(k for k in range(len(x)) if x[k] != y[k])
        for run in (x, y):
            _greedy_run(cfg, params, dev, r.prompt_tokens, run, (what, i))
        ties.append(dict(request=i, token=j, tokens=(x[j], y[j]),
                         gap=_greedy_gaps(cfg, params, dev, r.prompt_tokens,
                                          x[:j + 1])[1][j]))
        log(f"  {what} parity: request {i} takes the other token of a "
            f"near-tie at token {j}: {x[j]} vs {y[j]}, top-2 gap "
            f"{ties[-1]['gap']:.3e} (< {NEAR_TIE:g})")
        assert ties[-1]["gap"] < NEAR_TIE, ties[-1]
    return ties


def fleet_parity(cfg, dev):
    """Full width cut to 2 layers, fp32, on the kernels: the threaded plane
    gives the serial plane's tokens and decisions exactly (the same
    batches); the seed-7 kill gives the no-fault run's tokens and the
    drained run the undrained run's, both up to near-ties (restarted and
    migrated requests run in other batches; ``_same_tokens``)."""
    import torch
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = T.init_params(cfg2, gen, torch.float32, dev)
    f32 = torch.float32
    runs = {}
    for threads in (0, 3):
        je = _plane(cfg2, params, dev, "pd=1,colo=1", f32,
                    _heat(cfg, mixed=True), fleet_threads=threads)
        try:
            rids = _submit_all(je, _requests(cfg2, 8, 0, seed=31, tag="x"))
            je.run_to_completion()
            _check_plane(je, PD_COLO)
            runs[threads] = (_tokens(je, rids), dict(je.scheduler.decisions))
        finally:
            je.close()
            del je
    assert runs[0] == runs[3], "threads changed tokens or decisions"
    assert runs[0][1]["pd_disagg"] and runs[0][1]["pd_colo"], runs[0][1]
    reqs = _requests(cfg2, 12, 0, seed=32, tag="k")
    clean, _ = fleet_kill(cfg2, params, dev, f32, reqs, fault=False)
    killed, kill = fleet_kill(cfg2, params, dev, f32, reqs)
    kill_ties = _same_tokens(cfg2, params, dev, reqs, clean, killed, "kill")
    reqs = _requests(cfg2, 12, 0, seed=33, tag="d")
    plain, _ = fleet_drain(cfg2, params, dev, f32, reqs, drain=False)
    drained, _ = fleet_drain(cfg2, params, dev, f32, reqs)
    drain_ties = _same_tokens(cfg2, params, dev, reqs, plain, drained,
                              "drain")
    log(f"  fleet parity {cfg.name} x2 layers fp32: threads {runs[0][1]} "
        f"identical; kill ({kill['victim']}, restarts "
        f"{sum(kill['restart_counts'])}): {12 - len(kill_ties)} of 12 "
        f"requests identical, near-ties {kill_ties}; drain: "
        f"{12 - len(drain_ties)} of 12 identical, near-ties {drain_ties}")
    del params
    _release()


def phase6(dev):
    """The fleet control plane on the card: serving through the plane
    (qwen3-8b pd=1,colo=1 under Algorithm 1 and round-robin, then three
    executor threads against serial stepping, in turns), the cold-start
    ladder (fork, warm, cold) and the rwkv6-1.6b fork tree, a seeded kill
    with recovery and a drain under load, then 2-layer fp32 parity for
    threads, kill and drain. Returns each kernel's launches on the fleet
    path, per (arch, kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.distflow import _nbytes
    from repro_torch.models import transformer as T
    qwen, rwkv = get_config("qwen3-8b"), get_config("rwkv6-1.6b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = T.init_params(qwen, gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    weights_s = time.monotonic() - t0
    w, pool = _nbytes(params), _pool_bytes(qwen, 2)
    heat = _heat(qwen)
    launches = {}
    log(f"phase 6: fleet serving ({qwen.name}, pd=1,colo=1, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    _fits(3 * pool + 2 * 2**30, "pd=1,colo=1 fleet on one weights tree")
    reqs = _requests(qwen, 8, 2, seed=0, tag="f")
    runs = [fleet_serve(qwen, params, dev, "dist_sched", 0, reqs, heat)]
    for threads in (0, 3, 3, 0):
        runs.append(fleet_serve(qwen, params, dev, "round_robin", threads,
                                reqs, heat))
    for name in ("flash_prefill", "paged_attention"):
        launches["qwen3-8b", name] = sum(r["launches"][name] for r in runs)
    log("  threads vs serial (round_robin, in turns): " + json.dumps(
        [dict(fleet_threads=r["fleet_threads"],
              output_tok_per_s=r["output_tok_per_s"],
              tpot_ms_mean=r["tpot_ms_mean"],
              ttft_ms_p50=r["ttft_ms_p50"]) for r in runs[1:]]))
    log(f"phase 6: cold-start ladder ({qwen.name}) "
        f"[{time.monotonic() - T0:.1f} s]")
    fleet_ladder(qwen, params, dev, weights_s)
    log(f"phase 6: seeded kill and recovery ({qwen.name}, colo=3) "
        f"[{time.monotonic() - T0:.1f} s]")
    _fits(w + 4 * pool + 2 * 2**30, "colo=3 fleet and its repair fork")
    greedy = _requests(qwen, 12, 0, seed=24, tag="k")
    _, kill = fleet_kill(qwen, params, dev, torch.bfloat16, greedy)
    log("  kill: " + json.dumps(kill))
    log(f"phase 6: drain under load ({qwen.name}, colo=2) "
        f"[{time.monotonic() - T0:.1f} s]")
    _, drain = fleet_drain(qwen, params, dev, torch.bfloat16,
                           _requests(qwen, 12, 0, seed=25, tag="d"))
    log("  drain: " + json.dumps(drain))
    del params
    _release()
    log(f"phase 6: fork tree ({rwkv.name}, 1 -> 8) "
        f"[{time.monotonic() - T0:.1f} s]")
    tree = fleet_fork_tree(rwkv, dev)
    launches["rwkv6-1.6b", "wkv6"] = tree["launches"]["wkv6"]
    log(f"phase 6: fleet parity ({qwen.name}, 2 layers, fp32) "
        f"[{time.monotonic() - T0:.1f} s]")
    fleet_parity(qwen, dev)
    launches["recurrentgemma-2b", "rglru"] = None
    return launches


# --------------------------------------------------------------------------
# phase 7: tensor parallelism (the paged family)
# --------------------------------------------------------------------------

# (arch, tp, greedy, sampled): qwen3-8b's attention and pool split at tp 2
# (H 16 / Hkv 4 per rank); granite-moe-3b-a800m's at tp 4 (H 6 / Hkv 2,
# G 3; d_expert 512 -> 128 per rank)
TP_SERVED = (("qwen3-8b", 2, 8, 2), ("granite-moe-3b-a800m", 4, 6, 2))
# the slot family at tp 2: rwkv6-1.6b's state splits its 32 heads (16 per
# rank), recurrentgemma-2b's RG-LRU its 2560 channels (1280 per rank; its
# 10 query / 1 KV heads replicate attention, whose cache splits the
# sequence); the cross towers split their heads and their sequence
SLOT_TP_SERVED = (("rwkv6-1.6b", 2, 6, 2), ("recurrentgemma-2b", 2, 6, 2))
CROSS_TP = 2


def rank_cfg(cfg, tp):
    """One rank's attention shape of ``cfg`` at ``tp``."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def rank_recurrence_cfg(cfg, tp):
    """One rank's recurrence shape of ``cfg`` at ``tp``: rwkv6's heads
    (d_model / head_dim of them) or the RG-LRU width, cut ``tp`` ways."""
    if cfg.rwkv is not None:
        return dataclasses.replace(cfg, d_model=cfg.d_model // tp)
    return dataclasses.replace(cfg, rglru=dataclasses.replace(
        cfg.rglru, lru_width=cfg.rglru.lru_width // tp))


def tp_rows(dev):
    """Both attention kernels at one rank's shape of each TP_SERVED arch,
    and both recurrences at one rank's shape of each SLOT_TP_SERVED arch,
    timed and held against their plain versions as phase 2 holds the main
    path; each row names its arch and width."""
    from repro_torch.configs import get_config
    rows = []
    for name, tp, _, _ in TP_SERVED:
        cfg = rank_cfg(get_config(name), tp)
        for r in (main_path_decode(cfg, dev, seed=14, arch_row=True),
                  main_path_prefill(cfg, dev, seed=15, arch_row=True)):
            r["arch"] = f"{name} tp{tp}"
            rows.append(r)
    for name, tp, _, _ in SLOT_TP_SERVED:
        cfg = rank_recurrence_cfg(get_config(name), tp)
        r = (main_path_wkv6 if cfg.rwkv is not None else
             main_path_rglru)(cfg, dev)
        r["arch"] = f"{name} tp{tp}"
        rows.append(r)
    return rows


def _decode_logits(te, prompt):
    """The logits of one decode pass per position of ``prompt`` through
    ``te``'s runner, on pages (a slot) taken and given back: the raw
    numbers the engine samples from."""
    import torch
    from repro_torch.engine.kv_cache import pages_needed
    if te.pool is None:
        return _slot_decode_logits(te, prompt)
    pages = te.pool.alloc(pages_needed(len(prompt), te.pool.page_size))
    bt = torch.tensor([pages], dtype=torch.int32, device=te.device)
    out = []
    with torch.no_grad():
        for i, t in enumerate(prompt):
            out.append(te.runner.decoder.body(
                torch.tensor([t], dtype=torch.int32, device=te.device), bt,
                torch.tensor([i + 1], dtype=torch.int32, device=te.device)))
    te.pool.release(pages)
    return torch.cat(out)


def _slot_decode_logits(te, prompt):
    """``_decode_logits`` on a slot TE: one all-slot decode step per
    position, the row of a slot taken and given back."""
    import torch
    from repro_torch.engine.runners import SequenceState
    from repro_torch.models import serving as S
    rt = te.runner
    seq = SequenceState(seq_id="logits", tokens=list(prompt),
                        n_prompt=len(prompt))
    assert rt.alloc_slot(seq)
    out = []
    with torch.no_grad():
        for t in prompt:
            toks = torch.zeros((rt.n_slots,), dtype=torch.int64,
                               device=te.device)
            toks[seq.slot] = t
            logits, _ = S.decode_step(te.cfg, rt.params, toks, rt.caches,
                                      rt.mesh, impl=rt.impl)
            out.append(logits[seq.slot:seq.slot + 1])
    rt.free_slot(seq)
    return torch.cat(out)


def tp_parity(cfg, dev, n_layers=2, tps=(2, 16)):
    """Full width cut to ``n_layers`` layers, fp32: the tp-2 TE on the
    kernels gives the tp-2 TE on the plain versions' greedy tokens
    exactly; the TEs at ``tps`` (qwen3-8b at tp 16: Hkv 8 does not split
    16 ways, so attention and the pool replicate, the FFN and the vocab
    still split) give the tp-1 TE's tokens up to near-ties
    (``_same_tokens``). The largest logit difference against tp 1 over
    one prompt's decode passes is printed."""
    import torch
    from repro_torch.engine import FlowServe
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = T.init_params(cfg2, gen, torch.float32, dev)
    reqs = _requests(cfg2, 4, 0, seed=41, tag="t")
    toks, logits = {}, {}
    for tp, impl in ((1, "auto"), (2, "ref"),
                     *((t, "auto") for t in tps)):
        te = FlowServe(cfg2, params, _engine_config(cfg2, torch.float32,
                                                    impl, tp=tp), device=dev)
        if impl == "auto":
            logits[tp] = _decode_logits(te, reqs[0].prompt_tokens[:64])
        for r in _requests(cfg2, 4, 0, seed=41, tag="t"):
            te.add_request(r)
        got = {c.req_id: c.tokens for c in te.run_to_completion()}
        toks[tp, impl] = [got[r.req_id] for r in reqs]
        del te
        _release()
    assert toks[2, "auto"] == toks[2, "ref"], \
        "tp 2: the kernel and plain paths differ"
    out = {"kernel_vs_plain_tp2_identical": True}
    for tp in tps:
        d = float((logits[tp] - logits[1]).abs().max())
        ties = _same_tokens(cfg2, params, dev, reqs, toks[1, "auto"],
                            toks[tp, "auto"], f"tp {tp} vs tp 1")
        out[f"tp{tp}_vs_tp1"] = dict(
            identical=toks[tp, "auto"] == toks[1, "auto"],
            near_ties=ties, max_logit_diff=d)
    log(f"  tp parity {cfg.name} x{n_layers} layers fp32: " + json.dumps(out))
    del params
    _release()
    return out


def tp_fork(cfg, params, dev):
    """``FlowServe.fork_from`` a tp-2 TE onto a new tp-2 TE: every shard
    bit-equal to the source's, in new storage; the copies' device time by
    CUDA events against 2 x bytes / HBM rate."""
    import torch
    from repro_torch.engine import FlowServe
    from repro_torch.engine.distflow import _nbytes, tree_leaves
    ecfg = _engine_config(cfg, torch.bfloat16, tp=2)
    src = FlowServe(cfg, params, ecfg, name="tp-src", device=dev)
    torch.cuda.synchronize()
    fork = FlowServe.fork_from(src, ecfg, name="tp-fork")
    torch.cuda.synchronize()
    src_ptrs = {t.data_ptr() for t in tree_leaves(src.runner.params)}
    for r in range(2):
        a = tree_leaves(src.runner.params[r])
        b = tree_leaves(fork.runner.params[r])
        assert len(a) == len(b) and all(
            torch.equal(x, y) and y.data_ptr() not in src_ptrs
            for x, y in zip(a, b)), f"rank {r}'s forked shards differ"
    nbytes = _nbytes(fork.runner.params)
    ms = _ev_ms(fork.transfer_timing["fork"])
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(fork_ms=ms, fork_bytes=nbytes, fork_bound_ms=bound,
               fork_gb_per_s=nbytes / ms / 1e6, bound_over_fork=bound / ms,
               shards_bit_equal_new_storage=True, card=card_line())
    log("  tp fork: " + json.dumps(out))
    del src, fork
    _release()
    return out


def tp_plane(cfg, dev):
    """``ServingJobEngine`` over ``TopologySpec(pd=1, colo=1, tp=2)``: three
    tp-2 TEs, whose shards are views of the plane's one weights tree,
    sized from ``mem_get_info`` first (the depth cut, if the full model
    does not fit, is printed), serve the phase-3 requests round-robin."""
    import torch
    from repro_torch.engine.distflow import _nbytes
    from repro_torch.models import transformer as T
    _release()
    free, _ = torch.cuda.mem_get_info()
    layers = cfg.n_layers
    while True:
        c = dataclasses.replace(cfg, n_layers=layers)
        w = _nbytes(T.init_params(c, torch.Generator(), torch.bfloat16,
                                  "meta"))
        need = w + 3 * _pool_bytes(c, 2) + 4 * 2**30
        if need <= free or layers == 1:
            break
        layers -= 1
    cut = "" if layers == cfg.n_layers else \
        f" (depth cut from {cfg.n_layers}: the fleet does not fit)"
    log(f"  tp plane: {layers} layers{cut}; the weights tree and 3 tp-2 "
        f"TEs' pools need ~{need / 2**30:.1f} GiB of {free / 2**30:.1f} "
        f"free")
    assert need <= free, "the tp-2 plane does not fit the card"
    c = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(c, gen, torch.bfloat16, dev)
    out = fleet_serve(c, params, dev, "round_robin", 0,
                      _requests(c, 8, 2, seed=0, tag="p"), _heat(cfg),
                      topo="pd=1,colo=1,tp=2")
    out["layers"], out["full_layers"] = layers, cfg.n_layers
    del params
    _release()
    return out


def phase7(dev):
    """Tensor parallelism on the card. The paged family: the attention
    kernels at one rank's shapes; qwen3-8b at tp 2 and granite-moe-3b-a800m
    at tp 4 serving at full width (launches: n_layers x tp per decode
    iteration and per prefill pass); fp32 parity at 2 layers (kernel vs
    plain at tp 2 exactly; tp 2 and tp 16 vs tp 1 up to near-ties); a
    qwen3-8b PD pair from tp 4 to tp 2 at full width (the migrated run
    bit-identical after the import lands, one migration's device time)
    and its 2-layer fp32 tokens against a colocated tp-2 TE; a fork onto
    tp 2; the plane at tp 2. Then the slot family (``slot_tp``), with
    both recurrences at one rank's shape among the rows. Returns the
    per-rank kernel rows and each kernel's launches on this path, per
    (arch, kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    log(f"phase 7: attention kernels and recurrences at one rank's shape "
        f"[{time.monotonic() - T0:.1f} s]")
    rows = tp_rows(dev)
    launches = {}
    for name, tp, n_greedy, n_sampled in TP_SERVED:
        cfg = get_config(name)
        log(f"phase 7: full-width serving ({name}, tp {tp}, {cfg.n_layers} "
            f"layers, bf16) [{time.monotonic() - T0:.1f} s]")
        out = serve(cfg, dev, n_greedy, n_sampled, tp=tp)
        # at full width both archs' attention splits (granite: 24 / 8 heads)
        assert out["attention_ranks"] == tp, out["attention_ranks"]
        assert out["paged_attention_per_decode_iteration"] \
            == out["flash_prefill_per_prefill_pass"] == cfg.n_layers * tp
        for k in PAGED:
            launches[name, k] = out["launches"][k]
        for r in rows:
            if r["arch"] == f"{name} tp{tp}":
                r["launches"] = out["launches"][r["name"]]
    qwen = get_config("qwen3-8b")
    log(f"phase 7: tp parity ({qwen.name}, 2 layers, fp32) "
        f"[{time.monotonic() - T0:.1f} s]")
    tp_parity(qwen, dev)
    log(f"phase 7: PD tp 4 -> tp 2 ({qwen.name}, full width, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(qwen, gen, torch.bfloat16, dev)
    pd = serve_pd(qwen, params, dev, 8, 2, tp=(4, 2))
    assert pd["check_run_bit_identical"]
    for k, te in (("flash_prefill", "launches_prefill_te"),
                  ("paged_attention", "launches_decode_te")):
        launches["qwen3-8b", k] += pd[te][k]
    log(f"phase 7: fork onto tp 2 ({qwen.name}, full width, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    tp_fork(qwen, params, dev)
    del params
    _release()
    log(f"phase 7: PD tp 4 -> tp 2 vs colocated tp 2 ({qwen.name}, 2 "
        f"layers, fp32) [{time.monotonic() - T0:.1f} s]")
    pd_parity(qwen, dev, 2, tp=(4, 2))
    log(f"phase 7: serving plane pd=1,colo=1,tp=2 ({qwen.name}, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    plane = tp_plane(qwen, dev)
    for k in PAGED:
        launches["qwen3-8b", k] += plane["launches"][k]
    slot_tp(dev, rows, launches)
    return rows, launches


def slot_tp(dev, rows, launches):
    """Phase 7's slot family: rwkv6-1.6b and recurrentgemma-2b at tp 2
    serving at full width (each decode step and prefill dispatch launching
    the recurrence n_layers x tp times), the cross towers at tp 2 at full
    width and depth, 2- and 3-layer fp32 parity, an rwkv6 PD pair from tp
    2 to tp 1 at full width (the migrated state bit-identical, one
    migration's device time) and a fork onto tp 2. Adds each kernel's
    launches on these paths to ``launches`` and to its per-rank row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    for name, tp, n_greedy, n_sampled in SLOT_TP_SERVED:
        cfg = get_config(name)
        log(f"phase 7: full-width serving ({name}, tp {tp}, {cfg.n_layers} "
            f"layers, bf16) [{time.monotonic() - T0:.1f} s]")
        out = serve(cfg, dev, n_greedy, n_sampled, tp=tp)
        (k,) = PATH_KERNELS[name]
        n_kind = sum(kind == ("rwkv" if k == "wkv6" else "rglru")
                     for kind in cfg.layer_kinds())
        assert out["kernel_ranks"] == tp, out["kernel_ranks"]
        assert out[f"{k}_per_decode_step"] == n_kind * tp \
            == out[f"{k}_per_prefill_dispatch"], out
        launches[name, k] = out["launches"][k]
        for r in rows:
            if r["arch"] == f"{name} tp{tp}":
                r["launches"] = out["launches"][k]
    for name in CROSS_ARCHS:
        cfg = get_config(name)
        log(f"phase 7: full-width serving ({name}, tp {CROSS_TP}, "
            f"{cfg.n_layers} layers, bf16) [{time.monotonic() - T0:.1f} s]")
        serve(cfg, dev, 6, 2, tp=CROSS_TP)
    rwkv, rgemma = get_config("rwkv6-1.6b"), get_config("recurrentgemma-2b")
    for cfg, n_layers in ((rwkv, 2), (rgemma, 3)):
        log(f"phase 7: tp parity ({cfg.name}, {n_layers} layers, fp32) "
            f"[{time.monotonic() - T0:.1f} s]")
        tp_parity(cfg, dev, n_layers, tps=(2,))
    log(f"phase 7: PD tp 2 -> tp 1 ({rwkv.name}, full width, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(rwkv, gen, torch.bfloat16, dev)
    pd = serve_pd(rwkv, params, dev, 6, 2, tp=(2, 1))
    assert pd["check_state_bit_identical"]
    launches["rwkv6-1.6b", "wkv6"] += (pd["launches_prefill_te"]["wkv6"]
                                       + pd["launches_decode_te"]["wkv6"])
    log(f"phase 7: fork onto tp 2 ({rwkv.name}, full width, bf16) "
        f"[{time.monotonic() - T0:.1f} s]")
    tp_fork(rwkv, params, dev)
    del params
    _release()


# --------------------------------------------------------------------------
# phase 8: fine-tune jobs
# --------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH = 256, 8
# qwen3-8b's depth cut: 12 bytes a param (bf16 weights and grads, fp32 m
# and v) over 193 M a layer and 1.24 B of embed + head: 8 of 36 layers are
# 2.8 B params, ~33.5 GB before activations and the update's temporaries
TRAIN_CUT = {"qwen3-8b": 8}
TRAIN_RUNS = (("qwen3-8b", 10), ("rwkv6-1.6b", 3), ("recurrentgemma-2b", 3))
CKPT_LAYERS = 1                 # rwkv6-1.6b: ~3.9 GB of train state on disk


def _grad_calls(dev):
    """One call of each launcher entry (through ``ops``) on CUDA inputs
    whose floating tensors require grad."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)

    def f(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dev, dtype) \
            .requires_grad_()
    i32 = dict(dtype=torch.int32, device=dev)
    pages = (f(4, 16, 2, 64), f(4, 16, 2, 64))
    return {
        "paged_attention": lambda: ops.paged_attention(
            f(2, 4, 64), *pages, torch.zeros((2, 2), **i32),
            torch.ones((2,), **i32)),
        "flash_prefill (paged)": lambda: ops.paged_prefill(
            f(8, 4, 64), *pages, torch.tensor([0, 8], **i32),
            torch.zeros((1, 1), **i32), torch.zeros((1,), **i32),
            torch.from_numpy(FP.build_tiles([0, 8], 8)).to(dev)),
        "flash_prefill (dense)": lambda: ops.flash_prefill(
            f(1, 16, 4, 64), f(1, 16, 2, 64), f(1, 16, 2, 64)),
        "wkv6": lambda: ops.wkv6(
            f(1, 4, 2, 64), f(1, 4, 2, 64), f(1, 4, 2, 64),
            torch.from_numpy(np.full((1, 4, 2, 64), 0.9, np.float32))
            .to(dev, torch.bfloat16).requires_grad_(),
            f(2, 64, dtype=torch.float32),
            torch.zeros((1, 2, 64, 64), device=dev)),
        "rglru": lambda: ops.rglru(f(1, 4, 64, dtype=torch.float32),
                                   f(1, 4, 64, dtype=torch.float32),
                                   torch.zeros((1, 64), device=dev)),
    }


def _smoke_batch(cfg, dev, seq=16, batch=2, seed=0):
    """The packed corpus's first batch for ``cfg``, as tensors on dev."""
    import torch
    from repro_torch.data import DataConfig, PackedDataset
    ds = PackedDataset(DataConfig(seq_len=seq, batch_size=batch, n_docs=64,
                                  seed=seed))
    return [torch.from_numpy(a).to(dev) for a in next(ds.batches())]


def train_guard(dev):
    """Each launcher refuses CUDA inputs that require grad, its count
    unmoved; a forward on the kernels (impl "auto") under autograd raises
    on the recurrent towers, and the same loss on the plain versions
    (impl "ref") gives finite gradients."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model_factory import cross_entropy, get_model
    from repro_torch.training import tree as TR
    from repro_torch.training.train_loop import value_and_grad
    for name, call in _grad_calls(dev).items():
        before = ops.launch_counts()
        try:
            call()
        except RuntimeError as e:
            assert "no backward" in str(e), e
        else:
            raise AssertionError(f"{name} launched under autograd")
        assert ops.launch_counts() == before, name
        log(f"  {name}: refuses autograd, no launch counted")
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        b = get_model(arch, smoke=True)
        params = b.init_params(torch.Generator(device=dev).manual_seed(0),
                               torch.float32, dev)
        tokens, targets, mask = _smoke_batch(b.cfg, dev)

        def loss(impl):
            return lambda ps, t, y, m: cross_entropy(
                b.forward(b.cfg, ps, t, impl=impl, remat=True), y, m,
                b.cfg.vocab_size)
        before = ops.launch_counts()
        try:
            value_and_grad(loss("auto"), params, tokens, targets, mask)
        except RuntimeError as e:
            assert "no backward" in str(e), e
        else:
            raise AssertionError(f"{arch}: forward on the kernels ran "
                                 f"under autograd")
        assert ops.launch_counts() == before
        lv, grads = value_and_grad(loss("ref"), params, tokens, targets,
                                   mask)
        assert torch.isfinite(lv) and all(
            torch.isfinite(g).all() for g in TR.leaves(grads))
        log(f"  {arch}: forward(impl='auto') under autograd raises; "
            f"impl='ref' loss {float(lv):.4f}, finite grads")


def train_run(name, steps, dev):
    """``train()`` at full width in bf16, remat on, on packed batches of
    TRAIN_BATCH x TRAIN_SEQ at lr 1e-3 (2 warmup steps): every step's
    time by CUDA events (from one batch's fetch to the next), losses and
    grad norms from the log, peak memory, launches (none), and every leaf
    moved."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, PackedDataset
    from repro_torch.kernels import ops
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import (OptimizerConfig, TrainConfig, train)
    from repro_torch.training import tree as TR
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=TRAIN_CUT.get(name,
                                                           full.n_layers))
    n = cfg.param_count()
    need = 12 * n
    cut = "" if cfg.n_layers == full.n_layers else \
        f", depth cut from {full.n_layers}: 12 B a param (bf16 weights " \
        f"and grads, fp32 m and v) x {n / 1e9:.2f} B = {need / 1e9:.1f} GB " \
        f"before activations"
    log(f"phase 8: train {name} ({cfg.n_layers} layers{cut}; bf16, remat, "
        f"{steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ}) "
        f"[{time.monotonic() - T0:.1f} s]")
    _fits(need, f"{name} train state")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0),
                                torch.bfloat16, dev)
    ds = PackedDataset(DataConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  n_docs=2048))
    marks = []

    def batches():
        for b in ds.batches(epochs=100):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            yield b
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    new, stats = train(bundle, params, batches(),
                       TrainConfig(steps=steps, log_every=1,
                                   ckpt_every=10 ** 9,
                                   opt=OptimizerConfig(
                                       lr=1e-3, warmup_steps=2,
                                       total_steps=steps)),
                       log=lines.append)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert not any(launches.values()), f"a train step launched {launches}"
    marks.append(end)
    ms = [a.elapsed_time(b) for a, b in zip(marks[:steps],
                                            marks[1:steps + 1])]
    med = sorted(ms)[len(ms) // 2]
    losses = [float(s.split("loss=")[1].split()[0]) for s in lines]
    gnorms = [float(s.split("gnorm=")[1].split()[0]) for s in lines]
    assert len(losses) == steps and all(
        math.isfinite(x) for x in losses + gnorms), lines
    moved = [p for (p, a), b in zip(TR.flatten_with_paths(new),
                                    TR.leaves(params))
             if torch.equal(a, b)]
    assert not moved, f"{name}: leaves that did not move: {moved}"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = {"arch": name, "layers": cfg.n_layers, "params": n,
           "dtype": "bfloat16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": steps, "step_ms": ms, "step_ms_median": med,
           "tokens_per_s": tokens / (med / 1e3),
           "six_n_share_of_989tf": 6 * n * tokens / (med / 1e3) / BF16_FLOPS,
           "peak_gib": peak, "loss_first": stats["loss_first"],
           "loss_last": stats["loss_last"], "losses": losses,
           "grad_norms": gnorms, "launches": launches}
    log(f"  losses {losses}; grad norms {gnorms}")
    log(f"  step ms median {med:.1f} (all: "
        f"{', '.join(f'{x:.1f}' for x in ms)}); {row['tokens_per_s']:.0f} "
        f"tokens/s; 6*N*tokens/step = {row['six_n_share_of_989tf']:.3f} of "
        f"989 TFLOP/s; peak {peak:.2f} GiB; launches {launches}; every "
        f"leaf moved")
    del new, params
    _release()
    return row


def train_vs_cpu(dev):
    """The same smoke-width fp32 loss-and-grad (TF32 off) on the card and
    on the CPU, same weights and batch: loss within 1e-5 relative, grad
    norm within 1e-4 relative, each leaf within 1e-4 * max|g| + 1e-7."""
    import torch
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import optimizer as O
    from repro_torch.training import tree as TR
    from repro_torch.training.train_loop import make_loss_fn, value_and_grad
    cpu = torch.device("cpu")
    for arch in ("qwen3-8b", "rwkv6-1.6b", "recurrentgemma-2b"):
        b = get_model(arch, smoke=True)
        host = b.init_params(torch.Generator().manual_seed(0),
                             torch.float32, cpu)
        out = []
        for d in (cpu, dev):
            ps = TR.unflatten(host, [a.to(d) for a in TR.leaves(host)])
            lv, g = value_and_grad(make_loss_fn(b, True), ps,
                                   *_smoke_batch(b.cfg, d), {})
            out.append((float(lv), float(O.global_norm(g)),
                        [x.cpu() for x in TR.leaves(g)]))
        (l0, n0, g0), (l1, n1, g1) = out
        worst = max(float((a - c).abs().max())
                    / (1e-4 * float(c.abs().max()) + 1e-7)
                    for a, c in zip(g1, g0))
        log(f"  {arch} smoke: loss card {l1:.7f} cpu {l0:.7f}; grad norm "
            f"card {n1:.6f} cpu {n0:.6f}; worst leaf at {worst:.3f} of "
            f"its bound")
        assert abs(l1 - l0) <= 1e-5 * abs(l0) and abs(n1 - n0) <= 1e-4 * n0
        assert worst <= 1.0


def train_resume(dev):
    """Resume equivalence on the card (``tests/test_system.py``'s case,
    danube smoke): 8 steps straight against 4 + checkpoint + resume 4,
    params within atol 1e-5."""
    import tempfile
    import torch
    from repro_torch.data import DataConfig, PackedDataset
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      TrainConfig, train)
    from repro_torch.training import tree as TR
    b = get_model("h2o-danube-3-4b", smoke=True)
    p0 = b.init_params(torch.Generator(device=dev).manual_seed(0),
                       torch.float32, dev)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def data():
        return PackedDataset(DataConfig(seq_len=16, batch_size=2,
                                        n_docs=64)).batches(epochs=100)

    def tc(steps, every):
        return TrainConfig(steps=steps, log_every=100, ckpt_every=every,
                           opt=opt)
    quiet = lambda s: None  # noqa: E731
    full, _ = train(b, p0, data(), tc(8, 100), log=quiet)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        train(b, p0, data(), tc(4, 4), ckpt=ck, log=quiet)
        it = data()
        for _ in range(4):
            next(it)
        res, _ = train(b, p0, it, tc(8, 100), ckpt=ck, resume=True,
                       log=quiet)
    diff = max(float((x - y).abs().max())
               for x, y in zip(TR.leaves(full), TR.leaves(res)))
    log(f"  resume on the card (danube smoke, 8 vs 4 + resume 4): max param "
        f"difference {diff:.3e} (bound 1e-5)")
    assert diff <= 1e-5


def train_checkpoint(dev):
    """An async save of an rwkv6-1.6b train state at full width, cut to
    CKPT_LAYERS layers (params after one train step, and its optimizer
    state), restored onto the card: every leaf bit-equal; write and read
    seconds and GB/s (the read follows the write, so the page cache is
    warm). The directory is deleted."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      TrainConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training import tree as TR
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                              n_layers=CKPT_LAYERS)
    b = get_model(cfg)
    params = b.init_params(torch.Generator(device=dev).manual_seed(0),
                           torch.bfloat16, dev)
    step = make_train_step(b, TrainConfig(opt=OptimizerConfig(
        lr=1e-3, warmup_steps=0, total_steps=10)))
    params, opt, _ = step(params, init_opt_state(params),
                          *_smoke_batch(cfg, dev, seq=64), {})
    state = {"params": params, "opt": opt}
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = CheckpointManager(d)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ck.save(1, state, blocking=False)
        t_snap = time.monotonic() - t0
        ck.wait()
        t_write = time.monotonic() - t0
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(d) for f in fs)
        t0 = time.monotonic()
        got = ck.restore(state, device=dev)
        torch.cuda.synchronize()
        t_read = time.monotonic() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bad = [p for (p, a), c in zip(TR.flatten_with_paths(got),
                                  TR.leaves(state))
           if a.dtype != c.dtype or not torch.equal(a, c)]
    assert not bad, f"restored leaves differ: {bad}"
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "bytes_on_disk": on_disk,
           "snapshot_s": t_snap, "write_s": t_write,
           "write_gbps": on_disk / t_write / 1e9, "read_s": t_read,
           "read_gbps": on_disk / t_read / 1e9, "read_cache": "warm"}
    log(f"  checkpoint ({cfg.name}, {cfg.n_layers} layer(s), params + opt):"
        f" {on_disk / 1e9:.2f} GB on disk; async save {t_write:.2f} s "
        f"(host snapshot {t_snap:.2f} s), {row['write_gbps']:.2f} GB/s; "
        f"restore onto the card {t_read:.2f} s, {row['read_gbps']:.2f} GB/s "
        f"(warm page cache); every leaf bit-equal; directory deleted")
    del got, state, params, opt
    _release()
    return row


def phase8(dev):
    """Fine-tune jobs on the card: the launchers refuse autograd; qwen3-8b
    (depth cut), rwkv6-1.6b and recurrentgemma-2b train at full width in
    bf16 through ``train()`` with no kernel launched; the smoke train step
    on the card against the CPU's; resume equivalence; a checkpoint round
    trip. Returns {"runs": [...], "checkpoint": {...}}."""
    log(f"phase 8: train — the launchers refuse autograd "
        f"[{time.monotonic() - T0:.1f} s]")
    train_guard(dev)
    runs = [train_run(name, steps, dev) for name, steps in TRAIN_RUNS]
    q = runs[0]
    assert q["loss_last"] < q["loss_first"], \
        f"qwen3 loss did not fall: {q['losses']}"
    log(f"phase 8: train step card vs CPU, resume, checkpoint "
        f"[{time.monotonic() - T0:.1f} s]")
    train_vs_cpu(dev)
    train_resume(dev)
    return {"runs": runs, "checkpoint": train_checkpoint(dev)}


# --------------------------------------------------------------------------
# phase 9: the reference's long-context shapes
# --------------------------------------------------------------------------

# (a) the steps prefill on the kernel against the plain blockwise function:
# full width cut to 2 fp32 layers (gemma2's: one local, one global)
LONG_PARITY = (("qwen3-8b", 2), ("h2o-danube-3-4b", 2), ("gemma2-9b", 2))
LONG_PARITY_S = 8192
# fp32 logits and K/V of the two routes: the blockwise sums run in another
# order (|logit| up to ~30 under gemma2's final softcap)
LONG_ATOL, LONG_RTOL = 1e-4, 1e-5
# (b) prefill_32k at B 1 (the reference's 32 sequences: 32 x 4.83 GB of
# qwen3 K/V alone); (c) decode_32k at B 8 (128 sequences: 618 GB of KV)
PREFILL_S, PREFILL_ARCHS = 32768, ("qwen3-8b", "h2o-danube-3-4b")
DECODE_B, DECODE_STEPS, DECODE_PARITY_LAYERS = 8, 16, 2
# (d) long_500k at B 1; (e) train_4k: qwen3-8b at 8 of 36 layers (its 36
# with fp32 moments need 98 GB), 2 sequences of 4096 (the reference's 256)
LONG_S = 524288
TRAIN4K_ARCH, TRAIN4K_LAYERS, TRAIN4K_B, TRAIN4K_S = "qwen3-8b", 8, 2, 4096
# two microbatches of one sequence: the fp32 logits of 8192 tokens over
# qwen3's 152k vocab are 5 GB a copy, beside 33.5 GB of train state
TRAIN4K_STEPS, TRAIN4K_MICRO = 3, 2
WARM_S = 4096                   # a short call first: kernels, maps, plans


def _long_params(cfg, dev, dtype, seed=9):
    import torch
    from repro_torch.models import transformer as T
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dtype, dev)


def _long_tokens(cfg, b, s, dev, seed=9):
    import torch
    return torch.randint(3, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))


def _kv_bytes_per_token(cfg, layers=None, dtype_size=2):
    from repro_torch.models import serving as S
    la = S.attn_layer_count(cfg) if layers is None else layers
    return la * 2 * cfg.n_kv_heads * cfg.head_dim * dtype_size


def _launched():
    """The kernels launched since the last reset, with their counts."""
    from repro_torch.kernels import ops
    return {k: v for k, v in ops.launch_counts().items() if v}


def _timed_call(fn):
    """(result, host wall s, device ms by CUDA events) of one call."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.monotonic()
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, time.monotonic() - t, _ev_ms(ev)


def long_parity(name, n_layers, dev):
    """(a) the from-scratch prefill of ``launch/steps.py`` at
    LONG_PARITY_S tokens on the kernel (one ``flash_prefill`` launch per
    layer) and on the plain blockwise function: logits and every layer's
    K/V within LONG_ATOL + LONG_RTOL |plain|, the greedy next token
    equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    params = _long_params(cfg, dev, torch.float32)
    toks = _long_tokens(cfg, 1, LONG_PARITY_S, dev)
    with torch.no_grad():
        ops.reset_launches()
        lk, ck = ST.build_prefill_step(cfg)(params, toks, {})
        n = _launched()
        lr, cr = ST.build_prefill_step(cfg, impl="ref")(params, toks, {})
    assert n == {"flash_prefill": n_layers}, n
    tag = f"{name} x{n_layers} fp32 S {LONG_PARITY_S}"
    e = close(f"{tag} logits kernel vs plain", lk, lr, LONG_ATOL, LONG_RTOL)
    ekv = max(close(f"{tag} cache {k}", ck[k], cr[k], LONG_ATOL, LONG_RTOL)
              for k in ("k", "v"))
    v = cfg.vocab_size
    top2 = lr[0, :v].float().topk(2).values
    same = int(lk[0, :v].argmax()) == int(lr[0, :v].argmax())
    log(f"  {tag}: greedy next token kernel {int(lk[0, :v].argmax())} "
        f"plain {int(lr[0, :v].argmax())} identical={same} (top-2 gap "
        f"{float(top2[0] - top2[1]):.3e}); flash_prefill launches {n}")
    assert same, "kernel and plain prefill give other greedy tokens"
    del params, ck, cr
    _release()
    return {"arch": name, "layers": n_layers, "seq": LONG_PARITY_S,
            "max_abs_err_logits": e, "max_abs_err_kv": ekv,
            "greedy_identical": same, "launches": n}


def long_kernel_row(dev):
    """The dense ``flash_prefill`` entry at prefill_32k's attention shape
    (qwen3-8b: one sequence of PREFILL_S tokens, H 32 / Hkv 8, hd 128,
    bf16, causal): its time (CUDA events) against the plain blockwise
    function it replaces on this path (``layers.flash_attention``; the
    dense plain version's (S, S) scores would take 137 GB) and against
    one ``scaled_dot_product_attention`` call (causal, GQA), its largest
    error against the plain function, and the card's least time for the
    causal pairs' products."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    cfg = get_config("qwen3-8b")
    s, h, hkv, hd = PREFILL_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn((1, s, h, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, s, hkv, hd), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, device=dev)[None]
    with torch.no_grad():
        out = ops.flash_prefill(q, k, v)
        plain = L.flash_attention(q, k, v, pos, pos)
        e = check_main_path(f"flash_prefill dense S {s} vs plain blockwise",
                            out, plain, True)
        kernel_ms = time_ms(lambda: ops.flash_prefill(q, k, v), iters=5,
                            warmup=1)
        plain_ms = time_ms(lambda: L.flash_attention(q, k, v, pos, pos),
                           iters=1, warmup=0)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=5, warmup=1)
    nbytes = 2 * (2 * s * h * hd) + 2 * 2 * s * hkv * hd
    flops = 4 * h * hd * s * (s + 1) // 2
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    log(f"  flash_prefill dense at prefill_32k ({s} tokens, H {h} / Hkv "
        f"{hkv}, hd {hd}, bf16): kernel_ms {kernel_ms:.3f}; plain_ms "
        f"{plain_ms:.3f}; library_ms (SDPA) {library_ms:.3f}; bound_ms "
        f"{bound:.3f} ({by}); bound / kernel {bound / kernel_ms:.3f}")
    del q, k, v, out, plain
    _release()
    return {"name": "flash_prefill", "entry": "dense", "seq": s,
            "heads": [h, hkv], "head_dim": hd, "dtype": "bfloat16",
            "max_abs_err": e, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


# the other long shapes the dense entry's bf16 body runs at: danube's 32k
# layer whole; recurrentgemma's 524,288-token layer in row blocks of this
# many rows (the plain chunk scan over all its keys for every row would
# take 524,288^2 scores a head)
LONG_ROW_BLOCK = 1024
LONG_KERNEL_SHAPES = (("h2o-danube-3-4b", PREFILL_S),
                      ("recurrentgemma-2b", LONG_S))


def long_kernel_checks(dev):
    """The dense ``flash_prefill`` entry in bf16 (the ``wgmma`` body the
    long prefills launch) at the attention shapes of danube's prefill_32k
    (H 32 / Hkv 8, hd 120 padded to 128, window 4096: the whole output)
    and recurrentgemma's long_500k (H 10 / Hkv 1, hd 256, window 2048: row
    blocks at the start, across the first window's edge, in the middle
    and at the end, each against the plain blockwise function over its
    rows and the keys they see), at ``check_main_path``'s tolerance; the
    kernel's time at each shape (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    out = []
    for name, s in LONG_KERNEL_SHAPES:
        cfg = get_config(name)
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        win, cap = cfg.window, cfg.attn_logit_softcap
        g = torch.Generator(device=dev).manual_seed(23)
        q = torch.randn((1, s, h, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((1, s, hkv, hd), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        n = LONG_ROW_BLOCK
        blocks = [(0, s)] if s == PREFILL_S else [
            (0, n), (win - n // 2, win + n // 2),
            (s // 2 - n // 2, s // 2 + n // 2), (s - n, s)]
        tag = (f"flash_prefill dense {name} S {s} (H {h} / Hkv {hkv}, hd "
               f"{hd}, window {win}, softcap {cap}, bf16)")
        errs = []
        with torch.no_grad():
            got = ops.flash_prefill(q, k, v, cap, win)
            for a, b in blocks:
                lo = max(0, a - win + 1)
                want = L.flash_attention(
                    q[:, a:b], k[:, lo:b], v[:, lo:b],
                    torch.arange(a, b, device=dev)[None],
                    torch.arange(lo, b, device=dev)[None], win, cap)
                errs.append(check_main_path(
                    f"{tag} rows {a}..{b - 1} vs plain blockwise",
                    got[:, a:b], want, True))
                del want
            ms = time_ms(lambda: ops.flash_prefill(q, k, v, cap, win),
                         iters=3, warmup=1)
        log(f"  {tag}: {len(blocks)} row blocks agree; kernel_ms {ms:.3f}")
        out.append({"arch": name, "seq": s, "heads": [h, hkv],
                    "head_dim": hd, "window": win, "softcap": cap,
                    "row_blocks": blocks, "max_abs_err": max(errs),
                    "ms": ms})
        del q, k, v, got
        _release()
    return out


def prefill_32k(name, dev):
    """(b) prefill_32k through ``build_prefill_step`` at full width and
    depth, bf16, one sequence: host wall and device time, launches (one
    ``flash_prefill`` per layer and nothing else), peak memory and the
    stacked cache's bytes. Returns (row, params, logits, cache)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import serving as S
    cfg = get_config(name)
    params = _long_params(cfg, dev, torch.bfloat16)
    pre = ST.build_prefill_step(cfg)
    with torch.no_grad():
        pre(params, _long_tokens(cfg, 1, WARM_S, dev, seed=1), {})
        toks = _long_tokens(cfg, 1, PREFILL_S, dev)
        _release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        (logits, cache), wall, dev_ms = _timed_call(
            lambda: pre(params, toks, {}))
    launches = _launched()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    la = S.attn_layer_count(cfg)
    assert launches == {"flash_prefill": la}, launches
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    nbytes = cache["k"].nbytes + cache["v"].nbytes
    assert nbytes == PREFILL_S * _kv_bytes_per_token(cfg)
    row = {"arch": name, "layers": cfg.n_layers, "batch": 1,
           "seq": PREFILL_S, "dtype": "bfloat16", "wall_s": wall,
           "device_ms": dev_ms, "tokens_per_s": PREFILL_S / wall,
           "launches": launches, "peak_gib": peak, "cache_bytes": nbytes,
           "cache_bytes_per_token": nbytes // PREFILL_S}
    log(f"  prefill_32k {name}: {cfg.n_layers} layers x {PREFILL_S} tokens "
        f"in {wall * 1e3:.1f} ms wall, {dev_ms:.1f} ms device; "
        f"launches {launches} (= {la} attention layers); peak "
        f"{peak:.2f} GiB; cache {nbytes / 1e9:.2f} GB "
        f"({nbytes // PREFILL_S} B a token)")
    return row, params, logits, cache


def _fill_decode(cfg, cache, b, steps, dev):
    """A decode cache of ``b`` rows with room for ``steps`` tokens past the
    prefill's S, every row holding the one prefilled sequence's K/V."""
    import torch
    from repro_torch.launch.mesh import one_rank
    from repro_torch.models import serving as S
    s = cache["k"].shape[2]
    dc, = S.init_cache(cfg, b, s + steps, cache["k"].dtype, one_rank(dev))
    for key in ("k", "v"):
        dc[key][:, :, :s] = cache[key]          # broadcast over the rows
    dc["length"].fill_(s)
    return dc


def _first_tokens(cfg, logits, b, dev):
    """Row 0 decodes the prefill's greedy token, the other rows seeded
    random ones, so the rows' sequences part."""
    import torch
    tok = _long_tokens(cfg, 1, b, dev, seed=13)[0]
    tok[0] = logits[0, :cfg.vocab_size].argmax()
    return tok


def decode_32k(cfg, params, logits, cache, dev):
    """(c) decode_32k at full width and depth in bf16: DECODE_B rows each
    holding the 32k prefill's K/V, DECODE_STEPS greedy steps through
    ``build_decode_step`` (plain masked attention over the dense cache:
    no kernel launched); each step's device time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    dc = _fill_decode(cfg, cache, DECODE_B, DECODE_STEPS, dev)
    del cache
    _release()
    dec = ST.build_decode_step(cfg)
    tok = _first_tokens(cfg, logits, DECODE_B, dev)
    ms, toks = [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.no_grad():
        for _ in range(DECODE_STEPS):
            (lg, dc), _, d = _timed_call(lambda: dec(params, tok, dc))
            tok = lg[:, :cfg.vocab_size].argmax(-1)
            ms.append(d)
            toks.append(tok.tolist())
    launches = _launched()
    assert not any(launches.values()), launches
    assert all(0 <= t < cfg.vocab_size for row in toks for t in row)
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    kv = dc["k"].nbytes + dc["v"].nbytes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  decode_32k {cfg.name}: B {DECODE_B} x {DECODE_STEPS} greedy "
        f"steps over {PREFILL_S} + n tokens: step ms median {med:.2f} "
        f"(first {ms[0]:.2f}); KV {kv / 1e9:.1f} GB read a step "
        f"({kv / (med / 1e3) / 1e12:.2f} TB/s); peak {peak:.2f} GiB; "
        f"launches {launches}")
    del dc
    _release()
    return {"arch": cfg.name, "batch": DECODE_B, "context": PREFILL_S,
            "steps": DECODE_STEPS, "step_ms": ms, "step_ms_median": med,
            "kv_bytes": kv, "peak_gib": peak, "tokens_row0": [
                t[0] for t in toks]}


def decode_parity(name, dev):
    """(c) the tokens of the decode_32k chain against the plain path's, at
    full width cut to DECODE_PARITY_LAYERS fp32 layers: the 32k prefill
    on the kernel and on the plain blockwise function, each cache placed
    in DECODE_B rows, then DECODE_STEPS greedy steps each; every row's
    tokens identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    cfg = dataclasses.replace(get_config(name),
                              n_layers=DECODE_PARITY_LAYERS)
    params = _long_params(cfg, dev, torch.float32)
    toks = _long_tokens(cfg, 1, PREFILL_S, dev)
    dec = ST.build_decode_step(cfg)
    got, last = {}, {}
    with torch.no_grad():
        for impl in ("auto", "ref"):
            lg, cache = ST.build_prefill_step(cfg, impl=impl)(params, toks,
                                                               {})
            dc = _fill_decode(cfg, cache, DECODE_B, DECODE_STEPS, dev)
            del cache
            tok = _first_tokens(cfg, lg, DECODE_B, dev)
            seq = []
            for _ in range(DECODE_STEPS):
                lg, dc = dec(params, tok, dc)
                tok = lg[:, :cfg.vocab_size].argmax(-1)
                seq.append(tok.tolist())
            got[impl], last[impl] = seq, lg
            del dc
            _release()
    same = got["auto"] == got["ref"]
    d = float((last["auto"] - last["ref"]).abs().max())
    log(f"  decode_32k parity {name} x{DECODE_PARITY_LAYERS} fp32: "
        f"{DECODE_B} rows x {DECODE_STEPS} greedy tokens after the kernel "
        f"prefill and after the plain one identical={same} (last step's "
        f"largest logit difference {d:.3e})")
    assert same, "decode after the kernel prefill differs from the plain"
    del params
    _release()
    return {"arch": name, "layers": DECODE_PARITY_LAYERS,
            "identical": same, "max_logit_diff_last": d}


def _greedy_or_tie(ref_logits, other_logits, vocab):
    """The other run's greedy token equals the reference run's, or both
    are the reference's top two within one bf16 step of its largest logit
    (bf16 logits tie there). Returns the near-tie's gap, or None."""
    r = ref_logits[:vocab].float()
    o = int(other_logits[:vocab].argmax())
    top = r.topk(2)
    if o == int(top.indices[0]):
        return None
    gap = float(top.values[0] - top.values[1])
    assert o == int(top.indices[1]) and \
        gap <= abs(float(top.values[0])) * 2.0 ** -7, (o, top, gap)
    return gap


def long_500k_rwkv(dev):
    """(d) rwkv6-1.6b: a LONG_S-token prefill from scratch through the
    rwkv builder (24 WKV6 launches), then DECODE_STEPS greedy steps on
    its state (24 each)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    cfg = get_config("rwkv6-1.6b")
    params = _long_params(cfg, dev, torch.bfloat16)
    pre, dec = ST.build_prefill_step(cfg), ST.build_decode_step(cfg)
    with torch.no_grad():
        pre(params, _long_tokens(cfg, 1, WARM_S, dev, seed=1), {})
        toks = _long_tokens(cfg, 1, LONG_S, dev)
        _release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        (lg, cache), wall, dev_ms = _timed_call(
            lambda: pre(params, toks, {}))
        n_pre = _launched()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del toks
        assert n_pre == {"wkv6": cfg.n_layers}, n_pre
        state = sum(cache[k].nbytes for k in ("state", "last_tm", "last_cm"))
        ops.reset_launches()
        tok, ms, seq = lg[:, :cfg.vocab_size].argmax(-1), [], []
        for _ in range(DECODE_STEPS):
            (lg, cache), _, d = _timed_call(lambda: dec(params, tok, cache))
            tok = lg[:, :cfg.vocab_size].argmax(-1)
            ms.append(d)
            seq.append(int(tok[0]))
        n_dec = _launched()
    assert n_dec == {"wkv6": cfg.n_layers * DECODE_STEPS}, n_dec
    assert bool(torch.isfinite(lg).all()) and int(cache["length"][0]) == \
        LONG_S + DECODE_STEPS
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"  long_500k rwkv6-1.6b: prefill {LONG_S} tokens in "
        f"{wall * 1e3:.1f} ms wall, {dev_ms:.1f} ms device, peak "
        f"{peak:.2f} GiB, launches {n_pre}; state {state / 1e6:.2f} MB; "
        f"{DECODE_STEPS} greedy steps at context {LONG_S}: step ms median "
        f"{med:.2f}, launches {n_dec}; tokens {seq}")
    del params, cache
    _release()
    return {"arch": cfg.name, "seq": LONG_S, "prefill_wall_s": wall,
            "prefill_device_ms": dev_ms, "peak_gib": peak,
            "launches_prefill": n_pre, "launches_decode": n_dec,
            "state_bytes": state, "decode_step_ms": ms,
            "decode_step_ms_median": med, "tokens": seq}


def long_500k_hybrid(dev):
    """(d) recurrentgemma-2b: a LONG_S-token prefill from scratch (18
    RG-LRU launches, its 8 local attention layers through
    ``flash_prefill`` at window 2048), the last ring_len positions placed
    at slot t mod ring_len of a ring cache and all of them in a linear
    cache with room; DECODE_STEPS greedy steps on the ring, the linear
    cache fed the same tokens: its greedy token equal at every step (up
    to a bf16 tie, each logged)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import serving as S
    cfg = get_config("recurrentgemma-2b")
    params = _long_params(cfg, dev, torch.bfloat16)
    pre, dec = ST.build_prefill_step(cfg), ST.build_decode_step(cfg)
    la = S.attn_layer_count(cfg)
    with torch.no_grad():
        pre(params, _long_tokens(cfg, 1, WARM_S, dev, seed=1), {})
        toks = _long_tokens(cfg, 1, LONG_S, dev)
        _release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        (lg, cache), wall, dev_ms = _timed_call(
            lambda: pre(params, toks, {}))
        n_pre = _launched()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del toks
        assert n_pre == {"rglru": cfg.n_layers - la, "flash_prefill": la}, \
            n_pre
        ring = ST.decode_cache(cfg, cache, LONG_S + DECODE_STEPS, ring=True)
        lin = ST.decode_cache(cfg, cache, LONG_S + DECODE_STEPS)
        del cache
        _release()
        rb, lb = (c["k"].nbytes + c["v"].nbytes for c in (ring, lin))
        ops.reset_launches()
        tok, ms, seq, ties = lg[:, :cfg.vocab_size].argmax(-1), [], [], []
        for i in range(DECODE_STEPS):
            (lr, ring), _, d = _timed_call(lambda: dec(params, tok, ring))
            (ll, lin), _, d_lin = _timed_call(lambda: dec(params, tok, lin))
            gap = _greedy_or_tie(lr[0], ll[0], cfg.vocab_size)
            if gap is not None:
                ties.append({"step": i, "gap": gap})
                log(f"  step {i}: the linear cache's greedy token is the "
                    f"ring's second, a bf16 tie (gap {gap:.3e})")
            tok = lr[:, :cfg.vocab_size].argmax(-1)
            ms.append((d, d_lin))
            seq.append(int(tok[0]))
        n_dec = _launched()
    assert n_dec == {"rglru": 2 * (cfg.n_layers - la) * DECODE_STEPS}, n_dec
    assert ring["k"].shape[2] == S.ring_len(cfg) and \
        int(ring["length"][0]) == LONG_S + DECODE_STEPS
    assert len(ties) <= 1, ties
    med = sorted(m[0] for m in ms[1:])[len(ms[1:]) // 2]
    med_lin = sorted(m[1] for m in ms[1:])[len(ms[1:]) // 2]
    log(f"  long_500k recurrentgemma-2b: prefill {LONG_S} tokens in "
        f"{wall * 1e3:.1f} ms wall, {dev_ms:.1f} ms device, peak "
        f"{peak:.2f} GiB, launches {n_pre}; ring of {S.ring_len(cfg)} "
        f"slots {rb / 1e6:.1f} MB vs linear {lb / 1e9:.2f} GB; "
        f"{DECODE_STEPS} greedy steps: ring step ms median {med:.2f}, "
        f"linear {med_lin:.2f}; tokens equal the linear cache's "
        f"(near-ties {ties}); launches {n_dec}")
    del params, ring, lin
    _release()
    return {"arch": cfg.name, "seq": LONG_S, "prefill_wall_s": wall,
            "prefill_device_ms": dev_ms, "peak_gib": peak,
            "launches_prefill": n_pre, "launches_decode": n_dec,
            "ring_slots": S.ring_len(cfg), "ring_kv_bytes": rb,
            "linear_kv_bytes": lb, "decode_step_ms_ring": [m[0] for m in ms],
            "decode_step_ms_linear": [m[1] for m in ms],
            "decode_step_ms_median_ring": med,
            "decode_step_ms_median_linear": med_lin, "tokens": seq,
            "near_ties": ties}


def long_500k_skipped():
    """(d) the windowed archs long_500k is not run for on one card, each
    with the bytes that keep it off (computed from the configs): gemma2's
    global layers' cache; mixtral's MoE dispatch, whose capacity rows
    (tokens x top-k x capacity factor) hold a (rows, d_expert) bf16 tensor
    per up / gate projection."""
    from repro_torch.configs import get_config
    out = []
    for name in ("mixtral-8x7b", "gemma2-9b"):
        cfg = get_config(name)
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT.get(name,
                                                              cfg.n_layers))
        weights = cfg.param_count() * 2 / 1e9
        if name == "gemma2-9b":
            glob = sum(k == "attn_global" for k in cfg.layer_kinds())
            gb = LONG_S * _kv_bytes_per_token(cfg, glob) / 1e9
            why = (f"{gb:.1f} GB of cache for its {glob} global layers "
                   f"alone")
        else:
            moe = cfg.moe
            rows = int(LONG_S * moe.top_k * moe.capacity_factor)
            gb = rows * moe.d_expert * 2 / 1e9
            why = (f"its MoE dispatch: {rows:,} expert rows x "
                   f"{moe.d_expert} x 2 B = {gb:.1f} GB per up / gate "
                   f"tensor, beside {weights:.1f} GB of bf16 weights "
                   f"({cfg.n_layers} layers)")
        log(f"  long_500k {name}: not run on one 80 GB card: {why}")
        out.append({"arch": name, "layers": cfg.n_layers, "gb": gb,
                    "weights_gb": weights, "reason": why})
    return out


def long_500k_danube(dev):
    """(h) h2o-danube-3-4b at full depth (24 layers, bf16, B 1): the
    attention builder given ``max_len``/``ring`` places each layer's K/V
    into a ring of ring_len slots as the layer makes them (position t at
    slot t mod ring_len), so the 48.3 GB of stacked K/V never exist.
    First, at PREFILL_S tokens, the ring as made equals the stacked
    builder's cache placed by ``decode_cache`` bit for bit (and the
    logits); then the LONG_S-token prefill (one ``flash_prefill`` launch
    per layer) and DECODE_STEPS greedy steps on the ring (no launch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import serving as S
    cfg = get_config("h2o-danube-3-4b")
    params = _long_params(cfg, dev, torch.bfloat16)
    max_len = LONG_S + DECODE_STEPS
    made = ST.build_prefill_step(cfg, max_len=max_len, ring=True)
    with torch.no_grad():
        toks = _long_tokens(cfg, 1, PREFILL_S, dev, seed=1)
        ops.reset_launches()
        lm, ring = made(params, toks, {})
        ls, stacked = ST.build_prefill_step(cfg)(params, toks, {})
        n32 = _launched()
        placed = ST.decode_cache(cfg, stacked, max_len, ring=True)
        del stacked
        same = torch.equal(lm, ls) and sorted(ring) == sorted(placed) and \
            all(torch.equal(ring[k], placed[k]) for k in placed)
        log(f"  long_500k h2o-danube-3-4b: at {PREFILL_S} tokens the ring "
            f"as made equals builder + decode_cache bit for bit: {same}; "
            f"launches {n32}")
        assert same, "the ring as made differs from builder + decode_cache"
        assert n32 == {"flash_prefill": 2 * cfg.n_layers}, n32
        del ring, placed, toks, lm, ls
        toks = _long_tokens(cfg, 1, LONG_S, dev)
        _release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        (lg, ring), wall, dev_ms = _timed_call(lambda: made(params, toks,
                                                              {}))
        n_pre = _launched()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del toks
        assert n_pre == {"flash_prefill": cfg.n_layers}, n_pre
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
        rb = ring["k"].nbytes + ring["v"].nbytes
        stacked_b = LONG_S * _kv_bytes_per_token(cfg)
        assert ring["k"].shape[2] == S.ring_len(cfg)
        dec = ST.build_decode_step(cfg)
        ops.reset_launches()
        tok, ms, seq = lg[:, :cfg.vocab_size].argmax(-1), [], []
        for _ in range(DECODE_STEPS):
            (lg, ring), _, d = _timed_call(lambda: dec(params, tok, ring))
            tok = lg[:, :cfg.vocab_size].argmax(-1)
            ms.append(d)
            seq.append(int(tok[0]))
        n_dec = _launched()
    assert not any(n_dec.values()), n_dec
    assert bool(torch.isfinite(lg).all())
    assert all(0 <= t < cfg.vocab_size for t in seq), seq
    assert int(ring["length"][0]) == LONG_S + DECODE_STEPS
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"  long_500k h2o-danube-3-4b: prefill {LONG_S} tokens into a "
        f"{S.ring_len(cfg)}-slot ring in {wall * 1e3:.1f} ms wall, "
        f"{dev_ms:.1f} ms device, peak {peak:.2f} GiB, launches {n_pre}; "
        f"ring {rb / 1e9:.3f} GB against {stacked_b / 1e9:.1f} GB stacked; "
        f"{DECODE_STEPS} greedy steps: step ms median {med:.2f} (first "
        f"{ms[0]:.2f}); tokens {seq}")
    del params, ring
    _release()
    return {"arch": cfg.name, "layers": cfg.n_layers, "seq": LONG_S,
            "prefill_wall_s": wall, "prefill_device_ms": dev_ms,
            "peak_gib": peak, "launches_prefill": n_pre,
            "launches_placement_check": n32, "placement_bit_equal": same,
            "ring_slots": S.ring_len(cfg), "ring_kv_bytes": rb,
            "stacked_kv_bytes": stacked_b, "launches_decode": n_dec,
            "decode_step_ms": ms, "decode_step_ms_median": med,
            "tokens": seq}


# (f) the long path on a TE of width LONG_TP, every rank on the one card,
# at full width cut to a few fp32 layers: (arch, layers, ring, windowed
# decode). Every cache holds LONG_PARITY_S + DECODE_STEPS positions: a
# linear one takes a LONG_PARITY_S-token prompt, a ring (ring_len slots)
# one of ring_len - 12 tokens, so the decode steps wrap past its end.
LONG_TP = 2
LONG_TP_CASES = (("qwen3-8b", 2, False, False),
                 ("h2o-danube-3-4b", 2, False, False),
                 ("h2o-danube-3-4b", 2, False, True),
                 ("h2o-danube-3-4b", 2, True, False),
                 ("gemma2-9b", 2, False, False),
                 ("recurrentgemma-2b", 3, True, False))


def _joined_kv(caches):
    """The attention cache of rank caches, its sequence parts joined."""
    import torch
    from repro_torch.launch import sharding as SH
    return {k: torch.cat(SH.held([c[k] for c in caches]), 2)
            for k in ("k", "v")}


def long_tp_case(name, n_layers, ring, windowed, dev):
    """(f) one case: ``serving.init_cache`` / ``prefill`` / ``decode_step``
    at tp LONG_TP and at tp 1 on one fp32 weights tree (the ranks' shards
    views of it): the prefill (past 2048 slots the single-shot branch,
    one ``flash_prefill`` launch per attention layer per rank of the
    heads), then DECODE_STEPS greedy steps each. tp LONG_TP's logits of
    every step within LONG_ATOL + LONG_RTOL |tp 1|, its greedy tokens
    equal, its joined K/V within the same tolerance of tp 1's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.models import perf_flags as PF
    from repro_torch.models import serving as S
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    max_len = LONG_PARITY_S + DECODE_STEPS
    s = S.ring_len(cfg) - 12 if ring else LONG_PARITY_S
    params = _long_params(cfg, dev, torch.float32)
    toks = _long_tokens(cfg, 1, s, dev)
    la = S.attn_layer_count(cfg)
    runs = {}
    PF.set_flags(windowed_decode=windowed)
    try:
        for tp in (LONG_TP, 1):
            mesh = make_engine_mesh(tp, 0, dev)
            ps = SH.shard(params, SH.te_param_specs(cfg, tp), mesh)
            caches = S.init_cache(cfg, 1, max_len, torch.float32, mesh,
                                  ring=ring)
            with torch.no_grad():
                ops.reset_launches()
                lg, _ = S.prefill(cfg, ps, toks, caches, mesh)
                n_pre = _launched()
                ops.reset_launches()
                logits, seq = [lg], []
                for _ in range(DECODE_STEPS):
                    tok = lg[:, :cfg.vocab_size].argmax(-1)
                    seq.append(int(tok[0]))
                    S.check_room(cfg, caches)
                    lg, _ = S.decode_step(cfg, ps, tok, caches, mesh)
                    logits.append(lg)
                n_dec = _launched()
            kr = tp if SH.attn_shardable(cfg, tp) else 1
            held = SH.held([c["k"] for c in caches])
            # the single-shot branch past JOINT_PREFILL_MAX slots (every
            # case at full width) launches the kernel
            want = {"flash_prefill": la * kr} if sum(
                p.shape[2] for p in held) > S.JOINT_PREFILL_MAX else {}
            if cfg.rglru is not None:
                want["rglru"] = (n_layers - la) * tp
            assert n_pre == want, (name, tp, n_pre, want)
            runs[tp] = dict(logits=torch.stack(logits), seq=seq,
                            kv=_joined_kv(caches), launches_prefill=n_pre,
                            launches_decode=n_dec, kernel_ranks=kr,
                            slots=[c["k"].shape[2] for c in caches])
            del caches, ps
    finally:
        PF.reset()
    a, b = runs[LONG_TP], runs[1]
    kind = ("ring" if ring else "linear") + (", windowed decode"
                                             if windowed else "")
    tag = (f"{name} x{n_layers} fp32 tp {LONG_TP} vs tp 1 ({kind}, "
           f"{max_len} positions, prompt {s})")
    e = close(f"{tag} logits", a["logits"], b["logits"], LONG_ATOL,
              LONG_RTOL)
    ekv = max(close(f"{tag} joined cache {k}", a["kv"][k], b["kv"][k],
                    LONG_ATOL, LONG_RTOL) for k in ("k", "v"))
    same = a["seq"] == b["seq"]
    log(f"  {tag}: greedy tokens equal {same}; rank slots {a['slots']}; "
        f"launches prefill {a['launches_prefill']} (tp 1 "
        f"{b['launches_prefill']}), decode {a['launches_decode']}")
    assert same, (a["seq"], b["seq"])
    del params, runs
    _release()
    return {"arch": name, "layers": n_layers, "tp": LONG_TP, "cache": kind,
            "positions": max_len, "prompt": s, "rank_slots": a["slots"],
            "kernel_ranks": a["kernel_ranks"], "max_abs_err_logits": e,
            "max_abs_err_kv": ekv, "greedy_identical": same,
            "tokens": a["seq"], "launches_prefill": a["launches_prefill"],
            "launches_decode": a["launches_decode"],
            "launches_prefill_tp1": b["launches_prefill"],
            "launches_decode_tp1": b["launches_decode"]}


def long_tp_kernel_row(name, launches, dev):
    """(f) the dense ``flash_prefill`` entry in bf16 at one rank's heads
    of ``name`` at tp LONG_TP (H / 2, Hkv / 2), over LONG_PARITY_S tokens,
    with the arch's window and softcap (gemma2: its local layer's), held
    against the plain blockwise function at ``check_main_path``'s
    tolerance; kernel, plain and (where one call computes the function:
    no softcap) ``scaled_dot_product_attention`` ms (CUDA events), and the
    card's least time for the pairs the window keeps."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    cfg = get_config(name)
    s, hd = LONG_PARITY_S, cfg.head_dim
    h, hkv = cfg.n_heads // LONG_TP, cfg.n_kv_heads // LONG_TP
    win, cap = cfg.window, cfg.attn_logit_softcap
    g = torch.Generator(device=dev).manual_seed(29)
    q = torch.randn((1, s, h, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, s, hkv, hd), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, device=dev)[None]
    tag = (f"flash_prefill dense {name} one tp-{LONG_TP} rank (H {h} / Hkv "
           f"{hkv}, hd {hd}, window {win}, softcap {cap}, S {s}, bf16)")
    with torch.no_grad():
        out = ops.flash_prefill(q, k, v, cap, win)
        plain = L.flash_attention(q, k, v, pos, pos, win, cap)
        e = check_main_path(f"{tag} vs plain blockwise", out, plain, True)
        ms = time_ms(lambda: ops.flash_prefill(q, k, v, cap, win), iters=5,
                     warmup=1)
        plain_ms = time_ms(lambda: L.flash_attention(q, k, v, pos, pos, win,
                                                     cap), iters=1, warmup=0)
        library_ms = None
        if cap is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if win is None else L.causal_mask(pos[0], pos[0],
                                                          win)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), iters=5, warmup=1)
    w = s if win is None else win
    pairs = sum(min(i + 1, w) for i in range(s))
    nbytes = 2 * (2 * s * h * hd) + 2 * 2 * s * hkv * hd
    bound, by = _bound(nbytes, 4 * h * hd * pairs, BF16_FLOPS)
    lib = "none (no call softcaps)" if library_ms is None \
        else f"{library_ms:.3f}"
    log(f"  {tag}: kernel_ms {ms:.3f}; plain_ms {plain_ms:.3f}; library_ms "
        f"{lib}; bound_ms {bound:.3f} ({by}); bound / kernel "
        f"{bound / ms:.3f}; launches {launches}")
    del q, k, v, out, plain
    _release()
    return {"name": "flash_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_prefill.py:76",
            "arch": name, "tp": LONG_TP, "seq": s, "heads": [h, hkv],
            "head_dim": hd, "window": win, "softcap": cap,
            "dtype": "bfloat16", "launches": launches, "max_abs_err": e,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


# (g) the prefill builder on a mesh: qwen3-8b at 2 fp32 layers over
# PREFILL_S tokens
LONG_TP_BUILDER = ("qwen3-8b", 2)


def long_tp_builders(dev):
    """(g) ``build_prefill_step(mesh=...)`` at tp LONG_TP and at tp 1 on
    one fp32 weights tree: the logits and the joined rank caches within
    LONG_ATOL + LONG_RTOL |tp 1| (one ``flash_prefill`` launch per layer
    per rank), then each cache placed by ``decode_cache(mesh=...)`` into a
    linear cache with room and DECODE_STEPS greedy steps through
    ``build_decode_step(mesh=...)``: logits within the same tolerance,
    tokens equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_engine_mesh
    name, n_layers = LONG_TP_BUILDER
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    params = _long_params(cfg, dev, torch.float32)
    toks = _long_tokens(cfg, 1, PREFILL_S, dev)
    runs = {}
    for tp in (LONG_TP, 1):
        mesh = make_engine_mesh(tp, 0, dev)
        ps = SH.shard(params, SH.te_param_specs(cfg, tp), mesh)
        with torch.no_grad():
            ops.reset_launches()
            lg, caches = ST.build_prefill_step(cfg, mesh=mesh)(ps, toks, {})
            n = _launched()
            kv = _joined_kv(caches)
            dc = ST.decode_cache(cfg, caches, PREFILL_S + DECODE_STEPS,
                                 mesh=mesh)
            del caches
            dec = ST.build_decode_step(cfg, mesh=mesh)
            logits, seq = [lg], []
            for _ in range(DECODE_STEPS):
                tok = lg[:, :cfg.vocab_size].argmax(-1)
                seq.append(int(tok[0]))
                lg, dc = dec(ps, tok, dc)
                logits.append(lg)
        assert n == {"flash_prefill": n_layers * tp}, (tp, n)
        runs[tp] = dict(logits=torch.stack(logits), seq=seq, kv=kv,
                        launches=n, slots=[c["k"].shape[2] for c in dc])
        del dc, ps
        _release()
    a, b = runs[LONG_TP], runs[1]
    tag = (f"{name} x{n_layers} fp32 builder S {PREFILL_S} tp {LONG_TP} vs "
           f"tp 1")
    e = close(f"{tag} logits (prefill + {DECODE_STEPS} steps)", a["logits"],
              b["logits"], LONG_ATOL, LONG_RTOL)
    ekv = max(close(f"{tag} joined cache {k}", a["kv"][k], b["kv"][k],
                    LONG_ATOL, LONG_RTOL) for k in ("k", "v"))
    same = a["seq"] == b["seq"]
    log(f"  {tag}: greedy tokens equal {same}; decode cache rank slots "
        f"{a['slots']}; launches {a['launches']} (tp 1 {b['launches']})")
    assert same, (a["seq"], b["seq"])
    del params, runs
    _release()
    return {"arch": name, "layers": n_layers, "seq": PREFILL_S,
            "tp": LONG_TP, "max_abs_err_logits": e, "max_abs_err_kv": ekv,
            "greedy_identical": same, "tokens": a["seq"],
            "launches": a["launches"], "launches_tp1": b["launches"]}


def train_4k(dev):
    """(e) train_4k's step (``training/train_loop.py::make_train_step``,
    remat on) on TRAIN4K_B x TRAIN4K_S tokens in bf16 at full width cut
    to TRAIN4K_LAYERS layers: attention past 2048 keys through the plain
    blockwise flash (the kernels refuse autograd; no launch), then the
    same step with ``attn_impl="naive"``; step ms (CUDA events, median)
    and peak memory of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models.model_factory import get_model
    from repro_torch.training import OptimizerConfig, TrainConfig
    from repro_torch.training.optimizer import init_opt_state
    cfg = dataclasses.replace(get_config(TRAIN4K_ARCH),
                              n_layers=TRAIN4K_LAYERS)
    bundle = get_model(cfg)
    params = _long_params(cfg, dev, torch.bfloat16)
    seq = _long_tokens(cfg, TRAIN4K_B, TRAIN4K_S + 1, dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    n = cfg.param_count()
    rows = []
    for attn_impl in ("auto", "naive"):
        step = ST.build_train_step(bundle, TrainConfig(
            remat=True, attn_impl=attn_impl, microbatches=TRAIN4K_MICRO,
            opt=OptimizerConfig(lr=1e-4, warmup_steps=1,
                                total_steps=TRAIN4K_STEPS + 1)))
        opt = init_opt_state(params)
        p = params
        ms, losses = [], []
        _release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        for _ in range(TRAIN4K_STEPS + 1):
            (p, opt, m), _, d = _timed_call(
                lambda: step(p, opt, tokens, targets, mask, {}))
            ms.append(d)
            losses.append(float(m["loss"]))
        launches = _launched()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert not any(launches.values()), launches
        assert all(x == x and abs(x) < 1e4 for x in losses), losses
        med = sorted(ms[1:])[len(ms[1:]) // 2]
        tok = TRAIN4K_B * TRAIN4K_S
        rows.append({"arch": cfg.name, "layers": cfg.n_layers,
                     "batch": TRAIN4K_B, "seq": TRAIN4K_S,
                     "microbatches": TRAIN4K_MICRO,
                     "attn_impl": attn_impl, "step_ms": ms,
                     "step_ms_median": med, "tokens_per_s": tok / med * 1e3,
                     "six_n_share_of_989tf":
                         6 * n * tok / (med / 1e3) / BF16_FLOPS,
                     "peak_gib": peak, "losses": losses,
                     "launches": launches})
        log(f"  train_4k {cfg.name} x{cfg.n_layers} ({TRAIN4K_B} x "
            f"{TRAIN4K_S} in {TRAIN4K_MICRO} microbatches, remat, "
            f"attn_impl={attn_impl!r}): step ms median "
            f"{med:.1f} (first {ms[0]:.1f}); {rows[-1]['tokens_per_s']:.0f} "
            f"tokens/s; 6*N share {rows[-1]['six_n_share_of_989tf']:.3f}; "
            f"peak {peak:.2f} GiB; losses {losses}; launches {launches}")
        del opt, p, step
    del params
    _release()
    return rows


def phase9(dev):
    """The reference's long-context shapes on the card, (a)-(h); every
    cut printed. Returns the {"long": ...} row, with the launches of the
    long path's kernels (the qwen3 32k prefill, the 524k prefills and
    decodes, the tp-2 long path and builders, danube's ring as made)."""
    from repro_torch.configs import SHAPES, get_config
    t9 = time.monotonic()
    log(f"phase 9: long — cuts: prefill_32k B 1 of "
        f"{SHAPES['prefill_32k'].global_batch}; decode_32k B {DECODE_B} of "
        f"{SHAPES['decode_32k'].global_batch} ({DECODE_STEPS} steps); "
        f"long_500k B 1 ({DECODE_STEPS} steps); train_4k "
        f"{TRAIN4K_ARCH} at {TRAIN4K_LAYERS} layers, B {TRAIN4K_B} of "
        f"{SHAPES['train_4k'].global_batch} in {TRAIN4K_MICRO} "
        f"microbatches; kernel-vs-plain rows at "
        f"{LONG_PARITY_S} tokens, 2 fp32 layers; tp {LONG_TP} at 2 fp32 "
        f"layers (recurrentgemma 3) [{time.monotonic() - T0:.1f} s]")
    out = {"parity": [long_parity(n, k, dev) for n, k in LONG_PARITY]}
    log(f"phase 9: the long path at tp {LONG_TP} [{time.monotonic() - T0:.1f}"
        f" s]")
    out["long_tp"] = [long_tp_case(*c, dev) for c in LONG_TP_CASES]
    tp_launches = {}          # each arch's per-rank launches at tp 2
    for r in out["long_tp"]:
        tp_launches[r["arch"]] = tp_launches.get(r["arch"], 0) + \
            r["launches_prefill"].get("flash_prefill", 0)
    out["tp_kernels"] = [long_tp_kernel_row(n, tp_launches[n], dev)
                         for n in ("qwen3-8b", "h2o-danube-3-4b",
                                   "gemma2-9b")]
    out["long_tp_builders"] = long_tp_builders(dev)
    log(f"phase 9: prefill_32k / decode_32k [{time.monotonic() - T0:.1f} s]")
    out["kernel_32k"] = long_kernel_row(dev)
    out["kernel_checks"] = long_kernel_checks(dev)
    out["prefill_32k"], out["decode_32k"] = [], None
    for name in PREFILL_ARCHS:
        row, params, logits, cache = prefill_32k(name, dev)
        out["prefill_32k"].append(row)
        if name == "qwen3-8b":
            out["decode_32k"] = decode_32k(get_config(name), params, logits,
                                           cache, dev)
        del params, logits, cache
        _release()
    out["decode_32k_parity"] = decode_parity("qwen3-8b", dev)
    log(f"phase 9: long_500k [{time.monotonic() - T0:.1f} s]")
    out["long_500k"] = [long_500k_rwkv(dev), long_500k_hybrid(dev)]
    log(f"phase 9: long_500k h2o-danube-3-4b [{time.monotonic() - T0:.1f} "
        f"s]")
    out["long_500k"].append(long_500k_danube(dev))
    out["long_500k_not_run"] = long_500k_skipped()
    log(f"phase 9: train_4k [{time.monotonic() - T0:.1f} s]")
    out["train_4k"] = train_4k(dev)
    rw, rg, dn = out["long_500k"]
    tp_runs = [r[k] for r in out["long_tp"]
               for k in ("launches_prefill", "launches_decode",
                         "launches_prefill_tp1", "launches_decode_tp1")]
    tp_runs += [out["long_tp_builders"][k] for k in ("launches",
                                                      "launches_tp1")]

    def tp_sum(name):
        return sum(r.get(name, 0) for r in tp_runs)
    launches = {
        "flash_prefill": out["prefill_32k"][0]["launches"]["flash_prefill"]
        + rg["launches_prefill"]["flash_prefill"]
        + dn["launches_prefill"]["flash_prefill"]
        + dn["launches_placement_check"]["flash_prefill"]
        + tp_sum("flash_prefill"),
        "wkv6": rw["launches_prefill"]["wkv6"] + rw["launches_decode"]["wkv6"],
        "rglru": rg["launches_prefill"]["rglru"]
        + rg["launches_decode"]["rglru"] + tp_sum("rglru")}
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t9
    log(f"phase 9 done in {out['seconds']:.1f} s: launches on the long path "
        f"{launches} [{time.monotonic() - T0:.1f} s]")
    return out


LONG_MARK = "phase 9 row: "


def phase9_process():
    """Phase 9 in a process of its own, whose caching allocator maps
    expandable segments: a 524,288-token prefill frees and makes tensors
    of 2.7, 5.4 and 8 GB in turn, and with fixed segments the card ran
    out of memory with 23 GB of them cached but unallocated. The child
    finds the kernels phase 1 built; its log lines pass through, and its
    row comes back on a marked line."""
    _release()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--only", "long-process"],
                            stdout=subprocess.PIPE, text=True, env=env)
    row = None
    for line in proc.stdout:
        if line.startswith(LONG_MARK):
            row = json.loads(line[len(LONG_MARK):])
        else:
            print(line, end="", flush=True)
    rc = proc.wait()
    if rc != 0 or row is None:
        raise RuntimeError(f"phase 9 failed in its process (rc {rc})")
    return row


# phase 10: the reference engine's switches. Each run is one TE of one
# configuration; "default" is the engine's defaults (_engine_config)
PAGED_SWITCHES = (("batched_prefill", False), ("async_sched", False),
                  ("enable_prefix_cache", False), ("fused_decode", False),
                  ("decode_horizon", 1))
SLOT_SWITCHES = (("fused_decode", False), ("bucket_prefill", False))
# the switches that keep the default's arithmetic: the same passes over the
# same batch shapes (the slot family's unfused step is the fused step's
# decode, its argmax taken on the host)
PAGED_SAME = (("async_sched", False), ("enable_prefix_cache", False),
              ("decode_horizon", 1))
SLOT_SAME = (("fused_decode", False),)
# the switches whose passes are programs of their own (the per-sequence
# chunk, the unfused step, the raw-length slot chunk): each also served
# through its eager forms in bf16 and held to the same tokens and launches
EAGER_HELD = (("batched_prefill", False), ("fused_decode", False),
              ("bucket_prefill", False))
SWITCH_SLOT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
# the slot runs prefill every prompt (64-512 ids) in one chunk of the first
# step, so the teacher-forced forward is their oracle (the all-slot decode
# step also advances a slot still mid-prefill: a reference defect kept
# for parity, see oracle_parity)
SLOT_SWITCH_ECFG = dict(max_batch_tokens=4096, chunk_size=512)
PREFIX_LEN, PREFIX_SHARED = 1024, 768
# whole 256-token chunks, then a 7-token tail and the last token: a repeat
# reuses 1024 tokens (whole pages up to n_prompt - 1) and recomputes
# exactly the cold run's last pass, so its tokens and its first logits
# must equal the cold run's bit for bit, in bf16 too
PREFIX_ALIGNED = 1032
# the bf16 logits of two paths that round differently are held to twice
# the default path's own error against the exact result (the fp32 forward
# of the same bf16 weights): rounding, measured on this run's inputs
ROUNDING_FACTOR = 2.0


def _switch_te(cfg, params, dev, dtype, switch, **ecfg_kw):
    """A TE on ``_engine_config`` (with ``ecfg_kw``) with one switch set
    (``bucket_prefill`` is the slot runner's; the others are
    ``EngineConfig`` fields)."""
    from repro_torch.engine import FlowServe
    ecfg = dataclasses.replace(_engine_config(cfg, dtype), **ecfg_kw)
    name, value = switch or (None, None)
    if name is not None and name != "bucket_prefill":
        ecfg = dataclasses.replace(ecfg, **{name: value})
    te = FlowServe(cfg, params, ecfg, device=dev)
    if name == "bucket_prefill":
        te.runner.bucket_prefill = value
    return te


def switch_run(cfg, params, dev, dtype, make_reqs, switch=None,
               eager=False, **ecfg_kw):
    """Serve ``make_reqs()`` (made just before they arrive) on a TE with
    ``switch`` (through its eager forms with ``eager``); the launches are
    counted from just before the first request to just after the last
    completion. Returns the tokens in request order and what the run
    counted and took."""
    import torch
    from repro_torch.kernels import ops
    te = _switch_te(cfg, params, dev, dtype, switch, **ecfg_kw)
    if eager:
        _eager_all(te)
    chunks = []
    if switch == ("batched_prefill", False):
        # the (start, length) of every per-sequence pass, for the kernel
        # check at the shapes this run gave the paged varlen entry
        pre = te.runner.prefill
        one = pre.prefill_chunk

        def record(seq, chunk):
            chunks.append((seq.n_cached, len(chunk)))
            return one(seq, chunk)
        pre.prefill_chunk = record
    reqs = make_reqs()
    ops.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        te.add_request(r)
    comps = []
    while te.has_work():
        assert te.steps < 4000, "serving did not converge"
        comps += te.step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    _check_comps(comps, reqs, cfg)
    by_id = {c.req_id: c for c in comps}
    ttft = sorted(c.ttft * 1e3 for c in comps)
    out = dict(switch=f"{switch[0]}={switch[1]}" if switch else "default",
               tokens=[by_id[r.req_id].tokens for r in reqs], wall_s=wall,
               ttft_ms_p50=ttft[len(ttft) // 2],
               tpot_ms_mean=_mean([c.tpot * 1e3 for c in comps]),
               launches=launches, steps=te.steps,
               prefill_passes=te.prefill_dispatches,
               prefill_syncs=te.prefill_syncs,
               decode_iterations=te.decode_steps,
               sampler_dispatches=te.sampler_dispatches,
               prefix_cache=te.prefix_cache_stats(), chunks=chunks)
    del te
    _release()
    return out, reqs


def _hold_launches(cfg, row):
    """Each kernel of the path launched once per layer (and rank) for every
    pass that runs it: a paged TE's flash_prefill per prefill pass (one
    per sequence chunk on the per-sequence path) and paged_attention per
    decode iteration; a slot TE's recurrence per prefill dispatch and
    decode step."""
    launches, kinds = row["launches"], cfg.layer_kinds()
    if PATH_KERNELS[cfg.name] == PAGED:
        assert launches["flash_prefill"] == \
            cfg.n_layers * row["prefill_passes"] > 0 \
            and launches["paged_attention"] == \
            cfg.n_layers * row["decode_iterations"] > 0, (row["switch"],
                                                           launches)
        return
    (name,) = PATH_KERNELS[cfg.name]
    per = sum(k == ("rwkv" if name == "wkv6" else "rglru") for k in kinds)
    assert launches[name] == per * (row["prefill_passes"]
                                    + row["decode_iterations"]) > 0, \
        (row["switch"], launches, per)


def switch_set(cfg, dev, switches, same, n_req, max_prompt=1024,
               **ecfg_kw):
    """The default and every switch of ``switches`` on ``cfg`` at full
    width and depth, ``n_req`` greedy requests of 64-``max_prompt`` random
    ids, in bf16 after a warm-up run: launches held, TTFT and TPOT
    recorded. A switch in ``same`` runs the default's arithmetic (the same
    passes over the same batch shapes), so its bf16 tokens must equal the
    default's exactly. The others change batch shapes, which bf16 rounds
    differently, so they run again in fp32 beside the default: their
    greedy tokens held to the default's up to near-ties (``_same_tokens``,
    an fp32 threshold), the default's to the teacher-forced forward's
    greedy choice. Returns the bf16 rows and the fp32 near-ties."""
    import numpy as np
    import torch
    from repro_torch.engine import Request, SamplingParams
    from repro_torch.models import transformer as T

    def make_reqs():
        rng = np.random.RandomState(41)
        sp = SamplingParams(temperature=0.0, max_new_tokens=32,
                            stop_on_eos=False)
        return [Request(prompt_tokens=[int(t) for t in rng.randint(
                    3, cfg.vocab_size, int(rng.randint(64, max_prompt + 1)))],
                        sampling=sp, req_id=f"s{i}") for i in range(n_req)]

    def check_counters(runs):
        for row, _ in runs:
            if ecfg_kw:
                # every prompt prefilled in one chunk of the first step
                assert row["prefill_passes"] == n_req, row
            if row["switch"] == "batched_prefill=False":
                # one pass per sequence chunk, the first token from decode
                assert row["prefill_passes"] >= n_req \
                    and row["prefill_syncs"] == 0, row
            if row["switch"] == "fused_decode=False":
                # the host samples every decode iteration's logits
                assert row["sampler_dispatches"] == \
                    row["decode_iterations"] > 0, row

    rows, fp32 = [], {}
    other = [sw for sw in switches if sw not in same]
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = T.init_params(cfg, gen, dtype, dev)
        bf16 = dtype == torch.bfloat16
        if bf16:
            # first use of the card's libraries and allocator: not timed
            switch_run(cfg, params, dev, dtype, lambda: make_reqs()[:2],
                       **ecfg_kw)
        sws = (None, *(switches if bf16 else other))
        runs = [switch_run(cfg, params, dev, dtype, make_reqs, sw, **ecfg_kw)
                for sw in sws]
        check_counters(runs)
        (base, reqs) = runs[0]
        if bf16:
            for (row, _), sw in zip(runs, sws):
                _hold_launches(cfg, row)
                row["same_tokens_as_default"] = sum(
                    x == y for x, y in zip(row["tokens"], base["tokens"]))
                log(f"  switches {cfg.name} bf16 {row['switch']}: TTFT p50 "
                    f"{row['ttft_ms_p50']:.1f} ms, TPOT "
                    f"{row['tpot_ms_mean']:.2f} ms, launches "
                    f"{row['launches']}, prefill passes "
                    f"{row['prefill_passes']}, decode iterations "
                    f"{row['decode_iterations']}, requests with the "
                    f"default's tokens {row['same_tokens_as_default']} of "
                    f"{n_req} ({card_line()})")
                if sw in same:
                    assert row["tokens"] == base["tokens"], row["switch"]
                if sw in EAGER_HELD:
                    # the switch's programs against its eager forms: the
                    # same kernels and arithmetic, so the same bf16 tokens
                    # and launches
                    erow, _ = switch_run(cfg, params, dev, dtype, make_reqs,
                                         sw, eager=True, **ecfg_kw)
                    assert erow["tokens"] == row["tokens"] \
                        and erow["launches"] == row["launches"], \
                        (row["switch"], erow["launches"], row["launches"])
                    row.update(eager_tokens_equal=True, eager_ttft_ms_p50=erow[
                        "ttft_ms_p50"], eager_tpot_ms_mean=erow[
                        "tpot_ms_mean"])
                    log(f"  switches {cfg.name} bf16 {row['switch']} "
                        f"through its eager forms: the same tokens and "
                        f"launches; TTFT p50 {erow['ttft_ms_p50']:.1f} ms, "
                        f"TPOT {erow['tpot_ms_mean']:.2f} ms")
                rows.append({k: v for k, v in row.items()
                             if k not in ("tokens", "chunks")})
        else:
            for r, toks in zip(reqs, base["tokens"]):
                _greedy_run(cfg, params, dev, r.prompt_tokens, toks,
                            ("default", r.req_id))
            for row, _ in runs[1:]:
                fp32[row["switch"]] = _same_tokens(
                    cfg, params, dev, reqs, base["tokens"], row["tokens"],
                    f"{cfg.name} fp32 {row['switch']}")
            log(f"  switches {cfg.name}: {[f'{k}={v}' for k, v in same]} "
                f"give the default's bf16 tokens exactly; in fp32 the others "
                f"give them up to near-ties {fp32}")
        if PATH_KERNELS[cfg.name] == PAGED:
            prefix = prefix_check(cfg, params, dev, dtype)
            if bf16:
                per_seq = next(row for row, _ in runs
                               if row["switch"] == "batched_prefill=False")
                rows.append(per_seq_kernel_check(cfg, dev, per_seq["chunks"]))
                rows.append(bf16_rounding(
                    cfg, params, dev, [r.prompt_tokens for r in reqs],
                    prefix))
                rows.append(prefix)
            else:
                fp32["prefix_cache_hits"] = prefix["near_ties"]
        log(f"  switches {cfg.name} {str(dtype)[6:]} done "
            f"[{time.monotonic() - T0:.1f} s]")
        del params, runs
        _release()
    return rows, fp32


def prefix_check(cfg, params, dev, dtype):
    """On the default TE, each prompt served alone: a ``PREFIX_LEN``-token
    prompt cold, the same prompt again, one sharing its first
    ``PREFIX_SHARED`` tokens, then a ``PREFIX_ALIGNED``-token prompt cold
    and again. The RTC counts the hits. The aligned repeat recomputes the
    cold run's last pass, so its tokens and first-token logits equal the
    cold run's exactly. The ``PREFIX_LEN`` repeat recomputes its last
    partial page in a 16-row pass where the cold run's was 256 rows: in
    fp32 its tokens equal the cold run's up to near-ties (the shared
    prompt's are held to the forward); in bf16 its first-token logits are
    returned (``first_logits``, cold and hit) for ``bf16_rounding``."""
    import numpy as np
    import torch
    from repro_torch.engine import Request, SamplingParams
    te = _switch_te(cfg, params, dev, dtype, None)
    rng = np.random.RandomState(43)
    base = [int(t) for t in rng.randint(3, cfg.vocab_size, PREFIX_LEN)]
    shared = base[:PREFIX_SHARED] + [
        int(t) for t in rng.randint(3, cfg.vocab_size,
                                    PREFIX_LEN - PREFIX_SHARED)]
    aligned = [int(t) for t in rng.randint(3, cfg.vocab_size,
                                           PREFIX_ALIGNED)]
    # a prompt served alone is row 0 of every pass; its last pass samples
    # the first token
    first = []
    pre = te.runner.prefill
    ragged = pre.prefill_ragged_host

    def keep(*a, **kw):
        logits, toks = ragged(*a, **kw)
        first.append(logits[0].clone())    # the program's static output
        return logits, toks
    pre.prefill_ragged_host = keep
    sp = SamplingParams(temperature=0.0, max_new_tokens=32,
                        stop_on_eos=False)
    out = dict(switch="prefix_cache_hits", ttft_ms=[], card=card_line())
    toks, reqs, logits = [], [], []
    for i, p in enumerate((base, base, shared, aligned, aligned)):
        reqs.append(Request(prompt_tokens=p, sampling=sp, req_id=f"x{i}"))
        te.add_request(reqs[-1])
        (c,) = te.run_to_completion()
        torch.cuda.synchronize()
        toks.append(c.tokens)
        logits.append(first[-1])
        out["ttft_ms"].append(c.ttft * 1e3)
    stats = te.prefix_cache_stats()
    out.update(hits=stats["hits"], tokens_reused=stats["tokens_reused"],
               hit_tokens_equal_cold=toks[1] == toks[0],
               aligned_hit_tokens_equal_cold=toks[4] == toks[3])
    ps = te.pool.page_size
    # whole pages up to n_prompt - 1 of each repeat, the shared prefix
    reused = ((PREFIX_LEN - 1) // ps + (PREFIX_ALIGNED - 1) // ps) * ps \
        + PREFIX_SHARED
    assert stats["hits"] == 3 and stats["tokens_reused"] == reused, stats
    assert toks[4] == toks[3] and torch.equal(logits[4], logits[3]), \
        ("aligned prefix hit", str(dtype))
    if dtype == torch.float32:
        out["near_ties"] = _same_tokens(cfg, params, dev, reqs[:2], toks[:1],
                                        toks[1:2], "prefix hit")
        _greedy_run(cfg, params, dev, shared, toks[2], "shared prefix")
    else:
        out["first_logits"] = (base, logits[0], logits[1])
    log(f"  prefix cache {cfg.name} {str(dtype)[6:]}: cold / hit / shared / "
        f"aligned cold / aligned hit TTFT "
        f"{[round(t, 1) for t in out['ttft_ms']]} ms, hits {stats['hits']}, "
        f"tokens reused {stats['tokens_reused']}, hit tokens equal cold "
        f"{out['hit_tokens_equal_cold']}, aligned hit tokens and first "
        f"logits equal cold True")
    del te
    _release()
    return out


def per_seq_kernel_check(cfg, dev, chunks):
    """The paged varlen entry of ``flash_prefill`` in bf16 at every
    (start, length) the per-sequence run gave it: one entry, the query
    stream unpadded (Tb = the chunk's length), its cached prefix over a
    shuffled pool of 16-token pages, the arch's heads, head dim, windows
    and softcap; each against the plain version at ``check_main_path``'s
    tolerance (an entry from position 0 holds rows over a few keys, so it
    takes the arch rows' bf16 step of the plain output on top)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cpu")
    gen.manual_seed(29)
    h, hkv, hd, p = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    cap = cfg.attn_logit_softcap
    windows = sorted({w if w < T.GLOBAL_WINDOW else None
                      for w in T.window_schedule(cfg)},
                     key=lambda w: w or 0)
    shapes = sorted(set(chunks))
    errs = []
    for start, c in shapes:
        for win in windows:
            q, kp, vp, meta, _ = ragged_pack(
                gen, dev, torch.bfloat16, [c], [start], c, p, hkv, hd, h,
                n_pool=max(128, 2 * -(-(start + c) // p)))
            got = ops.paged_prefill(q, kp, vp, *meta, cap, win)
            want = ops.paged_prefill(q, kp, vp, *meta, cap, win, impl="ref")
            torch.cuda.synchronize()
            errs.append(check_main_path(
                f"flash_prefill per-sequence {cfg.name} Tb {c} from {start} "
                f"H{h}/{hkv} hd{hd} P{p} cap={cap} win={win} bf16",
                got, want, start == 0))
    log(f"  per-sequence prefill shapes {shapes}: the kernel agrees with "
        f"its plain version at all {len(errs)}, max_abs_err {max(errs):.3e}")
    return dict(switch="per_seq_kernel_check", shapes=shapes,
                max_abs_err=max(errs))


def prefill_logits(cfg, params, dev, prompts):
    """The last prompt position's logits of each prompt on one TE's
    runner, in the weights' dtype, by the two paged prefill paths: per
    sequence (``prefill_chunk`` over the engine's 256-token chunks, the
    last one returning the logits) and batched (``prefill_ragged``: every
    prompt whole, one entry each, in one pass). Returns two lists of
    (vocab,) fp32 tensors."""
    import numpy as np
    import torch
    from repro_torch.engine.hotloop import pow2_bucket, upload_i32
    from repro_torch.engine.kv_cache import pages_needed
    from repro_torch.engine.runners.base import SequenceState
    from repro_torch.kernels import flash_prefill as FP
    dtype = params["embed"].dtype
    te = _switch_te(cfg, params, dev, dtype, None)
    rt, pool = te.runner, te.pool
    ps, chunk, v = pool.page_size, te.ecfg.chunk_size, cfg.vocab_size
    per_seq = []
    for i, p in enumerate(prompts):
        seq = SequenceState(f"p{i}", tokens=list(p), n_prompt=len(p))
        seq.pages = pool.alloc(pages_needed(len(p), ps))
        for a in range(0, len(p), chunk):
            lg = rt.prefill_chunk(seq, p[a:a + chunk])
        per_seq.append(lg[:v].float())
        pool.release(seq.pages)
    pages = [pool.alloc(pages_needed(len(p), ps)) for p in prompts]
    sb, scratch = len(prompts), pool.scratch_page()
    pb = pow2_bucket(max(len(pg) for pg in pages))
    bt = np.full((sb, pb), scratch, np.int32)
    flat, pos, cu = [], [], [0]
    for i, (p, pg) in enumerate(zip(prompts, pages)):
        bt[i, :len(pg)] = pg
        flat += p
        pos += range(len(p))
        cu.append(len(flat))
    tb = pow2_bucket(len(flat))
    pos = np.asarray(pos + [0] * (tb - len(flat)))
    slots = np.where(np.arange(tb) < len(flat), pos % ps, 0)
    pgs = np.concatenate([np.asarray(pg)[np.arange(len(p)) // ps]
                          for p, pg in zip(prompts, pages)]
                         + [np.full(tb - len(flat), scratch)])
    logits, _ = rt.prefill_ragged(
        *upload_i32(dev, flat + [0] * (tb - len(flat)), pos, pgs, slots, cu,
                    bt, np.zeros(sb), FP.build_tiles(cu, tb),
                    np.asarray(cu[1:]) - 1),
        None, None, True, None)
    batched = [row[:v].float() for row in logits.clone()]
    for pg in pages:
        pool.release(pg)
    del te
    _release()
    return per_seq, batched


def fp32_last_logits(cfg, params, dev, prompts):
    """The exact answer of the bf16 model: the teacher-forced ``forward``
    in fp32 over an fp32 copy of the same bf16 weights, the last prompt
    position's (vocab,) logits of each prompt."""
    import torch
    from repro_torch.engine.distflow import tree_map
    from repro_torch.models import transformer as T
    p32 = tree_map(lambda t: t.float() if torch.is_tensor(t) else t, params)
    out = []
    with torch.no_grad():
        for p in prompts:
            lg = T.forward(cfg, p32, torch.tensor([p], device=dev))
            out.append(lg[0, -1, :cfg.vocab_size].float())
            del lg
    del p32
    _release()
    return out


def bf16_rounding(cfg, params, dev, prompts, prefix):
    """Measures, on this run's bf16 weights and prompts, the rounding that
    the switch runs' token differences are put down to. The last prompt
    position's logits of the per-sequence and the batched prefill
    (``prefill_logits``), and of the RTC hit and its cold run
    (``prefix_check``), each against the exact answer
    (``fp32_last_logits``): the per-sequence path (the hit) must be within
    ``ROUNDING_FACTOR`` x the batched path's (the cold run's) own error,
    and the two paths within that of each other."""
    base, cold, hit = prefix.pop("first_logits")
    per_seq, batched = prefill_logits(cfg, params, dev, prompts)
    ref = fp32_last_logits(cfg, params, dev, [*prompts, base])
    v = cfg.vocab_size
    cold, hit = cold[:v].float(), hit[:v].float()
    e_b = max(err(b, r) for b, r in zip(batched, ref))
    e_s = max(err(s, r) for s, r in zip(per_seq, ref))
    d = max(err(s, b) for s, b in zip(per_seq, batched))
    e_c, e_h, d_h = err(cold, ref[-1]), err(hit, ref[-1]), err(hit, cold)
    scale = max(float(r.abs().max()) for r in ref)
    same = sum(int(s.argmax()) == int(b.argmax())
               for s, b in zip(per_seq, batched))
    out = dict(switch="bf16_rounding", max_abs_logit=scale,
               batched_vs_fp32=e_b, per_seq_vs_fp32=e_s,
               per_seq_vs_batched=d, cold_vs_fp32=e_c, hit_vs_fp32=e_h,
               hit_vs_cold=d_h, same_first_token=same,
               hit_same_first_token=int(hit.argmax()) == int(cold.argmax()),
               factor=ROUNDING_FACTOR)
    log(f"  bf16 rounding {cfg.name}, last prompt position's logits (max "
        f"|logit| {scale:.3f}): batched vs fp32 {e_b:.4f}, per-sequence vs "
        f"fp32 {e_s:.4f}, per-sequence vs batched {d:.4f}, first tokens "
        f"equal {same} of {len(prompts)}; RTC cold vs fp32 {e_c:.4f}, hit "
        f"vs fp32 {e_h:.4f}, hit vs cold {d_h:.4f} (tol "
        f"{ROUNDING_FACTOR:g} x the batched / cold error; {card_line()})")
    assert e_s <= ROUNDING_FACTOR * e_b and d <= ROUNDING_FACTOR * e_b, out
    assert e_h <= ROUNDING_FACTOR * e_c and d_h <= ROUNDING_FACTOR * e_c, out
    return out


def phase10(dev):
    """The reference engine's switches at full width and depth: qwen3-8b
    with each paged switch off against the default, the RTC on repeated
    and shared prefixes; rwkv6-1.6b and recurrentgemma-2b with the unfused
    decode and the raw-length prefill. Returns the rows, the fp32
    near-ties and each kernel's launches over the bf16 runs."""
    from repro_torch.configs import get_config
    log(f"phase 10: switches [{time.monotonic() - T0:.1f} s]")
    out = {"rows": [], "near_ties": {}}
    for name in ("qwen3-8b", *SWITCH_SLOT_ARCHS):
        if name == "qwen3-8b":
            rows, ties = switch_set(get_config(name), dev, PAGED_SWITCHES,
                                    PAGED_SAME, 8)
        else:
            rows, ties = switch_set(get_config(name), dev, SLOT_SWITCHES,
                                    SLOT_SAME, 6, max_prompt=512,
                                    **SLOT_SWITCH_ECFG)
        for r in rows:
            r["arch"] = name
        out["rows"] += rows
        out["near_ties"][name] = ties
    launches = {}
    for r in out["rows"]:
        for k, n in r.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    log(f"phase 10 done: launches {launches} [{time.monotonic() - T0:.1f} s]")
    return out


# phase 11: the decode programs against the eager horizon, on phase 3's
# request sets (n greedy + n sampled) and engine config
PROGRAM_ARCHS = (("qwen3-8b", 8, 2), ("granite-moe-3b-a800m", 6, 2),
                 ("rwkv6-1.6b", 6, 2), ("recurrentgemma-2b", 6, 2))
# phase 12: the prefill programs against the eager prefill, the same
# request sets (seamless's with seeded frames)
PREFILL_PROGRAM_ARCHS = PROGRAM_ARCHS + (("seamless-m4t-large-v2", 6, 2),)


def _eager_decode(te):
    """Make ``te`` decode through the eager horizon (the paged runner's
    ``decode_eager``, the slot runner's ``decode_sample_eager``): the
    comparisons of phases 3 (the MoE census), 10 and 11 only; the engine
    itself never picks it on one card."""
    rt = te.runner
    if te.pool is not None:
        rt.decode_fused = rt.decoder.decode_eager
    else:
        rt.decode_sample = rt.decoder.decode_sample_eager


def _eager_prefill(te):
    """Make ``te`` prefill through the eager forms (the ragged pass and
    the per-sequence chunk, or the slot chunk on the slot's own rows with
    an int ``n_valid``): the comparisons of phases 3, 10 and 12 only."""
    pre = te.runner.prefill
    pre.prefill_chunk = pre.prefill_chunk_eager
    if te.pool is not None:
        pre.prefill_ragged_host = pre.prefill_ragged_host_eager


def _eager_all(te):
    """Every program of ``te`` replaced by its eager form, the unfused
    step's too (phase 10's comparisons)."""
    _eager_decode(te)
    _eager_prefill(te)
    te.runner.decoder.decode = te.runner.decoder.decode_step_eager


MODES = {"eager": _eager_decode, "eager_prefill": _eager_prefill,
         "programs": None}


def _shifted(cfg, reqs, tag):
    """``reqs`` again with every prompt id moved by one (the same lengths,
    so the same buckets, and no prefix-cache hit on the first pass)."""
    from repro_torch.engine import Request
    v = cfg.vocab_size
    return [Request(prompt_tokens=[t + 1 if t + 1 < v else 3
                                   for t in r.prompt_tokens],
                    sampling=r.sampling, req_id=f"{tag}{i}",
                    extra=r.extra)
            for i, r in enumerate(reqs)]


def program_pass(te, cfg, reqs, tag):
    """Serve ``reqs`` on ``te`` (launch counts zeroed just before the
    first arrives, read just after the last completes); the tokens in
    request order, TTFT, TPOT, the decode rate over the steps that ran no
    prefill pass, the wall of the engine's prefill calls, launches and
    the programs of each kind this pass built."""
    import torch
    from repro_torch.kernels import ops
    builds0, pbuilds0 = te.jit_compiles, te.prefill_jit_compiles
    d0, p0 = te.decode_steps, te.prefill_dispatches
    walls = []
    attr = "_prefill_batched" if te.pool is not None else "_prefill_slot"
    prefill = getattr(te, attr)

    def timed(entries):
        t0 = time.monotonic()
        prefill(entries)
        walls.append(time.monotonic() - t0)
    setattr(te, attr, timed)
    ops.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0              # the set is served again in each mode
        te.add_request(r)
    comps, dec_s, dec_tok = [], 0.0, 0
    while te.has_work():
        assert te.steps < 4000, "serving did not converge"
        pf, tk, ts = te.prefill_dispatches, te.decode_tokens, time.monotonic()
        comps += te.step()
        if te.prefill_dispatches == pf:
            dec_s += time.monotonic() - ts
            dec_tok += te.decode_tokens - tk
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    delattr(te, attr)
    _check_comps(comps, reqs, cfg)
    by_id = {c.req_id: c for c in comps}
    ttft = sorted(c.ttft * 1e3 for c in comps)
    row = dict(pass_=tag, wall_s=wall,
               tokens=[by_id[r.req_id].tokens for r in reqs],
               ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
               tpot_ms_mean=_mean([c.tpot * 1e3 for c in comps]),
               decode_tok_per_s=dec_tok / max(dec_s, 1e-9),
               prefill_call_ms_mean=1e3 * _mean(walls),
               launches=ops.launch_counts(), switch=tag,
               decode_iterations=te.decode_steps - d0,
               prefill_passes=te.prefill_dispatches - p0,
               programs_built=te.jit_compiles - builds0,
               prefill_programs_built=te.prefill_jit_compiles - pbuilds0)
    names = PATH_KERNELS[cfg.name]
    if names:
        _hold_launches(cfg, row)
        row["launches_per_iteration"] = row["launches"][names[0]] / (
            row["decode_iterations"] + (0 if te.pool is not None
                                        else row["prefill_passes"]))
    else:
        assert not any(row["launches"].values()), row["launches"]
        row["launches_per_iteration"] = 0.0
    # the prefill kernel's launches per prefill dispatch (the slot
    # family's recurrence launches per dispatch the same in every pass)
    row["launches_per_prefill"] = (
        row["launches"][names[-1]] / row["prefill_passes"]
        if names and te.pool is not None else row["launches_per_iteration"])
    return row


def _graph_pool_gib(te) -> float:
    """The GiB the caching allocator holds in ``te``'s graph pool (its
    segments in a memory snapshot)."""
    import torch
    pid = te.runner.programs.pool_id
    if pid is None:
        return 0.0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pid)) / 2**30


def _sync_free(call, cfg, n=3):
    """``call`` (one program's key) run ``n`` times: the first outside,
    the rest under sync-debug "error" (a blocking device call raises)."""
    import torch
    for i in range(n):
        torch.cuda.synchronize()
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            toks = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if toks is not None:
            assert int(toks.max()) < cfg.vocab_size


def steady_replays_sync_free(te, cfg, reqs):
    """Two of ``reqs`` prefilled, then one decode program (a paged
    horizon of 4 over the hot state rebuilt from them, or the slot step)
    called three times: the first call outside, the next two under
    sync-debug "error". Returns the program's key; the TE is left
    unservable (its device rows ran ahead of the host)."""
    import numpy as np
    for r in reqs[:2]:
        te.add_request(r)
    while te.scheduler.waiting or te.scheduler.prefilling \
            or len(te.scheduler.running) < 2:
        te.step()
    live = list(te.scheduler.running)
    if te.pool is not None:
        hot = te._hot_state()
        for sq in live:
            te._ensure_pages_no_preempt(sq, len(sq.tokens) + 12)
        hot.reset()
        hot.sync([(sq.seq_id, sq.pages, len(sq.tokens), sq.tokens[-1], 0.0,
                   1.0) for sq in live])
        call = lambda: te.runner.decode_fused(hot, 4)          # noqa: E731
        key = (4, hot.bb, hot.pb, True)
    else:
        temps = np.zeros((te.ecfg.n_slots,), np.float32)
        top_ps = np.ones((te.ecfg.n_slots,), np.float32)
        call = lambda: te.runner.decode_sample(                 # noqa: E731
            live, temps, top_ps, te._gen)
        key = (True,)
    _sync_free(call, cfg)
    assert key in te.runner.programs.programs, key
    return key


def steady_prefill_sync_free(te, cfg, req):
    """One prefill program called three times, the first outside and the
    next two under sync-debug "error": a ragged pass over ``req``'s first
    512 ids parked on the scratch page (an all-padding plan's key of this
    serve, all greedy), or one 256-id chunk of ``req`` on a free slot (its
    rows staged in and out, its modality inputs copied in). The first
    tokens are fetched outside. Returns the program's key."""
    import numpy as np
    from repro_torch.engine.hotloop import pow2_bucket
    from repro_torch.engine.runners.base import SequenceState
    from repro_torch.kernels import flash_prefill as FP
    rt = te.runner
    if te.pool is not None:
        s = rt.pool.scratch_page()
        sb = pow2_bucket(te.ecfg.max_prefill_seqs)
        cu = [0] * (sb + 1)
        toks = (req.prompt_tokens * 8)[:512]
        arrays = (toks, np.zeros(512), np.full(512, s),
                  np.zeros(512), cu, np.full((sb, 64), s), np.zeros(sb),
                  FP.build_tiles(cu, 512), np.zeros(sb))
        temps = np.zeros((sb,), np.float32)
        _sync_free(lambda: rt.prefill_ragged_host(
            arrays, temps, np.ones_like(temps), te._gen)[1], cfg)
        key = ("ragged", 512, 64, sb, True)
    else:
        seq = SequenceState(seq_id="sync",
                            tokens=(req.prompt_tokens * 4)[:256],
                            n_prompt=10 ** 6, extra=dict(req.extra))
        assert rt.alloc_slot(seq)
        _sync_free(lambda: rt.prefill_chunk(seq, seq.tokens), cfg)
        rt.free_slot(seq)
        key = ("slot_prefill", 256) + ((tuple(sorted(req.extra)),)
                                       if req.extra else ())
    prog = rt.programs.prefill_programs[key]
    assert prog.graph is not None or te.device.type != "cuda", key
    return key


def _phase_requests(cfg, n_greedy, n_sampled):
    """Phase 3's request set of ``cfg`` (its prompts and sampling), each
    request with its own seeded modality inputs where the model takes
    them."""
    import numpy as np
    reqs = _requests(cfg, n_greedy, n_sampled)
    rs = np.random.RandomState(1)
    for r in reqs:
        r.extra = modality(cfg, rs)
    return reqs


def _capture_stats(progs):
    cap = sorted(p.capture_ms for p in progs) or [0.0]
    return dict(programs=len(progs), capture_ms_median=cap[len(cap) // 2],
                capture_ms_max=cap[-1], capture_ms_sum=sum(cap),
                replay_launches={str(p.key): p.launches for p in progs[:3]})


def program_model(name, n_greedy, n_sampled, dev,
                  modes=("eager", "programs")):
    """One model at full width, bf16, served in one process once per mode
    of ``modes``: "eager" (the eager horizon, prefill programs: phase 11's
    comparison), "eager_prefill" (the eager prefill, decode programs:
    phase 12's) and "programs" (both kinds), each in two passes (the
    phase-3 requests, then the same lengths shifted by one id). Against
    the programs: greedy tokens equal bit for bit, sampled ids valid, the
    same launches per decode iteration and per prefill dispatch, no
    program of either kind built in the second pass, and a steady replay
    with no host sync. Returns {"decode": phase 11's row, "prefill":
    phase 12's row} for the comparisons ``modes`` holds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import FlowServe
    from repro_torch.models import transformer as T
    cfg = get_config(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    reqs = _phase_requests(cfg, n_greedy, n_sampled)
    again = _shifted(cfg, reqs, "s")
    runs, stats = {}, {}
    for mode in modes:
        te = FlowServe(cfg, params, _engine_config(cfg, torch.bfloat16),
                       name=f"te-{mode}", device=dev)
        if MODES[mode] is not None:
            MODES[mode](te)
        runs[mode] = [program_pass(te, cfg, reqs, "first"),
                      program_pass(te, cfg, again, "second")]
        if mode == "programs":
            progs = te.runner.programs
            stats["decode"] = dict(
                _capture_stats(list(progs.programs.values())),
                jit_compiles=te.jit_compiles)
            stats["prefill"] = dict(
                _capture_stats(list(progs.prefill_programs.values())),
                prefill_jit_compiles=te.prefill_jit_compiles)
            for k in stats:
                stats[k]["graph_pool_gib"] = _graph_pool_gib(te)
            if "eager_prefill" in modes:
                stats["prefill"]["sync_free_key"] = str(
                    steady_prefill_sync_free(te, cfg, reqs[0]))
            if "eager" in modes:
                stats["decode"]["sync_free_key"] = str(
                    steady_replays_sync_free(te, cfg, _shifted(cfg, reqs,
                                                               "z")))
        del te
        _release()
    out = {}
    for kind, base, keys in (
            ("decode", "eager", ("tpot_ms_mean", "decode_tok_per_s",
                                 "wall_s", "launches_per_iteration",
                                 "decode_iterations", "programs_built")),
            ("prefill", "eager_prefill", (
                "ttft_ms_p50", "ttft_ms_max", "tpot_ms_mean",
                "prefill_call_ms_mean", "wall_s", "launches_per_prefill",
                "launches_per_iteration", "prefill_passes",
                "prefill_programs_built", "programs_built"))):
        if base not in modes:
            continue
        row = dict(model=name, **stats[kind])
        for i, tag in enumerate(("first", "second")):
            e, g = runs[base][i], runs["programs"][i]
            same = sum(a == b for a, b in zip(e["tokens"][:n_greedy],
                                              g["tokens"][:n_greedy]))
            assert same == n_greedy, \
                f"{name} {kind} {tag} pass: {same} of {n_greedy} greedy " \
                f"requests equal"
            for k in ("launches_per_iteration", "launches_per_prefill",
                      "decode_iterations", "prefill_passes"):
                assert e[k] == g[k], (kind, tag, k, e[k], g[k])
            row[tag] = {k: dict(eager=e[k], programs=g[k]) for k in keys}
            row[tag]["greedy_equal"] = f"{same}/{n_greedy}"
        second = runs["programs"][1]
        assert second["programs_built"] == 0 \
            and second["prefill_programs_built"] == 0, \
            f"{name}: the second pass over the same buckets built programs"
        row["card"] = card_line()
        log(f"  {kind} programs: " + json.dumps(row))
        out[kind] = row
    del params
    _release()
    return out


def program_warmup(dev):
    """qwen3-8b at full width, bf16, phase 3's engine config:
    ``warmup_decode`` builds the whole grid (4 batch x 9 page x 4 horizon
    buckets = 144 programs, all-greedy); its seconds, each program's
    capture ms, the graph pool's GiB and the device memory it added; then
    phase 3's request set, all greedy, served inside the grid builds no
    program. Run by ``--only programs`` alone (about 2 min)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import FlowServe
    from repro_torch.models import transformer as T
    log(f"phase 11: the warmup grid [{time.monotonic() - T0:.1f} s]")
    cfg = get_config("qwen3-8b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    te = FlowServe(cfg, params, _engine_config(cfg, torch.bfloat16),
                   device=dev)
    torch.cuda.synchronize()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.monotonic()
    n = te.warmup_decode()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    cap = sorted(p.capture_ms for p in te.runner.programs.programs.values())
    by_k = {}
    for key, p in te.runner.programs.programs.items():
        by_k.setdefault(key[0], []).append(p.capture_ms)
    out = dict(model=cfg.name, shapes_run=n, programs=te.jit_compiles,
               warmup_s=secs, capture_ms_median=cap[len(cap) // 2],
               capture_ms_max=cap[-1], capture_ms_sum=sum(cap),
               capture_ms_mean_by_horizon={k: _mean(v) for k, v in
                                           sorted(by_k.items())},
               graph_pool_gib=_graph_pool_gib(te),
               allocated_gib_added=(torch.cuda.memory_allocated() - alloc0)
               / 2**30,
               reserved_gib_added=(torch.cuda.memory_reserved() - res0)
               / 2**30)
    assert n == te.jit_compiles == 4 * 9 * 4, out
    row = program_pass(te, cfg, _requests(cfg, 10, 0), "warm")
    assert row["programs_built"] == 0, row["programs_built"]
    out.update({k: row[k] for k in ("tpot_ms_mean", "decode_tok_per_s",
                                    "programs_built")})
    log("  warmup grid: " + json.dumps(out))
    del te, params
    _release()
    return out


def prefill_warmup(dev):
    """qwen3-8b at full width, bf16, phase 3's engine config:
    ``warmup_prefill`` builds its whole grid (pow2s(512 + 8) = 11 token
    buckets x pow2s(2048 // 8) = 9 page buckets = 99 ragged programs, all
    greedy, Sb 8); its seconds, each program's capture ms, the graph
    pool's GiB and the memory it added at its peak and after; then phase
    3's request set, all greedy, served inside the grid builds no prefill
    program. Run by ``--only prefill-programs`` alone."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import FlowServe
    from repro_torch.models import transformer as T
    log(f"phase 12: the prefill warmup grid [{time.monotonic() - T0:.1f} s]")
    cfg = get_config("qwen3-8b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, torch.bfloat16, dev)
    te = FlowServe(cfg, params, _engine_config(cfg, torch.bfloat16),
                   device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.monotonic()
    n = te.warmup_prefill()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    progs = te.runner.programs.prefill_programs
    by_tb = {}
    for key, p in progs.items():
        by_tb.setdefault(key[1], []).append(p.capture_ms)
    out = dict(model=cfg.name, shapes_run=n,
               prefill_programs=te.prefill_jit_compiles, warmup_s=secs,
               **{k: v for k, v in _capture_stats(list(
                   progs.values())).items() if k != "replay_launches"},
               capture_ms_mean_by_token_bucket={
                   k: _mean(v) for k, v in sorted(by_tb.items())},
               graph_pool_gib=_graph_pool_gib(te),
               allocated_gib_added=(torch.cuda.memory_allocated() - alloc0)
               / 2**30,
               peak_gib_added=(torch.cuda.max_memory_allocated() - alloc0)
               / 2**30,
               reserved_gib_added=(torch.cuda.memory_reserved() - res0)
               / 2**30, card=card_line())
    assert n == te.prefill_jit_compiles == 11 * 9, out
    row = program_pass(te, cfg, _requests(cfg, 10, 0), "warm")
    assert row["prefill_programs_built"] == 0, row["prefill_programs_built"]
    out.update({k: row[k] for k in ("ttft_ms_p50", "ttft_ms_max",
                                    "tpot_ms_mean", "prefill_call_ms_mean",
                                    "prefill_programs_built")})
    log("  prefill warmup grid: " + json.dumps(out))
    del te, params
    _release()
    return out


def phase11(dev):
    """The decode programs at full width: each of ``PROGRAM_ARCHS`` served
    through the eager horizon and through the captured programs in one
    process. Returns the rows."""
    log(f"phase 11: decode programs [{time.monotonic() - T0:.1f} s]")
    out = []
    for name, n_greedy, n_sampled in PROGRAM_ARCHS:
        log(f"phase 11: {name} [{time.monotonic() - T0:.1f} s]")
        out.append(program_model(name, n_greedy, n_sampled, dev)["decode"])
    log(f"phase 11 done [{time.monotonic() - T0:.1f} s]")
    return out


def phase12(dev):
    """The prefill programs at full width: each of
    ``PREFILL_PROGRAM_ARCHS`` served through the eager prefill and through
    the captured programs in one process. Returns the rows."""
    log(f"phase 12: prefill programs [{time.monotonic() - T0:.1f} s]")
    out = []
    for name, n_greedy, n_sampled in PREFILL_PROGRAM_ARCHS:
        log(f"phase 12: {name} [{time.monotonic() - T0:.1f} s]")
        out.append(program_model(name, n_greedy, n_sampled, dev,
                                 ("eager_prefill", "programs"))["prefill"])
    log(f"phase 12 done [{time.monotonic() - T0:.1f} s]")
    return out


def phase11_12(dev):
    """Phases 11 and 12 of the whole run in one pass over the models: each
    served with the eager horizon, with the eager prefill and with both
    kinds of program (the last run shared by both comparisons), seamless
    with the latter two. Returns (phase 11's rows, phase 12's rows)."""
    log(f"phases 11-12: decode and prefill programs "
        f"[{time.monotonic() - T0:.1f} s]")
    decode, prefill = [], []
    for name, n_greedy, n_sampled in PREFILL_PROGRAM_ARCHS:
        log(f"phases 11-12: {name} [{time.monotonic() - T0:.1f} s]")
        modes = ("eager", "eager_prefill", "programs") \
            if (name, n_greedy, n_sampled) in PROGRAM_ARCHS \
            else ("eager_prefill", "programs")
        rows = program_model(name, n_greedy, n_sampled, dev, modes)
        if "decode" in rows:
            decode.append(rows["decode"])
        prefill.append(rows["prefill"])
    log(f"phases 11-12 done [{time.monotonic() - T0:.1f} s]")
    return decode, prefill


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["all", "kernels", "pd", "fleet",
                                       "tp", "train", "long",
                                       "long-process", "switches",
                                       "programs", "prefill-programs"],
                    default="all",
                    help="'kernels' stops after phase 2 (a first check of a "
                         "new kernel); 'pd' runs phases 1 and 5 alone, "
                         "'fleet' phases 1 and 6, 'tp' phases 1 and 7, "
                         "'train' phases 1 and 8, 'long' phases 1 and 9 "
                         "('long-process': phase 9 alone, the process "
                         "phase9_process starts), 'switches' phases 1 and "
                         "10, 'programs' phases 1 and 11, "
                         "'prefill-programs' phases 1 and 12")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if args.only == "long-process":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        row = phase9(torch.device("cuda"))
        print(LONG_MARK + json.dumps(row), flush=True)
        return 0
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 1: build")
    _build.build_all()
    log(f"  built {sorted(p.name for p in _build.BUILD_DIR.glob('*.so'))} "
        f"in {_build.build_seconds:.2f} s")
    for stem, rep in sorted(_build.ptxas_report.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")

    if args.only == "train":
        log(json.dumps({"train": phase8(dev)}))
        log(card)
        return 0
    if args.only == "long":
        log(json.dumps({"long": phase9_process()}))
        log(card)
        return 0
    if args.only == "switches":
        log(json.dumps({"switches": phase10(dev)}))
        log(card)
        return 0
    if args.only == "programs":
        log(json.dumps({"programs": phase11(dev),
                        "warmup": program_warmup(dev)}))
        log(card)
        return 0
    if args.only == "prefill-programs":
        log(json.dumps({"prefill_programs": phase12(dev),
                        "warmup": prefill_warmup(dev)}))
        log(card)
        return 0
    if args.only in ("pd", "fleet", "tp"):
        {"pd": phase5, "fleet": phase6, "tp": phase7}[args.only](dev)
        log(card)
        return 0

    log(f"phase 2: kernels vs plain versions [{time.monotonic() - T0:.1f} s]")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    sweep_paged_attention(gen, dev)
    sweep_flash_prefill(gen, dev)
    sweep_paged_prefill(dev)
    sweep_wkv6(gen, dev)
    edges_wkv6(gen, dev)
    sweep_rglru(gen, dev)
    qwen, rwkv, rgemma = (get_config(n) for n in
                          ("qwen3-8b", "rwkv6-1.6b", "recurrentgemma-2b"))
    rows = [main_path_decode(qwen, dev), main_path_prefill(qwen, dev),
            main_path_wkv6(rwkv, dev), main_path_rglru(rgemma, dev)]
    for r, cfg in zip(rows, (qwen, qwen, rwkv, rgemma)):
        r["arch"] = cfg.name
    new = [get_config(n) for n in NEW_ARCHS]
    arch = [r for cfg in new for r in arch_rows(cfg, dev)]
    if args.only == "kernels":
        log(json.dumps({"arch_kernels": arch}))
        log(json.dumps({"kernels": rows}))
        log(card)
        return 0

    # phase 3: each path's launch counts are zeroed just before it runs and
    # read just after; a kernel's row takes the count of its own path
    launches = {}
    cross = [get_config(n) for n in CROSS_ARCHS]
    served = [(qwen, 8, 2), (rwkv, 6, 2), (rgemma, 6, 2)] \
        + [(a, 6, 2) for a in new + cross]
    for cfg, n_greedy, n_sampled in served:
        full = cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT.get(cfg.name, full))
        cut = "" if cfg.n_layers == full else \
            f" (depth cut from {full}: full-width weights of all {full} " \
            f"layers do not fit the card)"
        log(f"phase 3: full-width serving ({cfg.name}, {cfg.n_layers} "
            f"layers{cut}, bf16) [{time.monotonic() - T0:.1f} s]")
        out = serve(cfg, dev, n_greedy, n_sampled)
        for name in PATH_KERNELS[cfg.name]:
            launches[cfg.name, name] = out["launches"][name]
    for r in rows + arch:
        r["launches"] = launches[r["arch"], r["name"]]

    for cfg, n_layers in ((qwen, 2), (rwkv, 2), (rgemma, 3),
                          *((a, 2) for a in new)):
        log(f"phase 4: kernel path vs plain path ({cfg.name}, {n_layers} "
            f"layers, fp32) [{time.monotonic() - T0:.1f} s]")
        parity(cfg, dev, n_layers)
    for cfg, n_layers, n_enc in ((cross[0], 5, None), (cross[1], 2, 2)):
        log(f"phase 4: engine vs teacher-forced greedy oracle ({cfg.name}, "
            f"{n_layers} layers, fp32) [{time.monotonic() - T0:.1f} s]")
        oracle_parity(cfg, dev, n_layers, n_enc)

    pd = phase5(dev)
    fleet = phase6(dev)
    tp_kernels, tp_launches = phase7(dev)
    train = phase8(dev)
    longctx = phase9_process()
    switches = phase10(dev)
    programs, prefill_programs = phase11_12(dev)
    for r in rows:
        r["launches_pd"] = pd[r["arch"], r["name"]]
        r["launches_fleet"] = fleet[r["arch"], r["name"]]
        r["launches_tp"] = tp_launches.get((r["arch"], r["name"]))
        r["launches_long"] = longctx["launches"].get(r["name"], 0)
        r["launches_switches"] = switches["launches"][r["name"]]
    log(f"done [{time.monotonic() - T0:.1f} s]")

    log(json.dumps({"prefill_programs": prefill_programs}))
    log(json.dumps({"programs": programs}))
    log(json.dumps({"switches": switches}))
    log(json.dumps({"long": longctx}))
    log(json.dumps({"train": train}))
    log(json.dumps({"tp_kernels": tp_kernels}))
    log(json.dumps({"arch_kernels": arch}))
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
