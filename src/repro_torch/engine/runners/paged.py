"""Paged-KV runner family of the port (torch counterpart of
``repro/engine/runners/paged.py``): the colocated paged path's prefill and
decode phases, with attention through the port's kernels.

  * ``PagedPrefillRunner.prefill_ragged`` — the step's whole ragged prefill
    plan in one pass: flat token stream, one KV write per layer across all
    sequences, attention by the paged varlen prefill kernel over each
    entry's block-table row (where JAX gathers a page run per token), and
    the first token sampled from the chunk-final rows.
    ``PagedPrefillRunner.prefill_chunk`` is the per-sequence path
    (``batched_prefill=False``): the same pass over one sequence's chunk,
    the kernel's varlen entry with a single entry.
  * ``PagedDecodeRunner`` — the decode hot loop: the legacy per-step
    ``decode`` and the fused K-step ``decode_fused`` horizon, attention by
    the paged decode kernel (where the JAX engine calls its jnp oracle).

Each fused horizon is one device program (``engine/programs.py``), keyed
(K, Bb, Pb, all-greedy) as the reference keys its jits (K, Bb, Pb): on a
card the K decode+sample steps are captured once as one CUDA graph and
replayed per horizon; on the CPU the program runs the same body directly.
The reference's key has no greedy flag because its ``lax.cond`` picks the
sampler inside the jit; the port picks it on the host
(``DecodeHotState.all_greedy``), so in an all-greedy run both count the
same programs (``jit_compiles``). The prefill is programs too, counted as
``prefill_jit_compiles``: the ragged pass keyed ("ragged", Tb, Pb, Sb,
all-greedy) (the reference's ``_ragged_fn`` (Tb, Pb, Sb)), the
per-sequence chunk ("chunk", c, npages); and so is the unfused step,
("step", B, maxp), counted as ``jit_compiles``. Each program's operands
are views of one int32 static buffer that the engine uploads into in one
copy. ``decode_eager``, ``prefill_ragged_eager``, ``prefill_chunk_eager``
and ``decode_step_eager`` are the eager forms, kept for the comparisons
in the tests and ``chip_smoke.py``; the engine runs them only for a TE
whose ranks lie on more than one device, which keeps no program (decided
from the mesh when the runner is built).

The KV pool is updated in place (``index_put_``) where the JAX package
donates the pool to its jit and gets a new one back. Padding tokens and
padding rows all write slot 0 of the pool's scratch page; those duplicate
writes race, which is harmless because nothing reads that page.

Tensor parallelism: the weights are a list of rank trees (one at tp 1)
over the pool's mesh. Inside each layer every rank holding a head slice
writes its K/V into its own pool and runs the attention kernel on its own
shard (H/tp query and Hkv/tp KV heads); its output goes to ``block_out``,
which all-reduces the output projections' partials. The per-rank
operands of a pass (positions, pages, slots, block tables) are resolved
once, before the layer loop.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.engine.hotloop import (i32_buffer, pack_i32, split_views,
                                        to_device, upload_i32, upload_into)
from repro_torch.engine.programs import Program, ProgramCache
from repro_torch.engine.runners.base import SequenceState
from repro_torch.engine.sampling import greedy_core, sample_core
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T


class PagedRunner:
    """Family facade: shared state (the ranks' weights, the pool and its
    mesh, per-layer windows) and delegation to the two phase runners."""

    def __init__(self, cfg, params: list, pool, impl: str = "auto"):
        self.cfg = cfg
        self.pool = pool
        self.mesh = pool.mesh
        self.params = params                # one weights tree per rank
        self.impl = impl                    # "auto" (kernels) | "ref"
        # each layer's views of every rank's stacked weights
        self.layers = [[T.layer(p, li) for p in params]
                       for li in range(cfg.n_layers)]
        # None on global layers: the kernels then skip the window test
        self.windows = [w if w < T.GLOBAL_WINDOW else None
                        for w in T.window_schedule(cfg)]
        self.prefill = PagedPrefillRunner(self)
        self.decoder = PagedDecodeRunner(self)
        self.programs = ProgramCache(self.mesh)   # both kinds

    @property
    def jit_compiles(self) -> int:
        """Decode programs built (warmup included): the reference's count
        of decode-path jit cache misses."""
        return self.programs.builds

    @property
    def prefill_jit_compiles(self) -> int:
        """Prefill programs built (warmup included): the reference's count
        of prefill-path jit cache misses."""
        return self.programs.prefill_builds

    def layer_attn_inputs(self, li: int, r: int, q, k_new, v_new, pages,
                          slots):
        """Write rank r's fresh K/V of layer ``li`` into its pool in place;
        return the query in the pool's dtype and the layer's pool views."""
        kp, vp = self.pool.k[r][li], self.pool.v[r][li]
        kp.index_put_((pages, slots), k_new.to(kp.dtype))
        vp.index_put_((pages, slots), v_new.to(vp.dtype))
        return q.to(kp.dtype), kp, vp

    def decode(self, seqs: List[SequenceState]) -> torch.Tensor:
        return self.decoder.decode(seqs)

    def decode_fused(self, state, k_steps: int) -> torch.Tensor:
        return self.decoder.decode_fused(state, k_steps)

    def prefill_ragged(self, *args, **kw):
        return self.prefill.prefill_ragged(*args, **kw)

    def prefill_ragged_host(self, arrays, temps, top_ps, gen):
        return self.prefill.prefill_ragged_host(arrays, temps, top_ps, gen)

    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]):
        return self.prefill.prefill_chunk(seq, chunk_tokens)

    def warmup_fused(self, batch_buckets, page_buckets, horizons, gen) -> int:
        return self.decoder.warmup_fused(batch_buckets, page_buckets,
                                         horizons, gen)

    def warmup_ragged(self, token_buckets, page_buckets, n_rows: int) -> int:
        return self.prefill.warmup_ragged(token_buckets, page_buckets, n_rows)

    # ------------------------------------------------------------ PD export
    def export_kv(self, seq: SequenceState, host_gather: bool = False):
        """The PD migration payload: the sequence's page run (one run per
        rank) and its metadata. By default the run stays on the device (one
        gather per distinct pool, no host copy) and DistFlow moves it
        device to device; ``host_gather=True`` keeps the v1 host round trip
        (host tensors)."""
        meta = {"tokens": list(seq.tokens), "n_prompt": seq.n_prompt,
                "n_cached": seq.n_cached, "n_pages": len(seq.pages)}
        if host_gather:
            k, v = self.pool.gather(seq.pages)
            return {"k": k, "v": v, "host_gather": True, **meta}
        k, v = self.pool.gather_device(seq.pages)
        return {"k": k, "v": v, **meta}

    def import_kv(self, payload, pages: List[int]) -> None:
        """Install a migrated page run in place: a whole run (``k``/``v``,
        device or host, in the source's layout) or the layer chunks of a
        ``MigrationHandle`` (``{"chunks": [(layer_start, k, v), ...]}``,
        already in this pool's layout). Either way ``reshard`` puts each
        run in this pool's layout: a no-op for a run DistFlow already
        placed; a host run (v1) is uploaded, and re-split when the two
        TEs' tp differ."""
        chunks = payload.get("chunks")
        if chunks is None:
            chunks = [(0, payload["k"], payload["v"])]
        # the run covers the pages allocated at import time; a lazy import
        # may land after _ensure_pages appended the next decode page
        pages = pages[:chunks[0][1][0].shape[1]]
        mesh, dim = self.pool.run_sharding()
        for l0, k_run, v_run in chunks:
            k_run, v_run = (SH.reshard(run, SH.run_dim(self.cfg, run), dim,
                                       mesh, copy=False)
                            for run in (k_run, v_run))
            self.pool.scatter_run(pages, k_run, v_run, layer_start=l0)


# ===========================================================================
# Prefill phase
# ===========================================================================


class PagedPrefillRunner:
    def __init__(self, rt: PagedRunner):
        self.rt = rt

    @property
    def captures(self) -> bool:
        """Whether the prefill runs through its programs: on one device,
        unless the TE runs the plain kernel versions (``impl="ref"``),
        whose paged varlen prefill (``kernels/ref.py::paged_prefill_ref``)
        reads its entry offsets on the host and so cannot be captured:
        such a TE keeps the eager prefill, as its construction decides."""
        return self.rt.programs.enabled and self.rt.impl != "ref"

    # ------------------------------------------------------------ ragged
    @staticmethod
    def ragged_shapes(tb: int, pb: int, sb: int) -> tuple:
        """The shapes of the nine int32 operands of the ragged key (Tb, Pb,
        Sb), in ``prefill_ragged``'s order: fixed per key
        (``build_tiles`` returns (``max_tiles(Tb, Sb)``, 3))."""
        return ((tb,), (tb,), (tb,), (tb,), (sb + 1,), (sb, pb), (sb,),
                (FP.max_tiles(tb, sb), 3), (sb,))

    @torch.no_grad()
    def prefill_ragged(self, tokens, positions, pages, slots, cu_tokens,
                       entry_bt, entry_start, tiles, final_idx, temps,
                       top_ps, all_greedy: bool, gen: torch.Generator):
        """The whole step's prefill plan (DESIGN.md §12) through the
        program of (Tb, Pb, Sb, all-greedy): the reference's ``_ragged_fn``
        keys (Tb, Pb, Sb) and picks the sampler inside its jit, the port
        picks it on the host, as for the decode horizon. Operands, all on
        the pool's device:
          tokens/positions/pages/slots  (Tb,)   flat ragged token stream;
                                                padding tokens point at the
                                                scratch page, slot 0, pos 0
          cu_tokens (Sb+1,), entry_bt (Sb, Pb), entry_start (Sb,)
                                                entry-level block tables
          tiles (n_tiles, 3)                    the kernel's query tiles
                                                (``flash_prefill.build_tiles``)
          final_idx (Sb,)                       each entry's chunk-final row
          temps/top_ps (Sb,)                    per-entry sampling params
        ``all_greedy`` is decided on the host from ``temps``. Each operand
        is copied into the program's static buffer (device to device);
        the engine uploads its host arrays there directly
        (``prefill_ragged_host``). Returns (logits (Sb, Vp), sampled tokens
        (Sb,) int32): on a card the program's static outputs, consumed
        before the next program call."""
        ops_ = (tokens, positions, pages, slots, cu_tokens, entry_bt,
                entry_start, tiles, final_idx)
        if not self.captures:
            return self.prefill_ragged_eager(*ops_, temps, top_ps,
                                             all_greedy, gen)
        prog = self._ragged_program(tokens.shape[0], *entry_bt.shape[::-1],
                                    all_greedy, gen)
        for dst, src in zip(split_views(prog.inputs["ops"], [
                t.shape for t in ops_]), ops_):
            dst.copy_(src, non_blocking=True)
        return prog(**({} if all_greedy else dict(temps=temps,
                                                  top_ps=top_ps)))

    @torch.no_grad()
    def prefill_ragged_host(self, arrays, temps: np.ndarray,
                            top_ps: np.ndarray, gen: torch.Generator):
        """``prefill_ragged`` from the engine's host arrays (the nine int32
        operands in order, (Sb,) temps / top_ps): one host-to-device copy
        into the program's static buffer (pinned, non-blocking), the
        sampling params only for a sampled key."""
        rt = self.rt
        if not self.captures:
            return self.prefill_ragged_host_eager(arrays, temps, top_ps, gen)
        greedy = not bool((temps > 0.0).any())
        sb, pb = np.shape(arrays[5])
        prog = self._ragged_program(len(arrays[0]), pb, sb, greedy, gen)
        upload_into(prog.inputs["ops"], pack_i32(*arrays))
        if not greedy:
            upload_into(prog.inputs["temps"], temps)
            upload_into(prog.inputs["top_ps"], top_ps)
        return prog()

    @torch.no_grad()
    def prefill_ragged_host_eager(self, arrays, temps: np.ndarray,
                                  top_ps: np.ndarray, gen: torch.Generator):
        """``prefill_ragged_host`` as eager launches (the operands uploaded
        in one copy, then ``prefill_ragged_eager``)."""
        dev = self.rt.pool.device
        greedy = not bool((temps > 0.0).any())
        t_dev = p_dev = None
        if not greedy:
            t_dev, p_dev = to_device(temps, dev), to_device(top_ps, dev)
        return self.prefill_ragged_eager(*upload_i32(dev, *arrays), t_dev,
                                         p_dev, greedy, gen)

    def _ragged_program(self, tb: int, pb: int, sb: int, greedy: bool,
                        gen) -> Program:
        key = ("ragged", tb, pb, sb, greedy)
        return self.rt.programs.get(
            key, lambda: self._make_ragged(key, gen), "prefill")

    def _make_ragged(self, key: tuple, gen) -> Program:
        _, tb, pb, sb, greedy = key
        dev = self.rt.pool.device
        shapes = self.ragged_shapes(tb, pb, sb)
        inputs = {"ops": i32_buffer(shapes, dev)}
        if not greedy:
            inputs["temps"] = torch.zeros((sb,), dtype=torch.float32,
                                          device=dev)
            inputs["top_ps"] = torch.ones((sb,), dtype=torch.float32,
                                          device=dev)
        gen = None if greedy else gen

        def ragged(ops, temps=None, top_ps=None):
            return self.prefill_ragged_eager(*split_views(ops, shapes),
                                             temps, top_ps, greedy, gen)
        return Program(key, ragged, inputs, self.rt.programs, gen,
                       kind="prefill")

    @torch.no_grad()
    def prefill_ragged_eager(self, tokens, positions, pages, slots,
                             cu_tokens, entry_bt, entry_start, tiles,
                             final_idx, temps, top_ps, all_greedy: bool,
                             gen: torch.Generator):
        """The ragged prefill as eager launches on the given operands (the
        programs' body; kept for the comparisons in the tests and
        ``chip_smoke.py``, and run by a TE over several devices)."""
        rt = self.rt
        cfg = rt.cfg
        x = self._layers(tokens, positions, pages, slots, cu_tokens,
                         entry_bt, entry_start, tiles)
        # unembed ONLY the chunk-final rows — (Sb, Vp), not (Tb, Vp)
        logits = T.unembed(cfg, rt.params, x[final_idx.long()], rt.mesh)[:, 0]
        if all_greedy:
            toks = greedy_core(logits, cfg.vocab_size)
        else:
            toks = sample_core(logits, temps, top_ps, gen, cfg.vocab_size)
        return logits, toks

    # ----------------------------------------------------- per sequence
    def _chunk_arrays(self, seq: SequenceState, chunk_tokens: List[int]):
        """The eight int32 operands of one sequence's chunk as a single
        entry of the paged varlen prefill."""
        ps = self.rt.pool.page_size
        c = len(chunk_tokens)
        start = seq.n_cached
        pos = np.arange(start, start + c)
        bt = np.asarray(seq.pages, np.int32)
        return (chunk_tokens, pos, bt[pos // ps], pos % ps, [0, c], bt[None],
                [start], FP.build_tiles([0, c], c))

    @torch.no_grad()
    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]):
        """One chunk of one sequence (the reference's per-sequence
        ``prefill_chunk``, ``repro/engine/runners/paged.py:166-235``)
        through the program of (c, npages), its jit's key: its K/V written
        into the sequence's pages (already allocated), each token attending
        its prefix and the chunk before it with the layer's window and
        softcap, through the paged varlen prefill as a single entry; the
        operands uploaded in one copy into the program's static buffer.
        Advances ``n_cached``; returns the last position's (Vp,) logits (a
        copy) once the prompt is covered, else None."""
        rt = self.rt
        if not self.captures:
            return self.prefill_chunk_eager(seq, chunk_tokens)
        arrays = self._chunk_arrays(seq, chunk_tokens)
        key = ("chunk", len(chunk_tokens), len(seq.pages))
        prog = rt.programs.get(key, lambda: self._make_chunk(key),
                               "prefill")
        upload_into(prog.inputs["ops"], pack_i32(*arrays))
        (logits,) = prog()
        return self._chunk_done(seq, len(chunk_tokens), logits.clone())

    def _make_chunk(self, key: tuple) -> Program:
        _, c, npages = key
        shapes = ((c,), (c,), (c,), (c,), (2,), (1, npages), (1,),
                  (FP.max_tiles(c, 1), 3))
        inputs = {"ops": i32_buffer(shapes, self.rt.pool.device)}

        def chunk(ops):
            return (self._chunk_logits(*split_views(ops, shapes)),)
        return Program(key, chunk, inputs, self.rt.programs, kind="prefill")

    def _chunk_logits(self, *ops) -> torch.Tensor:
        """Every layer over one chunk's operands; the last row's (Vp,)
        logits."""
        x = self._layers(*ops)
        return T.unembed(self.rt.cfg, self.rt.params, x[-1:],
                         self.rt.mesh)[0, 0]

    def _chunk_done(self, seq: SequenceState, c: int, logits):
        seq.n_cached += c
        return logits if seq.n_cached >= seq.n_prompt else None

    @torch.no_grad()
    def prefill_chunk_eager(self, seq: SequenceState,
                            chunk_tokens: List[int]):
        """``prefill_chunk`` as eager launches (the comparisons; a TE over
        several devices)."""
        logits = self._chunk_logits(*upload_i32(
            self.rt.pool.device, *self._chunk_arrays(seq, chunk_tokens)))
        return self._chunk_done(seq, len(chunk_tokens), logits)

    def _layers(self, tokens, positions, pages, slots, cu_tokens, entry_bt,
                entry_start, tiles) -> torch.Tensor:
        """Every layer over a flat token stream (the operands of
        ``prefill_ragged``): each rank writes its K/V into its pool and
        attends through the paged varlen prefill. Returns the final hidden
        rows (Tb, 1, D)."""
        rt = self.rt
        cfg, mesh = rt.cfg, rt.mesh
        x = T.embed(cfg, rt.params, tokens[:, None], mesh)    # (Tb,1,D)
        pos_r = mesh.broadcast(positions[:, None])
        pg_r, sl_r, cu_r, bt_r, st_r, ti_r = (
            mesh.broadcast(t) for t in (pages.long(), slots.long(),
                                        cu_tokens, entry_bt, entry_start,
                                        tiles))
        for li, ps in enumerate(rt.layers):
            os = []
            for r, (q, k_new, v_new) in enumerate(
                    T.block_qkv(cfg, ps, x, pos_r, mesh)):
                q, kp, vp = rt.layer_attn_inputs(li, r, q[:, 0], k_new[:, 0],
                                                 v_new[:, 0], pg_r[r],
                                                 sl_r[r])
                o = ops.paged_prefill(q, kp, vp, cu_r[r], bt_r[r], st_r[r],
                                      ti_r[r],
                                      softcap=cfg.attn_logit_softcap,
                                      window=rt.windows[li], impl=rt.impl)
                os.append(o[:, None].to(x.dtype))
            x = T.block_out(cfg, ps, x, os, mesh)
        return x

    def warmup_ragged(self, token_buckets, page_buckets, n_rows: int) -> int:
        """Build the all-greedy program of every token bucket x page bucket
        (``n_rows`` entries), each run once with every token parked on the
        scratch page (an all-padding plan, so no live page is touched):
        serving inside that grid builds no prefill program. Returns the
        number of bucket shapes run."""
        scratch = self.rt.pool.scratch_page()
        cu = [0] * (n_rows + 1)
        temps = np.zeros((n_rows,), np.float32)
        n = 0
        for tb in sorted(set(token_buckets)):
            for pb in sorted(set(page_buckets)):
                self.prefill_ragged_host(
                    (np.zeros(tb), np.zeros(tb), np.full(tb, scratch),
                     np.zeros(tb), cu, np.full((n_rows, pb), scratch),
                     np.zeros(n_rows), FP.build_tiles(cu, tb),
                     np.zeros(n_rows)), temps, np.ones_like(temps), None)
                n += 1
        return n


# ===========================================================================
# Decode phase (the hot loop of DESIGN.md §8)
# ===========================================================================


class PagedDecodeRunner:
    def __init__(self, rt: PagedRunner):
        self.rt = rt

    def _step_arrays(self, seqs: List[SequenceState]):
        """(B,) last tokens, (B, maxp) block table, (B,) lengths: host
        int32 operands of one unfused step."""
        maxp = max(len(s.pages) for s in seqs)
        bt = np.zeros((len(seqs), maxp), np.int32)
        for i, s in enumerate(seqs):
            bt[i, :len(s.pages)] = s.pages
        return ([s.tokens[-1] for s in seqs], bt,
                [len(s.tokens) for s in seqs])

    @torch.no_grad()
    def decode(self, seqs: List[SequenceState]) -> torch.Tensor:
        """One decode step for a batch of sequences (the unfused path,
        ``fused_decode=False``) through the program of (B, maxp). The new
        token of each seq is seqs[i].tokens[-1]; its KV is written at
        position len(tokens)-1. B is not bucketed, as in the reference
        (padded rows would change the matmuls' shapes and so the bits);
        its jit counts a new maxp and retraces silently for a new B, the
        port builds and counts one program per (B, maxp). Returns (B, Vp)
        logits: on a card the program's static output, sampled before
        the next program call."""
        rt = self.rt
        if not rt.programs.enabled:
            return self.decode_step_eager(seqs)
        arrays = self._step_arrays(seqs)
        key = ("step",) + arrays[1].shape
        prog = rt.programs.get(key, lambda: self._make_step(key))
        upload_into(prog.inputs["ops"], pack_i32(*arrays))
        (logits,) = prog()
        for s in seqs:
            s.n_cached = len(s.tokens)
        return logits

    def _make_step(self, key: tuple) -> Program:
        _, b, maxp = key
        shapes = ((b,), (b, maxp), (b,))
        inputs = {"ops": i32_buffer(shapes, self.rt.pool.device)}

        def step(ops):
            return (self.body(*split_views(ops, shapes)),)
        return Program(key, step, inputs, self.rt.programs)

    @torch.no_grad()
    def decode_step_eager(self, seqs: List[SequenceState]) -> torch.Tensor:
        """``decode`` as eager launches (the comparisons; a TE over several
        devices)."""
        logits = self.body(*upload_i32(self.rt.pool.device,
                                       *self._step_arrays(seqs)))
        for s in seqs:
            s.n_cached = len(s.tokens)
        return logits

    def body(self, tokens, bt, lengths) -> torch.Tensor:
        """One decode step on device tensors: (B,) token ids, (B, Pb) block
        table, (B,) lengths -> (B, Vp) logits; KV written in place."""
        rt = self.rt
        cfg, mesh = rt.cfg, rt.mesh
        page_size = rt.pool.page_size
        x = T.embed(cfg, rt.params, tokens[:, None], mesh)    # (B,1,D)
        pos = (lengths - 1)[:, None]
        page = bt.gather(1, ((lengths - 1) // page_size).long()[:, None])
        slot = ((lengths - 1) % page_size).long()
        pos_r = mesh.broadcast(pos)
        pg_r, sl_r, bt_r, len_r = (mesh.broadcast(t) for t in (
            page[:, 0].long(), slot, bt, lengths))
        for li, ps in enumerate(rt.layers):
            os = []
            for r, (q, k_new, v_new) in enumerate(
                    T.block_qkv(cfg, ps, x, pos_r, mesh)):
                q, kp, vp = rt.layer_attn_inputs(li, r, q[:, 0], k_new[:, 0],
                                                 v_new[:, 0], pg_r[r],
                                                 sl_r[r])
                o = ops.paged_attention(q, kp, vp, bt_r[r], len_r[r],
                                        softcap=cfg.attn_logit_softcap,
                                        window=rt.windows[li], impl=rt.impl)
                os.append(o[:, None].to(x.dtype))
            x = T.block_out(cfg, ps, x, os, mesh)
        return T.unembed(cfg, rt.params, x, mesh)[:, 0]

    def _horizon(self, k_steps: int, greedy: bool, gen, bt, lengths, last,
                 active, temps, top_ps):
        """``k_steps`` decode+sample iterations: (k_steps, Bb) int32 token
        block, the advanced last tokens and lengths. Padding rows keep
        their token and length so their KV write stays parked on the
        scratch page."""
        cfg = self.rt.cfg
        out = torch.empty((k_steps, bt.shape[0]), dtype=torch.int32,
                          device=bt.device)
        act = active.to(torch.int32)
        for j in range(k_steps):
            logits = self.body(last, bt, lengths)
            if greedy:
                toks = greedy_core(logits, cfg.vocab_size)
            else:
                toks = sample_core(logits, temps, top_ps, gen,
                                   cfg.vocab_size)
            last = torch.where(active, toks, last)
            out[j] = last
            lengths = lengths + act
        return out, last, lengths

    @torch.no_grad()
    def decode_fused(self, state, k_steps: int) -> torch.Tensor:
        """The NPU-centric horizon (DESIGN.md §8): ``k_steps`` decode+sample
        iterations over the device-resident batch state as ONE program
        (the reference's one dispatch), with no host sync. Lengths and
        last tokens advance on the device and are written back into
        ``state`` in place. Returns the (k_steps, Bb) int32 token block
        WITHOUT copying it to the host; on a card it is the program's
        static output, so copy it before the next horizon is enqueued."""
        rt = self.rt
        if not rt.programs.enabled:
            return self.decode_eager(state, k_steps)
        key = (k_steps, state.bb, state.pb, state.all_greedy)
        prog = rt.programs.get(key, lambda: self._program(key, state))
        out, last, lengths = prog(
            bt=state.bt, lengths=state.lengths, last=state.last_tok,
            active=state.active, temps=state.temps, top_ps=state.top_ps)
        state.last_tok.copy_(last)
        state.lengths.copy_(lengths)
        return out

    def _program(self, key: tuple, state) -> Program:
        k_steps, _, _, greedy = key
        gen = None if greedy else state.gen
        inputs = {name: torch.empty_like(t) for name, t in (
            ("bt", state.bt), ("lengths", state.lengths),
            ("last", state.last_tok), ("active", state.active),
            ("temps", state.temps), ("top_ps", state.top_ps))}

        def horizon(**t):
            return self._horizon(k_steps, greedy, gen, **t)
        return Program(key, horizon, inputs, self.rt.programs, gen)

    @torch.no_grad()
    def decode_eager(self, state, k_steps: int) -> torch.Tensor:
        """The same horizon as eager launches over ``state``'s own tensors
        (each step enqueues every op of every layer)."""
        out, last, lengths = self._horizon(
            k_steps, state.all_greedy, state.gen, state.bt, state.lengths,
            state.last_tok, state.active, state.temps, state.top_ps)
        state.last_tok, state.lengths = last, lengths
        return out

    @torch.no_grad()
    def warmup_fused(self, batch_buckets, page_buckets, horizons,
                     gen: torch.Generator) -> int:
        """Build (or run) the program of every horizon x batch bucket x page
        bucket with all rows inactive on the scratch page (no live page is
        touched), so serving inside that grid builds none. Returns the
        number of bucket shapes run."""
        dev = self.rt.pool.device
        scratch = self.rt.pool.scratch_page()
        n = 0
        for k_steps in sorted(set(horizons)):
            for bb in sorted(set(batch_buckets)):
                for pb in sorted(set(page_buckets)):
                    state = _WarmState(bb, pb, scratch, dev, gen)
                    self.decode_fused(state, k_steps)
                    n += 1
        return n


class _WarmState:
    """An all-padding decode batch for ``warmup_fused``."""

    def __init__(self, bb, pb, scratch, dev, gen):
        self.bb, self.pb, self.gen = bb, pb, gen
        self.bt = torch.full((bb, pb), scratch, dtype=torch.int32, device=dev)
        self.lengths = torch.ones((bb,), dtype=torch.int32, device=dev)
        self.last_tok = torch.zeros((bb,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((bb,), dtype=torch.bool, device=dev)
        self.temps = torch.zeros((bb,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((bb,), dtype=torch.float32, device=dev)
        self.all_greedy = True
