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
same programs (``jit_compiles``). ``decode_eager`` is the horizon's eager
form, kept for the comparisons in the tests and ``chip_smoke.py``; the
engine runs it only for a TE whose ranks lie on more than one device,
which keeps no program (decided from the mesh when the runner is built).

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

from repro_torch.engine.hotloop import upload_i32
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
        self.programs = ProgramCache(self.mesh)   # the decode horizons'

    @property
    def jit_compiles(self) -> int:
        """Decode programs built (warmup included): the reference's count
        of decode-path jit cache misses."""
        return self.programs.builds

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

    @torch.no_grad()
    def prefill_ragged(self, tokens, positions, pages, slots, cu_tokens,
                       entry_bt, entry_start, tiles, final_idx, temps,
                       top_ps, all_greedy: bool, gen: torch.Generator):
        """The whole step's prefill plan (DESIGN.md §12). Operands, all on
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
        ``all_greedy`` is decided on the host from ``temps``. Returns
        (logits (Sb, Vp), sampled tokens (Sb,) int32)."""
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

    @torch.no_grad()
    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]):
        """One chunk of one sequence (the reference's per-sequence
        ``prefill_chunk``, ``repro/engine/runners/paged.py:166-235``): its
        K/V written into the sequence's pages (already allocated), each
        token attending its prefix and the chunk before it with the layer's
        window and softcap, through the paged varlen prefill as a single
        entry. Advances ``n_cached``; returns the last position's (Vp,)
        logits once the prompt is covered, else None."""
        rt = self.rt
        ps = rt.pool.page_size
        c = len(chunk_tokens)
        start = seq.n_cached
        pos = np.arange(start, start + c)
        bt = np.asarray(seq.pages, np.int32)
        x = self._layers(*upload_i32(
            rt.pool.device, chunk_tokens, pos, bt[pos // ps], pos % ps,
            [0, c], bt[None], [start], FP.build_tiles([0, c], c)))
        seq.n_cached = start + c
        if seq.n_cached < seq.n_prompt:
            return None
        return T.unembed(rt.cfg, rt.params, x[-1:], rt.mesh)[0, 0]

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
        """Run every token bucket x page bucket once with every token parked
        on the scratch page (all-padding plan, so no live page is touched):
        builds the kernels and warms the allocator ahead of serving.
        Returns the number of bucket shapes run."""
        rt = self.rt
        dev = rt.pool.device
        scratch = rt.pool.scratch_page()
        cu = [0] * (n_rows + 1)
        n = 0
        for tb in sorted(set(token_buckets)):
            for pb in sorted(set(page_buckets)):
                def i32(a):
                    return torch.as_tensor(np.asarray(a, np.int32)).to(dev)
                self.prefill_ragged(
                    i32(np.zeros(tb)), i32(np.zeros(tb)),
                    i32(np.full(tb, scratch)), i32(np.zeros(tb)), i32(cu),
                    i32(np.full((n_rows, pb), scratch)), i32(np.zeros(n_rows)),
                    i32(FP.build_tiles(cu, tb)), i32(np.zeros(n_rows)),
                    None, None, True, None)
                n += 1
        return n


# ===========================================================================
# Decode phase (the hot loop of DESIGN.md §8)
# ===========================================================================


class PagedDecodeRunner:
    def __init__(self, rt: PagedRunner):
        self.rt = rt

    @torch.no_grad()
    def decode(self, seqs: List[SequenceState]) -> torch.Tensor:
        """One decode step for a batch of sequences (the legacy path). The
        new token of each seq is seqs[i].tokens[-1]; its KV is written at
        position len(tokens)-1. Returns (B, Vp) logits."""
        dev = self.rt.pool.device
        b = len(seqs)
        maxp = max(len(s.pages) for s in seqs)
        bt = np.zeros((b, maxp), np.int32)
        for i, s in enumerate(seqs):
            bt[i, :len(s.pages)] = s.pages
        tokens = torch.tensor([s.tokens[-1] for s in seqs], dtype=torch.int32)
        lengths = torch.tensor([len(s.tokens) for s in seqs],
                               dtype=torch.int32)
        logits = self.body(tokens.to(dev), torch.from_numpy(bt).to(dev),
                           lengths.to(dev))
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
