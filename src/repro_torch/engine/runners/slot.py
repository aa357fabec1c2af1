"""Slot runner family of the port (torch counterpart of
``repro/engine/runners/slot.py``): recurrent, hybrid and cross-attention
towers (rwkv6, recurrentgemma, seamless-m4t enc-dec, llama-3.2-vision)
batching through fixed per-slot dense caches. Continuous
batching assigns sequences to free slots; prefix reuse is state-checkpoint
based (DESIGN.md §4).

``SlotRunner`` is the family facade over the phase pair:

  * ``SlotPrefillRunner.prefill_chunk`` — one sequence's chunk through
    ``serving.prefill``, its length bucketed to a power of two with a
    masked tail (``n_valid``: pad steps are exact identities for the
    recurrences and causally masked for attention), or at its raw length
    with ``bucket_prefill=False``, with the sequence's modality inputs
    (uploaded once, reused by every chunk). Each bucket is one device
    program (``engine/programs.py``; the reference's ``_prefill_fn``),
    counted as ``prefill_jit_compiles``: ``n_valid`` is a device operand,
    and the slot's rows are staged through a batch-1 cache, so one
    program serves every length in the bucket and every slot.
  * ``SlotDecodeRunner.decode_sample`` — the all-slot decode step plus
    in-pass sampling as one device program (the reference's
    ``_sample_fn``), keyed by the all-greedy flag that the reference
    decides inside its jit and the port on the host: a CUDA graph
    captured once and replayed per step on a card, the same body run
    directly on the CPU. Only the (n_slots,) token vector is returned.
    ``SlotDecodeRunner.decode`` is the unfused step (the engine's
    ``fused_decode=False``), one program too: the live rows' logits,
    sampled on the host. ``prefill_chunk_eager``,
    ``decode_sample_eager`` and ``decode_step_eager`` are the eager
    forms, kept for the comparisons in the tests and ``chip_smoke.py``;
    the engine runs them only for a TE whose ranks lie on more than one
    device.

Both phases run the recurrences through ``ops.wkv6`` / ``ops.rglru``: the
port's kernels on a CUDA cache, their plain versions on a CPU one, once
per rank of the TE's mesh. The runner holds its weights as the list of
the ranks' trees and its caches as the list of the ranks' caches
(``models/serving.py``), one of each at tp 1; the reference's SPMD slot TE
(``runners/slot.py:51-60``) shards the same way. The caches are updated in
place (the reference writes a new cache back). A slot snapshot (the state
checkpoint, and the payload of a PD migration) is one copy per rank of
the slot's rows with each leaf's split, so a TE of another tp reshards it
at import. The raw-length prefill and the unfused decode are the
reference's baselines for the bucketed prefill and the fused decode
(``repro/engine/runners/slot.py:42-49``, ``:138-146``, ``:202-213``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.distflow import _nbytes, map_distinct
from repro_torch.engine.hotloop import pow2_bucket, to_device, upload_into
from repro_torch.engine.programs import Program, ProgramCache
from repro_torch.engine.runners.base import SequenceState
from repro_torch.engine.sampling import greedy_core, sample_core
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh
from repro_torch.models import serving as S

_STATE_KEYS = ("state", "last_tm", "last_cm", "h", "conv")


@dataclass
class SlotSnapshot:
    """One slot's rows of every cache leaf as the ranks of a TE held them
    (``ranks[r][key]``: rank r's part, or the replicated rows every rank
    refers to), and each leaf's split dimension there (``splits``)."""
    ranks: List[Dict[str, torch.Tensor]]
    splits: Dict[str, Optional[int]]

    @property
    def nbytes(self) -> int:
        """Bytes of the rows, a replicated leaf's once (what DistFlow
        prices for a slot migration: the reference's global arrays)."""
        return _nbytes(self.ranks)


class SlotRunner:
    """Family facade: slot bookkeeping, the dense caches and phase
    delegation."""

    def __init__(self, cfg, params, n_slots: int, max_len: int,
                 dtype: torch.dtype, mesh: EngineMesh, impl: str = "auto"):
        self.cfg = cfg
        self.params = params                # the ranks' weights trees
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype                  # the caches'
        self.impl = impl                    # "auto" (kernels) | "ref"
        # pow2-bucketed prefill chunks with a masked tail; set False to run
        # each chunk at its raw length (read at every chunk)
        self.bucket_prefill = True
        self.mesh = mesh
        self.device = mesh.device           # activations and sampling
        if S.attn_layer_count(cfg) and max_len > S.JOINT_PREFILL_MAX:
            # past it the reference's prefill takes the single-shot
            # branch, which ignores the cached prefix: a sequence's
            # second chunk would lose its first
            raise ValueError(
                f"slot max_len {max_len} > {S.JOINT_PREFILL_MAX}: chunked "
                f"prefill attends jointly over at most that many cached "
                f"positions")
        self.caches = S.init_cache(cfg, n_slots, max_len, dtype, mesh)
        self.cache_specs = SH.engine_cache_specs(
            cfg, S.cache_like(cfg, n_slots, max_len, dtype), mesh.tp)
        self.free_slots = list(range(n_slots))
        # seq_id -> its modality inputs on the device (in the weights'
        # dtype), uploaded at its first chunk and dropped with its slot
        self.extra_dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self.prefill = SlotPrefillRunner(self)
        self.decoder = SlotDecodeRunner(self)
        self.programs = ProgramCache(mesh)        # both kinds

    @property
    def jit_compiles(self) -> int:
        """Decode programs built: the reference's count of decode-path jit
        cache misses (``repro/engine/runners/slot.py:236``)."""
        return self.programs.builds

    @property
    def prefill_jit_compiles(self) -> int:
        """Prefill programs built: the reference's count of prefill-path
        jit cache misses (``repro/engine/runners/slot.py:163``)."""
        return self.programs.prefill_builds

    def _slot_slice(self, slot: int) -> List[Dict[str, torch.Tensor]]:
        """Each rank's views of one slot's rows of every cache tensor
        (batch axis 1, ``length`` axis 0)."""
        return [{k: v[slot:slot + 1] if k == "length" else v[:, slot:slot + 1]
                 for k, v in c.items()} for c in self.caches]

    def alloc_slot(self, seq: SequenceState) -> bool:
        if not self.free_slots:
            return False
        seq.slot = self.free_slots.pop()
        # reset the slot's length AND its recurrent/conv state: stale KV is
        # masked by length, but a recurrent state would leak the previous
        # occupant into the new sequence (the cross cache needs no reset:
        # every prefill chunk refills it)
        self.caches[0]["length"][seq.slot:seq.slot + 1].fill_(0)
        for key in _STATE_KEYS:
            if key in self.caches[0]:
                for t in SH.held([c[key] for c in self.caches]):
                    t[:, seq.slot].zero_()
        return True

    def free_slot(self, seq: SequenceState) -> None:
        self.extra_dev.pop(seq.seq_id, None)
        if seq.slot is not None:
            self.free_slots.append(seq.slot)
            seq.slot = None

    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]
                      ) -> Optional[torch.Tensor]:
        return self.prefill.prefill_chunk(seq, chunk_tokens)

    def decode_sample(self, seqs: List[SequenceState], temps: np.ndarray,
                      top_ps: np.ndarray, gen: torch.Generator
                      ) -> torch.Tensor:
        return self.decoder.decode_sample(seqs, temps, top_ps, gen)

    def decode(self, seqs: List[SequenceState]) -> torch.Tensor:
        return self.decoder.decode(seqs)

    # state checkpointing (the prefix cache of recurrent archs)
    def snapshot_state(self, seq: SequenceState) -> SlotSnapshot:
        """A device copy of the slot's rows of every cache tensor on every
        rank, a replicated leaf's rows copied once."""
        views = self._slot_slice(seq.slot)
        copies = {k: map_distinct(torch.clone, [v[k] for v in views])
                  for k in views[0]}
        return SlotSnapshot([{k: copies[k][r] for k in copies}
                             for r in range(self.mesh.tp)],
                            dict(self.cache_specs))

    def restore_state(self, seq: SequenceState, snap: SlotSnapshot) -> None:
        """Write a snapshot into ``seq``'s slot on every rank holding a
        part, each leaf resharded from the snapshot's split onto this TE's
        (``sharding.reshard``: where the two agree, each part is copied
        as it is)."""
        views = self._slot_slice(seq.slot)
        for k in views[0]:
            parts = SH.reshard([r[k] for r in snap.ranks], snap.splits[k],
                               self.cache_specs[k], self.mesh, copy=False)
            for dst, src in zip(SH.held([v[k] for v in views]), parts):
                dst.copy_(src)
        seq.n_cached = int(snap.ranks[0]["length"][0])

    # PD migration: the slot snapshot is the whole payload (the v1 path)
    def export_kv(self, seq: SequenceState):
        return {"state": self.snapshot_state(seq), "tokens": list(seq.tokens),
                "n_prompt": seq.n_prompt, "n_cached": seq.n_cached}

    def import_kv(self, payload, seq: SequenceState) -> None:
        """Restore a migrated slot snapshot, from a TE of any tp, into
        ``seq``'s slot. Reading its length back is a host sync: this runs
        at admission, off the decode step."""
        self.restore_state(seq, payload["state"])


# ===========================================================================
# Prefill phase
# ===========================================================================


class SlotPrefillRunner:
    def __init__(self, rt: SlotRunner):
        self.rt = rt
        # one batch-1 cache per rank, allocated once per TE at its first
        # program: the slot's rows are staged through it
        self._stage: Optional[List[Dict[str, torch.Tensor]]] = None

    def _extra(self, seq: SequenceState) -> Dict[str, torch.Tensor]:
        """The sequence's modality inputs on the device (in the weights'
        dtype), uploaded at its first chunk."""
        rt = self.rt
        extra = rt.extra_dev.get(seq.seq_id)
        if extra is None:
            dt = rt.params[0]["embed"].dtype
            extra = rt.extra_dev[seq.seq_id] = {
                k: to_device(v, rt.device, dt) for k, v in seq.extra.items()}
        return extra

    def _bucket(self, c: int) -> int:
        return pow2_bucket(c) if self.rt.bucket_prefill else c

    @torch.no_grad()
    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]
                      ) -> Optional[torch.Tensor]:
        """Run one chunk of ``seq`` (pow2-bucketed with a masked tail, or
        at its raw length without ``bucket_prefill``) on its slot, through
        the program of ("slot_prefill", cb) plus the sorted names of the
        request's modality inputs (the reference's jit keys cb alone,
        ``repro/engine/runners/slot.py:152-163``). Its static inputs are
        the token bucket and ``n_valid`` (one int64 buffer, one upload:
        ``n_valid`` a device operand, so one program serves every real
        length in the bucket) and the modality inputs (copied device to
        device into buffers of the key's shapes); the slot's rows of every
        rank's cache are copied into the TE's batch-1 staging cache before
        the program and back after, in stream order, so one program
        serves every slot (the reference's jit takes the slot's slice and
        writes it back, ``:147-154``). Returns the last real position's
        logits (a copy) once the prompt is covered, else None."""
        rt = self.rt
        if not rt.programs.enabled:
            return self.prefill_chunk_eager(seq, chunk_tokens)
        c = len(chunk_tokens)
        cb = self._bucket(c)
        extra = self._extra(seq)
        key = ("slot_prefill", cb) + ((tuple(sorted(extra)),) if extra
                                      else ())
        prog = rt.programs.get(key, lambda: self._make(key, extra),
                               "prefill")
        ops_ = np.zeros((cb + 1,), np.int64)
        ops_[:c] = chunk_tokens
        ops_[cb] = c
        upload_into(prog.inputs["ops"], ops_)
        rows = rt._slot_slice(seq.slot)
        _copy_rows(self._stage, rows)
        (logits,) = prog(**extra)
        _copy_rows(rows, self._stage)
        seq.n_cached += c
        if seq.n_cached >= seq.n_prompt:
            return logits[0].clone()
        return None

    def _make(self, key: tuple, extra: Dict[str, torch.Tensor]) -> Program:
        rt = self.rt
        cb = key[1]
        if self._stage is None:
            self._stage = S.init_cache(rt.cfg, 1, rt.max_len, rt.dtype,
                                       rt.mesh)
        stage = self._stage
        inputs = {"ops": torch.zeros((cb + 1,), dtype=torch.int64,
                                     device=rt.device)}
        inputs.update({k: torch.zeros_like(v) for k, v in extra.items()})

        def chunk(ops, **mem):
            logits, _ = S.prefill(rt.cfg, rt.params, ops[:cb].view(1, cb),
                                  stage, rt.mesh, n_valid=ops[cb],
                                  impl=rt.impl, **mem)
            return (logits,)
        return Program(key, chunk, inputs, rt.programs, kind="prefill")

    @torch.no_grad()
    def prefill_chunk_eager(self, seq: SequenceState,
                            chunk_tokens: List[int]
                            ) -> Optional[torch.Tensor]:
        """``prefill_chunk`` as eager launches straight on the slot's rows,
        ``n_valid`` a Python int (the comparisons; a TE over several
        devices)."""
        rt = self.rt
        c = len(chunk_tokens)
        cb = self._bucket(c)
        toks = np.zeros((1, cb), np.int64)
        toks[0, :c] = chunk_tokens
        logits, _ = S.prefill(rt.cfg, rt.params, to_device(toks, rt.device),
                              rt._slot_slice(seq.slot), rt.mesh, n_valid=c,
                              impl=rt.impl, **self._extra(seq))
        seq.n_cached += c
        if seq.n_cached >= seq.n_prompt:
            return logits[0]
        return None


def _copy_rows(dst: List[Dict[str, torch.Tensor]],
               src: List[Dict[str, torch.Tensor]]) -> None:
    """Copy every leaf of the ranks' caches ``src`` into ``dst`` (one
    slot's rows each; a replicated leaf once), device to device."""
    for k in src[0]:
        for d, s_ in zip(SH.held([c[k] for c in dst]),
                         SH.held([c[k] for c in src])):
            d.copy_(s_, non_blocking=True)


# ===========================================================================
# Decode phase
# ===========================================================================


class SlotDecodeRunner:
    def __init__(self, rt: SlotRunner):
        self.rt = rt
        # the host arrays last uploaded as the sampled program's
        # temps/top_ps: the engine passes new arrays only when the batch's
        # composition changes
        self._sp_src: tuple = (None, None)

    def _tokens(self, seqs: List[SequenceState]) -> np.ndarray:
        """The (n_slots,) token vector: each live slot fed its sequence's
        last token."""
        tokens = np.zeros((self.rt.n_slots,), np.int64)
        for s in seqs:
            tokens[s.slot] = s.tokens[-1]
        return tokens

    def _step(self, seqs: List[SequenceState]) -> torch.Tensor:
        """One decode step of every slot; returns the (n_slots, Vp)
        logits."""
        rt = self.rt
        logits, _ = S.decode_step(rt.cfg, rt.params,
                                  to_device(self._tokens(seqs), rt.device),
                                  rt.caches, rt.mesh, impl=rt.impl)
        for s in seqs:
            s.n_cached = len(s.tokens)
        return logits

    @torch.no_grad()
    def decode(self, seqs: List[SequenceState]) -> torch.Tensor:
        """The unfused all-slot step (``repro/engine/runners/slot.py:
        202-213``) through one program (key ("step",): the reference's
        ``_decode_jit``, ``:192-199``) that returns the (n_slots, Vp)
        logits; the token vector is uploaded into its static input. Returns
        the live rows' (B, Vp) logits in ``seqs`` order (a gather after the
        program, so a copy), for the engine's host-side sampler."""
        rt = self.rt
        if not rt.programs.enabled:
            return self.decode_step_eager(seqs)
        prog = rt.programs.get(("step",), self._step_program)
        upload_into(prog.inputs["tokens"], self._tokens(seqs))
        (logits,) = prog()
        for s in seqs:
            s.n_cached = len(s.tokens)
        return logits.index_select(0, self._rows(seqs))

    def _rows(self, seqs: List[SequenceState]) -> torch.Tensor:
        return to_device(np.asarray([s.slot for s in seqs], np.int64),
                         self.rt.device)

    def _step_program(self) -> Program:
        rt = self.rt
        inputs = {"tokens": torch.zeros((rt.n_slots,), dtype=torch.int64,
                                        device=rt.device)}

        def step(tokens):
            logits, _ = S.decode_step(rt.cfg, rt.params, tokens, rt.caches,
                                      rt.mesh, impl=rt.impl)
            return (logits,)
        return Program(("step",), step, inputs, rt.programs)

    @torch.no_grad()
    def decode_step_eager(self, seqs: List[SequenceState]) -> torch.Tensor:
        """``decode`` as eager launches (the comparisons; a TE over several
        devices)."""
        return self._step(seqs).index_select(0, self._rows(seqs))

    @torch.no_grad()
    def decode_sample(self, seqs: List[SequenceState], temps: np.ndarray,
                      top_ps: np.ndarray, gen: torch.Generator
                      ) -> torch.Tensor:
        """Decode every slot one step and sample in the same program.
        ``temps``/``top_ps`` are (n_slots,) host arrays indexed by SLOT
        (free slots greedy); the all-greedy shortcut is decided from them
        on the host. The token vector is uploaded into the program's
        static input (pinned, non-blocking), ``temps``/``top_ps`` only
        when the engine hands in new arrays. Returns the (n_slots,) int32
        token vector on the device (on a card the program's static
        output: read it before the next step); the caller reads its live
        rows by slot."""
        rt = self.rt
        if not rt.programs.enabled:
            return self.decode_sample_eager(seqs, temps, top_ps, gen)
        greedy = float(temps.max()) <= 0.0
        prog = rt.programs.get((greedy,),
                               lambda: self._program(greedy, gen))
        if not greedy and (self._sp_src[0] is not temps
                           or self._sp_src[1] is not top_ps):
            upload_into(prog.inputs["temps"], temps)
            upload_into(prog.inputs["top_ps"], top_ps)
            self._sp_src = (temps, top_ps)
        upload_into(prog.inputs["tokens"], self._tokens(seqs))
        (toks,) = prog()
        for s in seqs:
            s.n_cached = len(s.tokens)
        return toks

    def _program(self, greedy: bool, gen: torch.Generator) -> Program:
        rt = self.rt
        n, dev = rt.n_slots, rt.device
        inputs = {"tokens": torch.zeros((n,), dtype=torch.int64, device=dev)}
        if not greedy:
            inputs["temps"] = torch.zeros((n,), dtype=torch.float32,
                                          device=dev)
            inputs["top_ps"] = torch.ones((n,), dtype=torch.float32,
                                          device=dev)
            self._sp_src = (None, None)

        def step(tokens, temps=None, top_ps=None):
            logits, _ = S.decode_step(rt.cfg, rt.params, tokens, rt.caches,
                                      rt.mesh, impl=rt.impl)
            if greedy:
                return (greedy_core(logits, rt.cfg.vocab_size),)
            return (sample_core(logits, temps, top_ps, gen,
                                rt.cfg.vocab_size),)
        return Program((greedy,), step, inputs, rt.programs,
                       None if greedy else gen)

    @torch.no_grad()
    def decode_sample_eager(self, seqs: List[SequenceState],
                            temps: np.ndarray, top_ps: np.ndarray,
                            gen: torch.Generator) -> torch.Tensor:
        """The same step as eager launches (each op of every layer
        enqueued), the sampling params uploaded at every call."""
        rt = self.rt
        logits = self._step(seqs)
        if float(temps.max()) <= 0.0:
            return greedy_core(logits, rt.cfg.vocab_size)
        return sample_core(logits, to_device(temps, rt.device),
                           to_device(top_ps, rt.device), gen,
                           rt.cfg.vocab_size)
