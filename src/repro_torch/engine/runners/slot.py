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
    (uploaded once, reused by every chunk).
  * ``SlotDecodeRunner.decode_sample`` — the all-slot decode step plus
    in-pass sampling as one device program (``engine/programs.py``; the
    reference's ``_sample_fn``), keyed by the all-greedy flag that the
    reference decides inside its jit and the port on the host: a CUDA
    graph captured once and replayed per step on a card, the same body
    run directly on the CPU. Only the (n_slots,) token vector is
    returned. ``decode_sample_eager`` is its eager form, kept for the
    comparisons in the tests and ``chip_smoke.py``; the engine runs it
    only for a TE whose ranks lie on more than one device.
    ``SlotDecodeRunner.decode`` is the unfused step (the engine's
    ``fused_decode=False``): the live rows' logits, sampled on the host.

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
        self.programs = ProgramCache(mesh)        # the decode step's

    @property
    def jit_compiles(self) -> int:
        """Decode programs built: the reference's count of decode-path jit
        cache misses (``repro/engine/runners/slot.py:236``)."""
        return self.programs.builds

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

    @torch.no_grad()
    def prefill_chunk(self, seq: SequenceState, chunk_tokens: List[int]
                      ) -> Optional[torch.Tensor]:
        """Run one chunk of ``seq`` (pow2-bucketed with a masked tail, or
        at its raw length without ``bucket_prefill``) on its slot. Returns
        the last real position's logits once the prompt is covered, else
        None."""
        rt = self.rt
        c = len(chunk_tokens)
        cb = pow2_bucket(c) if rt.bucket_prefill else c
        toks = np.zeros((1, cb), np.int64)
        toks[0, :c] = chunk_tokens
        extra = rt.extra_dev.get(seq.seq_id)
        if extra is None:
            dt = rt.params[0]["embed"].dtype
            extra = rt.extra_dev[seq.seq_id] = {
                k: to_device(v, rt.device, dt) for k, v in seq.extra.items()}
        logits, _ = S.prefill(rt.cfg, rt.params, to_device(toks, rt.device),
                              rt._slot_slice(seq.slot), rt.mesh, n_valid=c,
                              impl=rt.impl, **extra)
        seq.n_cached += c
        if seq.n_cached >= seq.n_prompt:
            return logits[0]
        return None


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
        202-213``): returns the live rows' (B, Vp) logits in ``seqs``
        order, for the engine's host-side sampler."""
        rows = to_device(np.asarray([s.slot for s in seqs], np.int64),
                         self.rt.device)
        return self._step(seqs).index_select(0, rows)

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
