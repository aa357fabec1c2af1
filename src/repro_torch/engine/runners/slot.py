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
    recurrences and causally masked for attention), with the sequence's
    modality inputs (uploaded once, reused by every chunk).
  * ``SlotDecodeRunner.decode_sample`` — the all-slot decode step plus
    in-pass sampling; only the (n_slots,) token vector is returned.

Both phases run the recurrences through ``ops.wkv6`` / ``ops.rglru``: the
port's kernels on a CUDA cache, their plain versions on a CPU one. The
caches are updated in place (the reference writes a new cache back).
The reference's raw-length prefill (``bucket_prefill=False``), its unfused
decode and its mesh branches have no caller in the port and are not
ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.hotloop import pow2_bucket, to_device
from repro_torch.engine.runners.base import SequenceState
from repro_torch.engine.sampling import greedy_core, sample_core
from repro_torch.models import serving as S

_STATE_KEYS = ("state", "last_tm", "last_cm", "h", "conv")


class SlotRunner:
    """Family facade: slot bookkeeping, the dense caches and phase
    delegation."""

    def __init__(self, cfg, params, n_slots: int, max_len: int,
                 dtype: torch.dtype, device, impl: str = "auto"):
        self.cfg = cfg
        # the ranks' weights trees, as every TE holds them: one rank here
        # (the slot family's tensor parallelism is ROADMAP.md Queue 1
        # item 8b), read as ``params[0]``
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.impl = impl                    # "auto" (kernels) | "ref"
        self.device = device
        self.cache = S.init_cache(cfg, n_slots, max_len, dtype, device)
        self.free_slots = list(range(n_slots))
        # seq_id -> its modality inputs on the device (in the weights'
        # dtype), uploaded at its first chunk and dropped with its slot
        self.extra_dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self.prefill = SlotPrefillRunner(self)
        self.decoder = SlotDecodeRunner(self)

    def _slot_slice(self, slot: int) -> Dict[str, torch.Tensor]:
        """Views of one slot's rows of every cache tensor (batch axis 1,
        ``length`` axis 0)."""
        return {k: v[slot:slot + 1] if k == "length" else v[:, slot:slot + 1]
                for k, v in self.cache.items()}

    def alloc_slot(self, seq: SequenceState) -> bool:
        if not self.free_slots:
            return False
        seq.slot = self.free_slots.pop()
        # reset the slot's length AND its recurrent/conv state: stale KV is
        # masked by length, but a recurrent state would leak the previous
        # occupant into the new sequence (the cross cache needs no reset:
        # every prefill chunk refills it)
        self.cache["length"][seq.slot:seq.slot + 1].fill_(0)
        for key in _STATE_KEYS:
            if key in self.cache:
                self.cache[key][:, seq.slot].zero_()
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

    # state checkpointing (the prefix cache of recurrent archs)
    def snapshot_state(self, seq: SequenceState) -> Dict[str, torch.Tensor]:
        """A device copy of the slot's rows of every cache tensor."""
        return {k: v.clone() for k, v in self._slot_slice(seq.slot).items()}

    def restore_state(self, seq: SequenceState, snap) -> None:
        for k, v in self._slot_slice(seq.slot).items():
            v.copy_(snap[k])
        seq.n_cached = int(snap["length"][0])

    # PD migration: the slot snapshot is the whole payload (the v1 path)
    def export_kv(self, seq: SequenceState):
        return {"state": self.snapshot_state(seq), "tokens": list(seq.tokens),
                "n_prompt": seq.n_prompt, "n_cached": seq.n_cached}

    def import_kv(self, payload, seq: SequenceState) -> None:
        """Restore a migrated slot snapshot into ``seq``'s slot. Reading
        its length back is a host sync: this runs at admission, off the
        decode step."""
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
        """Run one chunk of ``seq`` (pow2-bucketed, masked tail) on its
        slot. Returns the last real position's logits once the prompt is
        covered, else None."""
        rt = self.rt
        c = len(chunk_tokens)
        cb = pow2_bucket(c)
        toks = np.zeros((1, cb), np.int64)
        toks[0, :c] = chunk_tokens
        extra = rt.extra_dev.get(seq.seq_id)
        if extra is None:
            dt = rt.params[0]["embed"].dtype
            extra = rt.extra_dev[seq.seq_id] = {
                k: to_device(v, rt.device, dt) for k, v in seq.extra.items()}
        logits, _ = S.prefill(rt.cfg, rt.params[0],
                              to_device(toks, rt.device),
                              rt._slot_slice(seq.slot), n_valid=c,
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

    @torch.no_grad()
    def decode_sample(self, seqs: List[SequenceState], temps: np.ndarray,
                      top_ps: np.ndarray, gen: torch.Generator
                      ) -> torch.Tensor:
        """Decode every slot one step and sample in the same pass.
        ``temps``/``top_ps`` are (n_slots,) host arrays indexed by SLOT
        (free slots greedy); the all-greedy shortcut is decided from them
        on the host. Returns the (n_slots,) int32 token vector on the
        device; the caller reads its live rows by slot."""
        rt = self.rt
        cfg = rt.cfg
        tokens = np.zeros((rt.n_slots,), np.int64)
        for s in seqs:
            tokens[s.slot] = s.tokens[-1]
        logits, _ = S.decode_step(cfg, rt.params[0],
                                  to_device(tokens, rt.device),
                                  rt.cache, impl=rt.impl)
        if float(temps.max()) <= 0.0:
            toks = greedy_core(logits, cfg.vocab_size)
        else:
            toks = sample_core(logits, to_device(temps, rt.device),
                               to_device(top_ps, rt.device), gen,
                               cfg.vocab_size)
        for s in seqs:
            s.n_cached = len(s.tokens)
        return toks
