"""FLOWSERVE's centralized master scheduler (§4.2) — the port's own copy
of ``repro/engine/scheduler.py``. The slot family runs it without an RTC
(``rtc=None``): requests go straight to the ready queue, and prefix reuse
is the engine's state checkpoints. ``SchedulerConfig.mode`` serves the
three TE kinds of §4.5: a colocated TE plans prefill and decode, a
prefill TE (PD-disaggregated) plans only prefill and hands finished
sequences to its engine, a decode TE plans only decode over sequences
admitted by ``admit_running``.

Continuous batching with chunked prefill (Sarathi-style token budget per
step), preemption under page pressure, and the paper's two asynchrony
mechanisms:

  * async KV-cache prefetch — requests whose prefix matched a DRAM-tier
    RTC entry wait in PREFETCHING until the populate ticket completes
    (pumped off the critical path), then join the ready queue;
  * async (zero-overhead) execution — scheduling the next step needs only
    token *counts*, never token values, so ``prepare_next`` can run while
    the model executes the current step, and the engine always plans so.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.engine.runners.base import SequenceState
from repro_torch.engine.rtc import RelationalTensorCache


@dataclass
class StepPlan:
    # (seq, start_offset, chunk) — start lets the engine drop chunks that
    # became stale because the seq was preempted after planning
    prefill: List[Tuple[SequenceState, int, List[int]]] = field(default_factory=list)
    decode: List[SequenceState] = field(default_factory=list)


@dataclass
class SchedulerConfig:
    max_batch_tokens: int = 64          # chunked-prefill token budget / step
    max_decode_batch: int = 8
    chunk_size: int = 16                # prefill chunk granularity
    max_prefill_seqs: int = 8           # concurrent mid-prefill sequences
    mode: str = "colocated"             # colocated | prefill | decode


class Scheduler:
    """Owns the queues; the engine owns execution and page allocation."""

    def __init__(self, cfg: SchedulerConfig,
                 rtc: Optional[RelationalTensorCache]):
        self.cfg = cfg
        self.rtc = rtc
        self.waiting: deque = deque()           # SequenceState
        self.prefetching: List[Tuple[SequenceState, int]] = []  # (seq, ticket)
        self.ready: deque = deque()             # prefix resolved, needs prefill
        self.prefilling: List[SequenceState] = []
        self.running: List[SequenceState] = []  # decoding
        self.sched_time = 0.0                   # cumulative scheduler seconds

    # ------------------------------------------------------------ intake
    def admit(self, seq: SequenceState) -> None:
        self.waiting.append(seq)

    def resolve_prefix(self) -> None:
        """RTC match + populate decisions for newly waiting requests
        (the sched-enqueue thread of §4.2)."""
        while self.waiting:
            seq = self.waiting.popleft()
            if self.rtc is None:
                self.ready.append(seq)
                continue
            m = self.rtc.match_by_prefix_token(seq.tokens[:seq.n_prompt])
            if m.entry is None or m.matched_tokens == 0:
                self.ready.append(seq)
                continue
            if m.location == "npu":
                n, pages = self.rtc.reuse(
                    m.entry, min(m.matched_tokens, seq.n_prompt - 1))
                seq.pages = list(pages)
                seq.reused_pages = len(pages)
                seq.n_cached = n
                self.ready.append(seq)
            elif m.location == "dram":
                ticket = self.rtc.populate(m.entry)
                if ticket is None:  # cost model said recompute
                    self.ready.append(seq)
                else:
                    self.prefetching.append((seq, ticket.ticket))
            else:
                self.ready.append(seq)

    def pump_prefetch(self) -> None:
        if self.rtc is None or not self.prefetching:
            return
        self.rtc.pump_populates()
        still = []
        for seq, ticket in self.prefetching:
            if self.rtc.query_populate(ticket) or ticket not in self.rtc._pending:
                m = self.rtc.match_by_prefix_token(seq.tokens[:seq.n_prompt])
                if m.entry is not None and m.location == "npu":
                    n, pages = self.rtc.reuse(
                        m.entry, min(m.matched_tokens, seq.n_prompt - 1))
                    seq.pages = list(pages)
                    seq.reused_pages = len(pages)
                    seq.n_cached = n
                self.ready.append(seq)
            else:
                still.append((seq, ticket))
        self.prefetching = still

    # ------------------------------------------------------------ planning
    def prepare_next(self) -> StepPlan:
        """Build the next step's plan from queue *counts* only (async-safe).
        Chunked prefill: decode seqs cost 1 token each; the remaining token
        budget goes to prefill chunks."""
        t0 = time.monotonic()
        plan = StepPlan()
        if self.cfg.mode != "prefill":
            plan.decode = list(self.running[: self.cfg.max_decode_batch])
        budget = self.cfg.max_batch_tokens - len(plan.decode)
        if self.cfg.mode == "decode":
            self.sched_time += time.monotonic() - t0
            return plan
        # continue in-flight prefills first, then admit from ready
        candidates = list(self.prefilling)
        while self.ready and len(candidates) < self.cfg.max_prefill_seqs:
            candidates.append(self.ready.popleft())
        for seq in candidates:
            # target = every token but the last (which the decode path
            # processes). After a preemption this also re-covers the
            # already-generated tokens, whose KV was dropped.
            remaining = len(seq.tokens) - 1 - seq.n_cached
            if remaining <= 0:
                # single-token prompt or fully prefix-cached: prefill is
                # vacuously done; emit an empty chunk so the engine runs
                # the done-transition (slot alloc / migration).
                plan.prefill.append((seq, seq.n_cached, []))
                if seq not in self.prefilling:
                    self.prefilling.append(seq)
                continue
            if budget <= 0:
                if seq not in self.prefilling:
                    self.ready.appendleft(seq)
                continue
            take = min(self.cfg.chunk_size, budget, remaining)
            chunk = seq.tokens[seq.n_cached: seq.n_cached + take]
            plan.prefill.append((seq, seq.n_cached, chunk))
            if seq not in self.prefilling:
                self.prefilling.append(seq)
            budget -= take
        self.sched_time += time.monotonic() - t0
        return plan

    def safe_horizon(self, batch: List[SequenceState], k_target: int,
                     budget: int) -> int:
        """Multi-step decode proof (DESIGN.md §8): K decode+sample steps may
        run as ONE fused device dispatch iff the scheduler can show that for
        the next K steps (a) no prefill admission can interleave — every
        queue except ``running`` is empty, (b) the batch IS the whole
        running set (composition cannot change under it), and (c) no member
        can exhaust its ``max_new_tokens`` budget mid-horizon. EOS cannot be
        proven ahead of sampling, so the engine checks it one horizon late
        and discards post-stop tokens. Scheduling the horizon needs only
        token COUNTS, never values — the same §4.2 property that makes
        async single-step planning sound."""
        if k_target <= 1 or budget <= 1:
            return 1
        if self.waiting or self.prefetching or self.ready or self.prefilling:
            return 1
        if len(batch) != len(self.running):
            return 1
        return min(k_target, budget)

    # ------------------------------------------------------------ metrics
    def queued_seqs(self) -> List[SequenceState]:
        """Every sequence admitted but not yet fully prefilled."""
        return (list(self.waiting) + list(self.ready)
                + [s for s, _ in self.prefetching] + list(self.prefilling))

    def queued_prefill_tokens(self) -> int:
        """Prefill tokens still owed to queued sequences (the prefill half
        of the JE's live load signal)."""
        return sum(max(0, len(s.tokens) - 1 - s.n_cached)
                   for s in self.queued_seqs())

    def queue_depth(self) -> int:
        return (len(self.waiting) + len(self.ready) + len(self.prefetching)
                + len(self.prefilling))

    def occupancy(self) -> float:
        """Fraction of the decode batch in use (0 idle, >= 1 saturated:
        running may exceed the per-step batch; plans slice it)."""
        return len(self.running) / max(1, self.cfg.max_decode_batch)

    # ------------------------------------------------------------ commits
    def admit_running(self, seq: SequenceState) -> None:
        """Decode-TE admission of a migrated sequence: it arrives fully
        prefilled (its KV may still be in flight) and joins the decode set
        directly, past the prefill queues."""
        self.running.append(seq)

    def on_prefill_progress(self, seq: SequenceState, done: bool) -> None:
        if done:
            if seq in self.prefilling:
                self.prefilling.remove(seq)
            if self.cfg.mode == "prefill":
                return  # the engine hands the seq to a decode TE
            self.running.append(seq)

    def on_finished(self, seq: SequenceState) -> None:
        if seq in self.running:
            self.running.remove(seq)

    def remove(self, seq: SequenceState) -> None:
        """Forget a sequence that leaves this engine without finishing
        here (a migration): a zombie left in a queue would keep
        ``has_work`` true forever."""
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.prefilling:
            self.prefilling.remove(seq)
        try:
            self.ready.remove(seq)
        except ValueError:
            pass
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass
        self.prefetching = [(s, t) for s, t in self.prefetching
                            if s is not seq]

    def requeue(self, seq: SequenceState) -> None:
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.prefilling:
            self.prefilling.remove(seq)
        seq.n_cached = 0
        seq.pages = []
        self.waiting.appendleft(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefetching or self.ready
                    or self.prefilling or self.running)
