"""Distributed scheduling (§5, Algorithm 1), torch port of
``repro/core/scheduling.py``.

``dist_sched(req)`` = PD_aware -> (locality_aware | load_aware):
  1. PD-aware: pick the TE *type* (a disaggregated pair or a colocated TE)
     from the combined heatmap and the decode-length predictor (§5.3);
  2. if the surviving group is load-balanced, prefer the TE with the
     longest prefix match in the global prompt tree (§5.2);
  3. otherwise pick the least-loaded TE.

TEs are described by ``TEHandle``s, the JE's view (type, load, a prompt
tree). A handle is a live adapter when port engines are attached
(``engine``, and for a PD pair ``decode_engine``): ``refresh()`` reads the
load from the engines' ``load_metrics()`` (queued prefill tokens,
in-flight decode budget, the fused-horizon headroom) instead of the
hand-fed floats of simulations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fleet import TEState, advance
from repro_torch.core.heatmap import lookup
from repro_torch.core.predictor import DecodeLengthPredictor
from repro_torch.engine.radix_tree import RadixTree


@dataclass
class TEHandle:
    te_id: str
    te_type: str                        # "colocated" | "pd_pair"
    load: float = 0.0                   # outstanding work (tokens)
    prefill_load: float = 0.0           # refresh(): queued prefill tokens
    decode_load: float = 0.0            # refresh(): in-flight decode budget
    n_running: int = 0
    engine: object = None               # live FlowServe; pd_pair: the
    #                                     primary prefill engine
    decode_engine: object = None        # pd_pair: the primary decode engine
    # M:N PD groups (§4.6): several members per side; None means the
    # primary is the only member
    prefill_engines: Optional[List[object]] = None
    decode_engines: Optional[List[object]] = None
    state: TEState = TEState.SERVING    # lifecycle (core/fleet.py)
    prompt_tree: RadixTree = field(default_factory=RadixTree)

    def record_prompt(self, tokens) -> None:
        self.prompt_tree.insert(tuple(tokens), self.te_id)

    # ------------------------------------------------------------ lifecycle
    def transition(self, new: TEState) -> TEState:
        """Walk the PROVISIONING -> ... -> RELEASED machine; illegal moves
        raise."""
        self.state = advance(self.state, new)
        return self.state

    @property
    def admitting(self) -> bool:
        """Only SERVING TEs accept new placements."""
        return self.state is TEState.SERVING

    # ------------------------------------------------------------ members
    def prefill_members(self) -> List[object]:
        if self.prefill_engines is not None:
            return list(self.prefill_engines)
        return [self.engine] if self.engine is not None else []

    def decode_members(self) -> List[object]:
        if self.decode_engines is not None:
            return list(self.decode_engines)
        return [self.decode_engine] if self.decode_engine is not None else []

    def grow_decode(self, engine: object) -> None:
        """§4.6 M:N scale-out: add a decode member to this PD group."""
        if self.decode_engines is None:
            self.decode_engines = self.decode_members()
        self.decode_engines.append(engine)
        if self.decode_engine is None:
            self.decode_engine = engine

    def pick_decode_member(self) -> object:
        """The least-loaded decode member takes the next prefilled request
        (§4.6); load is the ``refresh`` signal, read per member."""
        members = self.decode_members()
        if len(members) <= 1:
            return members[0] if members else None
        return min(members, key=_engine_load)

    def live_engines(self) -> List[object]:
        """The attached engines that expose real load signals."""
        return [e for e in (*self.prefill_members(), *self.decode_members())
                if e is not None and hasattr(e, "load_metrics")]

    def refresh(self) -> float:
        """Recompute ``load`` from the attached engines' real state:

            load = queued_prefill_tokens + inflight_decode_tokens / headroom

        where headroom is the fused decode horizon the TE's scheduler can
        prove now (a TE in steady decode serves K steps per dispatch). A
        PD group sums its members (a sequence lives in one at a time). The
        prefill and decode halves are kept apart (``prefill_load``,
        ``decode_load``). Handles without live engines keep their hand-fed
        ``load``."""
        engines = self.live_engines()
        if not engines:
            return self.load
        prefill_toks = decode_toks = 0.0
        headroom = 1.0
        n_active = 0
        for eng in engines:
            m = eng.load_metrics()
            prefill_toks += m["queued_prefill_tokens"]
            decode_toks += m["inflight_decode_tokens"]
            headroom = max(headroom, m["horizon_headroom"])
            n_active += m["n_queued"] + m["n_running"]
        self.prefill_load = prefill_toks
        self.decode_load = decode_toks
        self.load = prefill_toks + decode_toks / headroom
        self.n_running = n_active
        return self.load


def _engine_load(eng) -> float:
    """Per-member load (the refresh() signal for ONE engine)."""
    m = eng.load_metrics()
    return (m["queued_prefill_tokens"]
            + m["inflight_decode_tokens"] / max(1.0, m["horizon_headroom"]))


def _predictor_trained(pred) -> bool:
    """An online predictor with no observation yet has nothing to say, and
    the request's own estimate stands; offline predictors (no
    ``n_observations``) are always trained."""
    n_obs = getattr(pred, "n_observations", None)
    return n_obs is None or n_obs() > 0


@dataclass
class SchedRequest:
    tokens: Sequence[int]
    predicted_decode: int = 128


class GlobalPromptTree:
    """JE side: one tree per TE group; payloads are TE ids (§5.2)."""

    def __init__(self):
        self.tree = RadixTree()

    def record(self, tokens, te_id: str) -> None:
        self.tree.insert(tuple(tokens), te_id)

    def best_te(self, tokens, candidates: List[TEHandle]
                ) -> Tuple[Optional[str], int]:
        """The TE holding the longest matching prefix among candidates."""
        cand_ids = {t.te_id for t in candidates}
        best_id, best_len = None, 0
        matched, path = self.tree.match_prefix(tuple(tokens))
        # walk the matched path from the root down; payload = te_id
        consumed = 0
        for node in path:
            consumed += len(node.key)
            payload = node.payload or self.tree.any_payload(node)
            if payload in cand_ids and min(consumed, matched) > best_len:
                best_id, best_len = payload, min(consumed, matched)
        return best_id, best_len


@dataclass
class DistSchedConfig:
    load_balance_threshold: float = 0.30   # max relative load spread
    min_prefix_tokens: int = 8             # ignore tiny prefix matches


class DistributedScheduler:
    """Runs inside a model-serving JE (one instance per TE group)."""

    def __init__(self, tes: List[TEHandle], combined_heatmap: np.ndarray,
                 prefill_lens, decode_ratios,
                 predictor: Optional[DecodeLengthPredictor] = None,
                 cfg: DistSchedConfig = DistSchedConfig()):
        self.tes = {t.te_id: t for t in tes}
        self.heatmap = combined_heatmap
        self.prefill_lens = prefill_lens
        self.decode_ratios = decode_ratios
        self.predictor = predictor
        self.cfg = cfg
        self.global_tree = GlobalPromptTree()
        self.decisions = {"pd_disagg": 0, "pd_colo": 0, "locality": 0,
                          "load": 0}

    # ------------------------------------------------------ Algorithm 1
    def dist_sched(self, req: SchedRequest) -> TEHandle:
        # lifecycle gate: draining or released TEs stop admitting
        tes = [t for t in self.tes.values() if t.admitting]
        if not tes:             # everything draining: any placement beats
            # dropping, but never onto a crashed or released TE
            tes = [t for t in self.tes.values()
                   if t.state not in (TEState.FAILED, TEState.RELEASED)]
        if not tes:
            raise RuntimeError("dist_sched: no routable TE (all failed "
                               "or released)")
        for te in tes:          # live handles read real engine state
            te.refresh()
        tes = self.pd_aware(req, tes)
        if self._is_load_balanced(tes):
            chosen = self.locality_aware(req, tes)
        else:
            chosen = self.load_aware(req, tes)
        return chosen

    def pd_aware(self, req: SchedRequest, tes: List[TEHandle]
                 ) -> List[TEHandle]:
        p_len = len(req.tokens)
        d_len = req.predicted_decode
        if self.predictor is not None and _predictor_trained(self.predictor):
            d_len = self.predictor.predict_tokens(req.tokens)
        val = lookup(self.heatmap, self.prefill_lens, self.decode_ratios,
                     p_len, d_len)
        want = "pd_pair" if val > 0 else "colocated"
        sub = [t for t in tes if t.te_type == want]
        if not sub:                      # the group has only one type
            return tes
        self.decisions["pd_disagg" if want == "pd_pair" else "pd_colo"] += 1
        return sub

    def locality_aware(self, req: SchedRequest, tes: List[TEHandle]
                       ) -> TEHandle:
        te_id, n = self.global_tree.best_te(req.tokens, tes)
        if te_id is not None and n >= self.cfg.min_prefix_tokens:
            self.decisions["locality"] += 1
            return self.tes[te_id]
        return self.load_aware(req, tes, count=False)

    def load_aware(self, req: SchedRequest, tes: List[TEHandle],
                   count: bool = True) -> TEHandle:
        if count:
            self.decisions["load"] += 1
        return min(tes, key=lambda t: t.load)

    # ------------------------------------------------------ bookkeeping
    def _is_load_balanced(self, tes: List[TEHandle]) -> bool:
        loads = [t.load for t in tes]
        if not loads or max(loads) <= 0:
            return True
        spread = (max(loads) - min(loads)) / max(max(loads), 1e-9)
        return spread <= self.cfg.load_balance_threshold

    def commit(self, req: SchedRequest, te: TEHandle) -> None:
        """Record a placement: load and prompt-tree bookkeeping."""
        te.load += len(req.tokens) + req.predicted_decode
        te.n_running += 1
        self.global_tree.record(req.tokens, te.te_id)
        te.record_prompt(req.tokens)

    def complete(self, req: SchedRequest, te: TEHandle,
                 actual_decode: Optional[int] = None) -> None:
        """Release the tokens the request actually consumed (the observed
        decode length when the caller has it, else the prediction);
        clamped at zero."""
        consumed = len(req.tokens) + (req.predicted_decode
                                      if actual_decode is None
                                      else actual_decode)
        te.load = max(0.0, te.load - consumed)
        te.n_running = max(0, te.n_running - 1)


def round_robin_scheduler(tes: List[TEHandle]):
    """The round-robin baseline of Figure 7. Skips TEs that stopped
    admitting, but stays degenerate otherwise."""
    state = {"i": 0}

    def pick(req: SchedRequest) -> TEHandle:
        for _ in range(len(tes)):
            te = tes[state["i"] % len(tes)]
            state["i"] += 1
            if te.admitting:
                return te
        # nothing admitting: degrade, but never onto a crashed/released TE
        routable = [t for t in tes
                    if t.state not in (TEState.FAILED, TEState.RELEASED)]
        if not routable:
            raise RuntimeError("round_robin: no routable TE (all failed "
                               "or released)")
        return routable[state["i"] % len(routable)]

    return pick
