"""Tensor parallelism of the port's paged family, held against the port's
own tp-1 TE (which ``tests/test_torch_engine.py`` and the PD / plane files
hold to JAX tp 1), on the CPU with every rank on ``cpu``, the smoke configs
cut to 2 layers. No JAX here:

  * PD at (src_tp, dst_tp) in {(1,1), (2,2), (4,2), (2,4)} (qwen3 smoke
    has 2 KV heads: its pool splits at tp 2 and replicates at tp 4): the
    P -> D pair gives the colocated tp-1 tokens, DistFlow prices
    min(src_tp, dst_tp) links, the D-TE's pools are written in place and
    its heads, joined, equal the P-TE's exported run bit for bit; the v1
    host path re-splits at import and prices a replicated or sharded run
    as the tp-1 pair does;
  * a fork onto tp 2 (from tp 1 and from tp 2): every shard bit-equal to
    its slice of the source, in new storage, and the fork serves the
    tp-1 tokens; a release to the warm pool and a warm bring-up at tp 2;
  * the serving plane at ``TopologySpec(pd=1, colo=1, tp=2)`` serves the
    tp-1 plane's tokens, and merges ``EngineConfig.tp`` as the reference;
  * gemma2's post-norms at tp 2 (they apply to the all-reduced sum);
  * a prefix-cache DRAM populate at tp 2, every rank's pool bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import scaling as TS
from repro_torch.core import serving_plane as TP
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.distflow import tree_leaves
from repro_torch.engine.rtc import RTCCostModel
from repro_torch.engine.runners.base import SequenceState
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import layers as L
from repro_torch.models import rglru as G
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]


def _prompts(n, length=11, seed0=0):
    return [[1] + [int(x) for x in
                   np.random.RandomState(seed0 + i).randint(3, 200, length)]
            for i in range(n)]


def _model(arch, layers=2):
    """A smoke config cut to ``layers`` (the splits, not depth) and seeded
    weights."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              n_layers=layers)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    return cfg, params


def _reqs(prompts, max_new=6, tag="r"):
    return [Request(prompt_tokens=p, req_id=f"{tag}{i}",
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=max_new,
                                            stop_on_eos=False))
            for i, p in enumerate(prompts)]


def _serve(te, prompts, max_new=6):
    for r in _reqs(prompts, max_new):
        te.add_request(r)
    got = {c.req_id: c.tokens for c in te.run_to_completion()}
    return [got[f"r{i}"] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def qwen3():
    cfg, params = _model("qwen3-8b")
    te = FlowServe(cfg, params, EngineConfig(**SHARED), device="cpu")
    return cfg, params, _serve(te, RAGGED)


def _pair(cfg, params, src_tp, dst_tp):
    pe = FlowServe(cfg, params, EngineConfig(mode="prefill", tp=src_tp,
                                             **SHARED), name="p",
                   device="cpu")
    de = FlowServe(cfg, params, EngineConfig(mode="decode", tp=dst_tp,
                                             **SHARED), name="d",
                   device="cpu")
    pe.distflow.link_cluster([de.distflow])
    return pe, de


# ---------------------------------------------------------------- PD matrix
def _heads(runs, dim):
    """Per-rank tensors joined on their head split (the one tensor of a
    replicated or tp-1 pool or run)."""
    return torch.cat(runs, dim) if dim is not None else runs[0]


@pytest.mark.parametrize("src_tp,dst_tp", [(1, 1), (2, 2), (4, 2), (2, 4)])
def test_pd_across_the_tp_matrix(qwen3, src_tp, dst_tp):
    cfg, params, want = qwen3
    pe, de = _pair(cfg, params, src_tp, dst_tp)
    ptrs = [t.data_ptr() for t in (*de.pool.k, *de.pool.v)]
    for r in _reqs(RAGGED):
        pe.add_request(r)
    comps, n_runs = {}, 0
    for _ in range(200):
        if not (pe.has_work() or de.has_work()):
            break
        if pe.has_work():
            pe.step()
        for rid in pe.pop_migratable():
            seq = pe._seqs[rid]
            k, v = (_heads(run, pe.pool.spec)
                    for run in pe.pool.gather_device(seq.pages))
            pe.migrate_out(rid, de, overlap=False)
            n = len(seq.pages)
            run = de._seqs[rid].pages[:n]
            assert torch.equal(_heads([t[:, run] for t in de.pool.k],
                                      de.pool.spec), k)
            assert torch.equal(_heads([t[:, run] for t in de.pool.v],
                                      de.pool.spec), v)
            n_runs += 1
        if de.has_work():
            for c in de.step():
                comps[c.req_id] = c.tokens
    assert [comps[f"r{i}"] for i in range(len(RAGGED))] == want
    assert n_runs == len(RAGGED)
    assert all(x.links == min(src_tp, dst_tp) for x in pe.distflow.log)
    # imports scatter in place: no pool was replaced by a whole-pool copy
    assert [t.data_ptr() for t in (*de.pool.k, *de.pool.v)] == ptrs


def test_pd_host_round_trip_reshards_at_import(qwen3):
    """The v1 host path carries the P-TE's per-rank runs (tp 4: one
    replicated run); the D-TE (tp 2) re-splits them at import."""
    cfg, params, want = qwen3
    pe, de = _pair(cfg, params, 4, 2)
    for r in _reqs(RAGGED):
        pe.add_request(r)
    comps = {}
    for _ in range(200):
        if not (pe.has_work() or de.has_work()):
            break
        if pe.has_work():
            pe.step()
        for rid in pe.pop_migratable():
            pe.migrate_out(rid, de, host_gather=True)
        if de.has_work():
            for c in de.step():
                comps[c.req_id] = c.tokens
    assert [comps[f"r{i}"] for i in range(len(RAGGED))] == want


def _v1_bytes(cfg, params, tp):
    """Every DistFlow charge of a P -> D pair at ``tp`` whose migrations
    take the v1 host path: (backend, bytes) on both clocks."""
    pe, de = _pair(cfg, params, tp, tp)
    for r in _reqs(RAGGED[2:4], max_new=2):
        pe.add_request(r)
    while pe.has_work():
        pe.step()
        for rid in pe.pop_migratable():
            pe.migrate_out(rid, de, host_gather=True)
    return [[(x.backend, x.n_bytes) for x in df.log]
            for df in (pe.distflow, de.distflow)]


@pytest.mark.parametrize("arch,tp", [("granite-moe-3b-a800m", 4),
                                     ("qwen3-8b", 2)])
def test_v1_host_migration_prices_the_run_as_tp1(arch, tp):
    """The v1 host path prices a run as the reference counts a global
    array: a replicated run (granite's attention at tp 4), which every
    rank refers to, once; a sharded one (qwen3 at tp 2) as its heads
    summed. Both clocks see the tp-1 pair's bytes."""
    cfg, params = _model(arch)
    want = _v1_bytes(cfg, params, 1)
    assert len(want[0]) == 2 * 2          # pcie_dram + ici per request
    assert _v1_bytes(cfg, params, tp) == want


# ---------------------------------------------------------------- fork
def _assert_shards_of(params, te, tp):
    """Every leaf of every rank of ``te`` is its slice of the full tree,
    in storage of its own."""
    want = SH.shard(params, SH.te_param_specs(te.cfg, tp),
                    make_engine_mesh(tp, 0, "cpu"))
    src = {t.data_ptr() for t in tree_leaves(params)}
    for got, ref in zip(te.runner.params, want):
        for a, b in zip(tree_leaves(got), tree_leaves(ref)):
            assert torch.equal(a, b) and a.data_ptr() not in src


@pytest.mark.parametrize("src_tp", [1, 2])
def test_fork_onto_tp2_is_bit_equal_in_new_storage(qwen3, src_tp):
    cfg, params, want = qwen3
    src = FlowServe(cfg, params, EngineConfig(tp=src_tp, **SHARED),
                    name="src", device="cpu")
    fork = FlowServe.fork_from(src, EngineConfig(tp=2, **SHARED),
                               name="fork")
    assert fork.mesh.tp == 2 and fork.pool.spec == 3
    _assert_shards_of(params, fork, 2)
    # priced as the reference: the whole model over tp = 2 ICI links
    (x,) = src.distflow.log
    assert x.links == 2 and x.n_bytes == sum(t.nbytes for t in
                                            tree_leaves(params))
    assert _serve(fork, RAGGED) == want


def test_release_and_warm_bring_up_at_tp2(qwen3):
    cfg, params, want = qwen3
    te = FlowServe(cfg, params, EngineConfig(tp=2, **SHARED), device="cpu")
    host = te.release_params()
    assert len(host) == 2 and not te.fork_ready
    # a leaf the ranks share is drained once
    assert host[0]["final_norm"]["scale"] is host[1]["final_norm"]["scale"]
    warm = FlowServe.from_warm(cfg, host, EngineConfig(tp=2, **SHARED),
                               device="cpu")
    _assert_shards_of(params, warm, 2)
    assert warm.runner.params[0]["final_norm"]["scale"] \
        is warm.runner.params[1]["final_norm"]["scale"]
    assert _serve(warm, RAGGED) == want
    with pytest.raises(TS.WarmPoolMismatchError):
        FlowServe.from_warm(cfg, host, EngineConfig(tp=4, **SHARED),
                            device="cpu")


# ---------------------------------------------------------------- plane
def _plane_tokens(cfg, params, topo, ecfg):
    je = TP.ServingJobEngine(cfg, params, topo, heatmap=np.ones((2, 2)),
                             prefill_lens=[16, 64], decode_ratios=[0.25, 1.0],
                             policy="round_robin", ecfg=ecfg, device="cpu")
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=6,
                            stop_on_eos=False)
        ids = [je.submit(p, sampling=sp) for p in _prompts(4, length=14)]
        got = {c.req_id: c.tokens for c in je.run_to_completion()}
        return [got[i] for i in ids], je
    finally:
        je.close()


def test_plane_at_tp2_serves_the_tp1_tokens():
    cfg, params = _model("qwen3-8b")
    want, _ = _plane_tokens(cfg, params, TP.TopologySpec(pd=1, colo=1),
                            EngineConfig(**SHARED))
    got, je = _plane_tokens(cfg, params, TP.TopologySpec(pd=1, colo=1, tp=2),
                            EngineConfig(**SHARED))
    assert got == want
    assert [e.mesh.tp for e in je.engines] == [2, 2, 2]
    assert all(e.ecfg.tp == 2 for e in je.engines)


def test_plane_merges_tp_as_the_reference():
    cfg, params = _model("qwen3-8b")
    kw = dict(heatmap=np.ones((2, 2)), prefill_lens=[16, 64],
              decode_ratios=[0.25, 1.0], device="cpu")
    topo = TP.TopologySpec(colo=1)
    je = TP.ServingJobEngine(cfg, params, topo,
                             ecfg=EngineConfig(tp=2, **SHARED), **kw)
    assert topo.tp == 2 and je.engines[0].mesh.tp == 2
    je.close()
    with pytest.raises(ValueError, match="conflicting tp"):
        TP.ServingJobEngine(cfg, params, TP.TopologySpec(colo=1, tp=4),
                            ecfg=EngineConfig(tp=2, **SHARED), **kw)


# ---------------------------------------------------------------- gemma2
def test_gemma2_post_norms_follow_the_all_reduce():
    """gemma2's post-norms (and its softcaps) at tp 2: the decode logits
    over fresh pages match tp 1 to fp32 rounding, which a norm applied to
    a rank's partial would not, and the greedy tokens are tp 1's."""
    cfg, params = _model("gemma2-9b")
    assert cfg.post_norms
    out = {}
    for tp in (1, 2):
        te = FlowServe(cfg, params, EngineConfig(tp=tp, **SHARED),
                       device="cpu")
        toks = _serve(te, RAGGED)
        bt = torch.tensor([te.pool.alloc(2)], dtype=torch.int32)
        logits = [te.runner.decoder.body(
            torch.tensor([t], dtype=torch.int32), bt,
            torch.tensor([i + 1], dtype=torch.int32))
            for i, t in enumerate(RAGGED[4][:9])]
        out[tp] = toks, torch.stack(logits)
    assert out[2][0] == out[1][0]
    torch.testing.assert_close(out[2][1], out[1][1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- DRAM tier
def test_dram_populate_per_rank_at_tp2(qwen3):
    cfg, params, _ = qwen3
    te = FlowServe(cfg, params, EngineConfig(tp=2, **SHARED), device="cpu")
    te.rtc.cost = RTCCostModel(fetch_bw_bytes=1e15)   # always fetch
    prompt = _prompts(1, length=30)[0]
    ref = FlowServe(cfg, params, EngineConfig(**SHARED), device="cpu")
    want = [_serve(ref, [prompt]), _serve(ref, [prompt + [5]])]
    got = [_serve(te, [prompt])]
    (entry,) = [leaf.payload for leaf in te.rtc.tree.leaves_by_lru()]
    pages = list(entry.pages)
    before = [(k[:, pages].clone(), v[:, pages].clone())
              for k, v in zip(te.pool.k, te.pool.v)]
    te.rtc.copy_to_dram(entry)
    assert entry.location == "dram" and entry.pages is None
    got.append(_serve(te, [prompt + [5]]))
    assert entry.location == "npu" and te.rtc.stats["populates"] == 1
    n = len(entry.pages)
    for (k0, v0), k, v in zip(before, te.pool.k, te.pool.v):
        assert torch.equal(k[:, entry.pages], k0[:, :n])
        assert torch.equal(v[:, entry.pages], v0[:, :n])
    assert got == want


# ---------------------------------------------------------------- slot family
# rwkv6 smoke at 2 layers (4 heads of 16: the state splits 2 or 4 ways),
# recurrentgemma smoke at 3 layers (two RG-LRU blocks of width 64 and one
# local-attention block, whose single KV head replicates attention while
# its cache splits the sequence)
SLOT = dict(n_slots=5, max_len=64, max_batch_tokens=32, chunk_size=8,
            max_decode_batch=4)
SLOT_ARCHS = {"rwkv6-1.6b": 2, "recurrentgemma-2b": 3}


# prompts a colocated TE prefills in its first step: none of them is then
# advanced by a decode step mid-prefill (the reference's all-slot decode
# does that, a P-TE does not), so a PD pair gives the colocated tokens
ONE_STEP = RAGGED[:4]


@pytest.fixture(scope="module")
def slot_models():
    """arch -> (cfg, params, the colocated tp-1 TE's tokens on RAGGED and
    on ONE_STEP)."""
    out = {}
    for arch, layers in SLOT_ARCHS.items():
        cfg, params = _model(arch, layers)
        out[arch] = cfg, params, *(
            _serve(FlowServe(cfg, params, EngineConfig(**SLOT),
                             device="cpu"), prompts)
            for prompts in (RAGGED, ONE_STEP))
    return out


def _joined(snap):
    """A slot snapshot's leaves as whole tensors: the parts of a split
    leaf joined on its split, a replicated leaf's one copy."""
    return {k: torch.cat([r[k] for r in snap.ranks], d) if d is not None
            and len(snap.ranks) > 1 else snap.ranks[0][k]
            for k, d in snap.splits.items()}


@pytest.mark.parametrize("arch", sorted(SLOT_ARCHS))
@pytest.mark.parametrize("src_tp,dst_tp", [(1, 1), (2, 1), (1, 2)])
def test_slot_pd_across_tp(slot_models, arch, src_tp, dst_tp):
    """A slot P -> D pair from tp 2 to tp 1 and back gives the colocated
    tokens; each migrated slot lands bit for bit (the snapshot resharded
    at import), and DistFlow prices a snapshot as the tp-1 pair does:
    every split leaf's parts once, a replicated leaf once."""
    cfg, params, _, want = slot_models[arch]
    pe = FlowServe(cfg, params, EngineConfig(mode="prefill", tp=src_tp,
                                             **SLOT), name="p", device="cpu")
    de = FlowServe(cfg, params, EngineConfig(mode="decode", tp=dst_tp,
                                             **SLOT), name="d", device="cpu")
    pe.distflow.link_cluster([de.distflow])
    for r in _reqs(ONE_STEP):
        pe.add_request(r)
    comps, sizes = {}, []
    for _ in range(200):
        if not (pe.has_work() or de.has_work()):
            break
        if pe.has_work():
            pe.step()
        for rid in pe.pop_migratable():
            sent = _joined(pe.runner.snapshot_state(pe._seqs[rid]))
            pe.migrate_out(rid, de)
            got = _joined(de.runner.snapshot_state(de._seqs[rid]))
            assert sent.keys() == got.keys()
            assert all(torch.equal(got[k], sent[k]) for k in sent)
            sizes.append(sum(t.nbytes for t in sent.values()))
        if de.has_work():
            for c in de.step():
                comps[c.req_id] = c.tokens
    assert [comps[f"r{i}"] for i in range(len(ONE_STEP))] == want
    assert len(sizes) == len(ONE_STEP)
    # the payload is the snapshot plus the same bookkeeping at every tp
    extra = pe.distflow.bytes_moved() - sum(sizes)
    assert 0 < extra < 4096 * len(ONE_STEP)


def test_slot_pd_prices_a_snapshot_as_tp1():
    cfg, params = _model("recurrentgemma-2b", 3)
    moved = {}
    for tp in (1, 2):
        pe = FlowServe(cfg, params, EngineConfig(mode="prefill", tp=tp,
                                                 **SLOT), name="p",
                       device="cpu")
        de = FlowServe(cfg, params, EngineConfig(mode="decode", **SLOT),
                       name="d", device="cpu")
        pe.distflow.link_cluster([de.distflow])
        pe.add_request(_reqs([RAGGED[3]])[0])
        while not pe._prefill_done_buffer:
            pe.step()
        pe.migrate_out(pe.pop_migratable()[0], de)
        moved[tp] = pe.distflow.bytes_moved()
    assert moved[2] == moved[1] > 0


@pytest.mark.parametrize("src_tp", [1, 2])
def test_slot_fork_onto_tp2(slot_models, src_tp):
    cfg, params, want, _ = slot_models["rwkv6-1.6b"]
    src = FlowServe(cfg, params, EngineConfig(tp=src_tp, **SLOT),
                    name="src", device="cpu")
    fork = FlowServe.fork_from(src, EngineConfig(tp=2, **SLOT), name="fork")
    assert fork.mesh.tp == 2 and len(fork.runner.caches) == 2
    _assert_shards_of(params, fork, 2)
    assert _serve(fork, RAGGED) == want


def test_slot_release_and_warm_bring_up_at_tp2(slot_models):
    cfg, params, want, _ = slot_models["rwkv6-1.6b"]
    te = FlowServe(cfg, params, EngineConfig(tp=2, **SLOT), device="cpu")
    host = te.release_params()
    assert len(host) == 2 and not te.fork_ready
    warm = FlowServe.from_warm(cfg, host, EngineConfig(tp=2, **SLOT),
                               device="cpu")
    _assert_shards_of(params, warm, 2)
    assert _serve(warm, RAGGED) == want


def test_slot_plane_at_colo1_tp2_serves_the_tp1_tokens():
    cfg, params = _model("rwkv6-1.6b")
    want, _ = _plane_tokens(cfg, params, TP.TopologySpec(colo=1),
                            EngineConfig(**SLOT))
    got, je = _plane_tokens(cfg, params, TP.TopologySpec(colo=1, tp=2),
                            EngineConfig(**SLOT))
    assert got == want
    assert [e.mesh.tp for e in je.engines] == [2]
    assert len(je.engines[0].runner.caches) == 2


def test_slot_launcher_at_tp2(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
        "--tp", "2", "--requests", "2", "--max-new", "4", "--layers", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "te-0: tp=2, ranks on ['cpu', 'cpu']" in out
    assert out.count("-> 4 tokens") == 2


# The one-tree arithmetic of the slot blocks before their rank lists, kept
# verbatim (bar names) as the baseline a tp-1 TE must reproduce bit for bit.
def _tree_time_mix(p, x, head_dim, state, last_x, n_valid=None):
    b, t, d = x.shape
    h = d // head_dim
    xs = torch.cat([last_x[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    delta = (xs - x).float()
    lora = x @ p["mix_lora_a"]
    mixes = p["mix_base"][:, None, None, :] + torch.einsum(
        "btr,mrd->mbtd", torch.tanh(lora.float()).to(x.dtype),
        p["mix_lora_b"]).float()
    xr, xk, xv, xw, xg = (x.float() + delta * mixes[i] for i in range(5))

    def proj(a, wname):
        return a.to(x.dtype) @ p[wname]

    r = proj(xr, "wr").reshape(b, t, h, head_dim)
    k = proj(xk, "wk").reshape(b, t, h, head_dim)
    v = proj(xv, "wv").reshape(b, t, h, head_dim)
    g = torch.nn.functional.silu(proj(xg, "wg"))
    dec = p["decay_base"] + ((xw.to(x.dtype) @ p["decay_lora_a"])
                             @ p["decay_lora_b"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, head_dim)
    if n_valid is not None and n_valid < t:
        valid = (torch.arange(t) < n_valid)[None, :, None, None]
        w = torch.where(valid, w, torch.ones_like(w))
        k = torch.where(valid, k, torch.zeros_like(k))
    y, state = ops.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                        w.to(r.dtype).contiguous(), p["bonus_u"], state)
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = (y32 - mu).square().mean(-1, keepdim=True)
    y32 = (y32 - mu) * torch.rsqrt(var + 1e-5)
    y = (y32.reshape(b, t, d) * p["ln_x"]).to(x.dtype) * g
    last = x[:, -1, :] if n_valid is None else x[:, n_valid - 1, :]
    return y @ p["wo"], last


def _tree_channel_mix(p, x, last_x, n_valid=None):
    xs = torch.cat([last_x[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    delta = (xs - x).float()
    xk = (x.float() + delta * p["cm_mix"][0]).to(x.dtype)
    xr = (x.float() + delta * p["cm_mix"][1]).to(x.dtype)
    kk = torch.relu(xk @ p["cm_k"]).square()
    rr = torch.sigmoid((xr @ p["cm_r"]).float()).to(x.dtype)
    last = x[:, -1, :] if n_valid is None else x[:, n_valid - 1, :]
    return rr * (kk @ p["cm_v"]), last


def _tree_rwkv_logits(cfg, params, tokens, cache, n_valid=None):
    one = make_engine_mesh(1, 0, "cpu")
    x = T.embed(cfg, [params], tokens, one)
    for li in range(cfg.n_layers):
        p = T.layer(params, li)
        h = L.apply_norm(x, p["ln1"], cfg.norm)
        y, cache["last_tm"][li] = _tree_time_mix(
            p["tm"], h, cfg.rwkv.head_dim, cache["state"][li],
            cache["last_tm"][li], n_valid)
        x = x + y
        h = L.apply_norm(x, p["ln2"], cfg.norm)
        y, cache["last_cm"][li] = _tree_channel_mix(
            p["tm"], h, cache["last_cm"][li], n_valid)
        x = x + y
    nv = tokens.shape[1] if n_valid is None else n_valid
    return T.unembed(cfg, [params], x[:, nv - 1:nv], one)[:, 0]


def _tree_rglru_block(p, x, h0, conv_state):
    gate = torch.nn.functional.gelu(x @ p["w_gate_in"], approximate="tanh")
    u, conv_state = G.conv1d_apply(p, x @ p["w_in"], conv_state)
    rg = torch.sigmoid((u @ p["wa"]).float())
    ig = torch.sigmoid((u @ p["wx"]).float())
    log_a = -8.0 * torch.nn.functional.softplus(p["lambda_p"].float()) * rg
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (ig * u.float())
    hseq, h = ops.rglru(a.contiguous(), b.contiguous(),
                        h0.float().contiguous())
    return (hseq.to(x.dtype) * gate) @ p["w_out"], h, conv_state


def test_slot_tp1_is_the_one_tree_arithmetic_bit_for_bit():
    """At tp 1 the rank-list bodies compute what one tree computes, bit for
    bit: the rwkv6 TE's logits over a prompt in two chunks (the first with
    a padded tail) and a decode step against the one-tree time/channel
    mixes on a copy of its caches, the RG-LRU block against its one-tree
    form, and attention over one key slice against plain attention (over
    two slices, merged, within fp32 rounding of it)."""
    cfg, params = _model("rwkv6-1.6b")
    rt = FlowServe(cfg, params, EngineConfig(**SLOT), device="cpu").runner
    prompt = RAGGED[4][:8]
    seq = SequenceState("s", tokens=list(prompt), n_prompt=len(prompt))
    rt.alloc_slot(seq)
    cache = {k: v.clone() for k, v in rt.caches[0].items()}
    row = {k: v[:, seq.slot:seq.slot + 1] for k, v in cache.items()
           if k != "length"}
    assert rt.prefill_chunk(seq, prompt[:6]) is None
    _tree_rwkv_logits(cfg, params, torch.tensor([prompt[:6] + [0, 0]]), row,
                      n_valid=6)
    assert torch.equal(rt.prefill_chunk(seq, prompt[6:]),
                       _tree_rwkv_logits(cfg, params,
                                         torch.tensor([prompt[6:]]), row)[0])
    tokens = torch.zeros((rt.n_slots,), dtype=torch.int64)
    tokens[seq.slot] = 17
    with torch.no_grad():
        logits, _ = S.decode_step(cfg, rt.params, tokens, rt.caches, rt.mesh)
    want = _tree_rwkv_logits(cfg, params, tokens[:, None], cache)
    assert torch.equal(logits, want)

    rcfg, rparams = _model("recurrentgemma-2b", 3)
    p = rparams["rglru_blocks"][0]["rec"]
    rs = np.random.RandomState(5)

    def randn(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    w = rcfg.rglru.lru_width
    x, h0, conv = randn(2, 5, rcfg.d_model), randn(2, w), randn(2, 3, w)
    one = make_engine_mesh(1, 0, "cpu")
    y, (h,), (c,) = G.rglru_block_apply([p], x, [h0], [conv], one)
    for a, b in zip((y, h, c), _tree_rglru_block(p, x, h0, conv)):
        assert torch.equal(a, b)
    q, k, v = randn(2, 3, 4, 16), randn(2, 9, 2, 16), randn(2, 9, 2, 16)
    mask = torch.from_numpy(rs.rand(2, 3, 9) > 0.3)
    whole = L.attention(q, k, v, mask, 50.0)
    assert torch.equal(L.attention_lse(q, k, v, mask, 50.0)[0], whole)
    assert torch.equal(S._attend([(q, k, v, mask)], 50.0, one), whole)
    # two key slices merged by their log-sum-exps: the whole softmax
    halves = [(q, k[:, a:b], v[:, a:b], mask[..., a:b])
              for a, b in ((0, 4), (4, 9))]
    torch.testing.assert_close(
        S._attend(halves, 50.0, make_engine_mesh(2, 0, "cpu")), whole,
        rtol=1e-6, atol=1e-6)
