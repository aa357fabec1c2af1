"""Tensor parallelism of the port's paged family against the JAX package,
on the CPU.

A tp > 1 port TE keeps one controller: its weights are a list of rank
trees, each rank's shard a tensor of its own, every rank here on ``cpu``,
and the all-reduces explicit sums. The JAX TE runs on a 1 x tp mesh of
the simulated host devices that ``tests/conftest.py`` forces. Held here:

  * the split dimensions of every config's weights and pool
    (``test_torch_tp_dims.py``, a file of its own for ``--dist loadfile``);
  * qwen3-8b smoke (cut to 2 layers, as every engine here) at tp 2
    (attention and pool split): raw prefill and first-decode logits
    within rtol = atol = 1e-4 of the JAX tp-2 TE's
    (``tests/test_tp_engine.py:83-88``), and greedy tokens equal to it on
    the ragged mix at K in {1, 4};
  * granite smoke at tp 4 (2 KV heads: attention and pool replicate, the
    MoE FFN splits ``d_expert``): logits within 1e-4 of JAX tp 4;
  * the sharding helpers (a shard's bits, a reshard across widths), the
    mesh's collectives, a slot arch served at tp 2 (the slot family's
    parity with JAX is ``tests/test_torch_tp_slot.py``) and the launcher's
    tp conflict check.
Everything else at tp > 1 is held against the port's own tp-1 TE, which
the other files hold to JAX tp 1 (``tests/test_torch_tp_fleet.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_config as jax_smoke_config
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlowServe as JFlowServe
from repro.engine import Request as JRequest
from repro.engine import SamplingParams as JSamplingParams
from repro.engine.kv_cache import pages_needed as jpages_needed
from repro.engine.model_runner import SequenceState as JSequenceState
from repro.models import get_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.engine import EngineConfig, FlowServe, Request, SamplingParams
from repro_torch.engine.kv_cache import pages_needed
from repro_torch.engine.runners.base import SequenceState
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_numpy
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

N_LAYERS = 2      # the smoke configs cut to 2 layers: the split, not depth
SHARED = dict(n_pages=64, page_size=8, max_batch_tokens=32, chunk_size=8,
              max_decode_batch=4)
WIDE = dict(SHARED, max_batch_tokens=64, chunk_size=32, max_decode_batch=8)
PROMPT = [1, 5, 9, 200, 41, 33, 77, 150, 3, 8, 12, 99]
RAGGED = [[7], [5, 6, 9], list(range(3, 11)), list(range(3, 12)),
          [1] + [int(x) for x in np.random.RandomState(3).randint(3, 200, 21)]]


def _bridge(arch):
    """The JAX smoke model cut to N_LAYERS and its weights, bridged."""
    bundle = get_model(dataclasses.replace(
        jax_smoke_config(jax_get_config(arch)), n_layers=N_LAYERS))
    jp = bundle.init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              n_layers=N_LAYERS)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return bundle, jp, cfg, tp


# ---------------------------------------------------------------- helpers
def test_shard_and_reshard_keep_every_bit():
    """A shard is rank r's contiguous slice, a view of the given tensor on
    its device; a reshard from tp 4 to tp 2 joins adjacent shards
    pairwise, and back; a replicated tensor lives once per distinct
    device; ``copy=True`` puts everything in new storage."""
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).view(2, 3, 8)
    m4, m2 = make_engine_mesh(4, 0, "cpu"), make_engine_mesh(2, 0, "cpu")
    s4 = SH.split(x, 2, m4, copy=False)
    assert all(torch.equal(s, x[..., 2 * r:2 * r + 2])
               and s.data_ptr() == x[..., 2 * r:].data_ptr()
               for r, s in enumerate(s4))
    s2 = SH.reshard(s4, 2, 2, m2, copy=True)
    assert all(torch.equal(s, x[..., 4 * r:4 * r + 4])
               and s.data_ptr() != x[..., 4 * r:].data_ptr()
               for r, s in enumerate(s2))
    same = SH.reshard(s4, 2, 2, m4, copy=True)
    assert all(torch.equal(a, b) and a.is_contiguous()
               and a.data_ptr() != b.data_ptr() for a, b in zip(same, s4))
    assert torch.equal(torch.cat(SH.reshard(s2, 2, 2, m4, copy=False), -1), x)
    rep = SH.split(x, None, m4, copy=False)
    assert all(t is x for t in rep)          # one device: no copy
    new = SH.split(x, None, m4, copy=True)
    assert all(t is new[0] for t in new) and new[0].data_ptr() != x.data_ptr()
    assert torch.equal(torch.cat(SH.reshard(rep, None, 2, m2, copy=False),
                                 2), x)
    whole = SH.reshard(s2, 2, None, make_engine_mesh(1, 0, "cpu"),
                       copy=False)
    assert len(whole) == 1 and torch.equal(whole[0], x)


def test_mesh_collectives_and_co_location():
    """Every rank of a CPU TE shares ``cpu``; ``broadcast`` issues no copy
    there; ``all_reduce`` sums in rank order and ``all_gather`` joins,
    both the identity over one rank."""
    m = make_engine_mesh(4, 1, "cpu")
    assert m.tp == 4 and m.distinct == [torch.device("cpu")]
    t = torch.ones(2)
    assert all(b is t for b in m.broadcast(t))
    parts = [torch.full((2,), float(r)) for r in range(4)]
    assert torch.equal(m.all_reduce(parts), torch.full((2,), 6.0))
    assert torch.equal(m.all_gather(parts, 0),
                       torch.tensor([0., 0., 1., 1., 2., 2., 3., 3.]))
    one = make_engine_mesh(1, 0, "cpu")
    assert one.all_reduce(parts[:1]) is parts[0]
    assert one.all_gather(parts[:1], 0) is parts[0]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "llama-3.2-vision-11b"])
def test_slot_family_refuses_tp_by_roadmap_item(arch):
    """(The name is from when a slot-family TE refused tp > 1 by its
    roadmap item.) A slot-family TE at tp 2 holds two rank trees and two
    rank caches and serves the tp-1 TE's greedy tokens."""
    cfg = smoke_config(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    toks = {}
    for tp in (1, 2):
        te = FlowServe(cfg, params, EngineConfig(tp=tp, n_slots=2,
                                                 max_len=64), device="cpu")
        assert len(te.runner.params) == len(te.runner.caches) == tp
        te.add_request(Request(prompt_tokens=PROMPT, req_id="r",
                               sampling=SamplingParams(
                                   temperature=0.0, max_new_tokens=4,
                                   stop_on_eos=False)))
        (c,) = te.run_to_completion()
        toks[tp] = c.tokens
    assert toks[2] == toks[1] and len(toks[2]) == 4


def test_launcher_refuses_conflicting_tp(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device", "cpu",
                                     "--tp", "2", "--topology",
                                     "pd=1,colo=1,tp=4"])
    with pytest.raises(SystemExit, match="conflicting tp"):
        serve.main()


# ---------------------------------------------------------------- (b) qwen3
@pytest.fixture(scope="module")
def qwen3():
    return _bridge("qwen3-8b")


def _jax_raw(te):
    """(prefill-final, first-decode) logits straight off a JAX TE's
    runner (``tests/test_tp_engine.py:60-68``), on pages it gives back."""
    seq = JSequenceState("s0", tokens=list(PROMPT), n_prompt=len(PROMPT))
    seq.pages = te.pool.alloc(jpages_needed(len(PROMPT) + 1,
                                            te.pool.page_size))
    pre = np.asarray(te.runner.prefill_chunk(seq, list(PROMPT)))
    seq.tokens.append(17)
    dec = np.asarray(te.runner.decode([seq])[0])
    te.pool.release(seq.pages)
    return pre, dec


def _port_raw(cfg, params, tp):
    """The JAX helper's two passes on the port's runner: PROMPT through the
    per-sequence ``prefill_chunk`` (one paged varlen entry), then one
    decode step of token 17."""
    te = FlowServe(cfg, params, EngineConfig(tp=tp, **SHARED), device="cpu")
    seq = SequenceState("s0", tokens=list(PROMPT), n_prompt=len(PROMPT))
    seq.pages = pages = te.pool.alloc(pages_needed(len(PROMPT) + 1,
                                                   te.pool.page_size))
    logits = te.runner.prefill_chunk(seq, list(PROMPT))
    dec = te.runner.decoder.body(*(torch.as_tensor(np.asarray(a, np.int32))
                                   for a in ([17], [pages], [len(PROMPT) + 1])))
    return logits.numpy(), dec[0].numpy(), te


@pytest.fixture(scope="module")
def qwen3_tp2_pair(qwen3):
    """One (JAX tp-2 TE, port tp-2 TE) pair; both read ``decode_horizon``
    afresh every step, so the cases share it (and its compiled shapes).
    A step takes the whole ragged mix in one pass (WIDE), which keeps the
    JAX TE's compiles few."""
    bundle, jp, cfg, params = qwen3
    return (JFlowServe(bundle, jp, JEngineConfig(tp=2, **WIDE)),
            FlowServe(cfg, params, EngineConfig(tp=2, **WIDE),
                      device="cpu"))


def test_qwen3_tp2_logits_match_jax_tp2(qwen3, qwen3_tp2_pair):
    _, _, cfg, params = qwen3
    jpre, jdec = _jax_raw(qwen3_tp2_pair[0])
    pre, dec, te = _port_raw(cfg, params, 2)
    assert te.pool.spec == 3 and len(te.pool.k) == 2
    assert te.pool.k[0].shape[3] == cfg.n_kv_heads // 2
    assert te.pool.k[0].data_ptr() != te.pool.k[1].data_ptr()
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dec, jdec, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_qwen3_tp2_greedy_tokens_equal_jax_tp2(qwen3_tp2_pair, k):
    jte, tte = qwen3_tp2_pair
    jte.ecfg.decode_horizon = tte.ecfg.decode_horizon = k
    ids = [f"k{k}-{i}" for i in range(len(RAGGED))]
    for rid, p in zip(ids, RAGGED):
        jte.add_request(JRequest(prompt_tokens=p, req_id=rid,
                                 sampling=JSamplingParams(
                                     temperature=0.0, max_new_tokens=6,
                                     stop_on_eos=False)))
        tte.add_request(Request(prompt_tokens=p, req_id=rid,
                                sampling=SamplingParams(
                                    temperature=0.0, max_new_tokens=6,
                                    stop_on_eos=False)))
    want = {c.req_id: c.tokens for c in jte.run_to_completion()}
    got = {c.req_id: c.tokens for c in tte.run_to_completion()}
    assert [got.get(i) for i in ids] == [want[i] for i in ids]
    assert tte.sampler_dispatches == 0


# ---------------------------------------------------------------- (c) granite
def test_granite_tp4_replicates_attention_and_matches_jax_tp4():
    bundle, jp, cfg, params = _bridge("granite-moe-3b-a800m")
    jpre, jdec = _jax_raw(JFlowServe(bundle, jp, JEngineConfig(
        tp=4, enable_prefix_cache=False, **SHARED)))
    pre, dec, te = _port_raw(cfg, params, 4)
    assert not SH.attn_shardable(cfg, 4) and te.pool.spec is None
    # one replicated pool, shared by the four ranks
    assert all(k is te.pool.k[0] for k in te.pool.k)
    assert te.pool.k[0].shape[3] == cfg.n_kv_heads
    blk = te.runner.params[1]["blocks"]
    assert blk["attn"]["wq"].shape[-1] == cfg.n_heads * cfg.head_dim
    assert blk["moe"]["w_up"].shape[-1] == cfg.moe.d_expert // 4
    assert blk["moe"]["w_down"].shape[-2] == cfg.moe.d_expert // 4
    assert blk["moe"]["router"] is te.runner.params[0]["blocks"]["moe"][
        "router"]
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dec, jdec, rtol=1e-4, atol=1e-4)
