"""PD disaggregation of the slot family in the port against the JAX
package, on the CPU, and DistFlow's pricing twins (the paged family's P->D
checks are in ``test_torch_pd.py``, whose helpers this file uses):

  * rwkv6-1.6b and recurrentgemma-2b smoke: slot-snapshot migration gives
    the JAX P->D pair's greedy tokens, the same bytes moved and the same
    simulated clocks (EXACT);
  * DistFlow's pricing twins of ``tests/test_pd_migration.py``: equal
    simulated clocks on the same byte counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.distflow import BufferInfo as JBufferInfo
from repro.engine.distflow import DistFlow as JDistFlow
from repro_torch.engine.distflow import BufferInfo, DistFlow
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_engine_mesh
from test_torch_pd import (PROMPT, _bridge, _jpair, _jreqs, _serve_pd,
                           _tpair, _treqs)
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)



@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_slot_pd_matches_jax_pair(arch):
    bundle, jp, cfg, tp = _bridge(arch)
    prompts = [PROMPT, [1] + list(range(30, 43)), [7]]
    jpair = _jpair(bundle, jp, "js")
    want = _serve_pd(jpair, _jreqs("s", prompts))
    tpair = _tpair(cfg, tp, "ts")
    got = _serve_pd(tpair, _treqs("s", prompts))
    ids = [f"s{i}" for i in range(len(prompts))]
    assert sorted(got) == sorted(want) == ids
    assert [got[i] for i in ids] == [want[i] for i in ids]
    assert tpair[0].distflow.bytes_moved() == \
        jpair[0].distflow.bytes_moved() > 0
    assert tpair[1].distflow.sim_clock == jpair[1].distflow.sim_clock


# ---------------------------------------------------------------------------
# DistFlow pricing twins of tests/test_pd_migration.py:222-260
# ---------------------------------------------------------------------------


def test_transfer_charges_both_endpoints_as_jax():
    clocks = []
    for df, bi in ((DistFlow, BufferInfo), (JDistFlow, JBufferInfo)):
        a, b = df("a"), df("b")
        a.link_cluster([b])
        a.transfer(bi("a", "npu", payload=np.zeros(1 << 16, np.uint8)),
                   bi("b", "npu", deliver=lambda p: None))
        assert a.sim_clock > 0 and b.sim_clock == a.sim_clock
        clocks.append((a.sim_clock, b.sim_clock))
    assert clocks[0] == clocks[1]


def test_broadcast_charges_peers_as_jax():
    out = []
    for df, bi in ((DistFlow, BufferInfo), (JDistFlow, JBufferInfo)):
        src = df("src")
        dsts = [df(f"d{i}") for i in range(3)]
        src.link_cluster(dsts)
        sink = []
        xfers = src.broadcast(
            bi("src", "npu", payload=np.zeros(1 << 20, np.uint8)),
            [bi(d.owner, "npu", deliver=lambda p: sink.append(p.copy()))
             for d in dsts])
        assert len(sink) == 3 and all(x.wall_seconds > 0 for x in xfers)
        assert src.bytes_moved() == 3 * (1 << 20)
        out.append([x.sim_seconds for x in xfers]
                   + [d.sim_clock for d in dsts] + [src.sim_clock])
    assert out[0] == out[1]


def test_sharded_transfer_prices_bytes_per_link_as_jax():
    """The same runs priced by both packages: the port's as per-rank head
    shards (one per source rank), JAX's as global arrays."""
    shape = (4, 8, 8, 4, 8)

    def port(a, src_tp, dst_tp):
        kv = {n: SH.split(torch.zeros(shape), 3,
                          make_engine_mesh(src_tp, 0, "cpu"), copy=False)
              for n in ("k", "v")}
        return a.transfer_sharded(
            kv, "b", src_dim=3, dst=(make_engine_mesh(dst_tp, 0, "cpu"), 3),
            src_tp=src_tp, dst_tp=dst_tp, layer_chunks=1)

    def jax_(a, src_tp, dst_tp):
        kv = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
        return a.transfer_sharded(kv, "b", src_tp=src_tp, dst_tp=dst_tp,
                                  layer_chunks=1)
    res = []
    for df, move in ((DistFlow, port), (JDistFlow, jax_)):
        a, b = df("a"), df("b")
        a.link_cluster([b])
        one, four, cross = (move(a, s, d) for s, d in ((1, 1), (4, 4),
                                                       (4, 2)))
        assert cross.xfer.links == 2 and b.sim_clock == a.sim_clock
        res.append([h.xfer.sim_seconds for h in (one, four, cross)]
                   + [a.sim_clock, b.sim_clock])
    assert res[0] == res[1]


def test_layer_chunks_cover_the_run():
    """``transfer_sharded`` splits the run into layer-contiguous chunks
    that concatenate back to it; CPU chunks carry no event and are ready;
    the transfer is done once every chunk has been waited on."""
    a = DistFlow("a")
    k = torch.arange(5 * 3 * 2, dtype=torch.float32).view(5, 3, 2, 1, 1)
    one = make_engine_mesh(1, 0, "cpu")
    h = a.transfer_sharded({"k": [k], "v": [-k]}, "b", src_dim=3,
                           dst=(one, 3), src_tp=1, dst_tp=1, layer_chunks=2)
    assert [c[0] for c in h.chunks] == [0, 3] and h.events == [None, None]
    assert h.chunk_ready(1) and not h.xfer.done
    assert h.wait_chunk(0)[0] == 0 and h.xfer.done
    assert torch.equal(torch.cat([c[1][0] for c in h.wait()["chunks"]]), k)
