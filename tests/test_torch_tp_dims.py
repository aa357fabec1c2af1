"""Tensor parallelism of the port's paged family against the JAX package,
on the CPU, shapes only (``jax.eval_shape``, no compile): the split
dimension of every weight leaf of every config at tp 2 and 4 equals the
axis where ``"model"`` stands in the JAX
``prune_unsplittable(param_specs(..., "serve", ...))``, and the pool's
too; ``attn_shardable`` agrees. The engines at tp > 1 are in
``test_torch_tp.py``."""
import jax
import jax.numpy as jnp
import pytest

from repro.launch import sharding as JSH
from repro.launch.mesh import make_engine_mesh as jmake_engine_mesh
from repro.models import get_model
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


class _Mesh:
    """The one attribute ``prune_unsplittable`` reads of a JAX mesh."""

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}


def _jax_dims(spec_tree):
    """path -> index of "model" in each leaf's PartitionSpec (or None)."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for kp, spec in flat[0]:
        dims = [i for i, ax in enumerate(tuple(spec)) if ax == "model"]
        out[jax.tree_util.keystr(kp)] = dims[0] if dims else None
    return out


def _port_dims(specs):
    out = {}
    SH.walk(specs, lambda path, s: out.__setitem__(path, s))
    return out


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_split_dims_match_jax_model_axis(arch):
    bundle = get_model(arch)
    like = jax.eval_shape(lambda: bundle.init_params(jax.random.PRNGKey(0),
                                                     jnp.float32))
    cfg = get_config(arch)
    tlike = T.meta_params(cfg)
    for tp in (2, 4):
        jspecs = JSH.prune_unsplittable(
            JSH.param_specs(bundle.cfg, like, "serve", ("data",), tp=tp,
                            heads_ok=JSH.attn_shardable(bundle.cfg, tp)),
            like, _Mesh(tp))
        want = _jax_dims(jspecs)
        got = _port_dims(SH.engine_param_specs(cfg, tlike, tp))
        assert got == want, (arch, tp)
        assert SH.te_param_specs(cfg, tp) == SH.engine_param_specs(
            cfg, tlike, tp)
        assert SH.attn_shardable(cfg, tp) == JSH.attn_shardable(bundle.cfg,
                                                                tp)
        pool = JSH.engine_kv_pool_sharding(bundle.cfg,
                                           jmake_engine_mesh(tp))
        dims = [i for i, ax in enumerate(tuple(pool.spec)) if ax == "model"]
        assert SH.engine_kv_pool_spec(cfg, tp) == (dims[0] if dims
                                                   else None), (arch, tp)
