"""Fixtures that the port's test files share. A file binds one by importing
it (``from test_torch_fixtures import one_torch_thread``); both are
autouse, so the import is all it takes. This module imports torch and
pytest only: the JAX engine is imported inside ``share_jax_programs``, so a
port file that binds ``one_torch_thread`` alone does not load JAX.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size torch ops gain nothing from intra-op threads, and the
    suite runs several workers on a few cores: one thread each here.
    Every port test file binds this fixture (six workers of eight torch
    threads each on eight cores took 2.4x the worker time of one thread
    each on the heaviest port files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def share_jax_programs():
    """Point every JAX TE's per-instance program caches at one dict per
    config for the module's duration. Each JAX runner keeps its jitted
    prefill / decode programs in per-instance dicts, whose programs depend
    only on the config and the shapes (weights and pools are arguments),
    so every TE of a module would otherwise compile the same programs
    again. Nothing else of the JAX engine changes."""
    import repro.engine.flowserve as JFS

    orig = JFS.FlowServe.__init__
    shared = {}

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        if self.pool is None:
            return
        caches = shared.setdefault(self.cfg.name, ({}, {}, {}, {}))
        (self.runner.prefill._ragged_fns, self.runner.decoder._fused_fns,
         self.runner.decoder._decode_fns, self.pool._scatter_jits) = caches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFS.FlowServe, "__init__", init)
        yield
