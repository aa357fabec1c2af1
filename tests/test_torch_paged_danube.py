"""h2o-danube-3-4b against the JAX package, on the CPU: the per-arch checks of
``test_torch_paged_archs.py`` (configs, bridge, own init layout,
teacher-forced logits, prefill + decode on the paged runner, EXACT greedy
tokens of the port's ``FlowServe`` against the JAX one on the ragged mix
and at K in {1, 4, 8}), in a file of its own so ``--dist loadfile`` can
put it on another worker."""
from test_torch_paged_archs import arch_suite
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["h2o-danube-3-4b"]

globals().update(arch_suite(ARCHS))
