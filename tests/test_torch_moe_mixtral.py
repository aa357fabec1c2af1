"""mixtral-8x7b (MoE, at smoke: 4 experts, drop-free) against the JAX
package, on the CPU: the per-arch checks of ``test_torch_paged_archs.py``
(configs, bridge, own init layout, teacher-forced logits, prefill + decode
on the paged runner, EXACT greedy tokens of the port's ``FlowServe``
against the JAX one on the ragged mix and at K in {1, 4, 8}) with the MoE
checks of ``test_torch_moe.py``."""
from test_torch_moe import moe_bridge_check, moe_config_check
from test_torch_paged_archs import arch_suite
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["mixtral-8x7b"]

globals().update(arch_suite(ARCHS, moe_config_check, moe_bridge_check))
