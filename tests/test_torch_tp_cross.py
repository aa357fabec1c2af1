"""Tensor parallelism of the port's cross-attention towers
(llama-3.2-vision-11b VLM, seamless-m4t-large-v2 enc-dec) against the JAX
package, on the CPU: the tp-2 checks of ``test_torch_tp_slot.py`` (cache
split dimensions against the JAX ``engine_cache_shardings``, each rank's
cache storage, prefill and first-decode logits within 1e-4, greedy tokens
on the ragged mix and through a state checkpoint, EXACT), with non-zero
modality inputs and (the VLM) non-zero gates."""
from test_torch_tp_slot import ENCDEC, VLM, slot_tp_suite
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ARCHS = [VLM, ENCDEC]

globals().update(slot_tp_suite(ARCHS))
