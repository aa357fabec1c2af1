from repro_torch.engine.flowserve import (  # noqa: F401
    Completion, EngineConfig, FlowServe, Request,
)
from repro_torch.engine.sampling import SamplingParams  # noqa: F401
