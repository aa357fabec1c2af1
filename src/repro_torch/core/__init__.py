"""The JE side of the port (§5): Algorithm-1 placement over TE handles,
the PD heatmap on an H100 cost model, the decode-length predictor and the
TE lifecycle. The serving plane, the fleet executor, scaling and fault
recovery come with the fleet slice."""
from repro_torch.core.fleet import LifecycleError, TEState, advance  # noqa: F401
from repro_torch.core.heatmap import HeatmapStudy, lookup  # noqa: F401
from repro_torch.core.perf_model import TECostModel, TEHardware  # noqa: F401
from repro_torch.core.predictor import (  # noqa: F401
    DecodeLengthPredictor, PredictorConfig, TraceEMAPredictor, synth_trace,
    train_predictor,
)
from repro_torch.core.scheduling import (  # noqa: F401
    DistributedScheduler, DistSchedConfig, GlobalPromptTree, SchedRequest,
    TEHandle, round_robin_scheduler,
)
