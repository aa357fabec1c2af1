"""The JE side of the port (§3, §5, §6, DESIGN.md §9-§11): the
request-job-task abstractions, Algorithm-1 placement over TE handles, the
PD heatmap on an H100 cost model, the decode-length predictor, the TE
lifecycle and the fleet executor, the serving plane, scaling (the
cold-start ladder's cost models, the warm pool, NPU-fork), fault
injection and the cluster manager."""
from repro_torch.core.abstractions import (  # noqa: F401
    Job, JobKind, RequestType, Status, Task, TaskKind, UserRequest,
    decompose,
)
from repro_torch.core.cluster import (  # noqa: F401
    AutoscalerConfig, ClusterManager, JobExecutor, TaskExecutor,
)
from repro_torch.core.faults import (  # noqa: F401
    AdmissionRejected, FaultPlan, FaultSpec, ForkFault, TEFailureError,
    TransferFault, backoff_s,
)
from repro_torch.core.fleet import (  # noqa: F401
    FleetExecutor, LifecycleError, TEState, advance,
)
from repro_torch.core.heatmap import HeatmapStudy, lookup  # noqa: F401
from repro_torch.core.perf_model import TECostModel, TEHardware  # noqa: F401
from repro_torch.core.predictor import (  # noqa: F401
    DecodeLengthPredictor, PredictorConfig, TraceEMAPredictor, synth_trace,
    train_predictor,
)
from repro_torch.core.scaling import (  # noqa: F401
    DRAMPageCache, DrainTrigger, FastScaler, LoadSpreadTrigger, ModelAsset,
    ModelLoader, ScaleTimings, WarmPool, WarmPoolMismatchError,
    npu_fork_live, tier_seconds,
)
from repro_torch.core.scheduling import (  # noqa: F401
    DistributedScheduler, DistSchedConfig, GlobalPromptTree, SchedRequest,
    TEHandle, round_robin_scheduler,
)
from repro_torch.core.serving_plane import (  # noqa: F401
    ServingJobEngine, TopologySpec,
)
