"""Fine-tune jobs of the port: AdamW, sharded checkpoints and the train
loop (the counterpart of ``repro/training``)."""
from repro_torch.training.optimizer import (  # noqa: F401
    OptimizerConfig, adamw_update, adamw_update_, init_opt_state)
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.training.train_loop import (  # noqa: F401
    TrainConfig, TrainProgram, make_train_step, train)
