from anyedit_tpu_torch.train.anysd import (
    AnySDConfig, AnySDTrainer, EXPERT_NAMES, TASK_EMB_BOOKS, TaskMoEAdapter,
)
from anyedit_tpu_torch.train.distill import DistillConfig, LCMDistiller, lcm_edit
