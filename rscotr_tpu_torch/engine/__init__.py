from rscotr_tpu_torch.engine.infer import device_normalize, make_infer_steps
from rscotr_tpu_torch.engine.optimizer import (MtlOptimizer, build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.train_step import (TrainStepConfig,
                                                make_train_step)

__all__ = ["device_normalize", "make_infer_steps", "MtlOptimizer",
           "build_optimizer", "task_param_masks", "TrainStepConfig",
           "make_train_step"]
