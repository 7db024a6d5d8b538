from rscotr_tpu_torch.engine.checkpoint import (CheckpointWriter,
                                                find_latest_checkpoint,
                                                load_checkpoint,
                                                resolve_checkpoint,
                                                save_checkpoint)
from rscotr_tpu_torch.engine.hooks import (CheckpointHook, Hook,
                                           KeyIndicator, LogHook,
                                           MultiDatasetsEvalHook,
                                           NumClassCheckHook,
                                           build_custom_hooks)
from rscotr_tpu_torch.engine.infer import device_normalize, make_infer_steps
from rscotr_tpu_torch.engine.optimizer import (MtlOptimizer, build_optimizer,
                                               task_param_masks)
from rscotr_tpu_torch.engine.runner import IterBasedRunner
from rscotr_tpu_torch.engine.test import evaluate_results, single_device_test
from rscotr_tpu_torch.engine.train_step import (TrainStepConfig,
                                                make_train_step,
                                                make_val_step)

__all__ = ["CheckpointWriter", "find_latest_checkpoint", "load_checkpoint",
           "resolve_checkpoint", "save_checkpoint", "CheckpointHook", "Hook",
           "KeyIndicator", "LogHook", "MultiDatasetsEvalHook",
           "NumClassCheckHook", "build_custom_hooks", "device_normalize",
           "make_infer_steps", "MtlOptimizer", "build_optimizer",
           "task_param_masks", "IterBasedRunner", "evaluate_results",
           "single_device_test", "TrainStepConfig", "make_train_step",
           "make_val_step"]
