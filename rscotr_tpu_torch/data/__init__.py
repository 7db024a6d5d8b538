"""The data side of the port's evaluation: datasets, test-time pipelines,
collates and loaders (counterpart of rscotr_tpu/data/)."""

from rscotr_tpu_torch.data.build import (build_dataloaders, build_dataset,
                                         build_datasets, load_data_cfg)
from rscotr_tpu_torch.data.loader import (TaskDataLoader, collate_cls,
                                          collate_det, collate_seg)

__all__ = ["build_dataloaders", "build_dataset", "build_datasets",
           "load_data_cfg", "TaskDataLoader", "collate_cls", "collate_det",
           "collate_seg"]
