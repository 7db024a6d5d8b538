"""The data side of the port: datasets, pipelines, collates, loaders, and
the multi-task loader of co-training (counterpart of rscotr_tpu/data/)."""

from rscotr_tpu_torch.data.build import (build_dataloaders, build_dataset,
                                         build_datasets,
                                         build_iteration_strategy,
                                         build_multidataloader,
                                         derive_dn_ladder, load_data_cfg)
from rscotr_tpu_torch.data.loader import (MultiDataLoader, PrefetchIterator,
                                          TaskDataLoader, collate_cls,
                                          collate_det, collate_seg)

__all__ = ["build_dataloaders", "build_dataset", "build_datasets",
           "build_iteration_strategy", "build_multidataloader",
           "derive_dn_ladder", "load_data_cfg", "MultiDataLoader",
           "PrefetchIterator", "TaskDataLoader", "collate_cls", "collate_det",
           "collate_seg"]
