"""Scale-out of the port over ``torch.distributed`` (counterpart of
rscotr_tpu/parallel/): process groups (``mesh``), host-side gathers
(``multihost``), the data-parallel gradient sum (``ddp``), FSDP2 sharding
(``fsdp``) and tensor-parallel placement (``tp``)."""

from rscotr_tpu_torch.parallel.ddp import GradSync, reduce_sum
from rscotr_tpu_torch.parallel.mesh import (broadcast_module,
                                            initialize_distributed,
                                            local_device,
                                            pad_batch_to_devices, rank,
                                            world_size)
from rscotr_tpu_torch.parallel.multihost import (all_gather_pyobjects,
                                                 merge_strided_results,
                                                 process_count,
                                                 process_index)

__all__ = ["GradSync", "reduce_sum", "broadcast_module",
           "initialize_distributed", "local_device", "pad_batch_to_devices",
           "rank", "world_size", "all_gather_pyobjects",
           "merge_strided_results", "process_count", "process_index"]
