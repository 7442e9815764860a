"""Data parallelism over ``torch.distributed``: one process per card.

``multihost`` joins the processes (the SOD100K_* variables or torchrun's)
and slices the global batch; ``mesh`` is the 1-D data group and its
collectives. Global-batch BN is ``ops.norm.GlobalBatchNorm2d``.
"""

from .mesh import (all_reduce_grads, all_reduce_sum, data_group,
                   gather_rows, local_device, rank, replicate, world_size)

__all__ = ["all_reduce_grads", "all_reduce_sum", "data_group", "gather_rows",
           "local_device", "rank", "replicate", "world_size"]
