"""Parallelism over ``torch.distributed``: one process per card.

``multihost`` joins the processes (the SOD100K_* variables or torchrun's)
and slices the global batch; ``mesh`` is the data x spatial mesh
(``Mesh2D``; plain data parallelism is its W x 1 shape) and its
collectives; ``spatial`` is the halo exchange of row bands. Global-batch
BN is ``ops.norm.GlobalBatchNorm2d``.
"""

from .mesh import (Mesh2D, all_reduce_grads, all_reduce_sum, data_mesh,
                   gather_rows, local_device, make_mesh_2d, rank, replicate,
                   world_size)

__all__ = ["Mesh2D", "all_reduce_grads", "all_reduce_sum", "data_mesh",
           "gather_rows", "local_device", "make_mesh_2d", "rank",
           "replicate", "world_size"]
