"""Multi-GPU parallelism: data, spatial and tensor parallelism over a
``torch.distributed`` device mesh (counterpart of
``minkowskiengine_tpu/parallel``)."""

from .data_parallel import (
    all_reduce_metrics,
    make_data_parallel_step,
    make_mesh,
    make_per_device_geometry_step,
    replicate,
    shard_batch,
)
from .spatial import (
    make_spatial_mesh,
    required_halo,
    shard_rows,
    shard_sparse_tensor,
    spatial_conv_apply,
    spatial_global_avg,
    spatial_global_sum,
    spatial_masked_moments,
)
from .tensor_parallel import apply_tensor_parallelism, make_tp_mesh
