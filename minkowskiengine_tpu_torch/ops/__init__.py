"""Feature-phase primitives."""

from . import functional
from .functional import (
    broadcast,
    channelwise_conv,
    global_pool,
    interpolate_features,
    local_pool_avg,
    local_pool_max,
    local_pool_sum,
    prune_features,
    segment_count,
    segment_max,
    segment_mean,
    segment_sum,
    sparse_conv,
    sparse_conv_kmap,
    splat_features,
    take_rows,
    union_features,
)
