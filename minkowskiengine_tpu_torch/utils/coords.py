"""Row correspondence between two sparse tensors (reference:
MinkowskiEngine/utils/coords.py).  Counterpart of
``minkowskiengine_tpu/utils/coords.py``."""

from __future__ import annotations

import torch


def get_coords_map(x, y):
    """(x_indices, y_indices), int64: each row of ``x`` whose voxel lies in
    ``y``'s coarser map, and that voxel's row in ``y``, so that
    ``x.C[x_indices]`` strided to ``y``'s tensor stride equals
    ``y.C[y_indices]`` (reference: utils/coords.py:29-63).  The two tensors
    must share a coordinate manager."""
    if x.coordinate_manager is not y.coordinate_manager:
        raise ValueError("x and y must share a coordinate manager")
    in_to_out = x.coordinate_manager.stride_map(x.coordinate_map_key, y.coordinate_map_key)
    valid = in_to_out >= 0
    return torch.nonzero(valid).flatten(), in_to_out[valid].long()
