"""Quantization on the native host engine, batch collation, coordinate
maps, initialisation, gradient checks, checkpoints, summaries, profiling,
weight import and synthetic data."""

from .checkpoint import load_checkpoint, save_checkpoint
from .collation import SparseCollation, batch_sparse_collate, batched_coordinates, sparse_collate
from .coords import get_coords_map
from .gradcheck import gradcheck
from .init import kaiming_normal_, kaiming_uniform_
from .profiling import Timer, named_scope, timer, trace
from .quantization import (
    QuantizationReturnType,
    fnv_hash_vec,
    quantize,
    quantize_label,
    quantize_label_reference,
    quantize_reference,
    ravel_hash_vec,
    sparse_quantize,
)
from .summary import summary
from .torch_import import (
    export_reference_state_dict,
    load_reference_state_dict,
    load_state_dict_from_reference,
    reference_named_params,
)

__all__ = [
    "QuantizationReturnType",
    "SparseCollation",
    "Timer",
    "batch_sparse_collate",
    "batched_coordinates",
    "export_reference_state_dict",
    "fnv_hash_vec",
    "get_coords_map",
    "gradcheck",
    "kaiming_normal_",
    "kaiming_uniform_",
    "load_checkpoint",
    "load_reference_state_dict",
    "load_state_dict_from_reference",
    "named_scope",
    "quantize",
    "quantize_label",
    "quantize_label_reference",
    "quantize_reference",
    "ravel_hash_vec",
    "reference_named_params",
    "save_checkpoint",
    "sparse_collate",
    "sparse_quantize",
    "summary",
    "timer",
    "trace",
]
