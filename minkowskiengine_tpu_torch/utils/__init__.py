"""Weight import, batch collation and synthetic data."""

from .collation import SparseCollation, batch_sparse_collate, batched_coordinates, sparse_collate

__all__ = ["SparseCollation", "batch_sparse_collate", "batched_coordinates", "sparse_collate"]
