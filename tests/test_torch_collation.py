"""Port parity for batch collation: ``utils/collation.py`` equals the JAX
package's on the same samples, and returns torch tensors.  Exact: the
functions only copy, floor and concatenate."""

import numpy as np
import pytest
import torch

from minkowskiengine_tpu.utils import collation as J
from minkowskiengine_tpu_torch.utils import collation as T


def _samples(n=3, seed=0):
    rng = np.random.RandomState(seed)
    coords = [rng.uniform(-5, 5, (rng.randint(2, 9), 3)).astype(np.float32) for _ in range(n)]
    feats = [rng.randn(len(c), 4).astype(np.float32) for c in coords]
    labels = [rng.randint(0, 7, len(c)) for c in coords]
    return coords, feats, labels


@pytest.mark.parametrize("as_tensor", [False, True])
def test_batched_coordinates_matches_jax(as_tensor):
    coords, _, _ = _samples()
    want = J.batched_coordinates(coords)
    got = T.batched_coordinates([torch.from_numpy(c) for c in coords] if as_tensor else coords)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        T.batched_coordinates(coords[0])
    with pytest.raises(ValueError):
        T.batched_coordinates([coords[0], coords[1][:, :2]])


@pytest.mark.parametrize("with_labels", [False, True])
def test_sparse_collate_matches_jax(with_labels):
    coords, feats, labels = _samples(seed=1)
    lab = labels if with_labels else None
    want = J.sparse_collate(coords, feats, lab)
    got = T.sparse_collate(coords, [torch.from_numpy(f) for f in feats], lab)
    assert len(got) == len(want) == (3 if with_labels else 2)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        T.sparse_collate([coords[0]], [feats[0][:-1]])


def test_batch_sparse_collate_and_limit_match_jax():
    coords, feats, labels = _samples(n=4, seed=2)
    data = list(zip(coords, feats, labels))
    for g, w in zip(T.batch_sparse_collate(data), J.batch_sparse_collate(data)):
        np.testing.assert_array_equal(g.numpy(), w)
    limit = len(coords[0]) + len(coords[1]) + 1  # the third sample does not fit
    got = T.SparseCollation(limit_numpoints=limit)(data)
    want = J.SparseCollation(limit_numpoints=limit)(data)
    assert set(got[0][:, 0].tolist()) == {0, 1}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
