"""Port parity for the data loader's quantization: ``sparse_quantize`` and
its hashes on the native host engine, ``get_coords_map``, and the host
engine's build.

The same seeded numpy points go through the JAX package's
``sparse_quantize`` and the port's; every output (coordinates, features,
labels, unique and inverse maps) must be bit-equal: both keep unique rows
in first-occurrence order.  The native engine is held bit-equal to the
numpy versions (``quantize_reference``, ``quantize_label_reference``).
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.utils import coords as jcoords
from minkowskiengine_tpu.utils import quantization as JQ
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.utils import hostengine
from minkowskiengine_tpu_torch.utils import quantization as TQ

ROOT = Path(__file__).resolve().parents[1]


def _points(seed=0, n=3000):
    """Float points with many per voxel, and per-point labels by height band:
    voxels across a band edge get conflicting labels."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * 2.0 - 0.5).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    labels = (np.floor(pts[:, 2] / 0.125).astype(np.int64) % 20)
    return pts, colors, labels


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))


FLAGS = [
    dict(),
    dict(return_index=True),
    dict(return_index=True, return_inverse=True),
    dict(return_maps_only=True),
    dict(return_maps_only=True, return_index=True, return_inverse=True),
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "plain")
@pytest.mark.parametrize("inputs", ["coords", "feats", "labels", "feats-labels"])
@pytest.mark.parametrize("qsize", [None, 0.1, (0.1, 0.2, 0.05)], ids=["none", "scalar", "per-axis"])
def test_sparse_quantize_matches_jax(flags, inputs, qsize):
    pts, colors, labels = _points()
    if qsize is None:
        pts = pts * 10.0
    kw = dict(flags, quantization_size=qsize, ignore_label=-100)
    if "feats" in inputs:
        kw["features"] = colors
    if "labels" in inputs:
        kw["labels"] = labels
    _same(MT.utils.sparse_quantize(pts, **kw), JQ.sparse_quantize(pts, **kw))


def test_sparse_quantize_contract_and_conflicts():
    pts, colors, labels = _points(1)
    coords, feats, labs, idx, inv = MT.utils.sparse_quantize(
        pts, colors, labels, quantization_size=0.1, ignore_label=-100,
        return_index=True, return_inverse=True,
    )
    full = np.floor(pts / 0.1).astype(np.int32)
    np.testing.assert_array_equal(coords[inv], full)
    np.testing.assert_array_equal(full[idx], coords)
    np.testing.assert_array_equal(feats, colors[idx])
    assert np.all(np.diff(idx) > 0)  # first-occurrence order
    # a voxel keeps its label where every point agrees, -100 where they differ
    lo = np.full(len(coords), 99)
    hi = np.full(len(coords), -99)
    np.minimum.at(lo, inv, labels)
    np.maximum.at(hi, inv, labels)
    np.testing.assert_array_equal(labs, np.where(lo == hi, lo, -100))
    assert 0 < (labs == -100).mean() < 1


def test_sparse_quantize_torch_in_torch_out():
    pts, colors, labels = _points(2)
    want = MT.utils.sparse_quantize(pts, colors, labels, quantization_size=0.1,
                                    return_index=True, return_inverse=True)
    got = MT.utils.sparse_quantize(torch.from_numpy(pts), torch.from_numpy(colors),
                                   torch.from_numpy(labels), quantization_size=0.1,
                                   return_index=True, return_inverse=True)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    maps = MT.utils.sparse_quantize(torch.from_numpy(pts), quantization_size=0.1,
                                    return_maps_only=True)
    assert isinstance(maps, torch.Tensor) and torch.equal(maps, got[3])


@pytest.mark.parametrize("call", [
    dict(return_inverse=True),
    dict(quantization_size=0.0),
    dict(quantization_size=(0.1, -0.1, 0.1)),
], ids=["inverse-without-index", "zero-size", "negative-size"])
def test_sparse_quantize_errors_as_jax(call):
    pts = _points()[0]
    with pytest.raises(ValueError):
        JQ.sparse_quantize(pts, **call)
    with pytest.raises(ValueError):
        MT.utils.sparse_quantize(pts, **call)


def test_rank_one_coordinates_are_refused():
    with pytest.raises(ValueError):
        MT.utils.sparse_quantize(np.zeros(5, np.float32))


def test_empty_input():
    coords, idx, inv = MT.utils.sparse_quantize(
        np.zeros((0, 3), np.float32), return_index=True, return_inverse=True
    )
    assert coords.shape == (0, 3) and len(idx) == 0 and len(inv) == 0
    um, inv, lab = MT.utils.quantize_label(np.zeros((0, 3), np.int32), np.zeros(0, np.int32), -1)
    assert len(um) == len(inv) == len(lab) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_numpy(seed):
    assert hostengine.load() is not None, "the host engine must build here (g++)"
    rng = np.random.RandomState(seed)
    coords = rng.randint(-50, 50, (5000, 4)).astype(np.int32)
    coords[: len(coords) // 2] = coords[len(coords) // 2:]
    labels = rng.randint(0, 3, len(coords)).astype(np.int32)
    for got, want in zip(MT.utils.quantize(coords), TQ.quantize_reference(coords)):
        np.testing.assert_array_equal(got, want)
    got = MT.utils.quantize_label(coords, labels, -1)
    want = TQ.quantize_label_reference(coords, labels, -1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # and both equal the JAX package's
    for g, w in zip(got, JQ.quantize_label(coords, labels, -1)):
        np.testing.assert_array_equal(g, w)


def test_quantize_label_conflict():
    coords = np.array([[0, 0], [0, 0], [2, 2], [0, 0]], np.int32)
    labels = np.array([7, 7, 3, 9], np.int32)
    um, inv, lab = MT.utils.quantize_label(coords, labels, ignore_label=-1)
    np.testing.assert_array_equal(um, [0, 2])
    np.testing.assert_array_equal(inv, [0, 0, 1, 0])
    np.testing.assert_array_equal(lab, [-1, 3])


def test_int64_coordinates_take_the_numpy_path_as_in_jax():
    coords = np.random.RandomState(3).randint(0, 5, (200, 3)).astype(np.int64)
    for g, w in zip(MT.utils.quantize(coords), JQ.quantize(coords)):
        np.testing.assert_array_equal(g, w)


def test_hashes_match_jax():
    coords = np.random.RandomState(4).randint(-20, 20, (300, 4)).astype(np.int32)
    np.testing.assert_array_equal(MT.utils.fnv_hash_vec(coords), JQ.fnv_hash_vec(coords))
    np.testing.assert_array_equal(MT.utils.ravel_hash_vec(coords), JQ.ravel_hash_vec(coords))
    # ravel keys are collision-free within the bounding box
    keys = MT.utils.ravel_hash_vec(coords)
    assert len(np.unique(keys)) == len(np.unique(coords, axis=0))


@pytest.mark.parametrize("stride", [2, 4])
def test_get_coords_map_matches_jax(stride):
    rng = np.random.RandomState(5)
    coords = np.unique(np.concatenate(
        [rng.randint(0, 2, (80, 1)), rng.randint(-6, 6, (80, 2))], 1).astype(np.int32), axis=0)
    feats = rng.randn(len(coords), 3).astype(np.float32)
    jx = ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))
    jy = ME.MinkowskiConvolution(3, 4, kernel_size=2, stride=stride, dimension=2)(jx)
    tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords), device="cpu")
    ty = MT.MinkowskiConvolution(3, 4, kernel_size=2, stride=stride, dimension=2, device="cpu")(tx)
    xi, yi = MT.utils.get_coords_map(tx, ty)
    jxi, jyi = jcoords.get_coords_map(jx, jy)
    assert xi.dtype == yi.dtype == torch.int64
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(jyi))
    c = tx.C[xi]
    np.testing.assert_array_equal(
        torch.cat([c[:, :1], torch.div(c[:, 1:], stride, rounding_mode="floor") * stride], 1).numpy(),
        ty.C[yi].numpy(),
    )
    with pytest.raises(ValueError):
        MT.utils.get_coords_map(tx, MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                                                    device="cpu"))


def test_host_engine_builds_under_build():
    path = hostengine.library_path()
    assert path.parent == ROOT / "build" / "hostengine"
    assert path.name.startswith("libme_hostengine-") and path.suffix == ".so"
    assert hostengine.library_path() == path  # keyed on the source: no rebuild


_BUILD = (
    "import sys; from pathlib import Path; "
    "from minkowskiengine_tpu_torch.utils import hostengine as h; "
    "h.BUILD_DIR = Path(sys.argv[1]); print(h.library_path())"
)


def test_concurrent_builds_do_not_race(tmp_path):
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=ROOT,
                         stdout=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(outs) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(outs.pop()).name]  # no temporaries left


def test_a_failed_build_warns_once_and_numpy_answers(tmp_path, monkeypatch):
    monkeypatch.setattr(hostengine, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hostengine, "_lib", None)
    monkeypatch.setattr(hostengine, "_tried", False)
    monkeypatch.setenv("CXX", "false")
    with pytest.warns(RuntimeWarning, match="host engine"):
        assert hostengine.load() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert hostengine.load() is None  # once
        coords = np.array([[1, 1], [0, 0], [1, 1]], np.int32)
        um, inv = MT.utils.quantize(coords)
    np.testing.assert_array_equal(um, [0, 1])
    np.testing.assert_array_equal(inv, [0, 1, 0])
