"""The PyTorch examples (``examples_torch/``) on the CPU, against the JAX
package's.

- ``common.py``'s synthetic generators give JAX ``examples/common.py``'s
  arrays, bit for bit, for seeds 0 and 1.
- ``indoor.py``'s chain (``segment``: a TensorField at 5 cm with
  UNWEIGHTED_AVERAGE, ``sparse()``, the model, ``slice()``) on a
  3,000-point synthetic room with ``MinkUNet14A`` in eval mode, against the
  JAX package's public API taking the steps of ``examples/indoor.py:161-178``
  with the same weights (``export_reference_state_dict``, random running
  statistics so that eval mode is a real test): per-point logits within
  1e-4 of max|ref| (float32 sums over up to 27 · 256 products per conv,
  taken in another order, through 20 convs).  JAX's eager network compiles
  each op on first use (about a minute on a CPU), so it runs in a subprocess
  started before the other cases, which run meanwhile.
- The PLY writer gives JAX's bytes, and the reader reads them (and a binary
  file) back as JAX's does.
- Every script runs ``main([... "--cpu"])`` in process at a small size; its
  results: shapes, finite losses, the files it writes into ``tmp_path``.
"""

import ast
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
REL = 1e-4
ROOM_POINTS, ROOM_VOXEL = 3000, 0.05


def _load(path: Path, name: str):
    """A script by its path, under a module name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(name):
    return _load(EXAMPLES / f"{name}.py", f"examples_torch_{name}")


def _jax_example(name):
    return _load(ROOT / "examples" / f"{name}.py", f"examples_jax_{name}")


# the JAX side of the indoor chain, in its own interpreter
_JAX_INDOOR = r"""
import sys
from pathlib import Path

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import MinkUNet14A
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm
from minkowskiengine_tpu.utils.torch_import import (
    export_reference_state_dict, load_reference_state_dict)

out = Path(sys.argv[1])
room = np.load(out / "room.npz")
points, colors, voxel_size = room["points"], room["colors"], float(room["voxel_size"])
model = MinkUNet14A(3, 20, D=3, rngs=nnx.Rngs(0))
sd = export_reference_state_dict(model)
rng = np.random.RandomState(0)
for k in sd:  # random running statistics, so that eval mode is a real test
    if k.endswith("running_mean"):
        sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
    elif k.endswith("running_var"):
        sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
load_reference_state_dict(model, sd)
for _, m in nnx.iter_graph(model):
    if isinstance(m, MinkowskiBatchNorm):
        m.train(False)
np.savez(out / "weights.npz", **sd)

# examples/indoor.py:161-178
in_field = ME.TensorField(
    features=(colors - 0.5).astype(np.float32),
    coordinates=ME.utils.batched_coordinates([points / voxel_size], dtype=np.float32),
    quantization_mode=ME.SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE,
)
sinput = in_field.sparse()
soutput = model(sinput)
out_field = soutput.slice(in_field)
np.savez(out / "jax.npz", logits=np.asarray(out_field.features), voxels=sinput.size)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The scripts' small CPU runs on one torch thread: inside a loaded
    multi-worker test run, torch's thread pool spinning against the other
    workers' cost these cases 20-30x their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_indoor(tmp_path_factory):
    """Starts JAX's indoor chain on the synthetic room before the first case
    of this file; ``test_indoor_chain_matches_jax`` (the last) waits for it."""
    out = tmp_path_factory.mktemp("indoor_jax")
    points, colors = _script("indoor").synthetic_room(n_points=ROOM_POINTS)
    np.savez(out / "room.npz", points=points, colors=colors, voxel_size=ROOM_VOXEL)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_INDOOR, str(out)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield out, proc, points, colors
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_are_jaxs(seed):
    """``data_loader``, ``random_scene``, ``random_point_cloud``,
    ``synthetic_shape`` and ``modelnet_batch`` draw JAX's numbers."""
    mine, jax_common = _script("common"), _jax_example("common")
    for kw in ({}, {"nchannel": 2, "is_classification": False, "dimension": 3, "batch_size": 3}):
        got, want = mine.data_loader(seed=seed, **kw), jax_common.data_loader(seed=seed, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype
    for fn, kw in (("random_scene", dict(n_points=500, batch_size=2)),
                   ("random_point_cloud", dict(n_points=300))):
        got, want = getattr(mine, fn)(seed=seed, **kw), getattr(jax_common, fn)(seed=seed, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    assert mine.SHAPE_CLASSES == jax_common.SHAPE_CLASSES
    for cls in range(len(mine.SHAPE_CLASSES)):
        np.testing.assert_array_equal(
            mine.synthetic_shape(cls, 100, np.random.RandomState(seed)),
            jax_common.synthetic_shape(cls, 100, np.random.RandomState(seed)))
    got = mine.modelnet_batch(4, n_points=100, seed=seed, transform=mine.CoordinateTransformation())
    want = jax_common.modelnet_batch(4, n_points=100, seed=seed,
                                     transform=jax_common.CoordinateTransformation())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_room_is_jaxs():
    """``indoor.synthetic_room``'s 200,000 points and colors are JAX's, bit
    for bit: 163,022 voxels at 2 cm."""
    points, colors = _script("indoor").synthetic_room()
    want_points, want_colors = _jax_example("indoor").synthetic_room()
    np.testing.assert_array_equal(points, want_points)
    np.testing.assert_array_equal(colors, want_colors)
    assert len(np.unique(np.floor(points / 0.02), axis=0)) == 163_022


# ---------------------------------------------------------------------------
# the PLY reader and writer
# ---------------------------------------------------------------------------


def test_ply_round_trip_is_jaxs(tmp_path):
    indoor, jax_indoor = _script("indoor"), _jax_example("indoor")
    rng = np.random.RandomState(0)
    points = rng.randn(50, 3) * 3
    colors = rng.randint(0, 300, (50, 3)).astype(np.float64) - 20  # clipped to 0-255
    indoor.write_ply(tmp_path / "port.ply", points, colors)
    jax_indoor.write_ply(tmp_path / "jax.ply", points, colors)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got, want = indoor.read_ply(tmp_path / "port.ply"), jax_indoor.read_ply(tmp_path / "jax.ply")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], points, atol=5e-5)
    np.testing.assert_array_equal(got[1], np.clip(colors, 0, 255).astype(np.uint8) / 255.0)

    # binary little-endian, double coordinates and uchar colors
    dtype = np.dtype([("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rows = np.zeros(50, dtype)
    for i, c in enumerate("xyz"):
        rows[c] = points[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        rows[c] = np.clip(colors[:, i], 0, 255)
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 50\nproperty double x\n"
              "property double y\nproperty double z\nproperty uchar red\nproperty uchar green\n"
              "property uchar blue\nend_header\n")
    (tmp_path / "bin.ply").write_bytes(header.encode() + rows.tobytes())
    got, want = indoor.read_ply(tmp_path / "bin.ply"), jax_indoor.read_ply(tmp_path / "bin.ply")
    np.testing.assert_array_equal(got[0], points)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# every script, run as a user runs it, on the CPU
# ---------------------------------------------------------------------------


def _finite(values):
    return len(values) > 0 and all(math.isfinite(v) for v in values)


def _check_indoor(r):
    assert r["points"] == 3000 and r["logits"].shape == (3000, 20)
    assert np.isfinite(r["logits"]).all() and r["counts"].sum() == 3000
    points, colors = _script("indoor").read_ply(r["out"])
    assert points.shape == (3000, 3) and colors.shape == (3000, 3)


SCRIPTS = {
    "example": (["--steps", "2"], lambda r: len(r["losses"]) == 2 and _finite(r["losses"])),
    "sparse_tensor_basic": ([], lambda r: r["averaged"] == [2.0, 5.0]
                            and r["slice"] == r["field"] == (1000, 3)
                            and r["union"] == {(0, 0, 0): 3.0, (0, 1, 0): 1.0, (0, 2, 2): 2.0}),
    "convolution": ([], lambda r: r["at_coords"] == r["at_key"] and r["strided"][1] == 3
                    and r["transposed"][1] == 3),
    "unet": (["--steps", "2"], lambda r: r["out"] == (r["sites"], 5) and _finite(r["losses"])),
    "stack_unet": ([], lambda r: r["out"][0] == r["in"][0] and r["out"][1] == 5
                   and r["tensor_stride"] == (1, 1)),
    "minkunet": (["--n_points", "600", "--steps", "1"], lambda r: _finite(r["losses"])
                 and 0 <= r["accuracy"] <= 1),
    "indoor": (["--n_points", "3000", "--voxel_size", "0.1"], _check_indoor),
    "resnet": (["--n_points", "3000", "--voxel_size", "0.1"], lambda r: all(
        v.shape == (1, 10) and torch.isfinite(v).all() for v in r["logits"].values())
        and len(r["logits"]) == 3),
    "pointnet": (["--steps", "2", "--batch_size", "4", "--n_points", "64", "--eval_batches",
                  "1"], lambda r: _finite(r["losses"]) and 0 <= r["accuracy"] <= 1),
    **{f"classification_modelnet40[{n}]": (
        ["--network", n, "--steps", "1", "--batch_size", "2", "--n_points", "64",
         "--eval_batches", "1"], lambda r: _finite(r["losses"]))
       for n in ("minkfcnn", "minksplatfcnn", "minkpointnet")},
    "completion": (["--steps", "1", "--res", "16", "--levels", "3"],
                   lambda r: _finite(r["losses"]) and r["completed"] >= 0),
    "vae": (["--steps", "1", "--res", "32", "--levels", "3"], lambda r: _finite(r["losses"])),
    "reconstruction": (["--steps", "1", "--res", "32", "--levels", "3"],
                       lambda r: _finite(r["losses"]) and r["reconstructed"] >= 0),
    "training": (["--steps", "2", "--n_points", "500"], lambda r: _finite(r["losses"])
                 and r["restored_equal"] and Path(r["checkpoint"]).is_file()),
    "fresh_geometry_training": (["--steps", "2", "--n_points", "500"],
                                lambda r: _finite(r["losses"]) and r["captures"] == 0),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_script_runs_on_the_cpu(case, tmp_path, capsys):
    name = case.split("[")[0]
    argv, check = SCRIPTS[case]
    argv = argv + ["--cpu"]
    if name == "indoor":
        argv += ["--out", str(tmp_path / "prediction.ply")]
    elif name == "training":
        argv += ["--ckpt", str(tmp_path / "checkpoint.pt")]
    result = _script(name).main(argv)
    assert capsys.readouterr().out.strip()
    assert check(result) is not False


def test_every_script_has_a_case_and_imports_no_jax():
    """Each script of ``examples_torch/`` is run above, or, for the
    multi-process ones, in ``test_torch_examples_parallel.py``'s world; none
    imports jax, flax, optax, orbax or the JAX package."""
    scripts = {p.stem for p in EXAMPLES.glob("*.py")} - {"common"}
    parallel = _load(Path(__file__).with_name("test_torch_examples_parallel.py"),
                     "examples_torch_parallel_cases").SCRIPTS
    assert scripts == {c.split("[")[0] for c in SCRIPTS} | set(parallel)
    for path in EXAMPLES.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "flax", "optax", "orbax",
                                               "minkowskiengine_tpu"), (path.name, n)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default runs on it")
def test_without_a_card_a_script_raises_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("example").main(["--steps", "1"])


# ---------------------------------------------------------------------------
# the slice as a whole: indoor's chain against JAX's (kept last: it waits for
# the subprocess the module fixture started)
# ---------------------------------------------------------------------------


def test_indoor_chain_matches_jax(jax_indoor):
    from minkowskiengine_tpu_torch.models import MinkUNet14A
    from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

    out, proc, points, colors = jax_indoor
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    want = np.load(out / "jax.npz")
    model = MinkUNet14A(3, 20, D=3, device="cpu")
    load_state_dict_from_reference(model, dict(np.load(out / "weights.npz")))
    model.eval()
    with torch.no_grad():
        logits, voxels = _script("indoor").segment(points, colors, model, ROOM_VOXEL, "cpu")
    assert voxels == int(want["voxels"])
    assert logits.shape == want["logits"].shape == (ROOM_POINTS, 20)
    ref = want["logits"].astype(np.float64)
    rel = np.abs(logits.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= REL, rel
