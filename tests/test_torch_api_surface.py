"""The port's public names against the JAX package's.

Every public name of the JAX package's top level, ``nn``, ``utils``, ``parallel``,
``models`` and ``MinkowskiFunctional`` must exist in the port, except the
allow-list below: what ROADMAP queue 1 still holds, each name with its
queue item, which must name it too.  Later slices shrink the list.

So must every keyword parameter of those classes' constructors and of those
functions (``rngs``, ``key`` and ``*varargs`` aside), and every public
attribute of a ``SparseTensor``, a ``TensorField`` and a
``CoordinateManager`` built on one cloud, except the allow-lists
``KEYWORDS_NOT_TAKEN`` and ``ATTRIBUTES_NOT_PORTED``: each entry gives its
reason, and ROADMAP names it.
"""

import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import minkowskiengine_tpu_torch as MT

ROOT = Path(__file__).resolve().parents[1]

# name -> the ROADMAP queue 1 item that still holds it
NOT_YET_PORTED = {}

_PADDED = "padded static shapes: ROADMAP queue 1, Not ported, on purpose"
_SLABS = "the TPU's slab maps: ROADMAP queue 2, Not ported, on purpose"
_INIT = ("torch idiom: the in-place initializer takes a tensor, not JAX's (key, shape): "
         "ROADMAP queue 1, Not ported, on purpose")

# (class or function, keyword) -> why the port does not take it
KEYWORDS_NOT_TAKEN = {
    ("CoordinateMap", "key_lanes"): "ROADMAP queue 1 item 2: keys for D > 6",
    ("CoordinateMap", "size_arr"): _PADDED,
    ("CoordinateMap", "_size_host"): _PADDED,
    ("Geometry", "dense_plans"): "ROADMAP queue 1 item 5: the dense-grid conv route",
    ("KernelMap", "fwd_slab"): _SLABS,
    ("KernelMap", "bwd_slab"): _SLABS,
    ("kaiming_normal_", "shape"): _INIT,
    ("kaiming_uniform_", "shape"): _INIT,
}

# (class, attribute) -> why the port does not have it
ATTRIBUTES_NOT_PORTED = {
    **{("SparseTensor", a): _PADDED for a in (
        "capacity", "padded_features", "size_array", "tree_flatten", "tree_unflatten",
        "valid_row_mask")},
    **{("TensorField", a): _PADDED for a in (
        "padded_features", "size_array", "tree_flatten", "tree_unflatten", "valid_row_mask")},
    **{("CoordinateManager", a): _PADDED for a in ("capacity", "size_array", "insert_and_map_padded")},
    ("CoordinateManager", "dense_plan"): "ROADMAP queue 1 item 5: the dense-grid conv route",
}

CLASSES = ("SparseTensor", "TensorField", "CoordinateManager")


PATHS = ["", "nn", "utils", "models", "MinkowskiFunctional", "parallel"]

# run in a fresh interpreter: a module that another test imports (say the
# JAX package's `cpp`) is bound on its package from then on
_PUBLIC = r"""
import inspect, json, types
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
import minkowskiengine_tpu as ME

def public(module, package):
    out = []
    for name in dir(module):
        if name.startswith("_"):
            continue
        value = getattr(module, name)
        if isinstance(value, types.ModuleType):
            # `from .nn import *` also binds nn's submodules on the JAX top
            # level; only the package's own top-level modules count
            if value.__name__ != f"{package}.{name}" and name != "MinkowskiFunctional":
                continue
        out.append(name)
    return out

names, keywords = {}, {}
for path in PATHS:
    mod = ME
    for part in filter(None, path.split(".")):
        mod = getattr(mod, part)
    names[path] = public(mod, mod.__name__ if path else "minkowskiengine_tpu")
    keywords[path] = {n: keyword_names(getattr(mod, n)) for n in names[path]}
coords = np.array([[0, 0, 0], [0, 1, 0], [0, 1, 1], [1, 2, 0]], np.int32)
feats = np.ones((4, 2), np.float32)
x = ME.SparseTensor(feats, coords)
objects = {"SparseTensor": x, "TensorField": ME.TensorField(feats, coords.astype(np.float32)),
           "CoordinateManager": x.coordinate_manager}
attributes = {k: [a for a in dir(v) if not a.startswith("_")] for k, v in objects.items()}
print(json.dumps({"names": names, "keywords": keywords, "attributes": attributes}))
"""


def keyword_names(obj):
    """The named parameters of a class's constructor or a function: those
    a caller may pass by keyword, without ``self``, ``rngs``, ``key`` and
    ``*varargs``; None for what is not callable or has no signature."""
    if isinstance(obj, type):
        obj = obj.__init__
    if not callable(obj):
        return None
    try:
        params = inspect.signature(obj).parameters.values()
    except (TypeError, ValueError):
        return None
    return [p.name for p in params
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD, p.POSITIONAL_ONLY)
            and p.name not in ("self", "rngs", "key")]


_PUBLIC = inspect.getsource(keyword_names) + _PUBLIC


@pytest.fixture(scope="module")
def jax_public():
    """Public names of each JAX module of PATHS after a fresh import: its
    classes, functions and values, and the package's own subpackages and
    modules bound on it."""
    proc = subprocess.run([sys.executable, "-c", f"PATHS = {PATHS!r}\n" + _PUBLIC], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_module(path):
    tmod = MT
    for part in filter(None, path.split(".")):
        tmod = getattr(tmod, part)
    return tmod


@pytest.mark.parametrize("path", PATHS)
def test_every_public_name_of_jax_exists_in_the_port(path, jax_public):
    tmod = _port_module(path)
    missing = sorted(n for n in jax_public["names"][path] if not hasattr(tmod, n))
    assert missing == sorted(n for n in missing if n in NOT_YET_PORTED), missing
    if not path:  # the allow-list holds nothing that was ported since
        assert sorted(NOT_YET_PORTED) == missing


@pytest.mark.parametrize("path", PATHS)
def test_every_keyword_of_jax_is_taken_by_the_port(path, jax_public):
    """Each keyword parameter of a JAX constructor or function exists in the
    port's, but the reasoned ``KEYWORDS_NOT_TAKEN``, each of which must
    still be missing."""
    missing = _missing_keywords(path, jax_public)
    assert missing <= set(KEYWORDS_NOT_TAKEN), sorted(missing - set(KEYWORDS_NOT_TAKEN))
    if not path:  # the allow-list holds nothing that was ported since
        every = set().union(*(_missing_keywords(p, jax_public) for p in PATHS))
        assert every == set(KEYWORDS_NOT_TAKEN), sorted(set(KEYWORDS_NOT_TAKEN) - every)


def _missing_keywords(path, jax_public):
    """(name, keyword) of each JAX keyword the port's name does not take."""
    tmod = _port_module(path)
    missing = set()
    for name, jax_keywords in jax_public["keywords"][path].items():
        port_keywords = keyword_names(getattr(tmod, name, None))
        if jax_keywords is not None and port_keywords is not None:
            missing |= {(name, k) for k in jax_keywords if k not in port_keywords}
    return missing


@pytest.mark.parametrize("cls", CLASSES)
def test_every_public_attribute_of_jax_exists_in_the_port(cls, jax_public):
    coords = torch.tensor([[0, 0, 0], [0, 1, 0], [0, 1, 1], [1, 2, 0]], dtype=torch.int32)
    feats = torch.ones(4, 2)
    x = MT.SparseTensor(feats, coords, device="cpu")
    objects = {"SparseTensor": x, "TensorField": MT.TensorField(feats, coords.float(), device="cpu"),
               "CoordinateManager": x.coordinate_manager}
    missing = {(cls, a) for a in jax_public["attributes"][cls] if not hasattr(objects[cls], a)}
    allowed = {k for k in ATTRIBUTES_NOT_PORTED if k[0] == cls}
    assert missing == allowed, (sorted(missing - allowed), sorted(allowed - missing))


def test_the_reasoned_allow_lists_are_in_roadmap():
    """Every keyword and attribute the port leaves out is named in ROADMAP,
    in the place its reason gives."""
    text = (ROOT / "ROADMAP.md").read_text()
    for (owner, name), why in {**KEYWORDS_NOT_TAKEN, **ATTRIBUTES_NOT_PORTED}.items():
        assert re.search(rf"[`.]{re.escape(name)}`", text), f"{owner}.{name} is not named in ROADMAP"
        assert "ROADMAP" in why, why


def test_the_allow_list_is_in_roadmap_queue_1():
    text = (ROOT / "ROADMAP.md").read_text()
    queue1 = text[text.index("### Queue 1"):text.index("### Queue 2")]
    for name, item in NOT_YET_PORTED.items():
        assert re.search(re.escape(item), queue1, re.I), f"{name}: queue 1 has no item {item!r}"
        assert name in queue1, f"{name} is not named in ROADMAP queue 1"


def test_reference_idioms_resolve():
    assert callable(MT.utils.sparse_quantize)
    assert callable(MT.MinkowskiFunctional.softmax)
    assert MT.MinkowskiLocalPoolingFunction is MT.nn.pooling.MinkowskiLocalPoolingFunction
    assert MT.models.VAEDecoder is MT.models.Decoder
    assert MT.models.VAEEncoder is MT.models.Encoder
    assert MT.CoordsManager is MT.CoordinateManager
    assert set(MT.__all__) <= set(dir(MT))
    assert set(MT.nn.__all__) <= set(dir(MT.nn))
    assert set(MT.utils.__all__) <= set(dir(MT.utils))


def test_the_port_imports_no_jax():
    code = (
        "import sys, minkowskiengine_tpu_torch as MT; MT.utils.sparse_quantize; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'minkowskiengine_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
