"""The port's public names against the JAX package's.

Every public name of the JAX package's top level, ``nn``, ``utils``, ``parallel``,
``models`` and ``MinkowskiFunctional`` must exist in the port, except the
allow-list below: what ROADMAP queue 1 still holds, each name with its
queue item, which must name it too.  Later slices shrink the list.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import minkowskiengine_tpu_torch as MT

ROOT = Path(__file__).resolve().parents[1]

# name -> the ROADMAP queue 1 item that still holds it
NOT_YET_PORTED = {}


PATHS = ["", "nn", "utils", "models", "MinkowskiFunctional", "parallel"]

# run in a fresh interpreter: a module that another test imports (say the
# JAX package's `cpp`) is bound on its package from then on
_PUBLIC = r"""
import json, types
import jax
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

names = {}
for path in PATHS:
    mod = ME
    for part in filter(None, path.split(".")):
        mod = getattr(mod, part)
    names[path] = public(mod, mod.__name__ if path else "minkowskiengine_tpu")
print(json.dumps(names))
"""


@pytest.fixture(scope="module")
def jax_public():
    """Public names of each JAX module of PATHS after a fresh import: its
    classes, functions and values, and the package's own subpackages and
    modules bound on it."""
    proc = subprocess.run([sys.executable, "-c", f"PATHS = {PATHS!r}\n" + _PUBLIC], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", PATHS)
def test_every_public_name_of_jax_exists_in_the_port(path, jax_public):
    tmod = MT
    for part in filter(None, path.split(".")):
        tmod = getattr(tmod, part)
    missing = sorted(n for n in jax_public[path] if not hasattr(tmod, n))
    assert missing == sorted(n for n in missing if n in NOT_YET_PORTED), missing
    if not path:  # the allow-list holds nothing that was ported since
        assert sorted(NOT_YET_PORTED) == missing


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
