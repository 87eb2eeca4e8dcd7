"""The port's documentation (``docs_torch/``).

- ``generate_api.py --check``: the API pages are what the generator writes
  from the port's docstrings and signatures.
- Every public name of the modules the API surface test reads (the top
  level, ``nn``, ``utils``, ``models``, ``MinkowskiFunctional``,
  ``parallel``; the port's names include JAX's, which that test checks)
  is on some API page, but names that are not the port's own objects
  (``typing.Optional`` bound in a module, say).
- Every relative link of the guides and pages resolves.
- No file under ``docs_torch/`` imports jax, flax or the JAX package.
- The parity page names every entry of the surface test's allow-lists and
  every test that pins a divergence ROADMAP keeps on purpose.
- No page states a time, rate or memory size in a section that does not
  name the card and its power limit.
"""

import ast
import re
import runpy
import types
from pathlib import Path

import pytest

import minkowskiengine_tpu_torch as MT

ROOT = Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs_torch"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PATHS = ("", "nn", "utils", "models", "MinkowskiFunctional", "parallel")


def _generator():
    return types.SimpleNamespace(**runpy.run_path(str(DOCS / "generate_api.py")))


def test_api_pages_are_current():
    assert _generator().main(["--check"]) == 0


def test_there_are_twelve_api_pages_and_five_guides():
    assert len(list((DOCS / "api").glob("*.md"))) == 12
    assert {p.name for p in DOCS.glob("*.md")} == {
        "index.md", "TUTORIAL.md", "TERMINOLOGY.md", "PARITY.md", "PERFORMANCE.md"}


def _public(module, package):
    """The API surface test's rule: public names, and the package's own
    submodules bound on the module."""
    out = {}
    for name in dir(module):
        if name.startswith("_"):
            continue
        value = getattr(module, name)
        if isinstance(value, types.ModuleType):
            if value.__name__ != f"{package}.{name}" and name != "MinkowskiFunctional":
                continue
        out[name] = value
    return out


@pytest.mark.parametrize("path", PATHS)
def test_every_public_name_is_on_an_api_page(path):
    _generator()  # imports every submodule of the package, as the pages list them
    pages = "\n".join(p.read_text() for p in (DOCS / "api").glob("*.md"))
    mod = MT
    for part in filter(None, path.split(".")):
        mod = getattr(mod, part)
    missing = []
    for name, obj in _public(mod, mod.__name__ if path else "minkowskiengine_tpu_torch").items():
        where = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(obj, "__module__", "")
        if not (where or "").startswith("minkowskiengine_tpu_torch"):
            continue
        labels = [f"{path}.{name}"] if path else []
        labels.append(name)
        if not any(re.search(r"`(module `)?" + re.escape(label) + r"[`(]", pages) for label in labels):
            missing.append(name)
    assert not missing, missing


_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")


def test_every_relative_link_resolves():
    broken = []
    for page in list(DOCS.glob("*.md")) + list((DOCS / "api").glob("*.md")):
        for target in _LINK.findall(page.read_text()):
            if re.match(r"[a-z]+:", target) or target.startswith("#"):
                continue
            if not (page.parent / target.split("#")[0]).exists():
                broken.append((page.name, target))
    assert not broken, broken


def test_nothing_under_docs_torch_imports_jax():
    banned = ("jax", "flax", "optax", "orbax", "minkowskiengine_tpu")
    for path in DOCS.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in banned for n in names), (path.name, names)
    for path in DOCS.rglob("*.md"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from) (jax|flax|minkowskiengine_tpu)\b(?!_torch)",
                             text, re.M), path.name


def test_parity_page_names_every_allow_listed_name_and_kept_divergence():
    parity = (DOCS / "PARITY.md").read_text()
    surface = runpy.run_path(str(ROOT / "tests" / "test_torch_api_surface.py"))
    for owner, name in {**surface["KEYWORDS_NOT_TAKEN"], **surface["ATTRIBUTES_NOT_PORTED"]}:
        assert f"`{owner}" in parity and name in parity, (owner, name)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    kept = roadmap[roadmap.index("**Kept on purpose.**"):]
    pins = set(re.findall(r"::(test_\w+)", kept))
    assert pins and not {p for p in pins if p not in parity}, sorted(p for p in pins if p not in parity)


_QUANTITY = re.compile(r"\d[\d.,]*\s*(?:–\s*[\d.,]+\s*)?(?:ms|µs|s\b|MiB|GiB|MB|GB|TB/s|GB/s|"
                       r"TFLOP/s|points/s|voxels/s)")


def test_every_measured_number_names_the_card():
    for page in DOCS.rglob("*.md"):
        sections = re.split(r"^## ", page.read_text(), flags=re.M)
        head = sections[0]
        for section in sections[1:]:
            if _QUANTITY.search(section):
                assert CARD in " ".join(section.split()) or CARD in " ".join(head.split()), (
                    page.name, section.splitlines()[0], _QUANTITY.search(section).group())
