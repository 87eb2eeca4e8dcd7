"""Where the kernel library is built: ``build/kernels`` in a source
checkout, the user's cache for an installed package.  Nothing here runs
``nvcc``."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRINT_BUILD_DIR = "from minkowskiengine_tpu_torch.kernels import build; print(build.BUILD_DIR)"


def _build_dir(cwd, **env):
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, **env}
    proc = subprocess.run(
        [sys.executable, "-c", PRINT_BUILD_DIR], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    return Path(proc.stdout.strip())


def test_source_checkout_builds_under_build():
    assert _build_dir(ROOT) == ROOT / "build" / "kernels"


def test_installed_package_builds_in_user_cache(tmp_path):
    site = tmp_path / "site"
    shutil.copytree(
        ROOT / "minkowskiengine_tpu_torch", site / "minkowskiengine_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    cache = tmp_path / "cache"
    got = _build_dir(site, XDG_CACHE_HOME=str(cache))
    assert got == cache / "minkowskiengine_tpu_torch" / "kernels"
