"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Loads, warms up, measures for ``--seconds``, compares what the
timed path produced with the plain reference, and prints the comparison's
numbers beside their limits as the last lines of standard error, then one
JSON line as the last line of standard output.  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  Exits 1 without a result where no card or too few
cards are visible, and 3 where the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench-cache"
# the program's build and kernel caches, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def host_threads(workload):
    """The cell's ``host_threads``, or None for PyTorch's own count."""
    path = ROOT / "portbench" / "workloads" / f"{workload}.json"
    return json.loads(path.read_text()).get("host_threads") if path.is_file() else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    threads = host_threads(args.workload)
    if threads:  # before torch starts its OpenMP pool
        os.environ["OMP_NUM_THREADS"] = str(threads)
    import torch

    if threads:
        torch.set_num_threads(threads)
    print(f"host threads {torch.get_num_threads()}", file=sys.stderr)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import minkowskiengine_tpu_torch as mt

    result, checks, _ = harness.run_cell(
        cell, args.seed, args.seconds, args.trace, "cuda:0", T_START, harness.benchmark(), mt,
    )
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the benchmark forbids: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
