#!/usr/bin/env python3
"""Device-only times of the bf16 K1 and K2 calls of one MinkUNet34 and one
MinkowskiFCNN training step, as a checkout's own wrappers launch them.

    python3 tools/bf16_step_times.py [--tree DIR] [--out FILE]

``--tree`` names the root of the checkout whose ``minkowskiengine_tpu_torch``
is timed (default: this one); its kernels build into its own
``build/kernels``.  Run it once on an older commit's checkout and once on
this one, in one session on one card, to compare two commits' kernels on
the same maps.  The maps, weights and timer are this checkout's
``chip_smoke.py`` (``step_inputs``, ``bf16_step_calls``, ``device_ms``),
so the older package needs only the public wrappers.  Prints, per call
and part (forward, input gradient, weight gradient), the device-only ms and
the wrapper's host µs per call with the plan the wrapper chose, then the
per-step sums; ``--out`` writes the same as JSON.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=REPO, help="checkout whose package is timed")
    ap.add_argument("--out", type=Path, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))  # the package to time comes first
    import torch

    # this checkout's chip_smoke.py, whatever the tree holds
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("bf16_step_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    package = Path(cs.MT.__file__).resolve().parent
    print(f"{smi}; package {package}")
    cs.build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for net, calls in cs.bf16_step_calls(dev, cs.step_inputs(dev)).items():
        for x, w, g, in_idx, out_idx_t, label, with_dx in calls:
            row = dict(net=net, label=label, K=w.shape[0], cin=w.shape[1], cout=w.shape[2],
                       n_in=x.shape[0], n_out=g.shape[0])
            for p, (kernel, _, kargs, _, _, bound_ms, _) in cs.kernel_parts(
                    x, w, g, in_idx, out_idx_t, with_dx).items():
                ms, host_us = cs.device_ms(lambda: kernel(*kargs))
                row[p] = dict(ms=ms, host_us=host_us, bound_ms=bound_ms,
                              plan=repr(kernel.last_plan))
            print(f"  {net} {row['label']:>7} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<4} "
                  f"rows {row['n_in']:>5}->{row['n_out']:<5} " + "  ".join(
                      f"{p} {row[p]['ms']:.4f} ms host {row[p]['host_us']:.1f} us {row[p]['plan']}"
                      for p, _ in cs.PARTS if p in row))
            rows.append(row)
    for net in dict.fromkeys(r["net"] for r in rows):
        for p, name in cs.PARTS:
            got = [r[p] for r in rows if r["net"] == net and p in r]
            print(f"{net}, sum over one step, {name}: {sum(q['ms'] for q in got):.3f} ms device, "
                  f"{sum(q['host_us'] for q in got) / 1e3:.3f} ms host, bound "
                  f"{sum(q['bound_ms'] for q in got):.4f} ms")
    if args.out:
        args.out.write_text(json.dumps(dict(device=smi, package=str(package), rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
