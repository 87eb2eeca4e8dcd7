"""The readings that the limits of a cell's comparison are set from.

    python3 portbench/control.py --workload <cell> --seeds 12 --control-seeds 3 --out <file.json>

On the card, in one process: the program's numbers on ``--seeds`` seeds,
each one run of the cell as ``run.py`` makes it (``harness.run_cell``, with
a window of ``--seconds``: the first three steps it compares come before
the window, and an inference window needs ``sample`` requests), then on
``--control-seeds`` seeds the numbers of the control (the reference in
TF32, the precision below the configuration's float32, put in the
program's place) and of each planted fault (half of the batch left out
of the mean; one answer altered where it is produced), each judged
against the float32 reference.  A step that leaves the state unchanged
reads 1 on the gradient and change numbers by their definition and needs
no run.  Writes every reading to ``--out`` and prints, per number, the
largest program reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness, tracing  # noqa: E402

FAULTS = ("half_batch", "altered")


def control_numbers(cell, seed, variant, device):
    """The reference in TF32 (``variant == "tf32"``) or with a planted
    fault, in the program's place, judged by the float32 reference."""
    traffic = harness.traffic_class(cell["kind"])(cell, seed, device, tracing.Tracer(False))
    spec = harness.reference_module(cell["config"]).parameter_spec(cell["config"])
    weights = harness.make_weights(spec, cell["traffic"].get("weight_seed", seed), device)
    precision, fault = ("tf32", None) if variant == "tf32" else ("float32", variant)
    kw = {}
    if cell["kind"] == "seg_infer":
        kw["indices"] = list(range(cell["traffic"]["sample"]))
    if cell["kind"] == "completion_train":
        kw["held"] = False
    judged = traffic.reference(weights, precision, fault, **kw)
    if cell["kind"] == "completion_train":
        kw["held"] = judged["levels"]
    truth = traffic.reference(weights, **kw)
    return traffic.compare(judged, truth, weights)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import minkowskiengine_tpu_torch as mt

    cell = harness.load_cell(args.workload)
    device = torch.device("cuda:0")
    out = {"cell": cell["name"], "device": torch.cuda.get_device_name(0), "program": {},
           "control": {}, **{f: {} for f in FAULTS}}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        _, _, out["program"][seed] = harness.run_cell(
            cell, seed, args.seconds, 0, device, t0, harness.benchmark(), mt)
        print(f"program seed {seed} ({time.perf_counter() - t0:.1f} s): {out['program'][seed]}",
              flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 104729 + 7919 * i
        for variant in ("control",) + FAULTS:
            t0 = time.perf_counter()
            out[variant][seed] = control_numbers(
                cell, seed, "tf32" if variant == "control" else variant, device)
            print(f"{variant} seed {seed} ({time.perf_counter() - t0:.1f} s): {out[variant][seed]}",
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    kinds = ("program", "control") + FAULTS
    names = next(iter(r for k in kinds for r in out[k].values())).keys()
    for n in names:
        extreme = {k: (max if k == "program" else min)(r[n] for r in out[k].values())
                   for k in kinds if out[k]}
        print(f"reading {n}: " + "; ".join(
            f"{k} {'max' if k == 'program' else 'min'} {v!r}" for k, v in extreme.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
