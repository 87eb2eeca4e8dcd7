#!/usr/bin/env python3
"""Per distinct conv of a training step, from ``chip_smoke.py`` logs.

    python3 tools/compare_step_convs.py parent=run1.txt change=run2.txt ...

Each argument is a label and the standard output of one ``chip_smoke.py``
run.  From each log's phase 8 (the 55 conv calls of one training step, on
the step's real maps) it takes the kernel and plain times of K1 forward
(``fwd``), K1 input gradient (``dx``) and K2 weight gradient (``dw``), and
prints one markdown row per distinct conv (K, Cin->Cout, rows in->out) with
the mean ms per call as ``kernel / plain`` for every log, then the sums
over the step.  Runs of two commits are comparable only from one call on
one card, taken in turns (parent, change, change, parent).
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict

CALL = re.compile(r"call(\d+) K=(\d+)\s+(\d+)->(\d+)\s+rows\s+(\d+)->(\d+)")
PART = re.compile(r"\b(fwd|dx|dw) ([\d.]+)/([\d.]+) ms")
PARTS = ("fwd", "dx", "dw")


def step_calls(text: str) -> list[tuple[tuple[int, ...], dict[str, tuple[float, float]]]]:
    """Phase 8's rows: ((K, Cin, Cout, rows in, rows out), {part: (kernel ms, plain ms)})."""
    start = text.index("[8 backward kernels")
    end = text.index("sum over one step", start)
    calls = []
    for line in text[start:end].splitlines():
        m = CALL.search(line)
        if m:
            parts = {p: (float(k), float(pl)) for p, k, pl in PART.findall(line)}
            calls.append((tuple(int(v) for v in m.groups()[1:]), parts))
    return calls


def table(runs: dict[str, str]) -> str:
    labels = list(runs)
    by_conv: dict[tuple[int, ...], dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for label, text in runs.items():
        for conv, parts in step_calls(text):
            by_conv[conv][label].append(parts)
    head = "| K | Cin→Cout | rows in→out | calls | " + " | ".join(
        f"{p} {label}" for p in PARTS for label in labels
    ) + " |"
    lines = [head, "|" + " --- |" * (4 + len(PARTS) * len(labels))]
    sums = {(p, label): [0.0, 0.0] for p in PARTS for label in labels}
    for conv, per_label in by_conv.items():
        k, cin, cout, n_in, n_out = conv
        cells = []
        for p in PARTS:
            for label in labels:
                got = [c[p] for c in per_label[label] if p in c]
                if not got:
                    cells.append("—")
                    continue
                kern = sum(g[0] for g in got) / len(got)
                plain = sum(g[1] for g in got) / len(got)
                sums[p, label][0] += sum(g[0] for g in got)
                sums[p, label][1] += sum(g[1] for g in got)
                cells.append(f"{kern:.4f} / {plain:.4f}")
        calls = len(per_label[labels[0]])
        lines.append(f"| {k} | {cin}→{cout} | {n_in}→{n_out} | {calls} | " + " | ".join(cells) + " |")
    lines.append("| sum | | | | " + " | ".join(
        f"{sums[p, label][0]:.3f} / {sums[p, label][1]:.3f}" for p in PARTS for label in labels
    ) + " |")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    if not argv or any("=" not in a for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    runs = {}
    for arg in argv:
        label, path = arg.split("=", 1)
        with open(path) as f:
            runs[label] = f.read()
    print(table(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
