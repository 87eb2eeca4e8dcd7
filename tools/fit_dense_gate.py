#!/usr/bin/env python3
"""Fit the dense-grid gate's cost model to several ``chip_smoke.py`` logs.

    python3 tools/fit_dense_gate.py run1.txt run2.txt ...

Each argument is the standard output of one ``chip_smoke.py`` run on the
card.  From each log's phase 41 it takes the route's and K1/K2's times of
every stride-1 MinkUNet34 conv (41b: forward, input gradient and weight
gradient, CUDA events) and every kernel map's build through the row grids
(41a), pools them over the logs, fits the cost model of
``minkowskiengine_tpu_torch/ops/dense_conv.py`` as phase 41c fits one run
(``chip_smoke.fit_gate``: least squares on relative residuals, coefficients
>= 0), and prints the constants and each conv's decision, its kernel map
cached or not.  Runs on the CPU.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

ROW = re.compile(
    r"^\s+(\S+) K=(\d+)\s+(\d+)->(\d+)\s+ts\s+(\d+):\s+(\d+) rows,\s+([\d,]+) cells "
    r"\(([\d,]+) pairs\); (.*)$"
)
PART = re.compile(r"\b(fwd|dx|dw) ([\d.]+) / ([\d.]+) ")
BUILD = re.compile(r"K=(\d+)\s+rows\s+(\d+): ([\d.]+) / ([\d.]+) ms")


def phase41(text: str):
    """(41b rows as ``chip_smoke.fit_gate`` takes them, 41a builds)."""
    section = text[text.index("[41a grid probe]"):text.index("[41c gate]")]
    rows, builds = [], []
    for line in section.splitlines():
        m = ROW.match(line)
        if m:
            name, K, cin, cout, ts, n, cells, pairs, parts = m.groups()
            times = {p: (float(a), float(b)) for p, a, b in PART.findall(parts)}
            rows.append(dict(
                label=name, K=int(K), cin=int(cin), cout=int(cout), ts=int(ts), rows=int(n),
                cells=int(cells.replace(",", "")), pairs=int(pairs.replace(",", "")),
                route={p: dict(ms=t[0]) for p, t in times.items()},
                k1k2={p: dict(ms=t[1]) for p, t in times.items()},
            ))
            continue
        m = BUILD.search(line)
        if m:
            builds.append((int(m.group(1)), int(m.group(2)), float(m.group(3))))
    return rows, builds


def main(argv) -> int:
    rows, builds = [], []
    for path in argv:
        r, b = phase41(Path(path).read_text())
        rows += r
        builds += b
    fit = chip_smoke.fit_gate(rows, builds)
    print(f"{len(rows)} conv measurements and {len(builds)} kernel-map builds from {len(argv)} logs")
    for k, v in fit.items():
        print(f"{k} = {v:.4g}")
    dc = chip_smoke.DC
    for k, v in fit.items():
        setattr(dc, k, v)
    for r in rows[: len(rows) // len(argv)]:
        plan = dc.DensePlan(None, (1, 1, 1, r["cells"]))  # the model reads D and the cells
        picks = ["dense" if dc.dense_conv_beneficial(
            plan, r["rows"], r["K"], r["cin"], r["cout"], map_cached=cached) else "sparse"
            for cached in (True, False)]
        print(f"{r['label']:>8} {r['cin']:>3}->{r['cout']:<3} ts {r['ts']:>2}: {picks[0]} with the "
              f"map cached, {picks[1]} without")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
