"""Model summary (reference: MinkowskiEngine/utils/summary.py:33-47):
parameter counts and the share of exactly-zero weights per module, and the
rows of every coordinate map a sample forward touched.

Counterpart of ``minkowskiengine_tpu/utils/summary.py``.  The port's maps
hold exact row counts, so there is no capacity column.
"""

from __future__ import annotations

import torch
from torch import nn


def summary(model: nn.Module, sample_input=None, depth: int = 2) -> str:
    """Print and return a table of parameters (trainable) and buffers (batch
    norm statistics and counters), grouped by the first ``depth`` parts of
    their names, with each group's zero share.  With ``sample_input`` (a
    SparseTensor or TensorField) it also runs a forward and lists the rows of
    every coordinate map of the input's manager."""
    groups: dict = {}
    totals = {"train": 0, "other": 0}
    tensors = [(n, p, "train") for n, p in model.named_parameters()]
    tensors += [(n, b, "other") for n, b in model.named_buffers()]
    for name, t, kind in tensors:
        key = ".".join(name.split(".")[:depth]) or "(root)"
        g = groups.setdefault(key, {"train": 0, "other": 0, "zeros": 0, "size": 0})
        n = t.numel()
        g[kind] += n
        totals[kind] += n
        g["zeros"] += int((t.detach() == 0).sum())
        g["size"] += n

    lines = [f"{'module':44s} {'params':>12s} {'buffers':>10s} {'zero%':>7s}", "-" * 76]
    for key in sorted(groups):
        g = groups[key]
        zero_pct = 100.0 * g["zeros"] / max(g["size"], 1)
        lines.append(f"{key:44s} {g['train']:>12,} {g['other']:>10,} {zero_pct:>6.1f}%")
    lines.append("-" * 76)
    lines.append(f"{'total trainable params':44s} {totals['train']:>12,}")
    lines.append(f"{'total non-trainable (BN stats etc.)':44s} {totals['other']:>12,}")
    lines.append(f"{'total':44s} {totals['train'] + totals['other']:>12,}")

    if sample_input is not None:
        with torch.no_grad():
            out = model(sample_input)
        mgr = sample_input.coordinate_manager
        lines += ["", f"{'coordinate map (tensor stride, id)':44s} {'rows':>10s}", "-" * 56]
        for raw in mgr.get_keys():
            lines.append(f"{str(raw):44s} {mgr._maps[raw].size:>10,}")
        feats = out.F if hasattr(out, "F") else out
        lines.append(f"output: {feats.shape[0]:,} rows x {feats.shape[1]} ch")

    text = "\n".join(lines)
    print(text)
    return text
