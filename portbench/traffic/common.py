"""What the traffic kinds share: seeded draws, the cheap host transforms
that make every step's coordinates fresh, and the training comparison.

A step's draws come from ``rng(seed, stream, index)``, so the inputs of
any step can be made again from the seed alone: the reference rebuilds
the first steps' batches after the window without keeping them.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .. import yardstick as Y

# the 8 flips and quarter-turns about z, as (swap x and y, sign of x, sign of y)
D4 = [(s, a, b) for s in (False, True) for a in (1, -1) for b in (1, -1)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *stream])


def turn_xy(xyz: np.ndarray, which: int, centre=0.0) -> np.ndarray:
    """One of ``D4`` applied to the x and y columns about ``centre``."""
    swap, sx, sy = D4[which]
    out = xyz.copy()
    x, y = xyz[:, 0] - centre, xyz[:, 1] - centre
    if swap:
        x, y = y, x
    out[:, 0] = sx * x + centre
    out[:, 1] = sy * y + centre
    return out


def leaf_norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def training_gaps(prog: dict, ref: dict, lr: float, p0: dict) -> dict:
    """The comparison of a training cell's first three steps.

    ``prog`` and ``ref`` each hold ``losses`` (three floats), ``p1`` and
    ``p3`` (the parameters after steps 1 and 3, on the host).  The first
    gradient as the optimizer got it is ``(p0 - p1) / lr`` on both sides.
    The change after three steps leaves out the leaves whose reference
    gradient is under a thousandth of the median leaf's: they move by
    round-off alone.  Each is read at the worst leaf and at the median leaf
    (``PERF.md`` says which a cell compares).
    """
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_prog = leaf_norms({n: (p0[n] - prog["p1"][n]) / lr for n in p0})
    g_ref = leaf_norms({n: (p0[n] - ref["p1"][n]) / lr for n in p0})
    floor = float(np.median(list(g_ref.values())))
    moving = {n for n, v in g_ref.items() if v >= 1e-3 * floor}
    d_prog = leaf_norms({n: prog["p3"][n] - p0[n] for n in p0})
    d_ref = leaf_norms({n: ref["p3"][n] - p0[n] for n in p0})
    return {
        "loss_gap": loss_gap,
        "grad_gap": Y.worst_leaf_gap(g_prog, g_ref),
        "grad_median_gap": Y.median_leaf_gap(g_prog, g_ref),
        "delta_gap": Y.worst_leaf_gap(d_prog, d_ref, keep=moving),
        "delta_median_gap": Y.median_leaf_gap(d_prog, d_ref, keep=moving),
    }


def host_params(named) -> dict:
    return {n: p.detach().to("cpu", copy=True) for n, p in named}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_module(cfg):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def load_weights(model, weights):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def segmentation_model(mt, cfg, device, weights):
    """The configuration's MinkUNet, checked against its widths, holding ``weights``."""
    model = getattr(mt.models, cfg["model"])(cfg["in_channels"], cfg["out_channels"], D=cfg["D"],
                                             device=device)
    if tuple(model.PLANES) != tuple(cfg["planes"]) or tuple(model.LAYERS) != tuple(cfg["layers"]):
        raise ValueError(f"{cfg['model']} does not have the configuration's widths")
    return load_weights(model, weights)


def aligned_gap(ours, theirs):
    """The largest |Δ| of two row-wise results over the largest of
    ``theirs``, rows matched by coordinates: ``ours`` and ``theirs`` are
    (coordinates (N, 4), values (N, ...)).  Rows either side lacks make it
    infinite."""
    from ..reference import plain as P

    (c_ours, v_ours), (c_theirs, v_theirs) = ours, theirs
    keys = P.pack(c_ours)
    order = torch.argsort(keys)
    rows = P.lookup(keys[order], P.pack(c_theirs))
    if len(c_ours) != len(c_theirs) or bool((rows < 0).any()):
        return float("inf")
    v = v_ours[order][rows]
    return float((v.double() - v_theirs.double()).abs().max() / v_theirs.double().abs().max())
