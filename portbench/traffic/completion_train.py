"""Shape completion training, as upstream ``examples/completion.py``
trains: the partial shapes as a ``SparseTensor``, the full shapes inserted
as the target map in the same fresh coordinate manager, the forward (the
encoder, then the generative levels with their pruning), the mean of each
level's sigmoid cross-entropy, the backward and an SGD step with momentum
and weight decay, ending in a sync.  A closed loop.

Traffic parameters: ``shapes`` shapes of the frozen ``completion_batch``
at ``resolution`` (``n_points`` points a shape) from seed ``pool_seed``:
the same shapes in every run and step.  Per step and shape the run's
seed draws one of the 8 flips and quarter-turns about z inside the grid,
and per step an integer shift in ``[-shift, shift]`` on each axis (one
for the batch, so that its bounding box stays the grid's); the input is
the turned shape's voxels below the x-centre, the crop of the upstream
example's ``make_shape``.  The weights come from the cell's
``weight_seed``, not from the run's seed: at random weights the pruning
keeps about the rows whose logit is above 0, so the weights set how many
rows every level has, and with them the work, and every seed has to do
the same work.

The comparison holds the reference to the program's keep mask per level
(``reference/completionnet.py`` says why); it reads how far from 0 the
logits lay where the two decided otherwise, and counts rows that either
side's levels lack.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import common as C
from . import data


class Traffic:
    role = "train"
    FIRST_STEPS = 3

    def __init__(self, cell, seed, device, tracer):
        self.cell, self.cfg, self.t = cell, cell["config"], cell["traffic"]
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        tr = self.cfg["train"]
        self.lr, self.momentum, self.wd = tr["lr"], tr["momentum"], tr["weight_decay"]
        self.fault = None  # a fault planted by ``tests/test_portbench_faults.py``
        self.transform_s = 0.0  # host seconds in ``inputs`` during the window
        _, _, full = data.completion_batch(self.t["shapes"], self.t["resolution"],
                                           seed=self.t["pool_seed"], n_points=self.t["n_points"])
        self.shapes = [full[full[:, 0] == b, 1:] for b in range(self.t["shapes"])]

    def inputs(self, index):
        """(partial (N, 4) int32, ones features, full (M, 4) int32) of step ``index``."""
        res = self.t["resolution"]
        draw = C.rng(self.seed, 1, index)
        shift = draw.integers(-self.t["shift"], self.t["shift"] + 1, size=3).astype(np.int32)
        partial, full = [], []
        for b, vox in enumerate(self.shapes):
            xyz = C.turn_xy(vox.astype(np.float64), int(draw.integers(8)), (res - 1) / 2)
            xyz = xyz.astype(np.int32)
            cut = xyz[:, 0] < res / 2
            xyz = xyz + shift
            rows = np.concatenate([np.full((len(xyz), 1), b, np.int32), xyz], 1)
            full.append(rows)
            partial.append(rows[cut])
        partial = np.concatenate(partial)
        return partial, np.ones((len(partial), 1), np.float32), np.concatenate(full)

    def samples(self):
        return self.t["shapes"]

    # -- the program ------------------------------------------------------
    def setup(self, mt, weights, warmup):
        cfg, dev = self.cfg, self.device
        model = getattr(mt.models, cfg["model"])(
            resolution=self.t["resolution"], in_nchannel=cfg["in_nchannel"],
            enc_channels=cfg["enc_channels"], dec_channels=cfg["dec_channels"], device=dev,
        )
        self.mt, self.model = mt, C.load_weights(model, weights).train()
        self.opt = torch.optim.SGD(model.parameters(), lr=self.lr, momentum=self.momentum,
                                   weight_decay=self.wd)
        self.index = 0
        self.record = {"losses": [], "levels": []}
        for i in range(self.FIRST_STEPS):
            loss, levels = self.step(keep_levels=True)
            self.record["losses"].append(float(loss))
            self.record["levels"].append(levels)
            if i == 0:
                self.record["p1"] = C.host_params(model.named_parameters())
        self.record["p3"] = C.host_params(model.named_parameters())
        for _ in range(warmup):
            self.step()
        self.transform_s = 0.0

    def step(self, keep_levels=False):
        """One training step; returns its loss (a device scalar), and with
        ``keep_levels`` each level's coordinates and keep mask on the host."""
        tr, dev, mt = self.tracer, self.device, self.mt
        with tr.span("load"):
            t0 = time.perf_counter()
            arrays = self.inputs(self.index)
            self.transform_s += time.perf_counter() - t0
            partial, feats, full = (torch.from_numpy(a).to(dev) for a in arrays)
        self.index += 1
        with tr.span("sparse_tensor"):
            mgr = mt.CoordinateManager(D=3, device=dev)
            x = mt.SparseTensor(feats, partial, coordinate_manager=mgr)
            target_key, _ = mgr.insert_and_map(full, 1)
        with tr.span("forward"):
            out_cls, targets, _ = self.model(x, target_key)
        with tr.span("loss"):
            logits = [c.F[:, 0] for c in out_cls]
            if self.fault == "altered":
                logits[-1] = _alter_row(logits[-1])
            level_logits, level_targets = logits, targets
            if self.fault == "half_batch":
                halves = [c.C[:, 0].to(dev) < self.t["shapes"] // 2 for c in out_cls]
                logits = [lg[h] for lg, h in zip(logits, halves)]
                targets = [t[h] for t, h in zip(targets, halves)]
            loss = sum(
                torch.nn.functional.binary_cross_entropy_with_logits(lg, t.to(lg.dtype))
                for lg, t in zip(logits, targets)
            ) / len(logits)
        with tr.span("optimizer"):
            self.opt.zero_grad()
        with tr.span("backward"):
            loss.backward()
        with tr.span("optimizer"):
            if self.fault != "unchanged":
                self.opt.step()
        C.sync(dev)
        if not keep_levels:
            return loss.detach()
        levels = [(c.C.cpu(), ((c.F[:, 0] > 0) | t).cpu(), lg.detach().cpu())
                  for c, t, lg in zip(out_cls, level_targets, level_logits)]
        return loss.detach(), levels

    def release(self):
        self.model = self.opt = None

    # -- the comparison ---------------------------------------------------
    def reference(self, weights, precision="float32", fault=None, held=None):
        """The reference's first three steps: (losses, p1, p3, each level's
        coordinates and keep mask) on the host, each step held to
        ``held``'s levels (default: the program's), and what the holding
        read."""
        R = C.reference_module(self.cfg)
        cfg, dev = self.cfg, self.device
        if held is None:
            held = self.record["levels"]
        p = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
        state = dict(p, **R.buffers(cfg, dev))
        opt = torch.optim.SGD(list(p.values()), lr=self.lr, momentum=self.momentum,
                              weight_decay=self.wd)
        rec = {"losses": [], "levels": [], "flip_margin": 0.0, "unmatched_rows": 0}
        for i in range(self.FIRST_STEPS):
            partial, feats, full = (torch.from_numpy(a).to(dev) for a in self.inputs(i))
            levels = [lv[:2] for lv in held[i]] if held is not False else None
            out, judged = R.forward(cfg, state, partial, feats, full, True, levels, precision)
            rec["flip_margin"] = max(rec["flip_margin"], judged["flip_margin"])
            rec["unmatched_rows"] += judged["unmatched_rows"]
            if fault == "altered":
                out[-1] = (_alter_row(out[-1][0]),) + tuple(out[-1][1:])
            rec["levels"].append([(c.cpu(), k.cpu(), lg.detach().cpu()) for lg, _, c, k in out])
            if fault == "half_batch":
                halves = [c[:, 0] < self.t["shapes"] // 2 for _, _, c, _ in out]
                out = [(lg[h], t[h], c, k) for (lg, t, c, k), h in zip(out, halves)]
            loss = R.bce(out)
            opt.zero_grad()
            loss.backward()
            opt.step()
            rec["losses"].append(float(loss.detach()))
            if i == 0:
                rec["p1"] = C.host_params(p.items())
        rec["p3"] = C.host_params(p.items())
        return rec

    def compare(self, prog, ref, weights):
        p0 = {n: t.detach().cpu() for n, t in weights.items()}
        gaps = C.training_gaps(prog, ref, self.lr, p0)
        gaps["logit_gap"] = max(C.aligned_gap((c, lg), (rc, rlg)) for (c, _, lg), (rc, _, rlg)
                                in zip(prog["levels"][0], ref["levels"][0]))
        gaps["flip_margin"] = ref["flip_margin"]
        gaps["unmatched_rows"] = float(ref["unmatched_rows"])
        return gaps


def _alter_row(logits):
    """A planted fault: one row's logit raised by 100."""
    bump = torch.zeros_like(logits)
    bump[0] = 100.0
    return logits + bump
