"""Point Transformer V3 segmentation training on cropped 2 cm rooms: one
closed loop of SGD steps, each a fresh ``SparseTensor``, the forward with
the step's order lists, cross-entropy, the backward and the optimizer
step, ending in a sync.

Traffic parameters (the cell's ``traffic``): ``pool`` rooms of
``n_points`` points (``extent`` metres, ``n_objects`` boxes) made from
seeds ``pool_seed + i`` and voxelized at ``voxel_size``; batches of
``batch`` rooms, fixed as consecutive rooms of the pool, which the run's
seed orders.  Per step the seed draws one of the 8 flips and
quarter-turns about z (the same for the step's rooms), each room's crop
centre, and one permutation of the four curves per level of the model.
A turned room's grid is taken relative to its minimum, as Pointcept's
``GridSample`` makes it, then cropped to the ``crop`` voxels nearest the
centre voxel (squared grid distance, ties by row), as ``SphereCrop(
point_max, mode="random")``; a room with fewer voxels is kept whole.
Features are a frozen normal draw (``in_channels`` of the configuration);
labels are the height band of each voxel's centre.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import common as C
from . import data
from .seg_train import _alter_row

LEVELS_SEED_STREAM = 2


class Traffic:
    role = "train"
    FIRST_STEPS = 3

    def __init__(self, cell, seed, device, tracer):
        self.cell, self.cfg, self.t = cell, cell["config"], cell["traffic"]
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.batch = self.t["batch"]
        self.lr = self.cfg["train"]["lr"]
        self.fault = None  # a fault planted by the benchmark's tests and ``control.py``
        self.transform_s = 0.0  # host seconds in ``inputs`` during the window
        self.pool = [self._room(self.t["pool_seed"] + i) for i in range(self.t["pool"])]
        self.order = C.rng(seed, 0).permutation(self.t["pool"] // self.batch)

    # -- the traffic ------------------------------------------------------
    def _room(self, room_seed):
        pts = data.make_room_scan(
            n_points=self.t["n_points"], extent=tuple(self.t["extent"]),
            n_objects=self.t["n_objects"], seed=room_seed,
        )
        vs = self.t["voxel_size"]
        vox = np.unique(np.floor(pts / vs).astype(np.int32), axis=0)
        feats = np.random.RandomState(room_seed + 1).randn(
            len(vox), self.cfg["in_channels"]).astype(np.float32)
        labels = data.height_band((vox[:, 2] + 0.5) * vs)
        corners = np.stack([vox.min(0), vox.max(0)])
        return vox, feats, labels, vox.T.astype(np.int64), corners

    def inputs(self, index):
        """(coordinates (N, 4) int32, features, labels, order lists) of step ``index``."""
        b = int(self.order[index % len(self.order)])
        draw = C.rng(self.seed, 1, index)
        turn = int(draw.integers(8))
        coords, feats, labels = [], [], []
        for j in range(self.batch):
            vox, f, lab, columns, corners = self.pool[b * self.batch + j]
            # a flip or quarter-turn keeps distances: crop first, turn the kept rows
            keep = _crop(columns, int(draw.integers(len(vox))), self.t["crop"])
            xyz = C.turn_xy(vox[keep], turn)
            xyz -= C.turn_xy(corners, turn).min(0)  # the turned room's minimum
            coords.append(np.concatenate([np.full((len(keep), 1), j, np.int32), xyz], 1))
            feats.append(f[keep])
            labels.append(lab[keep])
        levels = C.rng(self.seed, LEVELS_SEED_STREAM, index)
        orders = [levels.permutation(4).tolist() for _ in self.cfg["enc_depths"]]
        return np.concatenate(coords), np.concatenate(feats), np.concatenate(labels), orders

    def samples(self):
        return self.batch

    # -- the program ------------------------------------------------------
    def setup(self, mt, weights, warmup):
        cfg, dev = self.cfg, self.device
        model = getattr(mt.models, cfg["model"])(
            cfg["in_channels"], cfg["out_channels"], D=cfg["D"],
            enc_depths=cfg["enc_depths"], enc_channels=cfg["enc_channels"],
            enc_num_head=cfg["enc_num_head"], dec_depths=cfg["dec_depths"],
            dec_channels=cfg["dec_channels"], dec_num_head=cfg["dec_num_head"],
            patch_size=cfg["patch_size"], mlp_ratio=cfg["mlp_ratio"], device=dev,
        )
        self.mt, self.model = mt, C.load_weights(model, weights).train()
        self.opt = torch.optim.SGD(model.parameters(), lr=self.lr)
        self.index = 0
        self.record = {"losses": []}
        for i in range(self.FIRST_STEPS):
            loss, logits = self.step(keep_logits=True)
            self.record["losses"].append(float(loss))
            if i == 0:
                self.record["p1"] = C.host_params(model.named_parameters())
                self.record["logits"] = logits
        self.record["p3"] = C.host_params(model.named_parameters())
        for _ in range(warmup):
            self.step()
        self.transform_s = 0.0

    def step(self, keep_logits=False):
        """One training step; returns its loss (a device scalar), and with
        ``keep_logits`` the coordinates and logits the loss took, on the host."""
        tr, dev = self.tracer, self.device
        with tr.span("load"):
            t0 = time.perf_counter()
            coords, feats, labels, orders = self.inputs(self.index)
            self.transform_s += time.perf_counter() - t0
            coords = torch.from_numpy(coords).to(dev)
            feats = torch.from_numpy(feats).to(dev)
            labels = torch.from_numpy(labels).to(dev)
        self.index += 1
        with tr.span("sparse_tensor"):
            x = self.mt.SparseTensor(feats, coords, device=dev)
        with tr.span("forward"):
            out = self.model(x, orders).F
        with tr.span("loss"):
            rows = x.unique_index.to(dev).long()
            if self.fault == "altered":
                out = _alter_row(out)
            kept = (x.C.cpu(), out.detach().cpu()) if keep_logits else None
            if self.fault == "half_batch":
                keep = x.C[:, 0].to(dev) < self.batch // 2
                out, rows = out[keep], rows[keep]
            loss = torch.nn.functional.cross_entropy(out, labels.index_select(0, rows))
        with tr.span("optimizer"):
            self.opt.zero_grad()
        with tr.span("backward"):
            loss.backward()
        with tr.span("optimizer"):
            if self.fault != "unchanged":
                self.opt.step()
        C.sync(dev)
        return (loss.detach(), kept) if keep_logits else loss.detach()

    def release(self):
        self.model = self.opt = None

    # -- the comparison ---------------------------------------------------
    def reference(self, weights, precision="float32", fault=None):
        """The reference's first three steps from the same weights and
        inputs: (losses, p1, p3, step-1 logits) on the host."""
        from ..reference import plain as P

        R = C.reference_module(self.cfg)
        cfg, dev = self.cfg, self.device
        p = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
        state = dict(p, **R.buffers(cfg, dev))
        opt = torch.optim.SGD(list(p.values()), lr=self.lr)
        rec = {"losses": []}
        for i in range(self.FIRST_STEPS):
            coords, feats, labels, orders = self.inputs(i)
            coords, feats, labels = (torch.from_numpy(a).to(dev) for a in (coords, feats, labels))
            logits, base = R.forward(cfg, state, coords, feats, orders, True, precision)
            inv = P.unique(coords)[2]
            if fault == "altered":
                logits = _alter_row(logits)
            if i == 0:
                rec["logits"] = (base.cpu(), logits.detach().cpu())
            rows = torch.arange(len(labels), device=dev)
            if fault == "half_batch":
                rows = rows[coords[:, 0] < self.batch // 2]
            loss = torch.nn.functional.cross_entropy(logits.index_select(0, inv[rows]), labels[rows])
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
        gaps["logit_gap"] = C.aligned_gap(prog["logits"], ref["logits"])
        return gaps


def _crop(columns, centre, keep):
    """The rows of the ``keep`` voxels nearest voxel ``centre`` (squared
    grid distance, ties by row), in row order, of a room given as its x, y
    and z columns; all rows where there are no more."""
    n = columns.shape[1]
    if n <= keep:
        return np.arange(n)
    d = np.zeros(n, np.int64)
    for c in columns:
        d += (c - c[centre]) ** 2
    rank = d * n + np.arange(n)  # unique: distance, then row
    return np.sort(np.argpartition(rank, keep - 1)[:keep])
