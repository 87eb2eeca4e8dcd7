"""Scene segmentation requests, as upstream ``examples/indoor.py`` serves
them: host points and colours in, a ``TensorField`` at ``voxel_size``
with UNWEIGHTED_AVERAGE quantization, ``sparse()``, the model in eval
mode, ``slice()`` back onto the points, per-point logits on the host.
A closed loop: one request after another.

Traffic parameters: ``pool`` rooms of ``n_points`` points (``extent``
metres, ``n_objects`` boxes, colours by height and position) from seeds
``pool_seed + i``; the run's seed orders the rooms and draws per request
one of the 8 flips and quarter-turns about z and a shift of up to
``shift`` metres on each axis, made before the request's clock starts.
Batch norm takes the statistics of one train-mode pass over the first
room, as a trained network carries them (``indoor.py``'s ``calibrate``).
The comparison takes ``sample`` requests of the window, drawn from the
seed (a reservoir), and the reference's logits of the same points.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import common as C
from . import data


class Traffic:
    role = "infer"

    def __init__(self, cell, seed, device, tracer):
        self.cell, self.cfg, self.t = cell, cell["config"], cell["traffic"]
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.fault = None  # a fault planted by ``tests/test_portbench_faults.py``
        self.transform_s = 0.0
        self.pool = []
        for i in range(self.t["pool"]):
            pts = data.make_room_scan(n_points=self.t["n_points"], extent=tuple(self.t["extent"]),
                                      n_objects=self.t["n_objects"], seed=self.t["pool_seed"] + i)
            self.pool.append((pts, data.normalize_color(data.room_colors(pts))))
        self.order = C.rng(seed, 0).permutation(len(self.pool))

    def inputs(self, index):
        """(field coordinates (N, 4) float32 in voxels, colours) of request
        ``index``; -1 is the calibration room, untransformed."""
        if index < 0:
            pts, colors = self.pool[0]
        else:
            pts, colors = self.pool[int(self.order[index % len(self.order)])]
            draw = C.rng(self.seed, 1, index)
            pts = C.turn_xy(pts, int(draw.integers(8)))
            pts = pts + draw.uniform(-self.t["shift"], self.t["shift"], size=3).astype(np.float32)
        coords = np.empty((len(pts), 4), np.float32)
        coords[:, 0] = 0
        coords[:, 1:] = pts / np.float32(self.t["voxel_size"])
        return coords, colors

    # -- the program ------------------------------------------------------
    def setup(self, mt, weights, warmup):
        cfg, dev = self.cfg, self.device
        model = C.segmentation_model(mt, cfg, dev, weights)
        self.mt, self.model = mt, model
        bns = [m.bn for m in model.modules() if isinstance(m, mt.MinkowskiBatchNorm)]
        model.train()
        for bn in bns:
            bn.momentum = 1.0
        with torch.no_grad():
            self._request(*self.inputs(-1))
        for bn in bns:
            bn.momentum = 0.1
        model.eval()
        self.index, self.kept, self.seen = 0, [], 0
        for _ in range(warmup):
            self.step()
        self.index, self.kept, self.seen, self.draw = 0, [], 0, C.rng(self.seed, 2)
        self.transform_s = 0.0

    def _request(self, coords, colors):
        tr, dev, mt = self.tracer, self.device, self.mt
        with tr.span("load"):
            c = torch.from_numpy(coords).to(dev)
            f = torch.from_numpy(colors).to(dev)
        with tr.span("sparse_tensor"):
            field = mt.TensorField(
                features=f, coordinates=c, device=dev,
                quantization_mode=mt.SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE,
            )
            x = field.sparse()
        with tr.span("forward"):
            out = self.model(x)
        with tr.span("slice"):
            logits = out.slice(field).features
        with tr.span("to_host"):
            return logits.cpu()

    def step(self):
        """One request; returns its latency in seconds, host arrays in to
        logits on the host."""
        t0 = time.perf_counter()
        coords, colors = self.inputs(self.index)
        self.transform_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._request(coords, colors)
        latency = time.perf_counter() - t0
        if self.fault == "altered":
            logits[0, 0] += 1.0
        self._keep(self.index, logits)
        self.index += 1
        return latency

    def _keep(self, index, logits):
        """A reservoir of ``sample`` requests, drawn from the seed."""
        k = self.t["sample"]
        if len(self.kept) < k:
            self.kept.append((index, logits))
        else:
            j = int(self.draw.integers(self.seen + 1))
            if j < k:
                self.kept[j] = (index, logits)
        self.seen += 1

    def release(self):
        self.record = {"requests": self.kept}
        self.model = None

    # -- the comparison ---------------------------------------------------
    def reference(self, weights, precision="float32", fault=None, indices=None):
        """The reference's logits for the sampled requests (or ``indices``)."""
        from ..reference import plain as P

        R = C.reference_module(self.cfg)
        cfg, dev = self.cfg, self.device
        state = dict({n: t.detach().clone() for n, t in weights.items()}, **R.buffers(cfg, dev))
        if indices is None:
            indices = [i for i, _ in self.record["requests"]]

        def logits_of(index, training, momentum=0.1):
            coords, colors = (torch.from_numpy(a).to(dev) for a in self.inputs(index))
            vox = torch.floor(coords).to(torch.int32)
            u, _, inv = P.unique(vox)
            count = torch.zeros(len(u), device=dev).index_add_(0, inv, torch.ones(len(inv), device=dev))
            feats = torch.zeros((len(u), colors.shape[1]), device=dev).index_add_(0, inv, colors)
            feats = feats / count[:, None]
            out, _ = R.forward(cfg, state, u, feats, training, precision, bn_momentum=momentum)
            return out[inv]

        out = []
        with torch.no_grad():
            logits_of(-1, True, momentum=1.0)
            for i in indices:
                lg = logits_of(i, False).cpu()
                if fault == "altered":
                    lg[0, 0] += 1.0
                out.append((i, lg))
        return {"requests": out}

    def compare(self, prog, ref, weights):
        gap = 0.0
        for (i, a), (j, b) in zip(prog["requests"], ref["requests"]):
            if i != j:
                raise ValueError("compared requests differ")
            gap = max(gap, float((a - b).abs().max() / b.abs().max()))
        return {"logit_gap": gap}
