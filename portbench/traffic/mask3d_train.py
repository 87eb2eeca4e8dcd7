"""Mask3D instance segmentation training on 2 cm rooms: one closed loop of
SGD steps, each a fresh ``SparseTensor`` of the step's rooms, the model
with the step's key-sample generator, the set criterion (its Hungarian
matching on the host), the backward and the optimizer step, ending in a
sync.

Traffic parameters (the cell's ``traffic``): ``pool`` rooms of
``n_points`` points (``extent`` metres, ``n_objects`` boxes) made from
seeds ``pool_seed + i`` and voxelized at ``voxel_size``; batches of
``batch`` rooms, fixed as consecutive rooms of the pool, which the run's
seed orders.  Per step the seed draws one of the 8 flips and
quarter-turns about z and an integer shift in ``[-shift, shift]`` voxels,
the same for the step's rooms, and the seed of the key samples'
generator.  A voxel's raw coordinate is its first point's, turned with it;
its features are that point's colour (``room_colors``, normalized).  Each
box is one instance: a voxel belongs to the box whose face its first point
was drawn on (the frozen generator's own draw, replayed from
``data._rects_for_room``); floor, walls and ceiling carry none.  Each box
of the pool takes a class in ``[0, num_targets - 1)`` from the run's seed.

The comparison holds the reference to the program's decisions of the
first three steps (FPS rows, key samples, attention masks, assignments)
and reports the reference's own margins to them (``reference/mask3d.py``):
the FPS rows over the three steps, the masks' and the assignments'
margins and the loss at the first, where both sides hold the same
parameters (later, float32's own drift of the parameters moves them as
much as TF32 does).
Without the program's record (``control.py``), the first reference run
decides alone and a later run is held to its decisions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import common as C
from . import data
from .seg_train import _alter_row

TURN_STREAM, CLASS_STREAM, GAUSS_STREAM, SAMPLE_STREAM = 1, 3, 4, 5
NOISE = 0.003  # ``data.make_room_scan``'s default sensor noise


def room_with_faces(n_points, extent, n_objects, seed):
    """``data.make_room_scan``'s points and, for each, the rectangle it was
    drawn on: the same draws in the same order."""
    rng = np.random.RandomState(seed)
    rects = data._rects_for_room(rng, extent, n_objects)
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects])
    choice = rng.choice(len(rects), size=n_points, p=areas / areas.sum())
    a = rng.uniform(0, 1, (n_points, 1))
    b = rng.uniform(0, 1, (n_points, 1))
    origins, us, vs = (np.stack([r[j] for r in rects])[choice] for j in range(3))
    pts = origins + a * us + b * vs
    pts = pts + rng.normal(0.0, NOISE, pts.shape)
    return pts.astype(np.float32), choice


class Traffic:
    role = "train"
    FIRST_STEPS = 3

    def __init__(self, cell, seed, device, tracer):
        import minkowskiengine_tpu_torch as mt

        self.cell, self.cfg, self.t = cell, cell["config"], cell["traffic"]
        getattr(mt.models, self.cfg["model"])  # a program without the model fails here, at once
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.batch = self.t["batch"]
        self.lr = self.cfg["train"]["lr"]
        self.fault = None  # a fault planted by the benchmark's tests and ``control.py``
        self.transform_s = 0.0  # host seconds in ``inputs`` during the window
        self.pool = [self._room(self.t["pool_seed"] + i) for i in range(self.t["pool"])]
        self.order = C.rng(seed, 0).permutation(self.t["pool"] // self.batch)
        self.classes = C.rng(seed, CLASS_STREAM).integers(
            self.cfg["num_targets"] - 1, size=(self.t["pool"], self.t["n_objects"]))
        R = C.reference_module(self.cfg)
        self.gauss = torch.from_numpy(R.gauss_b(self.cfg, C.rng(seed, GAUSS_STREAM)))

    # -- the traffic ------------------------------------------------------
    def _room(self, room_seed):
        pts, face = room_with_faces(self.t["n_points"], tuple(self.t["extent"]),
                                    self.t["n_objects"], room_seed)
        vs = self.t["voxel_size"]
        vox, first = np.unique(np.floor(pts / vs).astype(np.int32), axis=0, return_index=True)
        frac = (pts[first].astype(np.float64) / vs - vox).astype(np.float32)
        box = np.where(face[first] >= 6, (face[first] - 6) // 5, -1)  # 6 shell faces, 5 a box
        colours = data.normalize_color(data.room_colors(pts[first]))
        return vox, frac, colours, box, np.unique(box[box >= 0])

    def inputs(self, index, fault=None):
        """(coordinates (N, 4) int32, features, raw coordinates (N, 3)
        metres, each row's target or -1, each target's class and scene) of
        step ``index``; ``fault == "half_batch"`` drops the targets of the
        second half of the rooms."""
        b = int(self.order[index % len(self.order)])
        draw = C.rng(self.seed, TURN_STREAM, index)
        turn = int(draw.integers(8))
        shift = draw.integers(-self.t["shift"], self.t["shift"] + 1, size=3).astype(np.int32)
        vs = self.t["voxel_size"]
        coords, feats, raw, instance, labels, scenes = [], [], [], [], [], []
        for j in range(self.batch):
            room = b * self.batch + j
            vox, frac, colours, box, present = self.pool[room]
            xyz = C.turn_xy(vox, turn) + shift
            coords.append(np.concatenate([np.full((len(xyz), 1), j, np.int32), xyz], 1))
            feats.append(colours)
            raw.append(((xyz + C.turn_xy(frac, turn, 0.5)) * vs).astype(np.float32))
            kept = present if fault != "half_batch" or j < self.batch // 2 else present[:0]
            target = np.full(self.t["n_objects"] + 1, -1, np.int64)  # the last for no box
            target[kept] = len(labels) + np.arange(len(kept))
            instance.append(target[box])
            labels.extend(self.classes[room, kept].tolist())
            scenes.extend([j] * len(kept))
        return (np.concatenate(coords), np.concatenate(feats), np.concatenate(raw),
                np.concatenate(instance), np.asarray(labels, np.int64), scenes)

    def generator(self, index):
        """The key samples' generator of step ``index``."""
        g = torch.Generator(device=self.device)
        return g.manual_seed(int(C.rng(self.seed, SAMPLE_STREAM, index).integers(2**62)))

    def samples(self):
        return self.batch

    # -- the program ------------------------------------------------------
    def setup(self, mt, weights, warmup):
        cfg, dev = self.cfg, self.device
        model = mt.models.Mask3D(
            cfg["in_channels"], cfg["num_targets"], D=cfg["D"], out_channels=cfg["out_channels"],
            num_queries=cfg["num_queries"], hidden_dim=cfg["hidden_dim"],
            num_heads=cfg["num_heads"], dim_feedforward=cfg["dim_feedforward"],
            num_decoders=cfg["num_decoders"],
            sample_sizes=[cfg["sample_sizes"][h] for h in cfg["hlevels"]],
            gauss_scale=cfg["gauss_scale"], device=dev)
        bb = cfg["backbone"]
        if (tuple(model.backbone.PLANES) != tuple(bb["planes"])
                or tuple(model.backbone.LAYERS) != tuple(bb["layers"])):
            raise ValueError("Mask3D's backbone does not have the configuration's widths")
        self.mt, self.model = mt, C.load_weights(model, weights).train()
        with torch.no_grad():
            model.decoder.pos_enc.gauss_B.copy_(self.gauss)
        self.criterion = mt.models.SetCriterion(
            cfg["num_targets"], cfg["eos_coef"],
            cost=(cfg["cost_class"], cfg["cost_mask"], cfg["cost_dice"]),
            weights=(cfg["weight_ce"], cfg["weight_mask"], cfg["weight_dice"]), device=dev)
        for module, name in ((model.decoder, "decoder"), (self.criterion.matcher, "match")):
            module.register_forward_pre_hook(lambda m, args, name=name: self._open(m, name))
            module.register_forward_hook(lambda m, args, out: self._close(m))
        self.opt = torch.optim.SGD(model.parameters(), lr=self.lr)
        self.index = 0
        self.record = {"losses": [], "held": []}
        for i in range(self.FIRST_STEPS):
            loss, kept = self.step(keep=True)
            self.record["losses"].append(float(loss))
            self.record["held"].append(kept.pop("held"))
            if i == 0:
                self.record["p1"] = C.host_params(model.named_parameters())
                self.record.update(kept)
        self.record["p3"] = C.host_params(model.named_parameters())
        for _ in range(warmup):
            self.step()
        self.transform_s = 0.0

    def _open(self, module, name):
        """A benchmark range around the decoder's or the matcher's forward."""
        module._portbench_range = self.tracer.span(name)
        module._portbench_range.__enter__()

    def _close(self, module):
        module._portbench_range.__exit__(None, None, None)

    def step(self, keep=False):
        """One training step; returns its loss (a device scalar), and with
        ``keep`` the step's logits and decisions on the host."""
        tr, dev = self.tracer, self.device
        with tr.span("load"):
            t0 = time.perf_counter()
            coords, feats, raw, instance, labels, scenes = self.inputs(self.index, self.fault)
            self.transform_s += time.perf_counter() - t0
            coords, feats, raw, instance, labels = (
                torch.from_numpy(a).to(dev) for a in (coords, feats, raw, instance, labels))
        gen = self.generator(self.index)
        self.index += 1
        with tr.span("sparse_tensor"):
            x = self.mt.SparseTensor(feats, coords, device=dev)
            rows = x.unique_index.to(dev).long()
        with tr.span("forward"):
            out = self.model(x, raw.index_select(0, rows), gen)
        with tr.span("loss"):
            if self.fault == "altered":
                out["pred_masks"] = _alter_row(out["pred_masks"])
            targets = self.mt.models.InstanceTargets(instance.index_select(0, rows), labels, scenes)
            loss, assignments = self.criterion(out, targets)
        with tr.span("optimizer"):
            self.opt.zero_grad()
        with tr.span("backward"):
            loss.backward()
        with tr.span("optimizer"):
            if self.fault != "unchanged":
                self.opt.step()
        C.sync(dev)
        if not keep:
            return loss.detach()
        kept = {
            "logits": (x.C.cpu(), out["pred_masks"].detach().cpu()),
            "classes": out["pred_logits"].detach().cpu(),
            "held": {"fps": out["fps"].cpu(), "attn": [a.cpu() for a in out["attn_masks"]],
                     "samples": [(r.cpu(), p.cpu()) for r, p in out["samples"]],
                     "assign": assignments},
        }
        return loss.detach(), kept

    def release(self):
        self.model = self.opt = self.criterion = None

    # -- the comparison ---------------------------------------------------
    def reference(self, weights, precision="float32", fault=None):
        """The reference's first three steps from the same weights and
        inputs, held to the program's decisions where the program ran:
        (losses, p1, p3, step-1 logits, margins) on the host."""
        R = C.reference_module(self.cfg)
        cfg, dev = self.cfg, self.device
        held = getattr(self, "record", None)
        p = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
        state = dict(p, **R.buffers(cfg, dev))
        state["decoder.pos_enc.gauss_B"] = self.gauss.to(dev)
        opt = torch.optim.SGD(list(p.values()), lr=self.lr)
        rec = {"losses": [], "held": [], "fps_mismatch": 0}
        for i in range(self.FIRST_STEPS):
            coords, feats, raw, instance, labels, scenes = self.inputs(i, fault)
            coords, feats, raw, instance, labels = (
                torch.from_numpy(a).to(dev) for a in (coords, feats, raw, instance, labels))
            step_held = held["held"][i] if held else None
            out = R.forward(cfg, state, coords, feats, raw, step_held, self.generator(i),
                            precision)
            if fault == "altered":
                classes, masks = out["predictions"][-1]
                out["predictions"][-1] = (classes, _alter_row(masks))
            loss, taken, margin = R.criterion(cfg, out, instance, labels, scenes,
                                              step_held["assign"] if step_held else None,
                                              precision)
            opt.zero_grad()
            loss.backward()
            opt.step()
            rec["losses"].append(float(loss.detach()))
            rec["fps_mismatch"] += out["fps_mismatch"]
            d = out["decisions"]
            rec["held"].append({"fps": d["fps"].cpu(), "attn": [a.cpu() for a in d["attn"]],
                                "samples": [(r.cpu(), q.cpu()) for r, q in d["samples"]],
                                "assign": taken})
            if i == 0:  # where both sides hold the same parameters
                rec["attn_flip_margin"], rec["match_margin"] = out["attn_flip_margin"], margin
                rec["p1"] = C.host_params(p.items())
                classes, masks = out["predictions"][-1]
                rec["logits"] = (out["coords"].cpu(), masks.detach().cpu())
                rec["classes"] = classes.detach().cpu()
            del out, loss
        rec["p3"] = C.host_params(p.items())
        if held is None:
            self.record = rec
        return rec

    def compare(self, prog, ref, weights):
        p0 = {n: t.detach().cpu() for n, t in weights.items()}
        gaps = C.training_gaps(prog, ref, self.lr, p0)
        gaps["loss_gap"] = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        classes = float((prog["classes"].double() - ref["classes"].double()).abs().max()
                        / ref["classes"].double().abs().max())
        gaps["logit_gap"] = max(C.aligned_gap(prog["logits"], ref["logits"]), classes)
        for k in ("fps_mismatch", "attn_flip_margin", "match_margin"):
            gaps[k] = ref[k]
        return gaps
