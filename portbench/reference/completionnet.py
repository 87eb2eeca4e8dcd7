"""Plain PyTorch CompletionNet (NVIDIA/MinkowskiEngine v0.5.4,
``examples/completion.py``).

The encoder: a k = 3 conv, then per level a k = 2 stride-2 conv and a
k = 3 conv, each with batch norm and ELU.  The decoder, coarsest level
first: a generative transposed conv (k = 4 at the first level, 2 after)
that spreads every row over its kernel at the finer stride, batch norm,
ELU, a k = 3 conv, batch norm, ELU, the encoder's map at that stride added
over the union of both maps, a k = 1 classifier with a bias, and pruning
to the rows whose logit is above 0 or, in training, that lie in the full
shape strided to the level.

``forward`` takes ``held``: per level, the coordinates and keep mask of
the run it judges.  Pruning on a logit near 0 can go either way in two
sound runs, and everything after it then sits on another map; so where
the reference's own decision differs from the judged run's, it takes the
judged run's if its own logit lies near 0 (the comparison reads how near)
and follows it from there.  Rows of the judged run's level that the
reference does not have, or the reverse, are counted.
"""

from __future__ import annotations

import math

import torch

from . import plain as P


def parameter_spec(cfg):
    enc, dec = cfg["enc_channels"], cfg["dec_channels"]
    levels = len(enc) - 1
    spec = []

    def conv(name, k, cin, cout, transposed=False):
        vol = k**3
        shape = (cin, cout) if k == 1 else (vol, cin, cout)
        spec.append((f"{name}.kernel", shape, 1.0 / math.sqrt((cout if transposed else cin) * vol)))

    def bn(name, c):
        spec.append((f"{name}.bn.weight", (c,), None))
        spec.append((f"{name}.bn.bias", (c,), None))

    conv("enc_first.0", 3, cfg["in_nchannel"], enc[0])
    bn("enc_first.1", enc[0])
    for i in range(levels):
        conv(f"enc_blocks.{i}.0", 2, enc[i], enc[i + 1])
        bn(f"enc_blocks.{i}.1", enc[i + 1])
        conv(f"enc_blocks.{i}.3", 3, enc[i + 1], enc[i + 1])
        bn(f"enc_blocks.{i}.4", enc[i + 1])
    for i in range(levels):
        cin = enc[levels] if i == 0 else dec[levels - i]
        cout = dec[levels - i - 1]
        conv(f"dec_blocks.{i}.0", 4 if i == 0 else 2, cin, cout, transposed=True)
        bn(f"dec_blocks.{i}.1", cout)
        conv(f"dec_blocks.{i}.3", 3, cout, cout)
        bn(f"dec_blocks.{i}.4", cout)
    for i in range(levels):
        c = dec[levels - i - 1]
        conv(f"cls_heads.{i}", 1, c, 1)
        spec.append((f"cls_heads.{i}.bias", (1, 1), 1.0 / math.sqrt(c)))
    return spec


def buffers(cfg, device):
    out = {}
    for name, shape, _ in parameter_spec(cfg):
        if name.endswith(".bn.weight"):
            base = name[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out


def forward(cfg, p, partial, feats, full, training, held=None, precision="float32"):
    """Per level (logits, targets, coordinates, keep); and the judged
    run's flips and unmatched rows when ``held`` is given.

    ``partial``/``full``: (N, 4) int32 unique coordinates; ``feats``: the
    partial rows' features in ``partial``'s order.  ``held``: per level
    (coordinates (M, 4), keep (M,) bool) of the judged run.
    """
    enc_ch = cfg["enc_channels"]
    levels = len(enc_ch) - 1
    coords, keys, inv = P.unique(partial)
    x = P.Sparse(P.Map(coords, keys, 1),
                 torch.zeros_like(feats).index_copy_(0, inv, feats))
    maps = P.Maps(x.map, precision)
    target_maps = P.Maps(P.Map(*P.unique(full)[:2], 1))

    def bn_elu(t, name):
        t = P.batch_norm(t, p, f"{name}.bn", training)
        return P.Sparse(t.map, torch.nn.functional.elu(t.feats))

    enc = [bn_elu(maps.conv(x, p["enc_first.0.kernel"], 3), "enc_first.1")]
    for i in range(levels):
        t = bn_elu(maps.conv(enc[-1], p[f"enc_blocks.{i}.0.kernel"], 2, stride=2), f"enc_blocks.{i}.1")
        enc.append(bn_elu(maps.conv(t, p[f"enc_blocks.{i}.3.kernel"], 3), f"enc_blocks.{i}.4"))

    out, judged = [], {"flip_margin": 0.0, "unmatched_rows": 0, "flips": 0}
    dec = enc[-1]
    for i in range(levels):
        k = 4 if i == 0 else 2
        gen = P.generate(dec.map, k, dec.map.stride // 2)
        dec_maps = P.Maps(gen, precision)
        t = dec_maps.conv_tr(dec, p[f"dec_blocks.{i}.0.kernel"], k, gen)
        t = bn_elu(t, f"dec_blocks.{i}.1")
        t = bn_elu(dec_maps.conv(t, p[f"dec_blocks.{i}.3.kernel"], 3), f"dec_blocks.{i}.4")
        t = P.union(t, enc[levels - i - 1])
        logits = P.matmul(t.feats, p[f"cls_heads.{i}.kernel"], precision)[:, 0] + p[f"cls_heads.{i}.bias"][0, 0]
        tmap = target_maps.at(t.map.stride)
        target = P.lookup(tmap.keys, t.map.keys) >= 0
        keep = logits > 0
        if training:
            keep = keep | target
        if held is not None:
            keep = _follow(judged, t.map, logits, keep, *held[i])
        out.append((logits, target, t.map.coords, keep))
        dec = t
        if bool(keep.any()):
            kept = torch.nonzero(keep).squeeze(1)
            dec = P.Sparse(P.Map(t.map.coords[kept], t.map.keys[kept], t.map.stride),
                           t.feats.index_select(0, kept))
    return out, judged


def _follow(judged, m, logits, keep, coords, their_keep):
    """The judged run's keep mask on the reference's rows where the two
    decide otherwise; count rows either map lacks."""
    theirs = P.pack(coords.to(m.keys.device))
    order = torch.argsort(theirs)
    rows = P.lookup(theirs[order], m.keys)
    found = rows >= 0
    judged["unmatched_rows"] += int((~found).sum()) + (theirs.numel() - int(found.sum()))
    their = torch.where(found, their_keep.to(m.keys.device)[order][rows.clamp(min=0)], keep)
    flipped = their != keep
    if bool(flipped.any()):
        scale = float(logits.detach().abs().max())
        judged["flip_margin"] = max(judged["flip_margin"], float(logits.detach()[flipped].abs().max()) / scale)
        judged["flips"] += int(flipped.sum())
    return their


def bce(out):
    """Mean over levels of each level's mean sigmoid cross-entropy."""
    return sum(
        torch.nn.functional.binary_cross_entropy_with_logits(lg, t.to(lg.dtype)) for lg, t, _, _ in out
    ) / len(out)
