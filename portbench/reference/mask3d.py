"""Plain PyTorch Mask3D (Schult et al., ICRA 2023, arXiv:2210.03105; the
authors' ``conf/model/mask3d.yaml`` with ``Res16UNet34C``, the ScanNet
criterion and matcher), the yardstick of ``mask3d.train.room2cm``.

Written from the published model on ``plain``'s coordinate code and
``minkunet34``'s parameters: the MinkUNet34 backbone's five decoder levels
(block4 … block8), a 1×1 conv of the finest to the mask features, each
level's raw coordinates average-pooled (k = 2, s = 2) from stride 1, their
Fourier encodings per scene, farthest point sampling from each scene's
first row, and the decoder: per pass and level a mask module (LayerNorm,
class logits, mask embedding, one scene's ``M_b E_bᵀ`` at a time), masked
cross-attention to the sampled keys, self-attention and the FFN, each
post-norm; explicit ``softmax(Q Kᵀ / √d) V`` with the mask as ``-inf``.
The criterion builds each scene's cost matrix from its definition
(``binary_cross_entropy_with_logits`` against ones and zeros, products
with the target masks, the dice ratio) and its losses pair by pair.

The comparison holds the reference to the program's discrete decisions
(``held``): the FPS rows, the key samples, the attention masks and the
assignments.  The reference makes each decision itself too and reports how
far the program's lies from its own: ``fps_mismatch`` (rows unequal),
``attn_flip_margin`` (the largest |pooled logit| of the reference where its
threshold and the program's mask disagree, over the mask's largest
|pooled logit|), ``match_margin`` (the reference's cost of the program's
assignment above its own optimum, over that optimum).
Without ``held`` the reference decides alone; its key samples then come
from one ``randperm`` per scene of the generator it is given, as upstream
draws them.

Departures from the published code: the backbone's classifier is built
and unused; the FPS kernel's skip of points within 1e-3 of the origin is
left out; the mask and dice losses are summed over matched pairs and
divided by the batch's target count.  ``precision="tf32"`` rounds every
product's operands to TF32, the control of the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from . import minkunet34 as U
from . import plain as P

PREFIX = "backbone."


def _backbone_cfg(cfg):
    return dict(cfg["backbone"], in_channels=cfg["in_channels"], out_channels=cfg["out_channels"])


def _levels(cfg):
    """Channels of the five levels, coarsest first."""
    planes = cfg["backbone"]["planes"]
    return [planes[3], planes[4], planes[5], planes[6], planes[7]]


def parameter_spec(cfg):
    """[(name, shape, uniform bound or None for a norm's or zero bias's
    fill)] under the program's names."""
    spec = [(PREFIX + n, s, b) for n, s, b in U.parameter_spec(_backbone_cfg(cfg))]
    h, ffn = cfg["hidden_dim"], cfg["dim_feedforward"]
    chans = _levels(cfg)

    def linear(name, cin, cout, xavier=False):
        bound = math.sqrt(6.0 / (cin + cout)) if xavier else 1.0 / math.sqrt(cin)
        spec.append((f"{name}.weight", (cout, cin), bound))
        spec.append((f"{name}.bias", (cout,), 1.0 / math.sqrt(cin)))

    def norm(name):
        spec.append((f"{name}.weight", (h,), None))
        spec.append((f"{name}.bias", (h,), None))

    def attention(name):
        spec.append((f"{name}.in_proj_weight", (3 * h, h), math.sqrt(6.0 / (4 * h))))
        spec.append((f"{name}.in_proj_bias", (3 * h,), None))
        spec.append((f"{name}.out_proj.weight", (h, h), math.sqrt(6.0 / (2 * h))))
        spec.append((f"{name}.out_proj.bias", (h,), None))

    d = "decoder."
    spec.append((d + "mask_features_head.kernel", (chans[-1], h), 1.0 / math.sqrt(chans[-1])))
    spec.append((d + "mask_features_head.bias", (1, h), 1.0 / math.sqrt(chans[-1])))
    linear(d + "query_projection.0", h, h)
    linear(d + "query_projection.2", h, h)
    norm(d + "decoder_norm")
    linear(d + "mask_embed_head.0", h, h)
    linear(d + "mask_embed_head.2", h, h)
    linear(d + "class_embed_head", h, cfg["num_targets"])
    for i, c in enumerate(chans[:-1]):
        linear(f"{d}lin_squeeze.{i}", c, h)
    for i in range(len(chans) - 1):
        attention(f"{d}cross_attention.{i}.multihead_attn")
        norm(f"{d}cross_attention.{i}.norm")
        attention(f"{d}self_attention.{i}.self_attn")
        norm(f"{d}self_attention.{i}.norm")
        linear(f"{d}ffn_attention.{i}.linear1", h, ffn, xavier=True)
        linear(f"{d}ffn_attention.{i}.linear2", ffn, h, xavier=True)
        norm(f"{d}ffn_attention.{i}.norm")
    return spec


def buffers(cfg, device):
    """Fresh batch-norm running statistics of the backbone."""
    return {PREFIX + n: t for n, t in U.buffers(_backbone_cfg(cfg), device).items()}


def gauss_b(cfg, rng):
    """The Fourier encoding's fixed matrix (3, hidden_dim / 2) from a numpy
    generator: N(0, 1) × ``gauss_scale``."""
    b = rng.standard_normal((3, cfg["hidden_dim"] // 2)) * cfg["gauss_scale"]
    return b.astype(np.float32)


# -- the backbone ------------------------------------------------------------
def backbone_levels(cfg, p, coords, feats, precision):
    """MinkUNet34 in training mode, its five decoder levels (``P.Sparse``,
    coarsest first), on the sorted unique coordinates; and the maps."""
    bcfg = _backbone_cfg(cfg)
    q = {n[len(PREFIX):]: t for n, t in p.items() if n.startswith(PREFIX)}
    base_coords, keys, inv = P.unique(coords)
    if base_coords.shape[0] != coords.shape[0]:
        raise ValueError("duplicate coordinates in a voxel cloud")
    x0 = torch.zeros_like(feats).index_copy_(0, inv, feats)
    maps = P.Maps(P.Map(base_coords, keys, 1), precision)

    def bn(x, name):
        return P.batch_norm(x, q, f"{name}.bn", True)

    def act(x):
        return P.Sparse(x.map, torch.relu(x.feats))

    def block(x, name):
        out = act(bn(maps.conv(x, q[f"{name}.conv1.kernel"], 3), f"{name}.norm1"))
        out = bn(maps.conv(out, q[f"{name}.conv2.kernel"], 3), f"{name}.norm2")
        res = x
        if f"{name}.downsample.0.kernel" in q:
            res = bn(maps.conv(x, q[f"{name}.downsample.0.kernel"], 1), f"{name}.downsample.1")
        return act(P.Sparse(out.map, out.feats + res.feats))

    def stage(x, s):
        for b in range(bcfg["layers"][s]):
            x = block(x, f"block{s + 1}.{b}")
        return x

    skips = [act(bn(maps.conv(P.Sparse(maps.base, x0), q["conv0p1s1.kernel"], 5), "bn0"))]
    out = skips[0]
    for s in range(4):
        out = act(bn(maps.conv(out, q[f"conv{s + 1}p{2**s}s2.kernel"], 2, stride=2), f"bn{s + 1}"))
        out = stage(out, s)
        skips.append(out)
    levels = [out]
    for s in range(4, 8):
        target = maps.at(out.map.stride // 2)
        out = maps.conv_tr(out, q[f"convtr{s}p{2 ** (8 - s)}s2.kernel"], 2, target)
        out = P.cat(act(bn(out, f"bntr{s}")), skips[7 - s])
        out = stage(out, s)
        levels.append(out)
    return levels, maps, inv


# -- pieces ------------------------------------------------------------------
def linear(x, p, name, precision):
    return P.matmul(x, p[f"{name}.weight"].t(), precision) + p[f"{name}.bias"]


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def avg_pool(feats, fine, coarse):
    """k = 2, s = 2 average pooling of rows on map ``fine`` onto ``coarse``:
    each coarse row the mean of the fine rows that floor onto it."""
    parent = P.lookup(coarse.keys, P.pack(_floor(fine.coords, coarse.stride)))
    sums = feats.new_zeros((coarse.n, feats.shape[1])).index_add_(0, parent, feats)
    counts = torch.bincount(parent, minlength=coarse.n).to(feats.dtype)
    return sums / counts[:, None]


def _floor(coords, stride):
    c = coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    return c


def offsets(m):
    """Each scene's first row and the end, on the host."""
    batch = m.coords[:, 0].contiguous()
    top = int(batch.max()) + 1
    return torch.searchsorted(batch, torch.arange(top + 1, device=batch.device,
                                                  dtype=batch.dtype)).tolist()


def fourier(xyz, lo, hi, gauss):
    xyz = (xyz - lo) / (hi - lo) * (2 * math.pi)
    proj = xyz @ gauss
    return torch.cat([proj.sin(), proj.cos()], -1)


def fps(coords, n):
    """Farthest point sampling of one scene's integer coordinates from row
    0; ``argmax`` takes the lowest row of a tie."""
    c = coords.to(torch.int64)
    best = torch.full((c.shape[0],), torch.iinfo(torch.int64).max, device=c.device)
    picked = [0]
    for _ in range(n - 1):
        best = torch.minimum(best, (c - c[picked[-1]]).pow(2).sum(1))
        picked.append(int(torch.argmax(best)))
    return torch.tensor(picked, device=c.device)


def attention(q_in, k_in, v_in, p, name, heads, allowed, precision):
    """``nn.MultiheadAttention``, batch first: (B, L, d) queries, (B, S, d)
    keys and values, ``allowed`` (B, L, S) or None."""
    d = q_in.shape[-1]
    w, b = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    q, k, v = (P.matmul(t, w[i * d:(i + 1) * d].t(), precision) + b[i * d:(i + 1) * d]
               for i, t in enumerate((q_in, k_in, v_in)))

    def split(t):
        return t.view(t.shape[0], t.shape[1], heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = P.matmul(q, k.transpose(-1, -2), precision) / math.sqrt(d // heads)
    if allowed is not None:
        scores = scores.masked_fill(~allowed[:, None], -math.inf)
    out = P.matmul(torch.softmax(scores, -1), v, precision)
    out = out.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], d)
    return linear(out, p, f"{name}.out_proj", precision)


# -- the model ---------------------------------------------------------------
def forward(cfg, p, coords, feats, raw, held=None, generator=None, precision="float32"):
    """The 13 predictions of one batch: coordinates (N, 4) int32 unique,
    features, raw coordinates (N, 3) in the input's rows.  Returns a dict:
    ``predictions`` [(class logits (B, Q, C), mask logits (N, Q))], the
    last the final one; ``decisions`` (``fps``, ``samples``, ``attn``) as
    taken; ``fps_mismatch`` and ``attn_flip_margin`` against ``held``;
    ``coords`` and ``inv`` (each input row's sorted row); ``offsets``."""
    d = "decoder."
    heads, nq = cfg["num_heads"], cfg["num_queries"]
    levels, maps, inv = backbone_levels(cfg, p, coords, feats, precision)
    finest = levels[-1]
    raw_rows = torch.empty_like(raw).index_copy_(0, inv, raw)
    m = finest.map
    mask_feats = P.matmul(finest.feats, p[d + "mask_features_head.kernel"], precision) \
        + p[d + "mask_features_head.bias"]
    n_att = len(levels) - 1
    with torch.no_grad():
        pooled = [raw_rows]
        for s in range(n_att):
            pooled.append(avg_pool(pooled[-1], maps.at(2 ** s), maps.at(2 ** (s + 1))))
        pooled.reverse()
    offs = [offsets(lv.map) for lv in levels]
    n_scenes = len(offs[-1]) - 1
    gauss = p[d + "pos_enc.gauss_B"]

    def encode(x, o):
        parts = []
        for a, b in zip(o[:-1], o[1:]):
            lo, hi = x[a:b].amin(0), x[a:b].amax(0)
            parts.append(fourier(x[a:b], lo, hi, gauss))
        return torch.cat(parts)

    pos = [encode(pooled[i], offs[i]) for i in range(n_att)]
    o = offs[-1]
    own_fps = torch.stack([fps(m.coords[a:b, 1:], nq) for a, b in zip(o[:-1], o[1:])])
    rec = {"fps_mismatch": 0, "attn_flip_margin": 0.0}
    if held is not None:
        used = held["fps"].to(own_fps.device)
        rec["fps_mismatch"] = int((used != own_fps).sum())
    else:
        used = own_fps
    qp = []
    for b, (a, e) in enumerate(zip(o[:-1], o[1:])):
        x = raw_rows[a:e]
        qp.append(fourier(x[used[b]], x.amin(0), x.amax(0), gauss))
    qp = torch.stack(qp)
    for i in (0, 2):
        qp = torch.relu(linear(qp, p, f"{d}query_projection.{i}", precision))
    queries = torch.zeros_like(qp)

    def mask_module(queries, steps):
        qn = layer_norm(queries, p, d + "decoder_norm")
        classes = linear(qn, p, d + "class_embed_head", precision)
        emb = linear(torch.relu(linear(qn, p, d + "mask_embed_head.0", precision)), p,
                     d + "mask_embed_head.2", precision)
        masks = torch.cat([P.matmul(mask_feats[a:e], emb[b].t(), precision)
                           for b, (a, e) in enumerate(zip(o[:-1], o[1:]))])
        logits = None
        if steps:
            with torch.no_grad():
                logits = masks
                for s in range(steps):
                    logits = avg_pool(logits, maps.at(2 ** s), maps.at(2 ** (s + 1)))
        return classes, masks, logits

    decisions = {"fps": used, "samples": [], "attn": []}
    predictions, k = [], 0
    for _ in range(cfg["num_decoders"]):
        for i in range(n_att):
            classes, masks, logits = mask_module(queries, n_att - i)
            predictions.append((classes, masks))
            own = logits.sigmoid() < 0.5
            if held is not None:
                attn = held["attn"][k].to(own.device)
                flips = own != attn
                if bool(flips.any()):
                    rec["attn_flip_margin"] = max(rec["attn_flip_margin"], float(
                        logits[flips].abs().max() / logits.abs().max()))
                rows, pad = (t.to(own.device) for t in held["samples"][k])
            else:
                attn = own
                rows, pad = _draw(offs[i], cfg["sample_sizes"][i], generator)
            decisions["attn"].append(attn)
            decisions["samples"].append((rows, pad))
            k += 1
            lv = levels[i]
            src = linear(lv.feats[rows], p, f"{d}lin_squeeze.{i}", precision)
            masked = attn[rows].transpose(1, 2)
            masked = masked & ~masked.all(-1, keepdim=True)
            masked = masked | pad[:, None, :]
            name = f"{d}cross_attention.{i}"
            out = attention(queries + qp, src + pos[i][rows], src, p, f"{name}.multihead_attn",
                            heads, ~masked, precision)
            queries = layer_norm(queries + out, p, f"{name}.norm")
            name = f"{d}self_attention.{i}"
            out = attention(queries + qp, queries + qp, queries, p, f"{name}.self_attn", heads,
                            None, precision)
            queries = layer_norm(queries + out, p, f"{name}.norm")
            name = f"{d}ffn_attention.{i}"
            h = torch.relu(linear(queries, p, f"{name}.linear1", precision))
            queries = layer_norm(queries + linear(h, p, f"{name}.linear2", precision), p,
                                 f"{name}.norm")
    classes, masks, _ = mask_module(queries, 0)
    predictions.append((classes, masks))
    rec.update(predictions=predictions, decisions=decisions, coords=m.coords, inv=inv,
               offsets=o, n_scenes=n_scenes)
    return rec


def _draw(o, size, generator):
    """Upstream's key sample of each scene: all rows padded with row 0 and
    masked, or ``randperm(n)[:size]``."""
    rows, pads = [], []
    for a, b in zip(o[:-1], o[1:]):
        n = b - a
        dev = generator.device if generator is not None else None
        if n <= size:
            idx = torch.zeros(size, dtype=torch.int64, device=dev)
            idx[:n] = torch.arange(n, device=dev)
            pad = torch.arange(size, device=dev) >= n
        else:
            idx = torch.randperm(n, generator=generator, device=dev)[:size]
            pad = torch.zeros(size, dtype=torch.bool, device=dev)
        rows.append(idx + a)
        pads.append(pad)
    return torch.stack(rows), torch.stack(pads)


# -- the criterion -----------------------------------------------------------
def criterion(cfg, rec, instance, labels, scenes, held=None, precision="float32"):
    """The set loss of ``forward``'s predictions: ``instance`` (N,) each
    input row's target or -1, ``labels`` (T,) each target's class,
    ``scenes`` (T,) its scene (host).  Returns (loss, the assignments taken
    (per prediction, per scene (queries, targets))), ``match_margin``)."""
    from scipy.optimize import linear_sum_assignment

    dev = instance.device
    inst = torch.empty_like(instance).index_copy_(0, rec["inv"], instance)
    o, n_scenes = rec["offsets"], rec["n_scenes"]
    scenes = np.asarray(scenes, np.int64)
    n_targets = len(scenes)
    c_class, c_mask, c_dice = cfg["cost_class"], cfg["cost_mask"], cfg["cost_dice"]
    w_ce, w_mask, w_dice = cfg["weight_ce"], cfg["weight_mask"], cfg["weight_dice"]
    weight = torch.ones(cfg["num_targets"], device=dev, dtype=rec["predictions"][0][0].dtype)
    weight[-1] = cfg["eos_coef"]
    taken, margin, loss = [], 0.0, 0.0
    norm = max(n_targets, 1)
    for k, (classes, masks) in enumerate(rec["predictions"]):
        per_scene = []
        target_classes = torch.full(classes.shape[:2], cfg["num_targets"] - 1, dtype=torch.int64,
                                    device=dev)
        mask_sum = dice_sum = 0.0
        for b, (a, e) in enumerate(zip(o[:-1], o[1:])):
            ts = np.flatnonzero(scenes == b)
            y = masks[a:e]
            t = (inst[a:e][None, :] == torch.as_tensor(ts, device=dev)[:, None]).to(y.dtype)
            with torch.no_grad():
                prob = classes[b].softmax(-1)[:, labels[ts]]
                pos = F.binary_cross_entropy_with_logits(y, torch.ones_like(y), reduction="none")
                neg = F.binary_cross_entropy_with_logits(y, torch.zeros_like(y), reduction="none")
                cost_mask = (P.matmul(pos.t(), t.t(), precision)
                             + P.matmul(neg.t(), (1 - t).t(), precision)) / y.shape[0]
                sig = y.sigmoid()
                num = 2 * P.matmul(sig.t(), t.t(), precision)
                den = sig.sum(0)[:, None] + t.sum(1)[None, :]
                cost = c_class * -prob + c_mask * cost_mask + c_dice * (1 - (num + 1) / (den + 1))
                c = cost.double().cpu().numpy()
            qo, to = linear_sum_assignment(c)
            if held is not None:
                q, tg = held[k][b]
                q, tg = np.asarray(q), np.asarray(tg)
                local = np.searchsorted(ts, tg)
                best = c[qo, to].sum()
                margin = max(margin, float((c[q, local].sum() - best) / max(abs(best), 1e-30)))
            else:
                q, local = qo, to
                tg = ts[to]
            per_scene.append((q, tg))
            if len(q):
                qt = torch.as_tensor(q, device=dev)
                target_classes[b, qt] = labels[torch.as_tensor(tg, device=dev)]
                for qi, li in zip(q.tolist(), local.tolist()):
                    yq, tq = y[:, qi], t[li]
                    mask_sum = mask_sum + F.binary_cross_entropy_with_logits(yq, tq)
                    s = yq.sigmoid()
                    dice_sum = dice_sum + 1 - (2 * (s * tq).sum() + 1) / (s.sum() + tq.sum() + 1)
        ce = F.cross_entropy(classes.reshape(-1, classes.shape[-1]), target_classes.reshape(-1),
                             weight=weight)
        loss = loss + w_ce * ce + (w_mask * mask_sum + w_dice * dice_sum) / norm
        taken.append(per_scene)
    return loss, taken, margin
