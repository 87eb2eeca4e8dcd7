"""Mask3D, the 3-D instance segmentation model, and its set criterion.

Schult et al., *Mask3D: Mask Transformer for 3D Instance Segmentation*,
ICRA 2023 (arXiv:2210.03105); the configuration of the authors'
``conf/model/mask3d.yaml`` for ScanNet.  A MinkUNet34 backbone (its
``Res16UNet34C``: MinkUNet34's blocks, planes and skips, a k = 5 stem)
gives five decoder levels (``MinkUNetBase.feature_levels``); a transformer
decoder of ``num_queries`` queries reads them coarse to fine:

* mask features ``M``: a 1×1 conv with bias of the stride-1 level, 96 →
  ``hidden_dim``;
* level coordinates: each voxel's raw coordinate (metres) at stride 1,
  average-pooled (k = 2, s = 2) onto each coarser level's map; their Fourier
  encoding ``[sin, cos](2π · (p - min) / (max - min) · B)``, the range each
  scene's at that level, ``B`` a fixed Gaussian (3, hidden_dim / 2) buffer;
* queries: farthest point sampling over each scene's voxel coordinates,
  from its first row (ties to the lowest row); ``query_pos`` is the
  projected encoding of the sampled raw coordinates, the queries start at 0;
* per decoder pass (``num_decoders``, one set of weights:
  ``shared_decoder``) and level (strides 16, 8, 4, 2): the mask module
  (LayerNorm, class logits, mask embedding, ``Y = M Eᵀ`` per scene, and
  ``A = sigmoid(AvgPool^(log2 s)(Y)) < 0.5``, the attention mask), then
  masked cross-attention to a sample of the level's rows (post-norm),
  self-attention and a ReLU FFN; a final mask module gives the last of the
  ``3 · 4 + 1`` predictions.

Every scene of the batch runs in one set of launches, with no host read:
rows find their scene by the batch column (indices ``0 .. B-1``), and
per-scene sums, ranges and argmaxes are masked reductions over the few
scenes.  The mask product computes every scene's queries against every
row and keeps each row's own scene's (``B`` times the useful operations).
Key samples: a scene of at most ``S`` rows at a level gives all of them,
padded with its first row and the padding masked; a larger scene a uniform
random ``S``-subset, drawn from the ``generator`` passed to ``forward``
(one ``randperm`` of the level's rows); ``S`` is the level's
``sample_sizes`` entry (upstream takes the smaller of it and the largest
scene, which changes no attended key).  A query whose mask covers every
sampled key is unmasked.

``SetCriterion`` matches each prediction to the targets of each scene by
the Hungarian algorithm (``HungarianMatcher``, ``scipy.optimize.
linear_sum_assignment`` on the host) on the cost ``2·(-p_class) + 5·BCE +
2·dice`` over all of a scene's rows, and sums over the predictions ``2·CE``
(no-object weighted ``eos_coef``) ``+ 5·BCE + 2·dice`` of the matched
pairs, divided by the batch's target count.  Each prediction's cost
matrices are read once for all scenes (``sync.match.costs``); the pairs of
all predictions go back to the card in one copy (``sync.match.indices``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..nn.conv import MinkowskiConvolution
from ..nn.pooling import MinkowskiAvgPooling
from ..sparse_tensor import SparseTensor
from ..types import resolve_device
from ..utils import profiling as P
from .minkunet import MinkUNet34


def _linear(cin, cout, g, xavier=False):
    """``nn.Linear``; PyTorch's default law, or Xavier's for the weight,
    drawn on the CPU."""
    layer = nn.Linear(cin, cout)
    with torch.no_grad():
        bound = math.sqrt(6.0 / (cin + cout)) if xavier else 1.0 / math.sqrt(cin)
        layer.weight.uniform_(-bound, bound, generator=g["generator"])
        layer.bias.uniform_(-1.0 / math.sqrt(cin), 1.0 / math.sqrt(cin), generator=g["generator"])
    return layer.to(g["device"])


def _attention(dim, heads, g):
    """``nn.MultiheadAttention``, batch first, with upstream's law drawn on
    the CPU: Xavier for both projections' weights, zero biases."""
    attn = nn.MultiheadAttention(dim, heads, batch_first=True, device=g["device"])
    with torch.no_grad():
        for w in (attn.in_proj_weight, attn.out_proj.weight):
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=g["generator"]))
        attn.in_proj_bias.zero_()
        attn.out_proj.bias.zero_()
    return attn


class CrossAttentionLayer(nn.Module):
    """Post-norm: ``LN(Q + MHA(Q + query_pos, K + pos, K, mask))``; the
    mask (B, Q, S) is True where a key is masked."""

    def __init__(self, dim, heads, g):
        super().__init__()
        self.multihead_attn = _attention(dim, heads, g)
        self.norm = nn.LayerNorm(dim, device=g["device"])

    def forward(self, tgt, memory, masked, pos, query_pos):
        out, _ = self.multihead_attn(
            tgt + query_pos, memory + pos, memory, need_weights=False,
            attn_mask=masked.repeat_interleave(self.multihead_attn.num_heads, 0))
        return self.norm(tgt + out)


class SelfAttentionLayer(nn.Module):
    """Post-norm: ``LN(Q + MHA(Q + query_pos, Q + query_pos, Q))``."""

    def __init__(self, dim, heads, g):
        super().__init__()
        self.self_attn = _attention(dim, heads, g)
        self.norm = nn.LayerNorm(dim, device=g["device"])

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt, need_weights=False)[0])


class FFNLayer(nn.Module):
    """Post-norm: ``LN(Q + W2 ReLU(W1 Q))``."""

    def __init__(self, dim, hidden, g):
        super().__init__()
        self.linear1 = _linear(dim, hidden, g, xavier=True)
        self.linear2 = _linear(hidden, dim, g, xavier=True)
        self.norm = nn.LayerNorm(dim, device=g["device"])

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class FourierEncoding(nn.Module):
    """Fourier features of coordinates in a range: ``[sin, cos](2π · (p -
    lo) / (hi - lo) · gauss_B)``; ``gauss_B`` (3, dim / 2) is N(0, 1) ×
    ``gauss_scale``, a buffer."""

    def __init__(self, dim, gauss_scale, g, d_in=3):
        super().__init__()
        b = torch.empty(d_in, dim // 2).normal_(generator=g["generator"])
        self.register_buffer("gauss_B", (b * gauss_scale).to(g["device"]))

    def forward(self, xyz, lo, hi):
        xyz = (xyz - lo) / (hi - lo) * (2 * math.pi)
        proj = xyz @ self.gauss_B
        return torch.cat([proj.sin(), proj.cos()], -1)


def _scene_onehot(scene, n_scenes):
    return scene[:, None] == torch.arange(n_scenes, device=scene.device)


def _scene_range(x, onehot):
    """Each scene's (min, max) of ``x`` (N, 3), as (B, 3) each."""
    lo = torch.where(onehot[:, :, None], x[:, None, :], math.inf).amin(0)
    hi = torch.where(onehot[:, :, None], x[:, None, :], -math.inf).amax(0)
    return lo, hi


def farthest_point_sample(coords, scene, onehot, starts, n):
    """``n`` rows of each scene by farthest point sampling from the scene's
    first row (``starts``), squared distances on integer coordinates,
    ties to the lowest row: (B, n) rows of ``coords``."""
    rows = torch.arange(coords.shape[0], device=coords.device)
    p = coords.to(torch.int64)
    best_d = torch.full((coords.shape[0],), torch.iinfo(torch.int64).max, device=coords.device)
    picked = [starts]
    for _ in range(n - 1):
        d = (p - p[picked[-1]][scene]).pow(2).sum(1)
        best_d = torch.minimum(best_d, d)
        far = torch.where(onehot, best_d[:, None], -1).amax(0)
        hit = onehot & (best_d[:, None] == far)
        picked.append(torch.where(hit, rows[:, None], coords.shape[0]).amin(0))
    return torch.stack(picked, 1)


def sample_keys(scene, counts, starts, size, generator):
    """(B, size) rows of a level, each scene's: all of a scene's rows when
    it has at most ``size`` (the rest its first row, padding), else a
    uniform random ``size``-subset; and the (B, size) padding mask."""
    n, dev = scene.shape[0], scene.device
    n_scenes = counts.shape[0]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.randperm(n, generator=generator, device=dev)] = torch.arange(n, device=dev)
    order = torch.argsort(scene * n + rank)
    pos = torch.arange(n, device=dev) - starts[scene[order]]
    slot = torch.where(pos < size, scene[order] * size + pos, n_scenes * size)
    table = torch.cat([starts.repeat_interleave(size), starts.new_zeros(1)])
    table = table.scatter(0, slot, order)[:-1].view(n_scenes, size)
    pad = torch.arange(size, device=dev)[None, :] >= counts[:, None]
    return table, pad


class Mask3DDecoder(nn.Module):
    """The query decoder over a backbone's five levels (coarsest first):
    parameters ``mask_features_head``, ``query_projection``,
    ``decoder_norm``, ``mask_embed_head``, ``class_embed_head`` and, per
    level it attends to, ``lin_squeeze``, ``cross_attention``,
    ``self_attention``, ``ffn_attention``; the buffer ``pos_enc.gauss_B``."""

    def __init__(self, level_channels, num_classes, num_queries=100, hidden_dim=128,
                 num_heads=8, dim_feedforward=1024, num_decoders=3,
                 sample_sizes=(200, 800, 3200, 12800), gauss_scale=1.0, D=3,
                 generator=None, device=None):
        super().__init__()
        g = dict(generator=generator, device=device)
        self.num_queries, self.num_decoders = num_queries, num_decoders
        self.sample_sizes = tuple(sample_sizes)
        attended = len(self.sample_sizes)
        if len(level_channels) != attended + 1:
            raise ValueError("one sample size per level attended to, all but the finest")
        self.mask_features_head = MinkowskiConvolution(
            level_channels[-1], hidden_dim, kernel_size=1, bias=True, dimension=D, **g)
        self.pos_enc = FourierEncoding(hidden_dim, gauss_scale, g)
        self.query_projection = nn.Sequential(
            _linear(hidden_dim, hidden_dim, g), nn.ReLU(), _linear(hidden_dim, hidden_dim, g),
            nn.ReLU())
        self.decoder_norm = nn.LayerNorm(hidden_dim, device=device)
        self.mask_embed_head = nn.Sequential(
            _linear(hidden_dim, hidden_dim, g), nn.ReLU(), _linear(hidden_dim, hidden_dim, g))
        self.class_embed_head = _linear(hidden_dim, num_classes, g)
        self.lin_squeeze = nn.ModuleList(_linear(c, hidden_dim, g) for c in level_channels[:-1])
        self.cross_attention = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, num_heads, g) for _ in range(attended))
        self.self_attention = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, num_heads, g) for _ in range(attended))
        self.ffn_attention = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward, g) for _ in range(attended))
        self.pooling = MinkowskiAvgPooling(kernel_size=2, stride=2, dimension=D)

    def _mask_module(self, queries, mask_feats, scene, mask_key, manager, pooling_steps):
        """(class logits (B, Q, classes), mask logits (N, Q), the attention
        mask at the level ``pooling_steps`` poolings up, or None)."""
        with P.mask3d_part("mask_module"):
            q = self.decoder_norm(queries)
            classes = self.class_embed_head(q)
            embed = self.mask_embed_head(q)
            n, (b, nq, c) = mask_feats.shape[0], embed.shape
            every = (mask_feats @ embed.reshape(b * nq, c).T).view(n, b, nq)
            masks = every.gather(1, scene.view(n, 1, 1).expand(n, 1, nq)).squeeze(1)
            attn = None
            if pooling_steps:
                with P.span("mask3d.pool"), torch.no_grad():
                    t = SparseTensor(masks.detach(), coordinate_map_key=mask_key,
                                     coordinate_manager=manager)
                    for _ in range(pooling_steps):
                        t = self.pooling(t)
                    attn = t.F.sigmoid() < 0.5
            return classes, masks, attn

    def forward(self, levels: Sequence[SparseTensor], raw_coordinates: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        finest = levels[-1]
        manager, key = finest.coordinate_manager, finest.coordinate_map_key
        dev = finest.F.device
        n_scenes = manager.number_of_unique_batch_indices(key)
        attended = levels[:len(self.sample_sizes)]
        with P.mask3d_part("levels"):
            mask_feats = self.mask_features_head(finest).F
            coords = [SparseTensor(raw_coordinates.to(dev, torch.float32), coordinate_map_key=key,
                                   coordinate_manager=manager)]
            with torch.no_grad():
                for _ in attended:
                    coords.append(self.pooling(coords[-1]))
            coords.reverse()  # coarsest first, as ``levels``
            for c, level in zip(coords, levels):
                if c.coordinate_map_key != level.coordinate_map_key:
                    raise ValueError(
                        "a level's pooled coordinates lie on another map than its features")
            scene_of = [level.C[:, 0].to(dev).long() for level in levels]
            onehots = [_scene_onehot(s, n_scenes) for s in scene_of]
            counts = [oh.sum(0) for oh in onehots]
            starts = [torch.cumsum(n, 0) - n for n in counts]
        with P.mask3d_part("fps"):
            fps = farthest_point_sample(finest.C[:, 1:].to(dev), scene_of[-1], onehots[-1],
                                        starts[-1], self.num_queries)
        with P.mask3d_part("posenc"):
            pos = []
            for c, oh, s in zip(coords[:-1], onehots, scene_of):
                lo, hi = _scene_range(c.F, oh)
                pos.append(self.pos_enc(c.F, lo[s], hi[s]))
            lo, hi = _scene_range(coords[-1].F, onehots[-1])
            query_pos = self.query_projection(
                self.pos_enc(coords[-1].F[fps], lo[:, None], hi[:, None]))
        queries = torch.zeros_like(query_pos)
        predictions, samples, attn_masks = [], [], []
        for _ in range(self.num_decoders):
            for i, level in enumerate(attended):
                steps = len(levels) - 1 - i
                classes, masks, attn = self._mask_module(queries, mask_feats, scene_of[-1], key,
                                                         manager, steps)
                predictions.append({"pred_logits": classes, "pred_masks": masks})
                attn_masks.append(attn)
                with P.mask3d_part("cross_attn"):
                    rows, pad = sample_keys(scene_of[i], counts[i], starts[i],
                                            self.sample_sizes[i], generator)
                    samples.append((rows, pad))
                    src = self.lin_squeeze[i](level.F[rows])
                    masked = attn[rows].transpose(1, 2)  # (B, Q, S)
                    masked = masked & ~masked.all(-1, keepdim=True)
                    masked = masked | pad[:, None, :]
                    queries = self.cross_attention[i](queries, src, masked, pos[i][rows],
                                                      query_pos)
                with P.mask3d_part("self_attn"):
                    queries = self.self_attention[i](queries, query_pos)
                with P.mask3d_part("ffn"):
                    queries = self.ffn_attention[i](queries)
        classes, masks, _ = self._mask_module(queries, mask_feats, scene_of[-1], key, manager, 0)
        return {
            "pred_logits": classes, "pred_masks": masks, "aux_outputs": predictions,
            "fps": fps - starts[-1][:, None], "samples": samples, "attn_masks": attn_masks,
            "scene": scene_of[-1], "scene_rows": counts[-1],
        }


class Mask3D(nn.Module):
    """``Mask3D(in_channels=3, num_classes=19, D=3, ...)``: a MinkUNet34
    backbone (``out_channels`` its classifier's, built and unused as
    upstream builds it) and ``Mask3DDecoder``.

    ``forward(x, raw_coordinates, generator=None)``: ``x`` a SparseTensor of
    scenes with batch indices ``0 .. B-1``; ``raw_coordinates`` (N, 3) each
    of its rows' coordinate in metres; ``generator`` the key samples'
    draws.  Returns a dict: ``pred_logits`` (B, Q, classes) and
    ``pred_masks`` (N, Q) of the last prediction, ``aux_outputs`` the other
    ``num_decoders · 4`` as dicts of those, and the step's discrete
    decisions: ``fps`` (B, Q) each scene's sampled rows (scene-local),
    ``samples`` per attention (the (B, S) level rows, the padding mask),
    ``attn_masks`` per attention ((N_level, Q), True: masked); ``scene``
    (N,) and ``scene_rows`` (B,)."""

    def __init__(self, in_channels=3, num_classes=19, D=3, out_channels=20, num_queries=100,
                 hidden_dim=128, num_heads=8, dim_feedforward=1024, num_decoders=3,
                 sample_sizes=(200, 800, 3200, 12800), gauss_scale=1.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        g = dict(generator=generator, device=device)
        self.backbone = MinkUNet34(in_channels, out_channels, D=D, **g)
        planes = self.backbone.PLANES
        self.decoder = Mask3DDecoder(
            (planes[3], planes[4], planes[5], planes[6], planes[7]), num_classes,
            num_queries, hidden_dim, num_heads, dim_feedforward, num_decoders, sample_sizes,
            gauss_scale, D, **g)

    def forward(self, x, raw_coordinates, generator=None):
        return self.decoder(list(self.backbone.feature_levels(x)), raw_coordinates, generator)


@dataclass
class InstanceTargets:
    """A batch's instances: ``instance`` (N,) each row's target (-1 for
    none), ``labels`` (T,) each target's class, ``scenes`` its scene (host
    integers)."""

    instance: torch.Tensor
    labels: torch.Tensor
    scenes: Sequence[int]


class HungarianMatcher(nn.Module):
    """Per scene, the assignment of queries to targets of least cost
    (``scipy.optimize.linear_sum_assignment``).  ``forward(cost, scenes,
    n_scenes)``: ``cost`` (T, Q) on the card, each target's column of
    costs against its own scene's queries, read once for all scenes;
    returns per scene (query indices, target indices)."""

    def forward(self, cost: torch.Tensor, scenes: Sequence[int], n_scenes: int):
        from scipy.optimize import linear_sum_assignment

        with P.span("mask3d.match"):
            with P.host_read("match.costs"):
                c = cost.detach().cpu().numpy()
            scenes = np.asarray(scenes, np.int64)
            out = []
            for b in range(n_scenes):
                targets = np.flatnonzero(scenes == b)
                q, t = linear_sum_assignment(c[targets].T)
                out.append((q.astype(np.int64), targets[t]))
            return out


class SetCriterion(nn.Module):
    """Mask3D's loss over its predictions: each matched by
    ``HungarianMatcher`` on ``cost_class · (-p_class) + cost_mask · BCE +
    cost_dice · dice``, then ``weight_ce · CE + weight_mask · BCE +
    weight_dice · dice``; class ``num_classes - 1`` is no-object, its CE
    weight ``eos_coef``.  ``forward(outputs, targets)`` returns (the loss,
    per prediction the per-scene (queries, targets) pairs)."""

    def __init__(self, num_classes=19, eos_coef=0.1, cost=(2.0, 5.0, 2.0),
                 weights=(2.0, 5.0, 2.0), device=None):
        super().__init__()
        self.matcher = HungarianMatcher()
        self.cost, self.weights = tuple(cost), tuple(weights)
        w = torch.ones(num_classes, device=resolve_device(device))
        w[-1] = eos_coef
        self.register_buffer("empty_weight", w)

    @staticmethod
    def _sums(masks, onehot, members):
        """Per (scene, query): Σ BCE(y, 0) and Σ sigmoid(y) over the scene's
        rows; per (target, query): Σ y and Σ sigmoid(y) over its rows; in
        float64, since a float32 product over a scene's ~10⁵ rows is off by
        ~1e-4 of the sum."""
        sig = masks.sigmoid()
        per_scene = onehot.T @ torch.cat([F.softplus(masks), sig], 1).double()
        per_target = members.T @ torch.cat([masks, sig], 1).double()
        nq = masks.shape[1]
        return per_scene[:, :nq], per_scene[:, nq:], per_target[:, :nq], per_target[:, nq:]

    def forward(self, outputs, targets: InstanceTargets):
        with P.mask3d_part("criterion"):
            preds = list(outputs["aux_outputs"]) + [outputs]
            b, nq, n_classes = outputs["pred_logits"].shape
            dev = outputs["pred_masks"].device
            onehot = _scene_onehot(outputs["scene"], b).to(torch.float64)
            n_targets = len(targets.scenes)
            members = (targets.instance[:, None]
                       == torch.arange(n_targets, device=dev)).to(torch.float64)
            sizes = members.sum(0)
            t_scene = (members.T @ onehot).argmax(1)  # every target has a row
            rows = outputs["scene_rows"].to(torch.float64)
            parts, indices = [], []
            for p in preds:
                sp, ss, yt, st = self._sums(p["pred_masks"], onehot, members)
                bce = (sp[t_scene] - yt) / rows[t_scene][:, None]  # (T, Q)
                dice = 1 - (2 * st + 1) / (ss[t_scene] + sizes[:, None] + 1)
                prob = p["pred_logits"].softmax(-1)[t_scene, :, targets.labels]  # (T, Q)
                c_class, c_mask, c_dice = self.cost
                cost = c_class * -prob + c_mask * bce + c_dice * dice
                indices.append(self.matcher(cost.detach(), targets.scenes, b))
                parts.append((p["pred_logits"], bce, dice))
            pairs = [np.concatenate([np.stack([np.full(len(q), s), q, t]) for s, (q, t)
                                     in enumerate(per_scene)], 1) for per_scene in indices]
            ends = np.cumsum([x.shape[1] for x in pairs])
            with P.host_read("match.indices"):
                uploaded = torch.from_numpy(np.concatenate(pairs, 1)).to(dev)
            w_ce, w_mask, w_dice = self.weights
            norm = max(n_targets, 1)
            loss = 0.0
            for (logits, bce, dice), lo, hi in zip(parts, np.concatenate([[0], ends[:-1]]), ends):
                s, q, t = uploaded[:, lo:hi]
                classes = torch.full((b * nq,), n_classes - 1, dtype=torch.int64, device=dev)
                classes = classes.index_put((s * nq + q,), targets.labels[t])
                ce = F.cross_entropy(logits.reshape(b * nq, n_classes), classes,
                                     weight=self.empty_weight)
                pairs_loss = w_mask * bce[t, q].sum() + w_dice * dice[t, q].sum()
                loss = loss + w_ce * ce + pairs_loss / norm
            return loss, indices
