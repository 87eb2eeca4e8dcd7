"""Plain PyTorch Mask3D, the port's yardstick in the CPU tests.

Float32 ``torch`` with TF32 off; no JAX and nothing of the port: its own
key packing, unique, strided and kernel maps, per-offset ``index_select`` +
matmul convs, average pooling, farthest point sampling, attention and the
criterion's cost matrices and losses.  A copy of the benchmark's
``portbench/reference/mask3d.py`` with the coordinate code of
``portbench/reference/plain.py`` and the backbone parameters of
``portbench/reference/minkunet34.py`` inlined, so the tests stand alone.
Written from the published model (Schult et al., ICRA 2023,
arXiv:2210.03105; the authors' ``conf/model/mask3d.yaml``):

* the MinkUNet34 backbone's five decoder levels (block4 … block8) in
  training mode, a 1×1 conv of the finest to the mask features, each
  level's raw coordinates average-pooled (k = 2, s = 2) from stride 1 and
  Fourier-encoded per scene, farthest point sampling from each scene's first
  row;
* per pass and level a mask module (one scene's ``M_b E_bᵀ`` at a time),
  masked cross-attention to the sampled keys, self-attention and the FFN,
  each post-norm, attention as explicit ``softmax(Q Kᵀ / √d) V``;
* the criterion's cost matrices from their definitions and its losses pair
  by pair; ``scipy``'s Hungarian solver for the reference's own optimum.

``held`` holds the reference to the port's discrete decisions (the FPS
rows, key samples, attention masks and assignments) and the reference
reports its own margins to them: ``fps_mismatch``, ``attn_flip_margin``
(over the mask's largest |pooled logit|), ``match_margin`` (over the
reference's optimum).  Departures from the published code: the backbone's
classifier is built and unused; the FPS kernel's skip of points within
1e-3 of the origin is left out; the mask and dice losses are summed over
matched pairs and divided by the batch's target count.
``precision="tf32"`` rounds every product's operands to TF32 (10-bit
mantissa), the lower precision the tests' tolerances must catch.
Parameters come by the port's names (``parameter_spec``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- keys, maps and convs ----------------------------------------------------
BIAS = 1 << 17  # coordinates lie in (-2^17, 2^17)
BITS = 18


def pack(coords: torch.Tensor) -> torch.Tensor:
    """(N, 4) int batch-first coordinates -> (N,) int64 keys, ascending in
    (batch, x, y, z)."""
    c = coords.to(torch.int64)
    key = c[:, 0]
    for d in (1, 2, 3):
        key = (key << BITS) | (c[:, d] + BIAS)
    return key


def unpack(keys: torch.Tensor) -> torch.Tensor:
    mask = (1 << BITS) - 1
    cols = [((keys >> (BITS * (3 - d))) & mask) - BIAS for d in (1, 2, 3)]
    return torch.stack([keys >> (3 * BITS), *cols], 1).to(torch.int32)


def check_range(coords: torch.Tensor) -> None:
    if coords.numel() and (coords[:, 1:].abs().max() >= BIAS or coords[:, 0].min() < 0):
        raise ValueError("coordinates outside the packed range")


def unique(coords: torch.Tensor):
    """(sorted unique coordinates, their keys, inverse of each input row)."""
    check_range(coords)
    keys, inverse = torch.unique(pack(coords), sorted=True, return_inverse=True)
    return unpack(keys), keys, inverse


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in ``sorted_keys``, or -1."""
    if sorted_keys.numel() == 0:
        return torch.full_like(queries, -1)
    pos = torch.searchsorted(sorted_keys, queries).clamp_(max=sorted_keys.numel() - 1)
    return torch.where(sorted_keys[pos] == queries, pos, -1)


def cube_offsets(kernel_size: int, device) -> torch.Tensor:
    """(k^3, 3) int64 offsets in units of the tensor stride, axis 0 fastest."""
    r = torch.arange(kernel_size, device=device)
    if kernel_size % 2:
        r = r - kernel_size // 2
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], 1)


@dataclass
class Map:
    coords: torch.Tensor  # (N, 4) int32, ascending keys
    keys: torch.Tensor  # (N,) int64
    stride: int

    @property
    def n(self) -> int:
        return self.coords.shape[0]


def strided(m: Map, stride: int) -> Map:
    """The map at ``stride``: each row floored to the stride, unique."""
    c = m.coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    coords, keys, _ = unique(c)
    return Map(coords, keys, stride)


def pairs(in_map: Map, out_map: Map, offsets: torch.Tensor, sign: int) -> List[Tuple]:
    """Per offset k, (input rows, output rows) with in = out + sign * offset_k."""
    out = []
    zero = torch.zeros((offsets.shape[0], 1), dtype=offsets.dtype, device=offsets.device)
    delta = torch.cat([zero, offsets], 1) * sign
    for k in range(offsets.shape[0]):
        rows = lookup(in_map.keys, pack(out_map.coords.to(torch.int64) + delta[k]))
        hit = rows >= 0
        out_rows = torch.nonzero(hit).squeeze(1)
        out.append((rows[hit], out_rows))
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (nearest, ties to even) in the bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def matmul(a, b, precision):
    """``a @ b``; in TF32, of the rounded operands, with the gradient
    passed through the rounding."""
    if precision == "tf32":
        a = a + (tf32(a.detach()) - a.detach())
        b = b + (tf32(b.detach()) - b.detach())
    return a @ b


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, plist, n_out, precision):
        ctx.save_for_backward(x, w)
        ctx.plist, ctx.precision = plist, precision
        out = x.new_zeros((n_out, w.shape[2]))
        for k, (i, o) in enumerate(plist):
            if i.numel():
                out.index_add_(0, o, matmul(x.index_select(0, i), w[k], precision))
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        for k, (i, o) in enumerate(ctx.plist):
            if not i.numel():
                continue
            gk = g.index_select(0, o)
            if dx is not None:
                dx.index_add_(0, i, matmul(gk, w[k].t(), ctx.precision))
            if dw is not None:
                dw[k] += matmul(x.index_select(0, i).t(), gk, ctx.precision)
        return dx, dw, None, None, None


@dataclass
class Sparse:
    """Features on a map of one cloud's ``Maps``."""

    map: Map
    feats: torch.Tensor


@dataclass
class Maps:
    """A cloud's maps by stride, and the pairs of each conv between them."""

    base: Map
    precision: str = "float32"
    by_stride: Dict[int, Map] = field(default_factory=dict)
    cache: Dict[tuple, list] = field(default_factory=dict)

    def __post_init__(self):
        self.by_stride[self.base.stride] = self.base

    def at(self, stride: int) -> Map:
        if stride not in self.by_stride:
            self.by_stride[stride] = strided(self.at(stride // 2), stride)
        return self.by_stride[stride]

    def conv(self, x: Sparse, w, kernel_size: int, stride: int = 1, out_map: Map = None):
        """Conv (stride 1 or strided): output on ``x``'s map, the strided
        map, or ``out_map``."""
        if w.dim() == 2:  # volume-1, stride-1: a product
            return Sparse(x.map, matmul(x.feats, w, self.precision))
        if out_map is None:
            out_map = x.map if stride == 1 else self.at(x.map.stride * stride)
        plist = self._pairs(x.map, out_map, kernel_size, x.map.stride, 1)
        return Sparse(out_map, _Conv.apply(x.feats, w, plist, out_map.n, self.precision))

    def conv_tr(self, x: Sparse, w, kernel_size: int, out_map: Map):
        """Transposed conv onto ``out_map`` (a finer stride)."""
        plist = self._pairs(x.map, out_map, kernel_size, out_map.stride, -1)
        return Sparse(out_map, _Conv.apply(x.feats, w, plist, out_map.n, self.precision))

    def _pairs(self, in_map, out_map, kernel_size, scale, sign):
        key = (id(in_map), id(out_map), kernel_size, scale, sign)
        if key not in self.cache:
            offs = cube_offsets(kernel_size, in_map.coords.device) * scale
            self.cache[key] = (in_map, out_map, pairs(in_map, out_map, offs, sign))
        return self.cache[key][2]


def batch_norm(x: Sparse, p: dict, name: str, training: bool, momentum: float = 0.1):
    f = torch.nn.functional.batch_norm(
        x.feats, p[f"{name}.running_mean"], p[f"{name}.running_var"], p[f"{name}.weight"],
        p[f"{name}.bias"], training=training, momentum=momentum, eps=1e-5,
    )
    return Sparse(x.map, f)


def cat(a: Sparse, b: Sparse) -> Sparse:
    """Channel concatenation of two tensors on one map."""
    if a.map is not b.map:
        raise ValueError("cat of tensors on different maps")
    return Sparse(a.map, torch.cat([a.feats, b.feats], 1))


# -- the backbone's parameters ---------------------------------------------
def _blocks(cfg):
    """(name, Cin, planes) of every BasicBlock, in forward order."""
    planes, layers, init = cfg["planes"], cfg["layers"], cfg["init_dim"]
    skips = [init, planes[0], planes[1], planes[2]]  # out_p1, out_b1p2, out_b2p4, out_b3p8
    out, inplanes = [], init
    for s in range(8):
        if s >= 4:
            inplanes = planes[s] + skips[7 - s]
        for b in range(layers[s]):
            out.append((f"block{s + 1}.{b}", inplanes, planes[s]))
            inplanes = planes[s]
    return out


def backbone_spec(cfg):
    """[(name, shape, stdv or None for a batch norm's ones and zeros)]."""
    spec = []

    def conv(name, k, cin, cout, transposed=False):
        fan = cout if transposed else cin
        vol = k**3
        shape = (cin, cout) if k == 1 else (vol, cin, cout)
        spec.append((f"{name}.kernel", shape, 1.0 / math.sqrt(fan * vol)))

    def bn(name, c):
        spec.append((f"{name}.bn.weight", (c,), None))
        spec.append((f"{name}.bn.bias", (c,), None))

    planes, init = cfg["planes"], cfg["init_dim"]
    conv("conv0p1s1", 5, cfg["in_channels"], init)
    bn("bn0", init)
    blocks = iter(_blocks(cfg))
    widths = [init, planes[0], planes[1], planes[2]]
    for s in range(8):
        if s < 4:
            conv(f"conv{s + 1}p{2**s}s2", 2, widths[s], widths[s])
            bn(f"bn{s + 1}", widths[s])
        else:
            cin = planes[3] if s == 4 else planes[s - 1]
            conv(f"convtr{s}p{2 ** (8 - s)}s2", 2, cin, planes[s], transposed=True)
            bn(f"bntr{s}", planes[s])
        for b in range(cfg["layers"][s]):
            name, cin, width = next(blocks)
            conv(f"{name}.conv1", 3, cin, width)
            bn(f"{name}.norm1", width)
            conv(f"{name}.conv2", 3, width, width)
            bn(f"{name}.norm2", width)
            if cin != width:
                conv(f"{name}.downsample.0", 1, cin, width)
                bn(f"{name}.downsample.1", width)
    conv("final", 1, planes[7], cfg["out_channels"])
    spec.append(("final.bias", (1, cfg["out_channels"]), 1.0 / math.sqrt(planes[7])))
    return spec


def backbone_buffers(cfg, device):
    """Fresh batch-norm running statistics, zeros and ones."""
    out = {}
    for name, shape, stdv in backbone_spec(cfg):
        if name.endswith(".bn.weight"):
            base = name[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out



# -- Mask3D -------------------------------------------------------------------
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
    spec = [(PREFIX + n, s, b) for n, s, b in backbone_spec(_backbone_cfg(cfg))]
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
    return {PREFIX + n: t for n, t in backbone_buffers(_backbone_cfg(cfg), device).items()}


def gauss_b(cfg, rng):
    """The Fourier encoding's fixed matrix (3, hidden_dim / 2) from a numpy
    generator: N(0, 1) × ``gauss_scale``."""
    b = rng.standard_normal((3, cfg["hidden_dim"] // 2)) * cfg["gauss_scale"]
    return b.astype(np.float32)


# -- the backbone ------------------------------------------------------------
def backbone_levels(cfg, p, coords, feats, precision):
    """MinkUNet34 in training mode, its five decoder levels (``Sparse``,
    coarsest first), on the sorted unique coordinates; and the maps."""
    bcfg = _backbone_cfg(cfg)
    q = {n[len(PREFIX):]: t for n, t in p.items() if n.startswith(PREFIX)}
    base_coords, keys, inv = unique(coords)
    if base_coords.shape[0] != coords.shape[0]:
        raise ValueError("duplicate coordinates in a voxel cloud")
    x0 = torch.zeros_like(feats).index_copy_(0, inv, feats)
    maps = Maps(Map(base_coords, keys, 1), precision)

    def bn(x, name):
        return batch_norm(x, q, f"{name}.bn", True)

    def act(x):
        return Sparse(x.map, torch.relu(x.feats))

    def block(x, name):
        out = act(bn(maps.conv(x, q[f"{name}.conv1.kernel"], 3), f"{name}.norm1"))
        out = bn(maps.conv(out, q[f"{name}.conv2.kernel"], 3), f"{name}.norm2")
        res = x
        if f"{name}.downsample.0.kernel" in q:
            res = bn(maps.conv(x, q[f"{name}.downsample.0.kernel"], 1), f"{name}.downsample.1")
        return act(Sparse(out.map, out.feats + res.feats))

    def stage(x, s):
        for b in range(bcfg["layers"][s]):
            x = block(x, f"block{s + 1}.{b}")
        return x

    skips = [act(bn(maps.conv(Sparse(maps.base, x0), q["conv0p1s1.kernel"], 5), "bn0"))]
    out = skips[0]
    for s in range(4):
        out = act(bn(maps.conv(out, q[f"conv{s + 1}p{2**s}s2.kernel"], 2, stride=2), f"bn{s + 1}"))
        out = stage(out, s)
        skips.append(out)
    levels = [out]
    for s in range(4, 8):
        target = maps.at(out.map.stride // 2)
        out = maps.conv_tr(out, q[f"convtr{s}p{2 ** (8 - s)}s2.kernel"], 2, target)
        out = cat(act(bn(out, f"bntr{s}")), skips[7 - s])
        out = stage(out, s)
        levels.append(out)
    return levels, maps, inv


# -- pieces ------------------------------------------------------------------
def linear(x, p, name, precision):
    return matmul(x, p[f"{name}.weight"].t(), precision) + p[f"{name}.bias"]


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def avg_pool(feats, fine, coarse):
    """k = 2, s = 2 average pooling of rows on map ``fine`` onto ``coarse``:
    each coarse row the mean of the fine rows that floor onto it."""
    parent = lookup(coarse.keys, pack(_floor(fine.coords, coarse.stride)))
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
    q, k, v = (matmul(t, w[i * d:(i + 1) * d].t(), precision) + b[i * d:(i + 1) * d]
               for i, t in enumerate((q_in, k_in, v_in)))

    def split(t):
        return t.view(t.shape[0], t.shape[1], heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(d // heads)
    if allowed is not None:
        scores = scores.masked_fill(~allowed[:, None], -math.inf)
    out = matmul(torch.softmax(scores, -1), v, precision)
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
    mask_feats = matmul(finest.feats, p[d + "mask_features_head.kernel"], precision) \
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
        masks = torch.cat([matmul(mask_feats[a:e], emb[b].t(), precision)
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
                cost_mask = (matmul(pos.t(), t.t(), precision)
                             + matmul(neg.t(), (1 - t).t(), precision)) / y.shape[0]
                sig = y.sigmoid()
                num = 2 * matmul(sig.t(), t.t(), precision)
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
