"""Plain PyTorch Point Transformer V3 (Wu et al., CVPR 2024, arXiv:2312.10035;
Pointcept ``configs/scannet/semseg-pt-v3m1-0-base.py``, ``PT-v3m1`` with a
Linear head).

Written from the published model, on ``plain``'s own coordinate code.  The
input's grid cells (non-negative, each scene's relative to its room's
minimum) are coded along the four curves as Pointcept's ``serialization``
package codes them: Morton by bit loops (x's bit i to 3i + 2, y's to 3i + 1,
z's to 3i), Hilbert by the ``numpy-hilbert-curve`` encoder's bit arrays,
``-trans`` with x and y swapped, ``batch << 3·depth`` above, ``depth`` the
bit length of the largest grid coordinate.  A pooled level takes each
coarse cell's code as its fine rows' code shifted right by 3, as
``SerializedPooling`` does, and the window plan is Pointcept's flash-path
padding (``get_padding_and_inverse``), built scene by scene on the host.
Attention is ``softmax(Q Kᵀ · head_dim^-0.5) V`` per window, in blocks of
windows, by an autograd Function that recomputes each block's
probabilities in its backward, so a full-size step fits.

``precision="tf32"`` rounds every product's operands to TF32 (convs,
Linears and both products of attention), the control of the comparison.
Departures from the published model, as in the configuration: drop path
0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from . import plain as P

CURVES = ("z", "z-trans", "hilbert", "hilbert-trans")
BLOCK_ELEMENTS = 1 << 26  # attention scores held at once


def _levels(cfg):
    """Per level: (encoder depth, width, heads) and, but for the last,
    (decoder depth, width, heads)."""
    enc = list(zip(cfg["enc_depths"], cfg["enc_channels"], cfg["enc_num_head"]))
    dec = list(zip(cfg["dec_depths"], cfg["dec_channels"], cfg["dec_num_head"]))
    return enc, dec


def parameter_spec(cfg):
    """[(name, shape, stdv or None for a norm's ones and zeros)], under the
    program's parameter names."""
    spec = []

    def linear(name, cin, cout):
        spec.append((f"{name}.linear.weight", (cout, cin), 1.0 / math.sqrt(cin)))
        spec.append((f"{name}.linear.bias", (cout,), 1.0 / math.sqrt(cin)))

    def norm(name, c, kind):
        spec.append((f"{name}.{kind}.weight", (c,), None))
        spec.append((f"{name}.{kind}.bias", (c,), None))

    def block(name, c):
        bound = 1.0 / math.sqrt(27 * c)
        spec.append((f"{name}.cpe_conv.kernel", (27, c, c), bound))
        spec.append((f"{name}.cpe_conv.bias", (1, c), bound))
        linear(f"{name}.cpe_linear", c, c)
        norm(f"{name}.cpe_norm", c, "ln")
        norm(f"{name}.norm1", c, "ln")
        linear(f"{name}.attn.qkv", c, 3 * c)
        linear(f"{name}.attn.proj", c, c)
        norm(f"{name}.norm2", c, "ln")
        linear(f"{name}.fc1", c, cfg["mlp_ratio"] * c)
        linear(f"{name}.fc2", cfg["mlp_ratio"] * c, c)

    enc, dec = _levels(cfg)
    c0 = enc[0][1]
    spec.append(("stem.kernel", (125, cfg["in_channels"], c0),
                 1.0 / math.sqrt(125 * cfg["in_channels"])))
    norm("stem_norm", c0, "bn")
    for s in range(1, len(enc)):
        linear(f"down.{s - 1}.proj", enc[s - 1][1], enc[s][1])
        norm(f"down.{s - 1}.norm", enc[s][1], "bn")
    for s, (depth, c, _) in enumerate(enc):
        for i in range(depth):
            block(f"enc.{s}.{i}", c)
    up_in = [c for _, c, _ in dec[1:]] + [enc[-1][1]]
    for s, (_, c, _) in enumerate(dec):
        linear(f"up.{s}.proj.0", up_in[s], c)
        norm(f"up.{s}.proj.1", c, "bn")
        linear(f"up.{s}.proj_skip.0", enc[s][1], c)
        norm(f"up.{s}.proj_skip.1", c, "bn")
    for s, (depth, c, _) in enumerate(dec):
        for i in range(depth):
            block(f"dec.{s}.{i}", c)
    linear("head", dec[0][1], cfg["out_channels"])
    return spec


def buffers(cfg, device):
    """Fresh batch-norm running statistics, zeros and ones."""
    out = {}
    for name, shape, _ in parameter_spec(cfg):
        if name.endswith(".bn.weight"):
            base = name[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out


# -- the curves ------------------------------------------------------------
def z_order(grid, depth):
    """Morton code, bit by bit."""
    x, y, z = (grid[:, i].to(torch.int64) for i in range(3))
    key = torch.zeros_like(x)
    for i in range(depth):
        bit = 1 << i
        key |= ((x & bit) << (2 * i + 2)) | ((y & bit) << (2 * i + 1)) | ((z & bit) << (2 * i))
    return key


def hilbert(grid, depth):
    """The ``numpy-hilbert-curve`` encoder on bit arrays (most significant
    bit first, x first), as Pointcept vendors it."""
    n = grid.shape[0]
    shifts = torch.arange(depth - 1, -1, -1, device=grid.device)
    bits = ((grid.to(torch.int64)[:, :, None] >> shifts) & 1).bool()  # (n, 3, depth)
    for b in range(depth):
        for d in range(3):
            mask = bits[:, d, b]
            bits[:, 0, b + 1:] ^= mask[:, None]
            flip = ~mask[:, None] & (bits[:, 0, b + 1:] ^ bits[:, d, b + 1:])
            bits[:, d, b + 1:] ^= flip
            bits[:, 0, b + 1:] ^= flip
    gray = bits.transpose(1, 2).reshape(n, 3 * depth)  # level-major, x first
    binary = torch.cumsum(gray.to(torch.int64), 1) % 2  # Gray to binary: prefix parity
    weights = (1 << torch.arange(3 * depth - 1, -1, -1, device=grid.device)).to(torch.int64)
    return (binary * weights).sum(1)


def encode(coords, depth, curve):
    """``batch << 3·depth | code`` of each row, on the grid the rows hold."""
    grid = coords[:, 1:].to(torch.int64)
    if curve.endswith("-trans"):
        grid = grid[:, [1, 0, 2]]
    code = hilbert(grid, depth) if curve.startswith("hilbert") else z_order(grid, depth)
    return (coords[:, 0].to(torch.int64) << (3 * depth)) | code


# -- windows and attention ---------------------------------------------------
def window_plan(order, offsets, K):
    """Pointcept's flash-path padding, scene by scene: (the rows of each full
    window (W, K), the rows of each short window, and for each row its place
    in the outputs laid out full windows first, then the short ones)."""
    order = order.cpu().numpy()
    full, short, owner = [], [], np.empty(len(order), np.int64)
    for a, b in zip(offsets[:-1], offsets[1:]):
        n = b - a
        if n > K:
            w = -(-n // K)
            for j in range(w):
                start = a + min(j * K, n - K)
                full.append(order[start:start + K])
    n_full = len(full)
    place = n_full * K
    for a, b in zip(offsets[:-1], offsets[1:]):
        n = b - a
        if 0 < n <= K:
            short.append(order[a:b])
            owner[order[a:b]] = place + np.arange(n)
            place += n
    window = 0
    for a, b in zip(offsets[:-1], offsets[1:]):
        n = b - a
        if n > K:
            w = -(-n // K)
            p = np.arange(n)
            j = np.minimum(p // K, w - 1)  # the first window that holds it
            owner[order[a:b]] = (window + j) * K + p - np.minimum(j * K, n - K)
            window += w
    return np.array(full, np.int64).reshape(n_full, K), short, owner


class _WindowAttention(torch.autograd.Function):
    """softmax(Q Kᵀ · scale) V over (windows, heads, L, d), in blocks of
    windows; the backward recomputes each block's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, scale, precision):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.precision = scale, precision
        out = torch.empty_like(q)
        for sl in _blocks(q):
            p = _probs(q[sl], k[sl], scale, precision)
            out[sl] = P.matmul(p, v[sl], precision)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, precision = ctx.scale, ctx.precision
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for sl in _blocks(q):
            p = _probs(q[sl], k[sl], scale, precision)
            dv[sl] = P.matmul(p.transpose(-1, -2), g[sl], precision)
            dp = P.matmul(g[sl], v[sl].transpose(-1, -2), precision)
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[sl] = P.matmul(ds, k[sl], precision) * scale
            dk[sl] = P.matmul(ds.transpose(-1, -2), q[sl], precision) * scale
        return dq, dk, dv, None, None


def _blocks(q):
    w, h, length, _ = q.shape
    step = max(1, BLOCK_ELEMENTS // max(1, h * length * length))
    return [slice(i, i + step) for i in range(0, w, step)]


def _probs(q, k, scale, precision):
    return torch.softmax(P.matmul(q, k.transpose(-1, -2), precision) * scale, -1)


def attention(qkv, plan, heads, precision):
    """(N, C) outputs of (N, 3C) packed rows over a ``window_plan``."""
    full, short, owner = plan
    c = qkv.shape[1] // 3
    d = c // heads
    dev = qkv.device

    def attend(rows):
        t = qkv.index_select(0, torch.as_tensor(rows, device=dev).reshape(-1))
        w, length = rows.shape if rows.ndim == 2 else (1, len(rows))
        q, k, v = t.view(w, length, 3, heads, d).permute(2, 0, 3, 1, 4)
        o = _WindowAttention.apply(q, k, v, d ** -0.5, precision)
        return o.transpose(1, 2).reshape(w * length, c)

    outs = ([attend(full)] if len(full) else []) + [attend(r) for r in short]
    return torch.cat(outs).index_select(0, torch.as_tensor(owner, device=dev))


# -- the model ---------------------------------------------------------------
def forward(cfg, p, coords, feats, orders, training=True, precision="float32"):
    """Logits of one batch of scenes: coordinates (N, 4) int32, unique,
    non-negative grid cells; ``orders``, one permutation of ``CURVES`` (as
    indices) per level.  Returns (logits in the rows of the sorted unique
    coordinates, those coordinates)."""
    base_coords, keys, inv = P.unique(coords)
    if base_coords.shape[0] != coords.shape[0]:
        raise ValueError("duplicate coordinates in a voxel cloud")
    maps = P.Maps(P.Map(base_coords, keys, 1), precision)
    K = cfg["patch_size"]
    enc, dec = _levels(cfg)

    def linear(x, name):
        return P.matmul(x, p[f"{name}.linear.weight"].t(), precision) + p[f"{name}.linear.bias"]

    def bn(x, name):
        return F.batch_norm(x, p[f"{name}.bn.running_mean"], p[f"{name}.bn.running_var"],
                            p[f"{name}.bn.weight"], p[f"{name}.bn.bias"], training=training,
                            momentum=0.01, eps=1e-3)

    def ln(x, name):
        return F.layer_norm(x, x.shape[1:], p[f"{name}.ln.weight"], p[f"{name}.ln.bias"], 1e-5)

    # each level's map, curve orders and window plans
    depth0 = int(base_coords[:, 1:].max()).bit_length()
    codes = {c: encode(base_coords, depth0, c) for c in CURVES}
    levels = [dict(map=maps.base, codes=codes)]
    for s in range(1, len(enc)):
        fine = levels[-1]
        coarse_map = maps.at(2 ** s)
        parent = P.lookup(coarse_map.keys, P.pack(_floor(fine["map"].coords, 2 ** s)))
        coarse = {c: torch.zeros(coarse_map.n, dtype=torch.int64, device=coords.device)
                  .scatter_(0, parent, code >> 3) for c, code in fine["codes"].items()}
        levels.append(dict(map=coarse_map, codes=coarse, parent=parent))
    for s, level in enumerate(levels):
        m = level["map"]
        offsets = torch.searchsorted(m.coords[:, 0].contiguous(),
                                     torch.arange(int(m.coords[:, 0].max()) + 2,
                                                  device=coords.device, dtype=torch.int32)).tolist()
        level["curves"] = [CURVES[i] for i in orders[s]]
        level["plans"] = {}
        for c in level["curves"]:
            level["plans"][c] = window_plan(torch.argsort(level["codes"][c]), offsets, K)

    def block(x, name, level, i, heads):
        cpe = maps.conv(x, p[f"{name}.cpe_conv.kernel"], 3).feats + p[f"{name}.cpe_conv.bias"]
        f = x.feats + ln(linear(cpe, f"{name}.cpe_linear"), f"{name}.cpe_norm")
        curve = level["curves"][i % len(level["curves"])]
        qkv = linear(ln(f, f"{name}.norm1"), f"{name}.attn.qkv")
        f = f + linear(attention(qkv, level["plans"][curve], heads, precision), f"{name}.attn.proj")
        h = F.gelu(linear(ln(f, f"{name}.norm2"), f"{name}.fc1"))
        return P.Sparse(x.map, f + linear(h, f"{name}.fc2"))

    x0 = torch.zeros_like(feats).index_copy_(0, inv, feats)
    x = maps.conv(P.Sparse(maps.base, x0), p["stem.kernel"], 5)
    x = P.Sparse(maps.base, F.gelu(bn(x.feats, "stem_norm")))
    skips = []
    for s, (depth, _, heads) in enumerate(enc):
        if s:
            skips.append(x)
            parent = levels[s]["parent"]
            h = linear(x.feats, f"down.{s - 1}.proj")
            pooled = h.new_full((levels[s]["map"].n, h.shape[1]), -math.inf)
            pooled = pooled.scatter_reduce(0, parent[:, None].expand_as(h), h, "amax",
                                           include_self=False)
            x = P.Sparse(levels[s]["map"], F.gelu(bn(pooled, f"down.{s - 1}.norm")))
        for i in range(depth):
            x = block(x, f"enc.{s}.{i}", levels[s], i, heads)
    for s in reversed(range(len(dec))):
        depth, _, heads = dec[s]
        up = F.gelu(bn(linear(x.feats, f"up.{s}.proj.0"), f"up.{s}.proj.1"))
        skip = skips[s]
        fine = F.gelu(bn(linear(skip.feats, f"up.{s}.proj_skip.0"), f"up.{s}.proj_skip.1"))
        x = P.Sparse(skip.map, fine + up.index_select(0, levels[s + 1]["parent"]))
        for i in range(depth):
            x = block(x, f"dec.{s}.{i}", levels[s], i, heads)
    return linear(x.feats, "head"), base_coords


def _floor(coords, stride):
    c = coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    return c
