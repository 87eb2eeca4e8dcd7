"""Plain PyTorch Point Transformer V3, the port's yardstick in the CPU tests.

Float32 ``torch`` with TF32 off; no JAX and nothing of the port: its own
key packing, unique, stride and kernel maps, per-offset ``index_select`` +
matmul convs, curve codes, window plan and attention.  Written from the
published model (Wu et al., CVPR 2024, arXiv:2312.10035; Pointcept
``configs/scannet/semseg-pt-v3m1-0-base.py``):

* curves: Morton by bit loops (x's bit i to 3i + 2, y's to 3i + 1, z's to
  3i), Hilbert by the ``numpy-hilbert-curve`` encoder's bit arrays,
  ``-trans`` with x and y swapped, ``batch << 3·depth`` above, ``depth`` the
  bit length of the input's largest grid coordinate; a pooled level's code
  is its fine rows' code shifted right by 3, as ``SerializedPooling`` takes
  it;
* windows: Pointcept's flash-path padding, scene by scene on the host;
* attention: explicit ``softmax(Q Kᵀ · head_dim^-0.5) V`` per window, in
  blocks of windows.

``precision="tf32"`` rounds every product's operands to TF32 (10-bit
mantissa), the lower precision the tests' tolerances must catch.
Parameters come by the port's names (``parameter_spec``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CURVES = ("z", "z-trans", "hilbert", "hilbert-trans")
BITS, BIAS = 18, 1 << 17
BLOCK_ELEMENTS = 1 << 24


# -- keys, maps and convs ----------------------------------------------------
def pack(coords):
    c = coords.to(torch.int64)
    key = c[:, 0]
    for d in (1, 2, 3):
        key = (key << BITS) | (c[:, d] + BIAS)
    return key


def unique(coords):
    """(sorted unique coordinates, their keys, inverse of each row)."""
    keys, inverse = torch.unique(pack(coords), sorted=True, return_inverse=True)
    mask = (1 << BITS) - 1
    cols = [((keys >> (BITS * (3 - d))) & mask) - BIAS for d in (1, 2, 3)]
    return torch.stack([keys >> (3 * BITS), *cols], 1).to(torch.int32), keys, inverse


def lookup(sorted_keys, queries):
    pos = torch.searchsorted(sorted_keys, queries).clamp_(max=sorted_keys.numel() - 1)
    return torch.where(sorted_keys[pos] == queries, pos, -1)


def floor_to(coords, stride):
    c = coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], stride, rounding_mode="floor") * stride
    return c


def tf32(x):
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def matmul(a, b, precision):
    if precision == "tf32":
        a = a + (tf32(a.detach()) - a.detach())
        b = b + (tf32(b.detach()) - b.detach())
    return a @ b


def conv(feats, coords, keys, kernel, kernel_size, stride, precision):
    """Submanifold conv on one map: the sum over offsets (axis 0 fastest,
    centred, times the map's stride) of ``W[k]`` times the row at out + offset."""
    r = torch.arange(kernel_size) - kernel_size // 2
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    offsets = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], 1) * stride
    out = feats.new_zeros((feats.shape[0], kernel.shape[2]))
    for k, off in enumerate(offsets):
        q = coords.to(torch.int64).clone()
        q[:, 1:] += off
        rows = lookup(keys, pack(q))
        hit = torch.nonzero(rows >= 0).squeeze(1)
        out = out.index_add(0, hit, matmul(feats.index_select(0, rows[hit]), kernel[k], precision))
    return out


# -- parameters --------------------------------------------------------------
def _levels(cfg):
    enc = list(zip(cfg["enc_depths"], cfg["enc_channels"], cfg["enc_num_head"]))
    dec = list(zip(cfg["dec_depths"], cfg["dec_channels"], cfg["dec_num_head"]))
    return enc, dec


def parameter_spec(cfg):
    """[(name, shape, uniform bound or None for a norm's ones and zeros)]."""
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
    spec.append(("stem.kernel", (125, cfg["in_channels"], enc[0][1]),
                 1.0 / math.sqrt(125 * cfg["in_channels"])))
    norm("stem_norm", enc[0][1], "bn")
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


def make_params(cfg, seed):
    """Every parameter from ``seed``: U(-b, b) by its bound, norms 1 and 0."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, bound in parameter_spec(cfg):
        if bound is None:
            out[name] = torch.full(shape, 1.0 if name.endswith(".weight") else 0.0)
        else:
            out[name] = (torch.rand(shape, generator=gen) * 2 - 1) * bound
    return out


# -- curves ------------------------------------------------------------------
def z_order(grid, depth):
    x, y, z = (grid[:, i].to(torch.int64) for i in range(3))
    key = torch.zeros_like(x)
    for i in range(depth):
        bit = 1 << i
        key |= ((x & bit) << (2 * i + 2)) | ((y & bit) << (2 * i + 1)) | ((z & bit) << (2 * i))
    return key


def hilbert(grid, depth):
    """The ``numpy-hilbert-curve`` encoder on bit arrays."""
    n = grid.shape[0]
    shifts = torch.arange(depth - 1, -1, -1)
    bits = ((grid.to(torch.int64)[:, :, None] >> shifts) & 1).bool()  # (n, 3, depth), MSB first
    for b in range(depth):
        for d in range(3):
            mask = bits[:, d, b]
            bits[:, 0, b + 1:] ^= mask[:, None]
            flip = ~mask[:, None] & (bits[:, 0, b + 1:] ^ bits[:, d, b + 1:])
            bits[:, d, b + 1:] ^= flip
            bits[:, 0, b + 1:] ^= flip
    gray = bits.transpose(1, 2).reshape(n, 3 * depth)
    binary = torch.cumsum(gray.to(torch.int64), 1) % 2
    return (binary * (1 << torch.arange(3 * depth - 1, -1, -1))).sum(1)


def encode(coords, depth, curve):
    grid = coords[:, 1:].to(torch.int64)
    if curve.endswith("-trans"):
        grid = grid[:, [1, 0, 2]]
    code = hilbert(grid, depth) if curve.startswith("hilbert") else z_order(grid, depth)
    return (coords[:, 0].to(torch.int64) << (3 * depth)) | code


# -- windows and attention ---------------------------------------------------
def window_plan(order, offsets, K):
    """(full windows' rows (W, K), short windows' rows, each row's place in
    the outputs: full windows first, then short ones, the first window
    that holds a row giving its output)."""
    order = order.numpy()
    full, short, owner = [], [], np.empty(len(order), np.int64)
    scenes = list(zip(offsets[:-1], offsets[1:]))
    for a, b in scenes:
        n = b - a
        if n > K:
            for j in range(-(-n // K)):
                start = a + min(j * K, n - K)
                full.append(order[start:start + K])
    place, window = len(full) * K, 0
    for a, b in scenes:
        n = b - a
        if 0 < n <= K:
            short.append(order[a:b])
            owner[order[a:b]] = place + np.arange(n)
            place += n
        elif n > K:
            w = -(-n // K)
            for p in range(n):
                j = min(p // K, w - 1)
                owner[order[a + p]] = (window + j) * K + p - min(j * K, n - K)
            window += w
    return np.array(full, np.int64).reshape(-1, K), short, owner


def attention(qkv, plan, heads, precision):
    full, short, owner = plan
    c = qkv.shape[1] // 3
    d = c // heads
    outs = []
    for rows in ([full] if len(full) else []) + [r[None] for r in short]:
        w, length = rows.shape
        t = qkv.index_select(0, torch.from_numpy(rows.reshape(-1)))
        q, k, v = t.view(w, length, 3, heads, d).permute(2, 0, 3, 1, 4)
        step = max(1, BLOCK_ELEMENTS // (heads * length * length))
        for i in range(0, w, step):  # blocks of windows
            s = matmul(q[i:i + step], k[i:i + step].transpose(-1, -2), precision) * d ** -0.5
            o = matmul(torch.softmax(s, -1), v[i:i + step], precision)
            outs.append(o.transpose(1, 2).reshape(-1, c))
    return torch.cat(outs).index_select(0, torch.from_numpy(owner))


# -- the model ---------------------------------------------------------------
def forward(cfg, p, coords, feats, orders, training=True, precision="float32", state=None):
    """Logits of a batch of scenes (coordinates (N, 4) int32, unique,
    non-negative): (logits in the rows of the sorted unique coordinates,
    those coordinates).  ``orders``: one permutation of ``CURVES`` (indices)
    per level.  ``state`` holds the batch norms' running statistics (fresh
    where None)."""
    coords0, keys0, inv = unique(coords)
    K = cfg["patch_size"]
    enc, dec = _levels(cfg)
    state = {} if state is None else state

    def linear(x, name):
        return matmul(x, p[f"{name}.linear.weight"].t(), precision) + p[f"{name}.linear.bias"]

    def bn(x, name):
        c = x.shape[1]
        mean = state.setdefault(f"{name}.bn.running_mean", torch.zeros(c))
        var = state.setdefault(f"{name}.bn.running_var", torch.ones(c))
        return F.batch_norm(x, mean, var, p[f"{name}.bn.weight"], p[f"{name}.bn.bias"],
                            training=training, momentum=0.01, eps=1e-3)

    def ln(x, name):
        return F.layer_norm(x, x.shape[1:], p[f"{name}.ln.weight"], p[f"{name}.ln.bias"], 1e-5)

    depth0 = int(coords0[:, 1:].max()).bit_length()
    levels = [dict(coords=coords0, keys=keys0,
                   codes={c: encode(coords0, depth0, c) for c in CURVES})]
    for s in range(1, len(enc)):
        fine = levels[-1]
        c_s, k_s, _ = unique(floor_to(fine["coords"], 2 ** s))
        parent = lookup(k_s, pack(floor_to(fine["coords"], 2 ** s)))
        codes = {c: torch.zeros(len(c_s), dtype=torch.int64).scatter_(0, parent, code >> 3)
                 for c, code in fine["codes"].items()}
        levels.append(dict(coords=c_s, keys=k_s, codes=codes, parent=parent))
    for s, level in enumerate(levels):
        batch = level["coords"][:, 0].contiguous()
        offsets = torch.searchsorted(batch, torch.arange(int(batch.max()) + 2, dtype=batch.dtype))
        level["curves"] = [CURVES[i] for i in orders[s]]
        level["plans"] = {c: window_plan(torch.argsort(level["codes"][c]), offsets.tolist(), K)
                          for c in level["curves"]}

    def block(f, name, s, i, heads):
        level = levels[s]
        cpe = conv(f, level["coords"], level["keys"], p[f"{name}.cpe_conv.kernel"], 3, 2 ** s,
                   precision) + p[f"{name}.cpe_conv.bias"]
        f = f + ln(linear(cpe, f"{name}.cpe_linear"), f"{name}.cpe_norm")
        qkv = linear(ln(f, f"{name}.norm1"), f"{name}.attn.qkv")
        plan = level["plans"][level["curves"][i % len(level["curves"])]]
        f = f + linear(attention(qkv, plan, heads, precision), f"{name}.attn.proj")
        h = F.gelu(linear(ln(f, f"{name}.norm2"), f"{name}.fc1"))
        return f + linear(h, f"{name}.fc2")

    x = torch.zeros_like(feats).index_copy_(0, inv, feats)
    x = F.gelu(bn(conv(x, coords0, keys0, p["stem.kernel"], 5, 1, precision), "stem_norm"))
    skips = []
    for s, (depth, _, heads) in enumerate(enc):
        if s:
            skips.append(x)
            parent = levels[s]["parent"]
            h = linear(x, f"down.{s - 1}.proj")
            pooled = h.new_full((len(levels[s]["coords"]), h.shape[1]), -math.inf)
            pooled = pooled.scatter_reduce(0, parent[:, None].expand_as(h), h, "amax",
                                           include_self=False)
            x = F.gelu(bn(pooled, f"down.{s - 1}.norm"))
        for i in range(depth):
            x = block(x, f"enc.{s}.{i}", s, i, heads)
    for s in reversed(range(len(dec))):
        depth, _, heads = dec[s]
        up = F.gelu(bn(linear(x, f"up.{s}.proj.0"), f"up.{s}.proj.1"))
        x = F.gelu(bn(linear(skips[s], f"up.{s}.proj_skip.0"), f"up.{s}.proj_skip.1"))
        x = x + up.index_select(0, levels[s + 1]["parent"])
        for i in range(depth):
            x = block(x, f"dec.{s}.{i}", s, i, heads)
    return linear(x, "head"), coords0
