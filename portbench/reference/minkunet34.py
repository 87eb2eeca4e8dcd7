"""Plain PyTorch MinkUNet34 (NVIDIA/MinkowskiEngine v0.5.4,
``examples/minkunet.py``; Choy et al., CVPR 2019).

``parameter_spec`` lists every parameter under the upstream state-dict
names with its shape and initial law; the benchmark draws one set of
weights from it and hands it to the port and to ``forward`` alike.
``forward`` runs the U-Net on one cloud with ``plain``'s own coordinate
code: a k = 5 stem, four k = 2 stride-2 convs each followed by BasicBlocks
(two k = 3 convs, batch norm, ReLU, residual, a k = 1 projection where the
width changes), four k = 2 transposed convs back onto the encoder's maps
with the skip concatenated after, and a k = 1 classifier with a bias.
"""

from __future__ import annotations

import math

import torch

from . import plain as P


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


def parameter_spec(cfg):
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


def buffers(cfg, device):
    """Fresh batch-norm running statistics, zeros and ones."""
    out = {}
    for name, shape, stdv in parameter_spec(cfg):
        if name.endswith(".bn.weight"):
            base = name[: -len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out


def forward(cfg, p, coords, feats, training, precision="float32", bn_momentum=0.1):
    """Logits of one cloud: coordinates (N, 4) int32, unique; returns
    (logits in the rows of ``maps.base``, the maps)."""
    base_coords, keys, inv = P.unique(coords)
    if base_coords.shape[0] != coords.shape[0]:
        raise ValueError("duplicate coordinates in a voxel cloud")
    x0 = torch.zeros_like(feats).index_copy_(0, inv, feats)
    maps = P.Maps(P.Map(base_coords, keys, 1), precision)
    relu = torch.relu

    def bn(x, name):
        return P.batch_norm(x, p, f"{name}.bn", training, bn_momentum)

    def act(x):
        return P.Sparse(x.map, relu(x.feats))

    def block(x, name):
        out = act(bn(maps.conv(x, p[f"{name}.conv1.kernel"], 3), f"{name}.norm1"))
        out = bn(maps.conv(out, p[f"{name}.conv2.kernel"], 3), f"{name}.norm2")
        res = x
        if f"{name}.downsample.0.kernel" in p:
            res = bn(maps.conv(x, p[f"{name}.downsample.0.kernel"], 1), f"{name}.downsample.1")
        return act(P.Sparse(out.map, out.feats + res.feats))

    def stage(x, s):
        for b in range(cfg["layers"][s]):
            x = block(x, f"block{s + 1}.{b}")
        return x

    x = P.Sparse(maps.base, x0)
    skips = [act(bn(maps.conv(x, p["conv0p1s1.kernel"], 5), "bn0"))]
    out = skips[0]
    for s in range(4):
        out = act(bn(maps.conv(out, p[f"conv{s + 1}p{2**s}s2.kernel"], 2, stride=2), f"bn{s + 1}"))
        out = stage(out, s)
        skips.append(out)
    for s in range(4, 8):
        target = maps.at(out.map.stride // 2)
        out = maps.conv_tr(out, p[f"convtr{s}p{2 ** (8 - s)}s2.kernel"], 2, target)
        out = P.cat(act(bn(out, f"bntr{s}")), skips[7 - s])
        out = stage(out, s)
    logits = P.matmul(out.feats, p["final.kernel"], precision) + p["final.bias"]
    return logits, maps
