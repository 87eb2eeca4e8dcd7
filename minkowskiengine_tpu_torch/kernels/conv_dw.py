"""Sparse-convolution weight gradient, ``dW[k] = Σ_o X[idx[k,o]]ᵀ ⊗ G[o]``.

``conv_dw`` launches the hand-written CUDA kernel (``csrc/conv_dw.cu``) for
CUDA tensors and runs the plain PyTorch version, ``conv_dw_reference``, for
CPU tensors.  There is no fallback between the two: on a CUDA tensor the
kernel runs, or the call raises.

It replaces the JAX package's Pallas dW family behind
``minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas``,
which takes float32 or bf16 ``x`` and ``g`` and always writes a float32 dW.
The kernel has a float32 instance (3xTF32 tensor-core products) and a bf16
one (bf16 tensor-core products, float32 sums, a float32 dW).  The plan
picks the body from the shapes: bf16 calls with Cin and Cout multiples of 8
and 16-byte aligned operands run the ``wgmma`` body and bf16 calls with
Cin <= 4 the ``mma.sync`` stem (``"stem_mma"``), both in
``csrc/conv_dw_wgmma.cu``; other Cin > 4 calls the ``mma.sync`` body
(``"mma"``), float32 calls with Cin <= 4 the SIMT stem (``"simt"``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling as P
from . import build
from .gather_gemm import MMA_STAGES, copy_width, wgmma_tile

ROWS_PER_SCAN = 256  # SCAN in csrc/conv_dw.cu: the unit of the row split
BLOCKS_PER_SM = 4  # blocks per SM the row split aims to fill
WORKSPACE_CAP = 16 * 2**20  # bytes of (S, K, Cin, Cout) partials: stays in the 50 MB L2
COUT_TILES = (32, 64, 96, 128)  # the mma.sync bodies' Cout tiles
BODIES = ("wgmma", "mma", "stem_mma", "simt")
STEM_STAGES = 4  # the bf16 stem's ring


def conv_dw_reference(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch weight gradient: per offset, gather rows (an index of
    -1, or any index outside [0, N_in), gathers a zero row), then one
    ``xᵀ @ g``.  bf16 inputs give what the bf16 instance gives: each
    product exact in float32, the sums in float32, a float32 dW."""
    if x.dtype == torch.bfloat16:
        return conv_dw_reference(x.float(), g.float(), idx)
    n_in = x.shape[0]
    padded = torch.cat([x, x.new_zeros(1, x.shape[1])])
    safe = torch.where((idx >= 0) & (idx < n_in), idx, n_in).long()
    dw = x.new_zeros(idx.shape[0], x.shape[1], g.shape[1])
    for k in range(idx.shape[0]):
        dw[k] = padded.index_select(0, safe[k]).T @ g
    return dw


def _check(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> None:
    if x.ndim != 2 or g.ndim != 2 or idx.ndim != 2:
        raise ValueError(
            f"expected x (N_in, Cin), g (N_out, Cout), idx (K, N_out); got "
            f"{tuple(x.shape)}, {tuple(g.shape)}, {tuple(idx.shape)}"
        )
    if g.shape[0] != idx.shape[1]:
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, idx {tuple(idx.shape)}")
    if x.device != g.device or x.device != idx.device:
        raise ValueError(
            f"x, g and idx must share a device: {x.device}, {g.device}, {idx.device}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float64) or g.dtype != x.dtype:
        raise TypeError(
            f"x and g must both be float32 or bf16 (or float64 on the CPU), got {x.dtype}, "
            f"{g.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")


class Plan(NamedTuple):
    """How ``conv_dw`` launches its kernel, chosen from shapes alone."""

    splits: int  # row ranges S; > 1: partial tiles summed in order by a second pass
    cin_tile: int
    cout_tile: int
    vec: int  # elements per copy, as gather_gemm.Plan.vec
    # "wgmma" (bf16, Hopper's warpgroup products), "mma" (mma.sync tensor
    # cores), "stem_mma" (bf16, Cin <= 4 on mma.sync) or "simt" (float32,
    # Cin <= 4)
    body: str
    stages: int = MMA_STAGES  # the ring's depth (the SIMT stem stages one tile at a time: 1)

    def blocks(self, k_vol: int, cin: int, cout: int) -> int:
        """Blocks of one row range."""
        return -(-cin // self.cin_tile) * -(-cout // self.cout_tile) * k_vol

    def workspace_bytes(self, k_vol: int, cin: int, cout: int) -> int:
        return 4 * self.splits * k_vol * cin * cout if self.splits > 1 else 0


def cout_tile(cout: int) -> int:
    """The Cout tile of the mma.sync bodies: the fewest tiles of at most 128
    channels, each rounded up to a multiple of 32 (96 -> one 96-wide tile,
    256 -> two of 128)."""
    per_tile = -(-cout // -(-cout // COUT_TILES[-1]))
    return -(-per_tile // 32) * 32


def wgmma_cin_tile(cin: int, tile: int) -> int:
    """The K2 wgmma body's Cin tile: 128 (two warpgroups along Cin sharing
    each stage's G rows, which are then gathered half as often) for Cin >
    64 and Cout tiles of 64, 96 or 128, else 64."""
    return 128 if cin > 64 and tile in (64, 96, 128) else 64


def wgmma_stages(tile: int, cin_tile: int = 64) -> int:
    """The K2 wgmma body's ring depth (``DTile::STAGES`` in
    csrc/conv_dw_wgmma.cu): as many stages of 64 compacted rows of X and G
    as fit beside the compaction ring in the shared memory of two blocks an
    SM (one warpgroup) or one, at most 8."""
    groups = cin_tile // 64 * (2 if tile > 128 else 1)
    fixed = 1024 + (2 * 512 + 4 * groups) * 4
    limit = (113 if groups == 1 else 227) * 1024
    return min(8, (limit - fixed) // (128 * (cin_tile + tile)))


def choose_body(cin: int, vec: int, bf16: bool, body: str | None) -> str:
    """The body for these widths: Cin <= 4 the stem (bf16 ``stem_mma``,
    float32 ``simt``); bf16 with 16-byte copies (Cin and Cout multiples of
    8, aligned operands) ``wgmma``; else ``mma``.  ``body`` asks for one,
    which must take the shapes (the bf16 stem may take ``simt``)."""
    stem = cin <= 4
    best = ("stem_mma" if bf16 else "simt") if stem else "wgmma" if bf16 and vec == 8 else "mma"
    if body is None:
        return best
    fits = body == best or (body == "simt" and stem) or (body == "mma" and not stem)
    if body not in BODIES or not fits:
        raise ValueError(f"the {body!r} body does not take Cin {cin}, copy width {vec}"
                         f"{', bf16' if bf16 else ', float32'}")
    return body


def plan(k_vol: int, cin: int, cout: int, n_out: int, sms: int, aligned: bool = True,
         bf16: bool = False, body: str | None = None) -> Plan:
    """The body (``choose_body``) and its tiles fitted to the channels (the
    wgmma body's from ``gather_gemm.wgmma_tile`` and ``wgmma_cin_tile``),
    and the row split: enough row ranges that the grid fills
    ``BLOCKS_PER_SM`` blocks per SM, no more than 256-row scans, and no
    more than keep the workspace within ``WORKSPACE_CAP``.  ``aligned``:
    both input pointers are 16-byte aligned; ``bf16``: the bf16 instance;
    ``body``: a body to take in place of the plan's choice (to compare
    bodies)."""
    vec = copy_width(cin, cout, aligned, bf16)
    body = choose_body(cin, vec, bf16, body)
    if body == "simt":
        p = Plan(1, 4, 64, 1, "simt", 1)
    elif body == "stem_mma":  # N = Cin padded to 8; G copies as wide as Cout allows
        p = Plan(1, 8, 64, copy_width(cout, cout, aligned, True), "stem_mma", STEM_STAGES)
    elif body == "wgmma":
        tile = wgmma_tile(cout)
        cin_tile = wgmma_cin_tile(cin, tile)
        p = Plan(1, cin_tile, tile, vec, "wgmma", wgmma_stages(tile, cin_tile))
    else:
        n_tile = cout_tile(cout)
        p = Plan(1, 32 if cin <= 32 and n_tile <= 64 else 64, n_tile, vec, "mma")
    want = -(-BLOCKS_PER_SM * sms // p.blocks(k_vol, cin, cout))
    scans = -(-n_out // ROWS_PER_SCAN)
    fit = WORKSPACE_CAP // (4 * k_vol * cin * cout)
    return p._replace(splits=max(1, min(want, scans, fit)))


def conv_dw(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, *,
            body: str | None = None) -> torch.Tensor:
    """``dW[k] = Σ_o x[idx[k, o], :]ᵀ ⊗ g[o, :]`` with -1 = no pair.

    Args:
      x: (N_in, Cin) float32 or bf16; float64 is taken on the CPU too (the
        plain version is type-generic), for checks against a float64 run.
      g: (N_out, Cout), of x's type.
      idx: (K, N_out) int32.
      body: on the card, a body to run in place of the plan's choice
        (``"wgmma"``, ``"mma"``, ``"stem_mma"`` or ``"simt"``), to compare
        bodies on the same inputs; it must take the shapes.  The CPU
        ignores it.

    Returns (K, Cin, Cout): float32 for float32 and bf16 inputs (float64
    for float64).  ``conv_dw.launches`` counts the float32 instance's
    launches, ``conv_dw.bf16_launches`` the bf16 instance's and
    ``conv_dw.bf16_body_launches`` the bf16 launches by body (CPU calls run
    the plain version and count nothing); ``conv_dw.last_plan`` is the
    ``Plan`` of the last launch.  The sum over rows is deterministic: two
    launches on the same inputs give the same bits.
    """
    _check(x, g, idx)
    if x.device.type == "cpu":
        return conv_dw_reference(x, g, idx)
    if x.device.type != "cuda":
        raise ValueError(f"conv_dw runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bf16, got {x.dtype}")
    for name, t in (("x", x), ("g", g), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_in, cin = x.shape
    k_vol, n_out = idx.shape
    cout = g.shape[1]
    if max(n_in, n_out, k_vol, cin, cout) >= 2**31:  # passed as C ints
        raise ValueError("conv_dw dimensions must fit in int32")
    out = torch.empty((k_vol, cin, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    p = plan(k_vol, cin, cout, n_out, sms, aligned, bf16, body)
    with P.span("k2." + p.body), torch.cuda.device(x.device):
        ws = None
        if p.splits > 1:  # per-split partial tiles, summed in order by a second pass
            ws = torch.empty((p.splits, k_vol, cin, cout), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        lib = build.library()
        pointers = (x.data_ptr(), g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr())
        sizes = (n_in, n_out, k_vol, cin, cout, p.splits)
        if p.body == "wgmma":
            err = lib.me_conv_dw_bf16_wgmma(*pointers, *sizes, p.cout_tile, p.cin_tile, stream)
        elif p.body == "stem_mma":
            err = lib.me_conv_dw_bf16_stem(*pointers, *sizes, p.vec, stream)
        else:
            err = (lib.me_conv_dw_bf16 if bf16 else lib.me_conv_dw_f32)(
                *pointers, *sizes, p.cin_tile, p.cout_tile, p.vec, stream)
    if err != 0:
        raise RuntimeError(f"conv_dw kernel launch failed: cudaError {err} ({p})")
    if bf16:
        conv_dw.bf16_launches += 1
        conv_dw.bf16_body_launches[p.body] += 1
    else:
        conv_dw.launches += 1
    conv_dw.last_plan = p
    return out


conv_dw.launches = 0
conv_dw.bf16_launches = 0
conv_dw.bf16_body_launches = dict.fromkeys(BODIES, 0)
conv_dw.last_plan = None
