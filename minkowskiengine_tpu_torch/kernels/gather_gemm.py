"""Gather-GEMM: the sparse-convolution forward, ``out[o] = Σ_k X[idx[k,o]] @ W[k]``.

``gather_gemm`` launches the hand-written CUDA kernel
(``csrc/gather_gemm.cu``) for CUDA tensors and runs the plain PyTorch
version, ``gather_gemm_reference``, for CPU tensors.  There is no fallback
between the two: on a CUDA tensor the kernel runs, or the call raises.

It replaces the JAX package's Pallas forward family behind
``minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_fwd_pallas``,
which takes float32 or bf16 features.  The kernel has two instances: float32
(3xTF32 tensor-core products) and bf16 (bf16 tensor-core products with a
float32 sum, rounded to bf16 once at the end, as the Pallas body does).
The plan picks the body from the shapes: calls with Cin and Cout multiples
of 8 and 16-byte aligned operands run a ``wgmma`` body, bf16 ``"wgmma"``
(``csrc/gather_gemm_wgmma.cu``) and float32 ``"wgmma_3xtf32"``
(``csrc/gather_gemm_wgmma_f32.cu``, 3xTF32 warpgroup products; each
stage's W[k] chunk is transposed and split into its tf32 halves in shared
memory); other Cin > 4 calls the ``mma.sync`` body (``"mma"``), Cin <= 4
the SIMT stem (``"simt"``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling as P
from . import build

ROWS_PER_TILE = 64  # BM in csrc/gather_gemm.cu and csrc/gather_gemm_wgmma.cu
COUT_PER_TILE = 64  # BN of the mma.sync and SIMT bodies
MMA_STAGES = 3  # the mma.sync bodies' ring
BLOCKS_PER_SM = 2  # blocks per SM the offset split aims for
WORKSPACE_CAP = 16 * 2**20  # bytes of (S, N_out, Cout) partials: stays in the 50 MB L2
# the wgmma bodies' Cout tiles (wgmma N), K1's and K2's alike
WGMMA_TILES = (16, 32, 48, 64, 96, 128, 192, 256)
BODIES = ("wgmma", "wgmma_3xtf32", "mma", "simt")
BF16_BODIES = ("wgmma", "mma", "simt")
F32_BODIES = ("wgmma_3xtf32", "mma", "simt")


class Plan(NamedTuple):
    """How ``gather_gemm`` launches its kernel, chosen from shapes alone."""

    splits: int  # offset ranges S; > 1: partial tiles summed in order by a second pass
    offsets_per_split: int
    # elements per cp.async copy: float32 4 (16 bytes) or 1 (4 bytes); bf16 8
    # (16 bytes), 2 (4 bytes) or 1 (plain 2-byte loads, odd widths)
    vec: int
    # "wgmma" (bf16) or "wgmma_3xtf32" (float32), Hopper's warpgroup
    # products; "mma" (mma.sync tensor cores) or "simt" (Cin <= 4, the stem)
    body: str
    tile: int = COUT_PER_TILE  # output channels per block (BN)
    stages: int = MMA_STAGES  # the ring's depth (the SIMT stem stages one tile at a time: 1)
    row_tile: int = ROWS_PER_TILE  # output rows per block: 64, or 128 (two warpgroups)

    def workspace_bytes(self, n_out: int, cout: int) -> int:
        return 4 * self.splits * n_out * cout if self.splits > 1 else 0


def wgmma_tile(cout: int, widest: int = 256) -> int:
    """The wgmma bodies' Cout tile: the fewest tiles of at most ``widest``
    channels (K1's float32 body: 128), each rounded up to the next of
    ``WGMMA_TILES`` (96 -> one 96-wide tile, 336 -> two of 192, 1024 ->
    four of 256; at 128, 256 -> two of 128)."""
    per_tile = -(-cout // -(-cout // widest))
    return next(t for t in WGMMA_TILES if t >= per_tile)


def wgmma_stages(tile: int, row_tile: int = ROWS_PER_TILE, f32: bool = False) -> int:
    """The K1 wgmma bodies' ring depth (``WTile::STAGES`` in
    csrc/gather_gemm_wgmma.cu, ``FTile::STAGES`` in
    csrc/gather_gemm_wgmma_f32.cu): as many stages of row_tile rows of 128
    bytes of X (64 bf16 or 32 float32) and W[k]'s chunk for the tile (64 x
    tile bf16, 32 x tile float32) as fit beside the staged indices (and, for
    float32, two pairs of the chunk's split tf32 tiles) in the shared memory
    of two blocks an SM or one (``wgmma_blocks_per_sm``), at most 8."""
    fixed = 1024 + (32 * row_tile + 2 * 32 + 4) * 4
    limit = (113 if wgmma_blocks_per_sm(tile, row_tile, f32) == 2 else 227) * 1024
    if f32:  # W[k]'s chunk as it lies (rows padded by 16 bytes), and two pairs of split tiles
        return min(8, (limit - fixed - 4 * tile * 128) // (row_tile * 128 + 32 * (tile + 4) * 4))
    return min(8, (limit - fixed) // (row_tile * 128 + tile * 128))


def wgmma_row_tile(tile: int, f32: bool = False) -> int:
    """Output rows per block of the K1 wgmma bodies: 128 where two
    warpgroups share each stage's W[k] chunk, which is then read from L2
    half as often per row (W[k] outweighs the X rows there): bf16 Cout
    tiles of 96 and more, every float32 tile (a float32 stage's W[k] chunk
    outweighs its paired X rows from a 32-wide tile on); else 64."""
    return 128 if f32 or tile >= 96 else ROWS_PER_TILE


def wgmma_blocks_per_sm(tile: int, row_tile: int, f32: bool = False) -> int:
    """Blocks of a K1 wgmma body an SM holds (``WTile::LIMIT``; the float32
    body one, ``FTile::LIMIT``): two of one warpgroup for bf16 Cout tiles up
    to 128, else one."""
    return 2 if not f32 and row_tile == ROWS_PER_TILE and tile <= 128 else 1


def copy_width(cin: int, cout: int, aligned: bool, bf16: bool) -> int:
    """Elements per copy of the tensor-core instances: the widest copy of
    16 or 4 bytes (or, for bf16, one 2-byte element) whose element count
    divides Cin and Cout; 16 bytes only when ``aligned`` (both data pointers
    16-byte aligned)."""
    widths = (8, 2, 1) if bf16 else (4, 1)
    for v in widths:
        if cin % v == 0 and cout % v == 0 and (aligned or v * (2 if bf16 else 4) < 16):
            return v
    return 1


def choose_body(cin: int, cout: int, vec: int, bf16: bool, body: str | None) -> str:
    """The body for these widths: Cin <= 4 the SIMT stem; 16-byte copies
    (aligned operands) with Cin and Cout multiples of 8 a ``wgmma`` body,
    ``"wgmma"`` for bf16 and ``"wgmma_3xtf32"`` for float32; else ``mma``.
    ``body`` asks for one, which must take the shapes."""
    wide = vec * (2 if bf16 else 4) == 16 and cin % 8 == 0 and cout % 8 == 0
    best = ("simt" if cin <= 4 else ("wgmma" if bf16 else "wgmma_3xtf32") if wide
            else "mma")
    if body is None:
        return best
    if body not in BODIES or (body == "simt") != (cin <= 4) or (
            body.startswith("wgmma") and best != body):
        raise ValueError(f"the {body!r} body does not take Cin {cin}, Cout {cout}, copy width "
                         f"{vec}{', bf16' if bf16 else ', float32'}")
    return body


def plan(n_out: int, k_vol: int, cin: int, cout: int, sms: int, aligned: bool = True,
         bf16: bool = False, body: str | None = None) -> Plan:
    """The body and its Cout tile and ring (``choose_body``; the wgmma
    bodies' tiles from ``wgmma_tile`` and ``wgmma_row_tile``), and the
    offset split: when the row x Cout tiles number fewer than
    ``BLOCKS_PER_SM`` per SM (the wgmma bodies: than the blocks the SMs
    hold), each block takes a contiguous range of offsets, enough ranges to
    fill the SMs (the wgmma bodies: no more than fill them once), no more
    than ``k_vol``, and no more than keep the float32 workspace within
    ``WORKSPACE_CAP``.  ``aligned``: both input pointers are 16-byte
    aligned; ``bf16``: the bf16 instance; ``body``: a body to take in place
    of the plan's choice (to compare bodies)."""
    vec = copy_width(cin, cout, aligned, bf16)
    body = choose_body(cin, cout, vec, bf16, body)
    tiles = -(-n_out // ROWS_PER_TILE) * -(-cout // COUT_PER_TILE)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    tile, row_tile = COUT_PER_TILE, ROWS_PER_TILE
    stages = 1 if body == "simt" else MMA_STAGES
    if body.startswith("wgmma"):  # as many ranges as fill one wave of the blocks the SMs hold
        f32 = body == "wgmma_3xtf32"
        tile = wgmma_tile(cout, 128 if f32 else 256)
        row_tile = wgmma_row_tile(tile, f32)
        stages = wgmma_stages(tile, row_tile, f32)
        tiles = -(-n_out // row_tile) * -(-cout // tile)
        want = max(1, wgmma_blocks_per_sm(tile, row_tile, f32) * sms // tiles)
    fit = WORKSPACE_CAP // (4 * n_out * cout)
    splits = max(1, min(k_vol, want, fit))
    per = -(-k_vol // splits)
    splits = -(-k_vol // per)  # no empty range
    return Plan(splits, per, vec, body, tile, stages, row_tile)


def gather_gemm_reference(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather-GEMM: per offset, gather rows (an index of -1,
    or any index outside [0, N_in), gathers a zero row), then
    matmul-accumulate.  bf16 inputs compute what the bf16 instance
    computes: each product exact in float32 (a bf16 x bf16 product fits its
    mantissa), the sums in float32, one rounding to bf16 at the end."""
    if x.dtype == torch.bfloat16:
        return gather_gemm_reference(x.float(), w.float(), idx).to(torch.bfloat16)
    n_in = x.shape[0]
    padded = torch.cat([x, x.new_zeros(1, x.shape[1])])
    safe = torch.where((idx >= 0) & (idx < n_in), idx, n_in).long()
    out = x.new_zeros(idx.shape[1], w.shape[2])
    for k in range(w.shape[0]):
        out = out + padded.index_select(0, safe[k]) @ w[k]
    return out


def _check(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 3 or idx.ndim != 2:
        raise ValueError(
            f"expected x (N_in, Cin), w (K, Cin, Cout), idx (K, N_out); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(idx.shape)}"
        )
    if w.shape[1] != x.shape[1] or w.shape[0] != idx.shape[0]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"idx {tuple(idx.shape)}"
        )
    if x.device != w.device or x.device != idx.device:
        raise ValueError(
            f"x, w and idx must share a device: {x.device}, {w.device}, {idx.device}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float64) or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must both be float32 or bf16 (or float64 on the CPU), got {x.dtype}, "
            f"{w.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")


def gather_gemm(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, *,
                body: str | None = None) -> torch.Tensor:
    """``out[o, :] = Σ_k x[idx[k, o], :] @ w[k]`` with -1 = no pair.

    Args:
      x: (N_in, Cin) float32 or bf16; float64 is taken on the CPU too (the
        plain version is type-generic), for checks against a float64 run.
      w: (K, Cin, Cout), of x's type.
      idx: (K, N_out) int32.
      body: on the card, a body to run in place of the plan's choice
        (``"wgmma"`` or ``"wgmma_3xtf32"`` by dtype, ``"mma"`` or
        ``"simt"``), to compare bodies on the same inputs; it must take the
        shapes.  The CPU ignores it.

    Returns (N_out, Cout) of x's type; bf16 is summed in float32 and rounded
    once.  ``gather_gemm.launches`` counts the float32 instance's launches
    and ``gather_gemm.bf16_launches`` the bf16 instance's, and
    ``gather_gemm.float32_body_launches`` and
    ``gather_gemm.bf16_body_launches`` each instance's launches by body
    (CPU calls run the plain version and count nothing);
    ``gather_gemm.last_plan`` is the ``Plan`` of the last launch.  Two
    launches on the same inputs give the same bits.
    """
    _check(x, w, idx)
    if x.device.type == "cpu":
        return gather_gemm_reference(x, w, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bf16, got {x.dtype}")
    for name, t in (("x", x), ("w", w), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_in, cin = x.shape
    k_vol, n_out = idx.shape
    cout = w.shape[2]
    if max(n_in, n_out, k_vol, cin, cout) >= 2**31:  # passed as C ints
        raise ValueError("gather_gemm dimensions must fit in int32")
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((n_out, cout), dtype=x.dtype, device=x.device)
    if n_out == 0 or cout == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    p = plan(n_out, k_vol, cin, cout, sms, aligned, bf16, body)
    with P.span("k1." + p.body), torch.cuda.device(x.device):
        ws = None
        if p.splits > 1:  # per-range partial tiles, summed in order by a second pass
            ws = torch.empty((p.splits, n_out, cout), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        lib = build.library()
        args = (x.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), n_in, n_out, k_vol, cin, cout, p.splits)
        if p.body == "wgmma":
            err = lib.me_gather_gemm_bf16_wgmma(*args, p.tile, p.row_tile, stream)
        elif p.body == "wgmma_3xtf32":
            err = lib.me_gather_gemm_f32_wgmma(*args, p.tile, p.row_tile, stream)
        else:
            err = (lib.me_gather_gemm_bf16 if bf16 else lib.me_gather_gemm_f32)(*args, p.vec, stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm kernel launch failed: cudaError {err} ({p})")
    if bf16:
        gather_gemm.bf16_launches += 1
        gather_gemm.bf16_body_launches[p.body] += 1
    else:
        gather_gemm.launches += 1
        gather_gemm.float32_body_launches[p.body] += 1
    gather_gemm.last_plan = p
    return out


gather_gemm.launches = 0
gather_gemm.bf16_launches = 0
gather_gemm.bf16_body_launches = dict.fromkeys(BF16_BODIES, 0)
gather_gemm.float32_body_launches = dict.fromkeys(F32_BODIES, 0)
gather_gemm.last_plan = None
