"""Sparse-convolution weight gradient, ``dW[k] = Σ_o X[idx[k,o]]ᵀ ⊗ G[o]``.

``conv_dw`` launches the hand-written CUDA kernel (``csrc/conv_dw.cu``) for
CUDA tensors and runs the plain PyTorch version, ``conv_dw_reference``, for
CPU tensors.  There is no fallback between the two: on a CUDA tensor the
kernel runs, or the call raises.

It replaces the JAX package's Pallas dW family behind
``minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas``,
which takes float32 or bf16 ``x`` and ``g`` and always writes a float32 dW.
The kernel has a float32 instance (3xTF32 tensor-core products) and a bf16
one (bf16 tensor-core products, float32 sums, a float32 dW).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .gather_gemm import copy_width

ROWS_PER_SCAN = 256  # SCAN in csrc/conv_dw.cu: the unit of the row split
BLOCKS_PER_SM = 4  # blocks per SM the row split aims to fill
WORKSPACE_CAP = 16 * 2**20  # bytes of (S, K, Cin, Cout) partials: stays in the 50 MB L2
COUT_TILES = (32, 64, 96, 128)  # the tensor-core instances' Cout tiles


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
    body: str  # "mma" (tensor cores) or "simt" (Cin <= 4, the stem)

    def blocks(self, k_vol: int, cin: int, cout: int) -> int:
        """Blocks of one row range."""
        return -(-cin // self.cin_tile) * -(-cout // self.cout_tile) * k_vol

    def workspace_bytes(self, k_vol: int, cin: int, cout: int) -> int:
        return 4 * self.splits * k_vol * cin * cout if self.splits > 1 else 0


def cout_tile(cout: int) -> int:
    """The Cout tile of the tensor-core instances: the fewest tiles of at
    most 128 channels, each rounded up to a multiple of 32 (96 -> one
    96-wide tile, 256 -> two of 128)."""
    per_tile = -(-cout // -(-cout // COUT_TILES[-1]))
    return -(-per_tile // 32) * 32


def plan(k_vol: int, cin: int, cout: int, n_out: int, sms: int, aligned: bool = True,
         bf16: bool = False) -> Plan:
    """Tiles fitted to the channels, and the row split: enough row ranges
    that the grid fills ``BLOCKS_PER_SM`` blocks per SM, no more than
    256-row scans, and no more than keep the workspace within
    ``WORKSPACE_CAP``.  ``aligned``: both input pointers are 16-byte
    aligned; ``bf16``: the bf16 instance (the same tiles)."""
    if cin <= 4:
        p = Plan(1, 4, 64, 1, "simt")
    else:
        vec = copy_width(cin, cout, aligned, bf16)
        n_tile = cout_tile(cout)
        p = Plan(1, 32 if cin <= 32 and n_tile <= 64 else 64, n_tile, vec, "mma")
    want = -(-BLOCKS_PER_SM * sms // p.blocks(k_vol, cin, cout))
    scans = -(-n_out // ROWS_PER_SCAN)
    fit = WORKSPACE_CAP // (4 * k_vol * cin * cout)
    return p._replace(splits=max(1, min(want, scans, fit)))


def conv_dw(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dW[k] = Σ_o x[idx[k, o], :]ᵀ ⊗ g[o, :]`` with -1 = no pair.

    Args:
      x: (N_in, Cin) float32 or bf16; float64 is taken on the CPU too (the
        plain version is type-generic), for checks against a float64 run.
      g: (N_out, Cout), of x's type.
      idx: (K, N_out) int32.

    Returns (K, Cin, Cout): float32 for float32 and bf16 inputs (float64
    for float64).  ``conv_dw.launches`` counts the float32 instance's
    launches and ``conv_dw.bf16_launches`` the bf16 instance's (CPU calls
    run the plain version and count nothing); ``conv_dw.last_plan`` is the
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
    p = plan(k_vol, cin, cout, n_out, sms, aligned, bf16)
    ws = None
    if p.splits > 1:  # per-split partial tiles, summed in order by a second pass
        ws = torch.empty((p.splits, k_vol, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = build.library()
        err = (lib.me_conv_dw_bf16 if bf16 else lib.me_conv_dw_f32)(
            x.data_ptr(), g.data_ptr(), idx.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            n_in, n_out, k_vol, cin, cout, p.splits, p.cin_tile, p.cout_tile, p.vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_dw kernel launch failed: cudaError {err} ({p})")
    if bf16:
        conv_dw.bf16_launches += 1
    else:
        conv_dw.launches += 1
    conv_dw.last_plan = p
    return out


conv_dw.launches = 0
conv_dw.bf16_launches = 0
conv_dw.last_plan = None
