"""Sparse-convolution weight gradient, ``dW[k] = Σ_o X[idx[k,o]]ᵀ ⊗ G[o]``.

``conv_dw`` launches the hand-written CUDA kernel (``csrc/conv_dw.cu``) for
CUDA tensors and runs the plain PyTorch version, ``conv_dw_reference``, for
CPU tensors.  There is no fallback between the two: on a CUDA tensor the
kernel runs, or the call raises.

It replaces the JAX package's Pallas dW family behind
``minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas``.
"""

from __future__ import annotations

import torch

from . import build

ROWS_PER_CHUNK = 64  # BR in csrc/conv_dw.cu
BLOCKS_PER_SM = 4  # resident 256-thread blocks per SM the row split aims to fill


def conv_dw_reference(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch weight gradient: per offset, gather rows (an index of
    -1, or any index outside [0, N_in), gathers a zero row), then one
    ``xᵀ @ g``."""
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
    if x.dtype not in (torch.float32, torch.float64) or g.dtype != x.dtype:
        raise TypeError(
            f"x and g must both be float32 (or float64 on the CPU), got {x.dtype}, {g.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")


def _row_splits(k_vol: int, cin: int, cout: int, n_out: int, sms: int) -> int:
    """How many blocks share one dW tile's rows: enough that the grid fills
    ``sms`` SMs, and no more splits than 64-row chunks."""
    cin_tile = 4 if cin <= 4 else 64  # the kernel's two instances
    blocks = -(-cin // cin_tile) * -(-cout // 64) * k_vol
    chunks = -(-n_out // ROWS_PER_CHUNK)
    return max(1, min(-(-BLOCKS_PER_SM * sms // blocks), chunks))


def conv_dw(x: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dW[k] = Σ_o x[idx[k, o], :]ᵀ ⊗ g[o, :]`` with -1 = no pair.

    Args:
      x: (N_in, Cin) float32; float64 is taken on the CPU too (the plain
        version is type-generic), for checks against a float64 run.
      g: (N_out, Cout), of x's type.
      idx: (K, N_out) int32.

    Returns (K, Cin, Cout) of x's type.  ``conv_dw.launches`` counts the kernel
    launches (CPU calls run the plain version and do not count).  The sum
    over rows is deterministic: two launches on the same inputs give the
    same bits.
    """
    _check(x, g, idx)
    if x.device.type == "cpu":
        return conv_dw_reference(x, g, idx)
    if x.device.type != "cuda":
        raise ValueError(f"conv_dw runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}")
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = _row_splits(k_vol, cin, cout, n_out, sms)
    ws = None
    if splits > 1:  # per-split partial tiles, summed in order by a second pass
        ws = torch.empty((splits, k_vol, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().me_conv_dw_f32(
            x.data_ptr(), g.data_ptr(), idx.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            n_in, n_out, k_vol, cin, cout, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_dw kernel launch failed: cudaError {err}")
    conv_dw.launches += 1
    return out


conv_dw.launches = 0
