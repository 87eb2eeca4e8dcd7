"""Serialized patch attention, fused: multi-head attention inside the windows
of a ``WindowPlan`` (``coords/serialize.py``), straight from the packed
``qkv`` rows of the map.

``attention(qkv, plan, heads, scale)`` gives each map row
``softmax(scale · Q Kᵀ) V`` over the window that owns it (the first that
holds it), per head; it is differentiable in ``qkv``.  For CUDA tensors
it launches the hand-written kernels (``csrc/serialized_attention.cu``:
3xTF32 ``wgmma`` forward and backward, the plan's gather in their loads,
full and short windows in one launch); for CPU tensors it runs the plain
PyTorch versions, ``attention_forward_reference`` and
``attention_backward_reference``, which compute the same quantities (the
base-2 log-sum-exp a row, Δ = rowsum(dO ∘ O), the gradients in window
order summed into the rows) in the same order.  There is no fallback
between the two: on a CUDA tensor the kernel runs, or the call raises.

It replaces no kernel of the JAX package, which has no attention (the
source says why it was added, its bound and its design).
``attention.fwd_launches`` and ``attention.bwd_launches`` count the
kernel's forward and backward launches (CPU calls count nothing).
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling as P
from . import build

HEAD_DIMS = (16, 32, 64)  # the kernel's instances
LOG2E = math.log2(math.e)
_BLOCK = 2**26  # score elements a block of the plain version computes at once


def check(qkv: torch.Tensor, heads: int) -> int:
    """The head width ``d`` of a kernel call, after refusing what the kernel
    does not take: other than float32, not (N, 3C) with C = heads · d, not
    contiguous, not 16-byte aligned, d outside ``HEAD_DIMS``."""
    if qkv.dtype != torch.float32:
        raise TypeError(f"the attention kernel takes float32 qkv, got {qkv.dtype}")
    if qkv.ndim != 2 or qkv.shape[1] % (3 * heads):
        raise ValueError(f"qkv must be (N, 3C) with C a multiple of {heads} heads, "
                         f"got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    d = qkv.shape[1] // (3 * heads)
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head widths {HEAD_DIMS}, got {d}")
    return d


def _segments(plan):
    """(first place, windows, length) of the full windows as one run, then
    of each short window."""
    out = [(0, plan.n_full, plan.patch_size)] if plan.n_full else []
    first = plan.n_full * plan.patch_size
    for n in plan.short:
        out.append((first, 1, n))
        first += n
    return out


def _heads(t: torch.Tensor, windows: int, length: int, heads: int) -> torch.Tensor:
    """(windows · length, heads · d) rows as (windows, heads, length, d)."""
    return t.reshape(windows, length, heads, -1).transpose(1, 2)


def attention_forward_reference(qkv: torch.Tensor, plan, heads: int, scale: float):
    """Plain version of the forward: per window ``softmax(scale · Q Kᵀ) V``
    in base 2 (exp2 of scale·log2(e)·S less the row's maximum).  Returns
    the (N, C) outputs, each row from its owning window, and the base-2
    log-sum-exp of scale·log2(e)·S at each place of the plan, (heads,
    places)."""
    packed = qkv.index_select(0, plan.rows)
    c = qkv.shape[1] // 3
    out = packed.new_empty(packed.shape[0], c)
    lse = packed.new_empty(heads, packed.shape[0])
    for first, windows, n in _segments(plan):
        step = max(1, _BLOCK // (heads * n * n))
        for w0 in range(0, windows, step):
            w = min(step, windows - w0)
            rows = slice(first + w0 * n, first + (w0 + w) * n)
            q, k, v = (_heads(t, w, n, heads) for t in packed[rows].split(c, 1))
            s = (q @ k.transpose(-1, -2)) * (scale * LOG2E)
            m = s.amax(-1, keepdim=True)
            p = torch.exp2(s - m)
            total = p.sum(-1, keepdim=True)
            out[rows] = ((p @ v) / total).transpose(1, 2).reshape(w * n, c)
            lse[:, rows] = (m + torch.log2(total)).squeeze(-1).transpose(0, 1).reshape(heads, -1)
    return out.index_select(0, plan.select), lse


def attention_backward_reference(qkv, out, lse, dout, plan, heads: int, scale: float):
    """Plain version of the backward: Δ = rowsum(dO ∘ O) at each place
    that owns its row (dO is zero at the others: their outputs are not
    used), then per window P = exp2(scale·log2(e)·S − lse), dV = Pᵀ dO,
    dS = scale · P ∘ (dO Vᵀ − Δ), dK = dSᵀ Q, dQ = dS K, in window order,
    summed into the rows.  Returns d qkv (N, 3C)."""
    own = (plan.kernel_rows >= 0).unsqueeze(1).to(dout.dtype)
    packed = qkv.index_select(0, plan.rows)
    g_w = dout.index_select(0, plan.rows) * own
    c = qkv.shape[1] // 3
    delta = (g_w * out.index_select(0, plan.rows)).view(-1, heads, c // heads).sum(-1).T
    grad = torch.zeros_like(packed)
    for first, windows, n in _segments(plan):
        step = max(1, _BLOCK // (heads * n * n))
        for w0 in range(0, windows, step):
            w = min(step, windows - w0)
            rows = slice(first + w0 * n, first + (w0 + w) * n)
            q, k, v = (_heads(t, w, n, heads) for t in packed[rows].split(c, 1))
            g = _heads(g_w[rows], w, n, heads)
            l, dl = (x[:, rows].reshape(heads, w, n).transpose(0, 1).unsqueeze(-1)
                     for x in (lse, delta))
            p = torch.exp2((q @ k.transpose(-1, -2)) * (scale * LOG2E) - l)
            ds = scale * p * (g @ v.transpose(-1, -2) - dl)
            parts = (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ g)
            grad[rows] = torch.cat([t.transpose(1, 2).reshape(w * n, c) for t in parts], 1)
    return torch.zeros_like(qkv).index_add_(0, plan.rows, grad)


def _launch_forward(qkv, plan, heads, scale):
    d = check(qkv, heads)
    n, c3 = qkv.shape
    places = plan.kernel_rows.numel()
    out = torch.empty((n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((heads, places), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = build.library().me_attention_fwd_f32(
            qkv.data_ptr(), plan.kernel_rows.data_ptr(), plan.bounds.data_ptr(), out.data_ptr(),
            lse.data_ptr(), places, plan.bounds.numel() - 1, plan.patch_size, heads, d, scale,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention forward launch failed: cudaError {err}")
    attention.fwd_launches += 1
    return out, lse


def _launch_backward(qkv, out, lse, dout, plan, heads, scale):
    d = check(qkv, heads)
    dout = dout.contiguous()
    places = plan.kernel_rows.numel()
    delta = torch.empty((heads, places), dtype=torch.float32, device=qkv.device)
    grad = torch.zeros((places, qkv.shape[1]), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = build.library().me_attention_bwd_f32(
            qkv.data_ptr(), plan.kernel_rows.data_ptr(), plan.bounds.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), grad.data_ptr(), places,
            plan.bounds.numel() - 1, plan.patch_size, heads, d, scale,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention backward launch failed: cudaError {err}")
    attention.bwd_launches += 1
    return torch.zeros_like(qkv).index_add_(0, plan.rows, grad)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, plan, heads, scale):
        if qkv.device.type == "cuda":
            out, lse = _launch_forward(qkv, plan, heads, scale)
        elif qkv.device.type == "cpu":
            out, lse = attention_forward_reference(qkv, plan, heads, scale)
        else:
            raise ValueError(f"attention runs on CPU or CUDA tensors, got {qkv.device}")
        ctx.plan, ctx.heads, ctx.scale = plan, heads, scale
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        with P.attn_part("bwd"):
            args = (qkv, out, lse, dout, ctx.plan, ctx.heads, ctx.scale)
            grad = _launch_backward(*args) if qkv.is_cuda else attention_backward_reference(*args)
        return grad, None, None, None


def attention(qkv: torch.Tensor, plan, heads: int, scale: float) -> torch.Tensor:
    """(N, C) attention outputs of (N, 3C) packed q, k, v rows (``[q | k |
    v]``, each ``heads`` heads of C / heads columns) over ``plan``: each
    row's output from the first window that holds it.  Differentiable in
    ``qkv``; the backward is the span ``me.attn.bwd``."""
    return _Attention.apply(qkv, plan, heads, float(scale))


attention.fwd_launches = 0
attention.bwd_launches = 0
