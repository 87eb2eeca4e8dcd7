// Weight gradient of the sparse convolution on Hopper (sm_90a), float32.
//
//   dW[k] = sum_o X[idx[k, o], :]^T (x) G[o, :]        idx = -1: no pair
//
// Replaces the Pallas dW family of the JAX package,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas
// (_conv_dw_kernel, _conv_dw_kernel_union) and its outlier correction
// ops/functional.py::_outlier_dw.  The TPU kernels walk the output tiles in
// one sequential grid, keep dW^T resident in VMEM and DMA input slabs; here
// blocks run in parallel and in no order, so the reduction over output rows
// is split across blocks and summed in a second pass.  Rows are gathered by
// index straight from the dense matching, so there are no slabs and no
// outlier list: every pair is carried.
//
// Design (right and simple first):
//   * one block of 256 threads per (Cin tile, Cout tile of 64, offset k,
//     row split s);
//   * a loop over the split's output rows in chunks of 64: the chunk's 64
//     indices go to shared memory, and a chunk with no pair is skipped (one
//     block-wide vote); the X rows are gathered by index into shared memory
//     (zero for -1) and the G rows are staged beside them;
//   * each thread accumulates a 4 x 4 register tile of dW with f32 FMAs;
//   * Cin tiles are 64 wide, or 4 for Cin <= 4 (the 3-channel stem): there
//     the 256 threads split the chunk's rows into 16 groups, and the groups'
//     partial tiles are summed in shared memory in a fixed order;
//   * a deterministic reduction over the splits: with S > 1 each block
//     writes its partial tile to an (S, K, Cin, Cout) workspace and a second
//     small kernel sums the S partials in order s = 0 .. S-1.  No atomics,
//     so two launches on the same inputs give the same bits.
//
// What bounds it on the H100: like K1, the f32 FMA rate at 64-256 channels
// (16 FMAs per 8 shared-memory loads, SIMT only; no tensor cores yet), and
// at Cin = 3 the staging and barriers of each chunk (the 4-wide instance
// took 1.09 ms against 2.80 ms for the 64-wide one on the stem of a 51k-
// voxel batch).  Whole chunks are computed, pairless rows and the padding
// of a ragged Cout tile included: on the 51k-row K = 27 96 -> 96 convs this
// kernel (2.9 ms) is slower than the plain gather + matmul (2.3 ms).  The
// row split S is chosen by the caller so that the grid fills the SMs;
// without it K * tiles blocks (108 for K = 27, 96 -> 96) would each walk
// every row of the level.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BR = 64;                     // output rows per chunk
constexpr int BN = 64;                     // output channels per block
constexpr int TM = 4;                      // input channels per thread
constexpr int TN = 4;                      // output channels per thread
constexpr int THREADS = 256;
constexpr int COL_THREADS = BN / TN;       // 16

template <int BC>  // input channels per block: 64, or 4 for Cin <= 4
__global__ void __launch_bounds__(THREADS)
conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const int* __restrict__ idx, float* __restrict__ dst,
               int n_in, int n_out, int k_vol, int cin, int cout,
               int chunks_per_split) {
  constexpr int ROW_THREADS = BC / TM;                              // 16 or 1
  constexpr int GROUPS = THREADS / (ROW_THREADS * COL_THREADS);     // 1 or 16
  // row stride of the G tile: with GROUPS > 1 a warp reads two rows at
  // once, and 16 floats of padding put them on disjoint banks
  constexpr int GS = BN + (GROUPS > 1 ? 16 : 0);
  static_assert(GROUPS * BC * BN <= BR * GS, "group partials must fit in gs");

  __shared__ int rows[BR];
  __shared__ float xs[BR][BC];
  __shared__ float gs[BR * GS];

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS;
  const int ty = (tid / COL_THREADS) % ROW_THREADS;
  const int grp = tid / (COL_THREADS * ROW_THREADS);
  const int tiles_n = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / tiles_n) * BC;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int k = blockIdx.y;
  const int* idx_k = idx + static_cast<int64_t>(k) * n_out;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_chunks = (n_out + BR - 1) / BR;
  const int ch_begin = blockIdx.z * chunks_per_split;
  const int ch_end = min(n_chunks, ch_begin + chunks_per_split);
  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int o0 = ch * BR;
    int r = -1;
    if (tid < BR) {
      if (o0 + tid < n_out) r = idx_k[o0 + tid];
      if (r >= n_in) r = -1;  // out-of-range rows gather zero, as take_rows does
      rows[tid] = r;
    }
    // barrier + vote: skip chunks with no pair at this offset
    if (!__syncthreads_or(r >= 0)) continue;

    for (int e = tid; e < BR * BC; e += THREADS) {
      const int i = e / BC;
      const int c = e % BC;
      const int row = rows[i];
      float v = 0.f;
      if (row >= 0 && c0 + c < cin) v = x[static_cast<int64_t>(row) * cin + c0 + c];
      xs[i][c] = v;
    }
    for (int e = tid; e < BR * BN; e += THREADS) {
      const int i = e / BN;
      const int j = e % BN;
      float v = 0.f;  // rows without a pair add nothing: skip their G row
      if (rows[i] >= 0 && n0 + j < cout)
        v = g[static_cast<int64_t>(o0 + i) * cout + n0 + j];
      gs[i * GS + j] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = grp; i < BR; i += GROUPS) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = xs[i][ty + m * ROW_THREADS];
#pragma unroll
      for (int n = 0; n < TN; ++n) b[n] = gs[i * GS + tx + n * COL_THREADS];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();  // the tiles (and rows[]) are rewritten next
  }

  // this block's (Cin, Cout) tile of split blockIdx.z
  float* out = dst + (static_cast<int64_t>(blockIdx.z) * k_vol + k) * cin * cout;
  if constexpr (GROUPS == 1) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int ci = c0 + ty + m * ROW_THREADS;
      if (ci >= cin) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int co = n0 + tx + n * COL_THREADS;
        if (co < cout) out[static_cast<int64_t>(ci) * cout + co] = acc[m][n];
      }
    }
  } else {
    // sum the row groups' partial tiles in a fixed order
    float* red = gs;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n)
        red[(grp * BC + ty + m * ROW_THREADS) * BN + tx + n * COL_THREADS] = acc[m][n];
    __syncthreads();
    for (int e = tid; e < BC * BN; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) s += red[q * BC * BN + e];
      const int ci = c0 + e / BN;
      const int co = n0 + e % BN;
      if (ci < cin && co < cout) out[static_cast<int64_t>(ci) * cout + co] = s;
    }
  }
}

// out[e] = sum_s ws[s, e] in order s = 0 .. splits-1
__global__ void sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  int64_t n, int splits) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += ws[q * n + e];
    out[e] = s;
  }
}

}  // namespace

// workspace: (splits, k_vol, cin, cout) float32 when splits > 1, else unused
extern "C" int me_conv_dw_f32(const void* x, const void* g, const void* idx,
                              void* out, void* workspace, int n_in, int n_out,
                              int k_vol, int cin, int cout, int splits,
                              void* stream) {
  if (k_vol <= 0 || cin <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (n_out + BR - 1) / BR;
  const int chunks_per_split = (n_chunks + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  const int tiles_n = (cout + BN - 1) / BN;
  if (cin <= 4) {
    const dim3 grid((cin + 3) / 4 * tiles_n, k_vol, splits);
    conv_dw_kernel<4><<<grid, THREADS, 0, s>>>(xf, gf, ii, dst, n_in, n_out, k_vol,
                                               cin, cout, chunks_per_split);
  } else {
    const dim3 grid((cin + 63) / 64 * tiles_n, k_vol, splits);
    conv_dw_kernel<64><<<grid, THREADS, 0, s>>>(xf, gf, ii, dst, n_in, n_out, k_vol,
                                                cin, cout, chunks_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(k_vol) * cin * cout;
  const int64_t blocks = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
