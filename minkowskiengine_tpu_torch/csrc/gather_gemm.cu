// Gather-GEMM for sparse convolution on Hopper (sm_90a), float32.
//
//   out[o, :] = sum_k X[idx[k, o], :] @ W[k]        idx = -1: no pair
//
// Replaces the Pallas forward family of the JAX package,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_fwd_pallas
// (_conv_fwd_kernel, _conv_fwd_kernel_union, _conv_fwd_kernel_union_wide).
// The TPU kernels DMA a contiguous input slab per tile and gather from it
// with one-hot matmuls, because row gathers are slow there; Hopper gathers
// rows natively, so this kernel reads X rows by index and needs no slabs,
// windows or outlier lists.
//
// Design (right and simple first):
//   * one block of 256 threads per 64 output rows x 64 output channels;
//   * a loop over offsets k: the tile's 64 indices go to shared memory, and
//     an offset with no pair in the tile is skipped (one block-wide vote);
//   * a loop over Cin in chunks of BK: the 64 X rows are gathered by index
//     into shared memory (zero for -1), W[k]'s chunk is staged beside them;
//   * each thread accumulates a 4 x 4 register tile with f32 FMAs;
//   * one masked store at the end.  Cin and Cout need no padding: loads and
//     stores are masked on the ragged edges, and Cin <= 4 (the 3-channel
//     stem) takes a BK = 4 instance so the chunk is not mostly zeros
//     (on an H100, 0.127 ms against 0.360 ms for BK = 16 on the stem of a
//     26k-voxel room scan).
//
// What bounds it on the H100: at Cin = 3 (stem, K = 125) the work per
// gathered byte is tiny, so the scattered row gathers (12-byte rows) bound
// it; the empty-offset skip and the narrow chunk cut what is moved.  At
// 128-256 channels the f32 FMA rate bounds it (no tensor cores yet); the
// 4 x 4 register tile gives 16 FMAs per 8 shared-memory loads.  wgmma, TMA
// and bf16 are later work.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;                            // output rows per block
constexpr int BN = 64;                            // output channels per block
constexpr int TM = 4;                             // rows per thread
constexpr int TN = 4;                             // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);    // 256
constexpr int ROW_STEP = BM / TM;                 // 16
constexpr int COL_STEP = BN / TN;                 // 16

template <int BK>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int n_in, int n_out, int k_vol, int cin, int cout) {
  __shared__ int rows[BM];
  __shared__ float xs[BK][BM + 1];  // transposed gather tile; +1 spreads banks
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COL_STEP;
  const int ty = tid / COL_STEP;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_vol; ++k) {
    int r = -1;
    if (tid < BM) {
      if (m0 + tid < n_out) r = idx[static_cast<int64_t>(k) * n_out + m0 + tid];
      if (r >= n_in) r = -1;  // out-of-range rows gather zero, as take_rows does
      rows[tid] = r;
    }
    // barrier + vote: skip offsets with no pair in this tile
    if (!__syncthreads_or(r >= 0)) continue;

    const float* wk = w + static_cast<int64_t>(k) * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int i = e / BK;
        const int c = e % BK;
        const int row = rows[i];
        float v = 0.f;
        if (row >= 0 && c0 + c < cin) v = x[static_cast<int64_t>(row) * cin + c0 + c];
        xs[c][i] = v;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int c = e / BN;
        const int j = e % BN;
        float v = 0.f;
        if (c0 + c < cin && n0 + j < cout)
          v = wk[static_cast<int64_t>(c0 + c) * cout + n0 + j];
        ws[c][j] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[c][ty + i * ROW_STEP];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[c][tx + j * COL_STEP];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the tiles (and rows[]) are rewritten next
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int o = m0 + ty + i * ROW_STEP;
    if (o >= n_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * COL_STEP;
      if (col < cout) out[static_cast<int64_t>(o) * cout + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int me_gather_gemm_f32(const void* x, const void* w, const void* idx,
                                  void* out, int n_in, int n_out, int k_vol,
                                  int cin, int cout, void* stream) {
  if (n_out <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* ii = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (cin <= 4) {
    gather_gemm_kernel<4><<<grid, THREADS, 0, s>>>(xf, wf, ii, of, n_in, n_out,
                                                   k_vol, cin, cout);
  } else {
    gather_gemm_kernel<16><<<grid, THREADS, 0, s>>>(xf, wf, ii, of, n_in, n_out,
                                                    k_vol, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
