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
// windows or outlier lists.  The same kernel computes the input gradient
// (the inverse map, W[k] transposed).
//
// Design, Cin > 4 (gather_gemm_mma_kernel):
//   * one block of 128 threads (2 x 2 warps, 32 x 32 each) per 64 output
//     rows x 64 output channels x range of offsets (the offset split);
//   * the tile's indices for up to 32 offsets go to shared memory, and one
//     vote per offset keeps only the offsets with a pair in the tile;
//   * the (offset, 32-wide Cin chunk) stages run through a 3-stage ring in
//     shared memory: the 64 X rows are gathered by index and W[k]'s chunk
//     copied with cp.async (16 bytes when Cin and Cout are multiples of 4
//     and the pointers 16-byte aligned, else 4 bytes; zero-filled for -1
//     and the ragged edges), two stages ahead of the one being computed;
//   * the products run on the tensor cores in 3xTF32 (mma_tile.cuh), each
//     stage into a zeroed fragment that is then added to the float32
//     accumulator; padded shared-memory rows keep the fragment loads free
//     of bank conflicts;
//   * with S > 1 offset ranges each block writes its partial tile to an
//     (S, N_out, Cout) workspace, summed in order s = 0 .. S-1 by a second
//     pass.  No atomics: two launches give the same bits.
// Cin <= 4 (the 3-channel stem) keeps the SIMT body (gather_gemm_stem_kernel):
// 4-wide chunks and 4 x 4 register tiles, f32 FMAs.
//
// What bounds it on the H100: the offset split exists because the deep
// levels (125 and 618 rows) gave only 8-40 row x Cout tiles on 132 SMs,
// each walking up to 27 offsets x 12 chunks in series; the caller picks S
// from the shapes so the grid holds a few blocks per SM.  Each stage then
// costs the latency of its gathered rows (L2 hits) more than its 24 mma
// per warp and k-step, so the ring depth and the blocks per SM, not the
// tensor-core rate, bound it.  At 51k rows (S = 1) the gathers of X rows,
// about 0.6 of the slots paired, bound it.  wgmma (needs K-major shared
// operands; W[k] is (Cin, Cout) row-major), TMA and bf16 are later work.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"

namespace {

// --- Cin > 4: tensor cores ----------------------------------------------------

constexpr int BM = 64;              // output rows per block
constexpr int BN = 64;              // output channels per block
constexpr int BK = 32;              // Cin per stage
constexpr int NSTAGE = 3;           // ring depth
constexpr int KG = 32;              // offsets whose indices are staged at once
constexpr int THREADS = 128;        // 2 x 2 warps of 32 x 32
constexpr int LDA = BK + 4;         // 36 = 4 (mod 32): A fragment loads hit 32 banks
constexpr int LDB = BN + 8;         // 72 = 8 (mod 32): B fragment loads hit 32 banks
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES =
    (NSTAGE * (A_STAGE + B_STAGE)) * 4 + (KG * BM + 2 * KG + 4) * 4;

// 3 blocks per SM, as the shared memory allows (unbounded, ptxas spilled
// the 16-byte instance at 128 registers)
template <int VEC>
__global__ void __launch_bounds__(THREADS, 3)
gather_gemm_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int* __restrict__ idx, float* __restrict__ dst, int n_in,
                       int n_out, int k_vol, int cin, int cout, int offsets_per_split) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);     // [NSTAGE][BM][LDA]
  float* bs = as + NSTAGE * A_STAGE;               // [NSTAGE][BK][LDB]
  int* rows = reinterpret_cast<int*>(bs + NSTAGE * B_STAGE);  // [KG][BM]
  int* has_pair = rows + KG * BM;                  // [KG]
  int* active = has_pair + KG;                     // [KG] offsets (in the group) to run
  int* n_active = active + KG;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / 2;  // warp's 32 rows
  const int wn = warp % 2;  // warp's 32 channels
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * offsets_per_split;
  const int k_end = min(k_vol, k_begin + offsets_per_split);
  const int n_chunks = (cin + BK - 1) / BK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int kg0 = k_begin; kg0 < k_end; kg0 += KG) {
    const int kn = min(KG, k_end - kg0);
    if (tid < KG) has_pair[tid] = 0;
    __syncthreads();  // also: the previous group's stages are all consumed
    for (int e = tid; e < kn * BM; e += THREADS) {
      const int kl = e / BM;
      const int m = e % BM;
      int r = -1;
      if (m0 + m < n_out) r = idx[static_cast<int64_t>(kg0 + kl) * n_out + m0 + m];
      if (r >= n_in) r = -1;  // out-of-range rows gather zero, as take_rows does
      rows[e] = r;
      if (r >= 0) has_pair[kl] = 1;
    }
    __syncthreads();
    // the vote: compact the offsets with a pair in this tile, in order
    if (warp == 0) {
      const bool on = lane < kn && has_pair[lane] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (on) active[__popc(ballot & ((1u << lane) - 1u))] = lane;
      if (lane == 0) *n_active = __popc(ballot);
    }
    __syncthreads();
    const int stages = *n_active * n_chunks;

    // stage s: offset active[s / n_chunks], Cin chunk s % n_chunks
    auto issue = [&](int s) {
      const int kl = active[s / n_chunks];
      const int c0 = (s % n_chunks) * BK;
      float* a_dst = as + (s % NSTAGE) * A_STAGE;
      float* b_dst = bs + (s % NSTAGE) * B_STAGE;
      const int* rows_k = rows + kl * BM;
      for (int e = tid; e < BM * (BK / VEC); e += THREADS) {
        const int m = e / (BK / VEC);
        const int c = c0 + (e % (BK / VEC)) * VEC;
        const int r = rows_k[m];
        const bool ok = r >= 0 && c < cin;
        const float* src = ok ? x + static_cast<int64_t>(r) * cin + c : x;
        cp_async_vec<VEC>(a_dst + m * LDA + (c - c0), src, ok);
      }
      const float* wk = w + static_cast<int64_t>(kg0 + kl) * cin * cout;
      for (int e = tid; e < BK * (BN / VEC); e += THREADS) {
        const int kk = e / (BN / VEC);
        const int j = (e % (BN / VEC)) * VEC;
        const bool ok = c0 + kk < cin && n0 + j < cout;
        const float* src = ok ? wk + static_cast<int64_t>(c0 + kk) * cout + n0 + j : w;
        cp_async_vec<VEC>(b_dst + kk * LDB + j, src, ok);
      }
    };

#pragma unroll
    for (int p = 0; p < NSTAGE - 1; ++p) {
      if (p < stages) issue(p);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      if (s + NSTAGE - 1 < stages) issue(s + NSTAGE - 1);
      cp_async_commit();
      cp_async_wait<NSTAGE - 1>();  // stage s has landed
      __syncthreads();
      const float* a_s = as + (s % NSTAGE) * A_STAGE + (wm * 32) * LDA;
      const float* b_s = bs + (s % NSTAGE) * B_STAGE + wn * 32;
      float part[2][4][4];  // this stage's products (see mma_tile.cuh: accumulation)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* a = a_s + (i * 16 + g) * LDA + kk + t;
          split_tf32(a[0], a_hi[i][0], a_lo[i][0]);
          split_tf32(a[8 * LDA], a_hi[i][1], a_lo[i][1]);
          split_tf32(a[4], a_hi[i][2], a_lo[i][2]);
          split_tf32(a[8 * LDA + 4], a_hi[i][3], a_lo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* b = b_s + (kk + t) * LDB + j * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(b[0], b_hi[0], b_lo[0]);
          split_tf32(b[4 * LDB], b_hi[1], b_lo[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_3xtf32(part[i][j], a_hi[i], a_lo[i], b_hi, b_lo);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
      __syncthreads();  // the buffer is refilled by the next issue
    }
  }

  // this block's tile of split blockIdx.z (the output itself when S = 1)
  float* out = dst + static_cast<int64_t>(blockIdx.z) * n_out * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + wm * 32 + i * 16 + g + h * 8;
      if (o >= n_out) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col < cout) out[static_cast<int64_t>(o) * cout + col] = acc[i][j][2 * h];
        if (col + 1 < cout) out[static_cast<int64_t>(o) * cout + col + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// --- Cin <= 4 (the stem): SIMT f32 ------------------------------------------

constexpr int S_BK = 4;                                   // Cin per chunk
constexpr int S_TM = 4;                                   // rows per thread
constexpr int S_TN = 4;                                   // channels per thread
constexpr int S_THREADS = (BM / S_TM) * (BN / S_TN);      // 256
constexpr int ROW_STEP = BM / S_TM;                       // 16
constexpr int COL_STEP = BN / S_TN;                       // 16

__global__ void __launch_bounds__(S_THREADS)
gather_gemm_stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const int* __restrict__ idx, float* __restrict__ dst, int n_in,
                        int n_out, int k_vol, int cin, int cout, int offsets_per_split) {
  __shared__ int rows[BM];
  __shared__ float xs[S_BK][BM + 1];  // transposed gather tile; +1 spreads banks
  __shared__ float ws[S_BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COL_STEP;
  const int ty = tid / COL_STEP;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * offsets_per_split;
  const int k_end = min(k_vol, k_begin + offsets_per_split);

  float acc[S_TM][S_TN];
#pragma unroll
  for (int i = 0; i < S_TM; ++i)
#pragma unroll
    for (int j = 0; j < S_TN; ++j) acc[i][j] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    int r = -1;
    if (tid < BM) {
      if (m0 + tid < n_out) r = idx[static_cast<int64_t>(k) * n_out + m0 + tid];
      if (r >= n_in) r = -1;
      rows[tid] = r;
    }
    // barrier + vote: skip offsets with no pair in this tile
    if (!__syncthreads_or(r >= 0)) continue;

    const float* wk = w + static_cast<int64_t>(k) * cin * cout;
    for (int e = tid; e < BM * S_BK; e += S_THREADS) {
      const int i = e / S_BK;
      const int c = e % S_BK;
      const int row = rows[i];
      xs[c][i] = row >= 0 && c < cin ? x[static_cast<int64_t>(row) * cin + c] : 0.f;
    }
    for (int e = tid; e < S_BK * BN; e += S_THREADS) {
      const int c = e / BN;
      const int j = e % BN;
      ws[c][j] = c < cin && n0 + j < cout ? wk[static_cast<int64_t>(c) * cout + n0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < S_BK; ++c) {
      float a[S_TM], b[S_TN];
#pragma unroll
      for (int i = 0; i < S_TM; ++i) a[i] = xs[c][ty + i * ROW_STEP];
#pragma unroll
      for (int j = 0; j < S_TN; ++j) b[j] = ws[c][tx + j * COL_STEP];
#pragma unroll
      for (int i = 0; i < S_TM; ++i)
#pragma unroll
        for (int j = 0; j < S_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles (and rows[]) are rewritten next
  }

  float* out = dst + static_cast<int64_t>(blockIdx.z) * n_out * cout;
#pragma unroll
  for (int i = 0; i < S_TM; ++i) {
    const int o = m0 + ty + i * ROW_STEP;
    if (o >= n_out) continue;
#pragma unroll
    for (int j = 0; j < S_TN; ++j) {
      const int col = n0 + tx + j * COL_STEP;
      if (col < cout) out[static_cast<int64_t>(o) * cout + col] = acc[i][j];
    }
  }
}

}  // namespace

// workspace: (splits, n_out, cout) float32 when splits > 1, else unused.
// vec: 4 for 16-byte copies (Cin % 4 == 0, Cout % 4 == 0, x and w 16-byte
// aligned), 1 for 4-byte copies.
extern "C" int me_gather_gemm_f32(const void* x, const void* w, const void* idx, void* out,
                                  void* workspace, int n_in, int n_out, int k_vol, int cin,
                                  int cout, int splits, int vec, void* stream) {
  if (n_out <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (cin % 4 != 0 || cout % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int offsets_per_split = (k_vol + splits - 1) / splits;
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err;
  if (cin <= 4) {
    gather_gemm_stem_kernel<<<grid, S_THREADS, 0, s>>>(xf, wf, ii, dst, n_in, n_out, k_vol, cin,
                                                        cout, offsets_per_split);
    err = cudaGetLastError();
  } else if (vec == 4) {
    err = launch_dynamic(gather_gemm_mma_kernel<4>, grid, THREADS, SMEM_BYTES, s, xf, wf, ii, dst,
                         n_in, n_out, k_vol, cin, cout, offsets_per_split);
  } else {
    err = launch_dynamic(gather_gemm_mma_kernel<1>, grid, THREADS, SMEM_BYTES, s, xf, wf, ii, dst,
                         n_in, n_out, k_vol, cin, cout, offsets_per_split);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(static_cast<const float*>(workspace),
                                     static_cast<float*>(out),
                                     static_cast<int64_t>(n_out) * cout, splits, s));
}
