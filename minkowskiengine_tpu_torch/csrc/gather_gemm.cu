// Gather-GEMM for sparse convolution on Hopper (sm_90a), float32 and bf16.
//
//   out[o, :] = sum_k X[idx[k, o], :] @ W[k]        idx = -1: no pair
//
// Replaces the Pallas forward family of the JAX package,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_fwd_pallas
// (_conv_fwd_kernel, _conv_fwd_kernel_union, _conv_fwd_kernel_union_wide),
// in both of its types: float32, and bf16 X and W with a float32
// accumulator and a bf16 output rounded once (conv_kernel.py:797-820).
// The TPU kernels DMA a contiguous input slab per tile and gather from it
// with one-hot matmuls, because row gathers are slow there; Hopper gathers
// rows natively, so this kernel reads X rows by index and needs no slabs,
// windows or outlier lists.  The same kernel computes the input gradient
// (the inverse map, W[k] transposed).
//
// Since the float32 wgmma body of gather_gemm_wgmma_f32.cu takes every
// float32 call with Cin and Cout multiples of 8 and 16-byte aligned
// operands, as gather_gemm_wgmma.cu takes the bf16 ones, the mma.sync
// bodies here serve the odd or unaligned widths (and ``body="mma"``).
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
//   * bf16 (me_gather_gemm_bf16, the mma.sync body; since the wgmma body
//     of gather_gemm_wgmma.cu takes every bf16 call with Cin and Cout
//     multiples of 8 and 16-byte aligned operands, this one serves the odd
//     or unaligned widths): the same tiles, ring and vote, with
//     copies of 8 elements (16 bytes; Cin and Cout multiples of 8), 2
//     (4 bytes; even widths) or 1 (plain loads: cp.async has no 2-byte
//     form); fragments by ldmatrix, plain for the gathered X rows (Cin
//     contiguous) and .trans for W[k] (Cout contiguous), into one
//     mma.sync m16n8k16 per 16 of Cin, each stage into a zeroed fragment
//     added to the float32 accumulator; rows padded by 8 elements (80 and
//     144 bytes, odd multiples of 16: conflict-free ldmatrix); the tile is
//     rounded to bf16 once, or, with S > 1, written to the float32
//     workspace, whose in-order sum rounds once;
//   * with S > 1 offset ranges each block writes its partial tile to an
//     (S, N_out, Cout) workspace, summed in order s = 0 .. S-1 by a second
//     pass.  No atomics: two launches give the same bits.
// Cin <= 4 (the 3-channel stem) keeps the SIMT body (gather_gemm_stem_kernel):
// 4-wide chunks and 4 x 4 register tiles, f32 FMAs; its bf16 instance loads
// bf16, multiplies and sums in float32 and rounds once.
//
// What bounds it on the H100: the offset split exists because the deep
// levels (125 and 618 rows) gave only 8-40 row x Cout tiles on 132 SMs,
// each walking up to 27 offsets x 12 chunks in series; the caller picks S
// from the shapes so the grid holds a few blocks per SM.  Each stage then
// costs the latency of its gathered rows (L2 hits) more than its 24 mma
// per warp and k-step, so the ring depth and the blocks per SM, not the
// tensor-core rate, bound it.  At 51k rows (S = 1) the gathers of X rows,
// about 0.6 of the slots paired, bound it.  The wgmma bodies answer both:
// the bf16 one reads W[k] as it lies through wgmma's transpose bits; TF32
// wgmma takes only K-major shared operands, so the float32 one transposes
// and splits each stage's W[k] chunk in shared memory.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"

namespace {

// --- Cin > 4: tensor cores ----------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BM = 64;              // output rows per block
constexpr int BN = 64;              // output channels per block
constexpr int BK = 32;              // Cin per stage
constexpr int NSTAGE = 3;           // ring depth
constexpr int KG = 32;              // offsets whose indices are staged at once
constexpr int THREADS = 128;        // 2 x 2 warps of 32 x 32

// shared-memory row strides in elements.  float32: 36 = 4 (mod 32) and
// 72 = 8 (mod 32), so the A and B fragment loads hit 32 banks.  bf16: 40
// and 72 elements, 80 and 144 bytes, odd multiples of 16, so each 8-row
// ldmatrix phase hits 8 distinct bank groups.
template <typename T>
struct Tile {
  static constexpr int LDA = sizeof(T) == 4 ? BK + 4 : BK + 8;
  static constexpr int LDB = BN + 8;
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int SMEM_BYTES =
      NSTAGE * (A_STAGE + B_STAGE) * static_cast<int>(sizeof(T)) + (KG * BM + 2 * KG + 4) * 4;
};

// T: float (3xTF32) or bf16 (m16n8k16); OutT: the output's type, or float
// for the split workspace.  3 blocks per SM, as the shared memory allows
// (unbounded, ptxas spilled the float32 16-byte instance at 128 registers)
template <typename T, int VEC, typename OutT>
__global__ void __launch_bounds__(THREADS, 3)
gather_gemm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ idx, OutT* __restrict__ dst, int n_in,
                       int n_out, int k_vol, int cin, int cout, int offsets_per_split) {
  constexpr int LDA = Tile<T>::LDA;
  constexpr int LDB = Tile<T>::LDB;
  constexpr int A_STAGE = Tile<T>::A_STAGE;
  constexpr int B_STAGE = Tile<T>::B_STAGE;
  extern __shared__ float4 smem4[];
  T* as = reinterpret_cast<T*>(smem4);             // [NSTAGE][BM][LDA]
  T* bs = as + NSTAGE * A_STAGE;                   // [NSTAGE][BK][LDB]
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
      T* a_dst = as + (s % NSTAGE) * A_STAGE;
      T* b_dst = bs + (s % NSTAGE) * B_STAGE;
      const int* rows_k = rows + kl * BM;
      for (int e = tid; e < BM * (BK / VEC); e += THREADS) {
        const int m = e / (BK / VEC);
        const int c = c0 + (e % (BK / VEC)) * VEC;
        const int r = rows_k[m];
        const bool ok = r >= 0 && c < cin;
        const T* src = ok ? x + static_cast<int64_t>(r) * cin + c : x;
        cp_async_vec<VEC>(a_dst + m * LDA + (c - c0), src, ok);
      }
      const T* wk = w + static_cast<int64_t>(kg0 + kl) * cin * cout;
      for (int e = tid; e < BK * (BN / VEC); e += THREADS) {
        const int kk = e / (BN / VEC);
        const int j = (e % (BN / VEC)) * VEC;
        const bool ok = c0 + kk < cin && n0 + j < cout;
        const T* src = ok ? wk + static_cast<int64_t>(c0 + kk) * cout + n0 + j : w;
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
      const T* a_s = as + (s % NSTAGE) * A_STAGE + (wm * 32) * LDA;
      const T* b_s = bs + (s % NSTAGE) * B_STAGE + wn * 32;
      float part[2][4][4];  // this stage's products (see mma_tile.cuh: accumulation)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
      if constexpr (sizeof(T) == 4) {
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
      } else {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of each 16-row tile
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldmatrix_x4(a[i], a_s + (i * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
          // B: W[k] rows are k; k 0-7 and 8-15 of two 8-wide column tiles
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, b_s + (kk + (lane & 15)) * LDB + jj * 16 + (lane >> 4) * 8);
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(part[i][2 * jj], a[i], b0);
              mma_bf16(part[i][2 * jj + 1], a[i], b1);
            }
          }
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
  OutT* out = dst + static_cast<int64_t>(blockIdx.z) * n_out * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + wm * 32 + i * 16 + g + h * 8;
      if (o >= n_out) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col < cout) store_as(out + static_cast<int64_t>(o) * cout + col, acc[i][j][2 * h]);
        if (col + 1 < cout)
          store_as(out + static_cast<int64_t>(o) * cout + col + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

// --- Cin <= 4 (the stem): SIMT, float32 FMAs --------------------------------

constexpr int S_BK = 4;                                   // Cin per chunk
constexpr int S_TM = 4;                                   // rows per thread
constexpr int S_TN = 4;                                   // channels per thread
constexpr int S_THREADS = (BM / S_TM) * (BN / S_TN);      // 256
constexpr int ROW_STEP = BM / S_TM;                       // 16
constexpr int COL_STEP = BN / S_TN;                       // 16

// T: the inputs' type (float or bf16, loaded and widened to float32);
// OutT: the output's type, or float for the split workspace
template <typename T, typename OutT>
__global__ void __launch_bounds__(S_THREADS)
gather_gemm_stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ idx, OutT* __restrict__ dst, int n_in,
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

    const T* wk = w + static_cast<int64_t>(k) * cin * cout;
    for (int e = tid; e < BM * S_BK; e += S_THREADS) {
      const int i = e / S_BK;
      const int c = e % S_BK;
      const int row = rows[i];
      xs[c][i] = row >= 0 && c < cin ? to_float(x[static_cast<int64_t>(row) * cin + c]) : 0.f;
    }
    for (int e = tid; e < S_BK * BN; e += S_THREADS) {
      const int c = e / BN;
      const int j = e % BN;
      ws[c][j] =
          c < cin && n0 + j < cout ? to_float(wk[static_cast<int64_t>(c) * cout + n0 + j]) : 0.f;
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

  OutT* out = dst + static_cast<int64_t>(blockIdx.z) * n_out * cout;
#pragma unroll
  for (int i = 0; i < S_TM; ++i) {
    const int o = m0 + ty + i * ROW_STEP;
    if (o >= n_out) continue;
#pragma unroll
    for (int j = 0; j < S_TN; ++j) {
      const int col = n0 + tx + j * COL_STEP;
      if (col < cout) store_as(out + static_cast<int64_t>(o) * cout + col, acc[i][j]);
    }
  }
}

// one launch of the instance for T and the copy width VEC into dst (the
// output, or the float32 workspace when S > 1)
template <typename T, int VEC, typename OutT>
cudaError_t launch(dim3 grid, cudaStream_t s, const T* x, const T* w, const int* idx, OutT* dst,
                   int n_in, int n_out, int k_vol, int cin, int cout, int offsets_per_split) {
  if (cin <= 4) {
    gather_gemm_stem_kernel<T, OutT><<<grid, S_THREADS, 0, s>>>(x, w, idx, dst, n_in, n_out,
                                                                 k_vol, cin, cout,
                                                                 offsets_per_split);
    return cudaGetLastError();
  }
  return launch_dynamic(gather_gemm_mma_kernel<T, VEC, OutT>, grid, THREADS,
                        Tile<T>::SMEM_BYTES, s, x, w, idx, dst, n_in, n_out, k_vol, cin, cout,
                        offsets_per_split);
}

template <typename T, int VEC>
cudaError_t run(const void* x, const void* w, const void* idx, void* out, void* workspace,
                int n_in, int n_out, int k_vol, int cin, int cout, int splits, void* stream) {
  const int offsets_per_split = (k_vol + splits - 1) / splits;
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int* ii = static_cast<const int*>(idx);
  if (splits == 1)
    return launch<T, VEC>(grid, s, xt, wt, ii, static_cast<T*>(out), n_in, n_out, k_vol, cin,
                          cout, offsets_per_split);
  float* ws = static_cast<float*>(workspace);
  const cudaError_t err = launch<T, VEC>(grid, s, xt, wt, ii, ws, n_in, n_out, k_vol, cin, cout,
                                         offsets_per_split);
  if (err != cudaSuccess) return err;
  return sum_splits(ws, static_cast<T*>(out), static_cast<int64_t>(n_out) * cout, splits, s);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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
  if (vec == 4 && (cin % 4 != 0 || cout % 4 != 0 || !aligned(x, 16) || !aligned(w, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(
      vec == 4 ? run<float, 4>(x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                               stream)
               : run<float, 1>(x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                               stream));
}

// bf16 x, w and out; workspace as above.  vec: 8 for 16-byte copies (Cin
// and Cout multiples of 8, x and w 16-byte aligned), 2 for 4-byte copies
// (even widths, 4-byte aligned), 1 for plain 2-byte loads.  Cin <= 4 takes
// the SIMT stem whatever vec says.
extern "C" int me_gather_gemm_bf16(const void* x, const void* w, const void* idx, void* out,
                                   void* workspace, int n_in, int n_out, int k_vol, int cin,
                                   int cout, int splits, int vec, void* stream) {
  if (n_out <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || (vec != 1 && vec != 2 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (cin % vec != 0 || cout % vec != 0 || !aligned(x, 2 * vec) ||
                  !aligned(w, 2 * vec)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (vec == 8)
    err = run<bf16, 8>(x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits, stream);
  else if (vec == 2)
    err = run<bf16, 2>(x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits, stream);
  else
    err = run<bf16, 1>(x, w, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits, stream);
  return static_cast<int>(err);
}
