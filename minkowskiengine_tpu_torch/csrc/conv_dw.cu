// Weight gradient of the sparse convolution on Hopper (sm_90a), float32 and
// bf16 inputs, float32 dW.
//
//   dW[k] = sum_o X[idx[k, o], :]^T (x) G[o, :]        idx = -1: no pair
//
// Replaces the Pallas dW family of the JAX package,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas
// (_conv_dw_kernel, _conv_dw_kernel_union) and its outlier correction
// ops/functional.py::_outlier_dw, in both of its types: float32, and bf16 X
// and G with a float32 dW (conv_kernel.py:1460).  The TPU kernels walk the output tiles in
// one sequential grid, keep dW^T resident in VMEM and DMA input slabs; here
// blocks run in parallel and in no order, so the reduction over output rows
// is split across blocks and summed in a second pass.  Rows are gathered by
// index straight from the dense matching, so there are no slabs and no
// outlier list: every pair is carried.
//
// Design:
//   * one block per (Cin tile, Cout tile, offset k, row split s);
//   * in-block row compaction: the block scans its split's output rows,
//     one row per thread, and keeps only those with a pair (0 <= idx[k, o]
//     < N_in), packed in order of o by ballots and prefix sums into a ring
//     in shared memory (mma_tile.cuh::compact_scan).  Full tiles of
//     compacted rows are gathered, X rows by index and G rows by o; the
//     split's last tile is partial and zero-filled.  No load and no
//     product goes to a pairless row;
//   * Cin > 4 (conv_dw_mma_kernel): 128 threads, a Cin tile of 64, or 32
//     for Cin <= 32 and Cout tiles <= 64 (m16 fragments of X^T), by a Cout
//     tile of 32, 64, 96 or 128 fitted to Cout (96 -> one 96-wide tile).
//     32-row tiles of X and G are copied with cp.async (16 bytes when Cin
//     and Cout are multiples of 4 and the pointers 16-byte aligned, else 4
//     bytes) through a 3-stage ring, two tiles ahead of the one being
//     computed; the products run on the
//     tensor cores in 3xTF32 (mma_tile.cuh), the reduction over the
//     compacted rows in steps of 8, each tile into a zeroed fragment that
//     is then added to the float32 accumulator;
//   * bf16 (me_conv_dw_bf16, the mma.sync body; since the wgmma body and
//     the mma.sync stem of conv_dw_wgmma.cu take every bf16 call with Cin
//     and Cout multiples of 8 and aligned operands, and every bf16 call
//     with Cin <= 4, this one serves the odd or unaligned widths, and the
//     SIMT stem below the float32 instance, or a bf16 call that asks for
//     it): the same tiles, compaction and ring, with
//     copies of 8 elements (16 bytes), 2 (4 bytes) or 1 (plain loads, odd
//     widths); both operands are stored along the compacted rows, which
//     are the reduction's k, so both fragments come by ldmatrix.trans
//     (X^T as A, G as B) into mma.sync m16n8k16, each tile into a zeroed
//     fragment added to the float32 accumulator; rows padded by 8 elements
//     (row strides of an odd number of 16-byte units: conflict-free
//     ldmatrix);
//   * Cin <= 4 (the 3-channel stem, conv_dw_stem_kernel): SIMT f32 on
//     64-row compacted tiles, 256 threads in 16 row groups whose 4 x 64
//     partial tiles are summed in shared memory in a fixed order; its bf16
//     instance widens X and G to float32 as it stages them;
//   * a deterministic reduction over the splits: with S > 1 each block
//     writes its partial tile to an (S, K, Cin, Cout) workspace and a
//     second pass sums the S partials in order s = 0 .. S-1.  The
//     compacted order is fixed by the map, and there are no atomics, so two
//     launches on the same inputs give the same bits.
//
// What bounds it on the H100: the gathers.  On the 51k-row stride-1 convs
// each paired row brings Cin + Cout floats from L2 (X and G stay resident)
// for 2 Cin Cout useful flops, 3xTF32 triples the tensor-core work, and the
// row split S (chosen by the caller so the grid fills the SMs) adds an
// (S, K, Cin, Cout) workspace pass.  At Cin = 3 the staging and barriers of
// the SIMT tiles bound it.  wgmma for the float32 instance is later work:
// its TF32 form takes only K-major shared operands, and X^T and G are
// stored along the rows (MN-major).  The bf16 form takes MN-major operands
// through its transpose bits, which the bf16 wgmma body
// (conv_dw_wgmma.cu) uses.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"

namespace {

constexpr int SCAN = 256;  // the unit of the row split (rows)

// --- Cin > 4: tensor cores ----------------------------------------------------

constexpr int THREADS = 128;  // one row scan of 128 rows per compaction
constexpr int BR = 32;        // compacted rows per tile
constexpr int NSTAGE = 3;     // ring depth
constexpr int CAP = 256;      // compaction ring: < BR pending + one 128-row scan

using bf16 = __nv_bfloat16;

// row strides LDX = BC + 8 and LDG = BN + 8 elements: float32 = 8 (mod
// 32), so the fragment loads hit 32 banks; bf16 an odd number of 16-byte
// units, so each 8-row ldmatrix phase hits 8 distinct bank groups
template <typename T, int BC, int BN>
constexpr int mma_smem_bytes() {
  return NSTAGE * BR * ((BC + 8) + (BN + 8)) * static_cast<int>(sizeof(T)) +
         (2 * CAP + THREADS / 32) * 4;
}

// T: float (3xTF32) or bf16 (m16n8k16); dW is float32 either way
template <typename T, int BC, int BN, int VEC>
__global__ void __launch_bounds__(THREADS)
conv_dw_mma_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const int* __restrict__ idx, float* __restrict__ dst, int n_in, int n_out,
                   int k_vol, int cin, int cout, int rows_per_split) {
  constexpr int WM = BC / 16;            // warps along Cin (m16 each)
  constexpr int WN = (THREADS / 32) / WM;  // warps along Cout
  constexpr int NT = BN / 8 / WN;        // n8 tiles per warp
  constexpr int LDX = BC + 8;
  constexpr int LDG = BN + 8;
  static_assert(WM * WN == THREADS / 32 && NT * 8 * WN == BN, "warp layout");
  static_assert(sizeof(T) == 4 ? LDX % 32 == 8 && LDG % 32 == 8
                               : LDX * 2 / 16 % 2 == 1 && LDG * 2 / 16 % 2 == 1,
                "padding");
  static_assert(sizeof(T) == 4 || NT % 2 == 0, "bf16 B fragments load in pairs of n8 tiles");

  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);                // [NSTAGE][BR][LDX]
  T* gs = xs + NSTAGE * BR * LDX;                     // [NSTAGE][BR][LDG]
  int* p_row = reinterpret_cast<int*>(gs + NSTAGE * BR * LDG);  // [CAP]
  int* p_o = p_row + CAP;                             // [CAP]
  int* warp_counts = p_o + CAP;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const int cb = (warp % WM) * 16;        // warp's Cin rows in the tile
  const int nb = (warp / WM) * (NT * 8);  // warp's Cout columns in the tile
  const int tiles_n = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / tiles_n) * BC;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int k = blockIdx.y;
  const int* idx_k = idx + static_cast<int64_t>(k) * n_out;
  const int o_begin = blockIdx.z * rows_per_split;
  const int o_end = min(n_out, o_begin + rows_per_split);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // gather n <= BR compacted rows from the ring at head into buffer b
  auto issue = [&](int b, int head, int n) {
    T* xd = xs + b * BR * LDX;
    T* gd = gs + b * BR * LDG;
    for (int e = tid; e < BR * (BC / VEC); e += THREADS) {
      const int i = e / (BC / VEC);
      const int c = (e % (BC / VEC)) * VEC;
      const bool ok = i < n && c0 + c < cin;
      const int r = ok ? p_row[(head + i) & (CAP - 1)] : 0;
      cp_async_vec<VEC>(xd + i * LDX + c, x + static_cast<int64_t>(r) * cin + (ok ? c0 + c : 0),
                        ok);
    }
    for (int e = tid; e < BR * (BN / VEC); e += THREADS) {
      const int i = e / (BN / VEC);
      const int j = (e % (BN / VEC)) * VEC;
      const bool ok = i < n && n0 + j < cout;
      const int o = ok ? p_o[(head + i) & (CAP - 1)] : 0;
      cp_async_vec<VEC>(gd + i * LDG + j, g + static_cast<int64_t>(o) * cout + (ok ? n0 + j : 0),
                        ok);
    }
    cp_async_commit();
  };

  // acc += X_tile^T G_tile on buffer b; rows past the tile's count are zero
  auto compute = [&](int b) {
    float part[NT][4];  // this tile's products (see mma_tile.cuh: accumulation)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
    if constexpr (sizeof(T) == 4) {
      const float* xb = xs + b * BR * LDX + cb + gq;
      const float* gb = gs + b * BR * LDG + nb + gq;
#pragma unroll
      for (int kk = 0; kk < BR; kk += 8) {
        uint32_t a_hi[4], a_lo[4];
        const float* a = xb + (kk + t) * LDX;
        split_tf32(a[0], a_hi[0], a_lo[0]);                // (c = g,     row t)
        split_tf32(a[8], a_hi[1], a_lo[1]);                // (c = g + 8, row t)
        split_tf32(a[4 * LDX], a_hi[2], a_lo[2]);          // (c = g,     row t + 4)
        split_tf32(a[4 * LDX + 8], a_hi[3], a_lo[3]);      // (c = g + 8, row t + 4)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp = gb + (kk + t) * LDG + j * 8;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(bp[0], b_hi[0], b_lo[0]);
          split_tf32(bp[4 * LDG], b_hi[1], b_lo[1]);
          mma_3xtf32(part[j], a_hi, a_lo, b_hi, b_lo);
        }
      }
    } else {
      const bf16* xb = xs + b * BR * LDX + cb;
      const bf16* gb = gs + b * BR * LDG + nb;
#pragma unroll
      for (int kk = 0; kk < BR; kk += 16) {
        // A = X^T: matrix q = lane / 8 holds rows kk + 8 (q / 2) .. + 7 and
        // channels 8 (q % 2) .. + 7; transposed, lane (g, t) gets channel g
        // of rows 2t, 2t + 1: a0 (c 0-7, r 0-7), a1 (c 8-15, r 0-7),
        // a2 (c 0-7, r 8-15), a3 (c 8-15, r 8-15)
        uint32_t a[4];
        ldmatrix_x4_trans(a, xb + (kk + (lane & 7) + (lane >> 4) * 8) * LDX + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          // B = G: rows kk .. kk + 15 of two 8-wide Cout tiles
          uint32_t r[4];
          ldmatrix_x4_trans(r, gb + (kk + (lane & 15)) * LDG + jj * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
          mma_bf16(part[2 * jj], a, b0);
          mma_bf16(part[2 * jj + 1], a, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
  };

  int head = 0, pending = 0, issued = 0;
  // after each issue: compute the tile issued NSTAGE - 1 issues ago
  auto advance = [&]() {
    ++issued;
    if (issued >= NSTAGE) {
      cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      compute((issued - NSTAGE) % NSTAGE);
      __syncthreads();  // the buffer is refilled by the next issue
    }
  };
  for (int o0 = o_begin; o0 < o_end; o0 += THREADS) {
    pending = compact_scan<THREADS, CAP>(idx_k, o0, o_end, n_in, p_row, p_o, head, pending,
                                         warp_counts);
    while (pending >= BR) {
      issue(issued % NSTAGE, head, BR);
      head += BR;
      pending -= BR;
      advance();
    }
  }
  if (pending > 0) {
    issue(issued % NSTAGE, head, pending);
    advance();
  }
  // the last NSTAGE - 1 tiles
  cp_async_wait<0>();
  __syncthreads();
  for (int q = max(0, issued - NSTAGE + 1); q < issued; ++q) compute(q % NSTAGE);

  // this block's (Cin, Cout) tile of split blockIdx.z
  float* out = dst + (static_cast<int64_t>(blockIdx.z) * k_vol + k) * cin * cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = c0 + cb + gq + h * 8;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int co = n0 + nb + j * 8 + 2 * t;
      if (co < cout) out[static_cast<int64_t>(ci) * cout + co] = acc[j][2 * h];
      if (co + 1 < cout) out[static_cast<int64_t>(ci) * cout + co + 1] = acc[j][2 * h + 1];
    }
  }
}

// --- Cin <= 4 (the stem): SIMT f32 ------------------------------------------

constexpr int S_THREADS = 256;
constexpr int S_BR = 64;                          // compacted rows per tile
constexpr int S_BC = 4;                           // input channels per block
constexpr int S_BN = 64;                          // output channels per block
constexpr int S_TN = 4;                           // output channels per thread
constexpr int COL_THREADS = S_BN / S_TN;          // 16
constexpr int GROUPS = S_THREADS / COL_THREADS;   // 16 row groups
constexpr int S_CAP = 512;                        // < S_BR pending + one 256-row scan
// row stride of the G tile: a warp reads two rows at once, and 16 floats
// of padding put them on disjoint banks
constexpr int GS = S_BN + 16;
static_assert(GROUPS * S_BC * S_BN <= S_BR * GS, "group partials must fit in gs");

// T: the inputs' type (float or bf16, widened to float32 as staged)
template <typename T>
__global__ void __launch_bounds__(S_THREADS)
conv_dw_stem_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const int* __restrict__ idx, float* __restrict__ dst, int n_in, int n_out,
                    int k_vol, int cin, int cout, int rows_per_split) {
  __shared__ int p_row[S_CAP];
  __shared__ int p_o[S_CAP];
  __shared__ int warp_counts[S_THREADS / 32];
  __shared__ float xs[S_BR][S_BC];
  __shared__ float gs[S_BR * GS];

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS;
  const int grp = tid / COL_THREADS;
  const int n0 = blockIdx.x * S_BN;
  const int k = blockIdx.y;
  const int* idx_k = idx + static_cast<int64_t>(k) * n_out;
  const int o_begin = blockIdx.z * rows_per_split;
  const int o_end = min(n_out, o_begin + rows_per_split);

  float acc[S_BC][S_TN];
#pragma unroll
  for (int m = 0; m < S_BC; ++m)
#pragma unroll
    for (int n = 0; n < S_TN; ++n) acc[m][n] = 0.f;

  // stage n <= S_BR compacted rows from the ring at head and accumulate them
  auto tile = [&](int head, int n) {
    for (int e = tid; e < S_BR * S_BC; e += S_THREADS) {
      const int i = e / S_BC;
      const int c = e % S_BC;
      float v = 0.f;
      if (i < n && c < cin)
        v = to_float(x[static_cast<int64_t>(p_row[(head + i) & (S_CAP - 1)]) * cin + c]);
      xs[i][c] = v;
    }
    for (int e = tid; e < S_BR * S_BN; e += S_THREADS) {
      const int i = e / S_BN;
      const int j = e % S_BN;
      float v = 0.f;
      if (i < n && n0 + j < cout)
        v = to_float(g[static_cast<int64_t>(p_o[(head + i) & (S_CAP - 1)]) * cout + n0 + j]);
      gs[i * GS + j] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = grp; i < n; i += GROUPS) {
      float b[S_TN];
#pragma unroll
      for (int q = 0; q < S_TN; ++q) b[q] = gs[i * GS + tx + q * COL_THREADS];
#pragma unroll
      for (int m = 0; m < S_BC; ++m) {
        const float a = xs[i][m];
#pragma unroll
        for (int q = 0; q < S_TN; ++q) acc[m][q] = fmaf(a, b[q], acc[m][q]);
      }
    }
    __syncthreads();  // the tiles are rewritten next
  };

  int head = 0, pending = 0;
  for (int o0 = o_begin; o0 < o_end; o0 += S_THREADS) {
    pending = compact_scan<S_THREADS, S_CAP>(idx_k, o0, o_end, n_in, p_row, p_o, head, pending,
                                             warp_counts);
    while (pending >= S_BR) {
      tile(head, S_BR);
      head += S_BR;
      pending -= S_BR;
    }
  }
  if (pending > 0) tile(head, pending);

  // sum the row groups' partial tiles in a fixed order
  float* out = dst + (static_cast<int64_t>(blockIdx.z) * k_vol + k) * cin * cout;
  float* red = gs;
#pragma unroll
  for (int m = 0; m < S_BC; ++m)
#pragma unroll
    for (int q = 0; q < S_TN; ++q) red[(grp * S_BC + m) * S_BN + tx + q * COL_THREADS] = acc[m][q];
  __syncthreads();
  for (int e = tid; e < S_BC * S_BN; e += S_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) s += red[q * S_BC * S_BN + e];
    const int ci = e / S_BN;
    const int co = n0 + e % S_BN;
    if (ci < cin && co < cout) out[static_cast<int64_t>(ci) * cout + co] = s;
  }
}

template <typename T, int BC, int BN, int VEC>
cudaError_t launch_mma(dim3 grid, cudaStream_t s, const T* x, const T* g, const int* idx,
                       float* dst, int n_in, int n_out, int k_vol, int cin, int cout,
                       int rows_per_split) {
  return launch_dynamic(conv_dw_mma_kernel<T, BC, BN, VEC>, grid, THREADS,
                        mma_smem_bytes<T, BC, BN>(), s, x, g, idx, dst, n_in, n_out, k_vol, cin,
                        cout, rows_per_split);
}

template <typename T, int VEC>
cudaError_t launch_mma_tiles(int cin_tile, int cout_tile, dim3 grid, cudaStream_t s,
                             const T* x, const T* g, const int* idx, float* dst,
                             int n_in, int n_out, int k_vol, int cin, int cout,
                             int rows_per_split) {
#define ME_CONV_DW_TILE(BC, BN)                                                                  \
  if (cin_tile == BC && cout_tile == BN)                                                         \
    return launch_mma<T, BC, BN, VEC>(grid, s, x, g, idx, dst, n_in, n_out, k_vol, cin, cout, \
                                      rows_per_split);
  ME_CONV_DW_TILE(32, 32)
  ME_CONV_DW_TILE(32, 64)
  ME_CONV_DW_TILE(64, 32)
  ME_CONV_DW_TILE(64, 64)
  ME_CONV_DW_TILE(64, 96)
  ME_CONV_DW_TILE(64, 128)
#undef ME_CONV_DW_TILE
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// the row split, the stem or the tensor-core instance for T and VEC, and
// the in-order sum of the splits' partials into out
template <typename T, int VEC>
cudaError_t run(const void* x, const void* g, const void* idx, void* out, void* workspace,
                int n_in, int n_out, int k_vol, int cin, int cout, int splits, int cin_tile,
                int cout_tile, void* stream) {
  const int scans = (n_out + SCAN - 1) / SCAN;
  const int rows_per_split = (scans + splits - 1) / splits * SCAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err;
  if (cin <= 4) {
    const dim3 grid((cout + S_BN - 1) / S_BN, k_vol, splits);
    conv_dw_stem_kernel<T><<<grid, S_THREADS, 0, s>>>(xt, gt, ii, dst, n_in, n_out, k_vol, cin,
                                                       cout, rows_per_split);
    err = cudaGetLastError();
  } else {
    if (cin_tile <= 0 || cout_tile <= 0) return cudaErrorInvalidValue;
    const dim3 grid((cin + cin_tile - 1) / cin_tile * ((cout + cout_tile - 1) / cout_tile), k_vol,
                    splits);
    err = launch_mma_tiles<T, VEC>(cin_tile, cout_tile, grid, s, xt, gt, ii, dst, n_in, n_out,
                                   k_vol, cin, cout, rows_per_split);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(static_cast<const float*>(workspace), static_cast<float*>(out),
                    static_cast<int64_t>(k_vol) * cin * cout, splits, s);
}

}  // namespace

// workspace: (splits, k_vol, cin, cout) float32 when splits > 1, else unused.
// Cin > 4: (cin_tile, cout_tile) in {32} x {32, 64} or {64} x {32, 64,
// 96, 128}; vec 4
// for 16-byte copies (Cin % 4 == 0, Cout % 4 == 0, x and g 16-byte
// aligned), 1 for 4-byte copies.  Cin <= 4 takes the stem instance (tiles
// 4 x 64) and ignores cin_tile, cout_tile and vec.
extern "C" int me_conv_dw_f32(const void* x, const void* g, const void* idx, void* out,
                              void* workspace, int n_in, int n_out, int k_vol, int cin, int cout,
                              int splits, int cin_tile, int cout_tile, int vec, void* stream) {
  if (k_vol <= 0 || cin <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin > 4 && vec == 4 && (cin % 4 != 0 || cout % 4 != 0 || !aligned(x, 16) || !aligned(g, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(
      vec == 4 ? run<float, 4>(x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                               cin_tile, cout_tile, stream)
               : run<float, 1>(x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                               cin_tile, cout_tile, stream));
}

// bf16 x and g, float32 out and workspace, tiles as above.  vec: 8 for
// 16-byte copies (Cin and Cout multiples of 8, x and g 16-byte aligned), 2
// for 4-byte copies (even widths, 4-byte aligned), 1 for plain 2-byte
// loads.  Cin <= 4 takes the stem instance.
extern "C" int me_conv_dw_bf16(const void* x, const void* g, const void* idx, void* out,
                               void* workspace, int n_in, int n_out, int k_vol, int cin,
                               int cout, int splits, int cin_tile, int cout_tile, int vec,
                               void* stream) {
  if (k_vol <= 0 || cin <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || (vec != 1 && vec != 2 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin > 4 && vec > 1 &&
      (cin % vec != 0 || cout % vec != 0 || !aligned(x, 2 * vec) || !aligned(g, 2 * vec)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (vec == 8)
    err = run<bf16, 8>(x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                       cin_tile, cout_tile, stream);
  else if (vec == 2)
    err = run<bf16, 2>(x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                       cin_tile, cout_tile, stream);
  else
    err = run<bf16, 1>(x, g, idx, out, workspace, n_in, n_out, k_vol, cin, cout, splits,
                       cin_tile, cout_tile, stream);
  return static_cast<int>(err);
}
