// Weight gradient of the sparse convolution on Hopper (sm_90a), the bf16
// bodies: wgmma for Cin > 4, mma.sync for the Cin <= 4 stem.
//
//   dW[k] = sum_o X[idx[k, o], :]^T (x) G[o, :]        idx = -1: no pair
//
// bf16 X and G, float32 sums, a float32 dW.  Replaces the Pallas dW family
// of the JAX package on bf16 features,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_dw_pallas
// (:1391; bf16 X and G into a float32 dW, :1460), for every call whose Cin
// and Cout are multiples of 8 and whose X and G are 16-byte aligned (the
// wgmma body), and for every bf16 call with Cin <= 4 (the stem).
// conv_dw.cu keeps the mma.sync body for odd or unaligned widths.
//
// What bounds it on the H100: the latency of the gathered rows, as in K1.
// The mma.sync body staged 32 compacted rows a stage through a 3-stage
// ring and gathered every G row once per 32- to 128-wide Cout tile; its
// Cin = 3 stem, on SIMT FMAs with plain loads of G, took ~100x its bound.
//
// Design (Cin > 4, conv_dw_wgmma_kernel):
//   * one block per (Cin tile, Cout tile BN, offset k, row split s).  BN is
//     Cout rounded up to one of 16, 32, 48, 64, 96, 128, 192, 256 (Cout >
//     256: the fewest tiles of at most 256), so for Cout <= 256 each G row
//     is gathered once per Cin tile.  The Cin tile is 64 rows of dW per
//     warpgroup: two warpgroups (128 rows, sharing the stage's G rows) for
//     Cin > 64 and BN of 64-128, one for BN < 64 or Cin <= 64; BN of 192
//     and 256 runs on two warpgroups that take half the columns each;
//   * in-block row compaction (mma_tile.cuh::compact_scan): the split's
//     output rows whose index has a pair are packed, in order of o, into a
//     ring in shared memory; full stages of 64 compacted rows are gathered,
//     X rows by index and G rows by o, with 16-byte cp.async (the split's
//     last stage partial and zero-filled) through a ring as deep as the
//     shared memory allows (4-8 stages; two blocks an SM for one
//     warpgroup);
//   * M = Cin, N = Cout, K = the compacted rows: both tiles are stored as
//     gathered, a row per compacted row, which is MN-major for X^T (A) and
//     for G (B), read through wgmma's imm-trans-a and imm-trans-b from
//     128-byte (X, an atom of 64 Cin per warpgroup) and 128-, 64- or
//     32-byte (G) swizzled rows;
//   * per stage four wgmma m64nNk16 into a zeroed partial (scale-d = 0 on
//     the first), added to the float32 accumulator with round-to-nearest
//     adds: dW sums up to 51k rows and is held to 1e-4, where the tensor
//     core's truncating accumulation would drift (mma_tile.cuh);
// Design (Cin <= 4, conv_dw_stem_mma_kernel): dW[k]^T = G^T X on mma.sync
// m16n8k16, M = Cout (a warp per 16), N = Cin padded to 8, K = the
// compacted rows; 64-row stages, G by cp.async (16 bytes where Cout is a
// multiple of 8) through a 4-stage ring, X rows (6 bytes at Cin = 3) by
// plain loads into rows of 8 zero-padded elements; both fragments by
// ldmatrix.trans; each stage into a zeroed fragment.
// Both: with S > 1 row splits each block writes its partial tile to an (S,
// K, Cin, Cout) float32 workspace summed in order s = 0 .. S-1 by a second
// pass (mma_tile.cuh::sum_splits).  The compacted order is fixed by the
// map and there are no atomics, so two launches give the same bits.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int SCAN = 256;  // the unit of the row split (rows)
constexpr int BR = 64;     // compacted rows per stage
constexpr int CAP = 512;   // compaction ring: < BR pending + one 256-row scan

// --- Cin > 4: wgmma -----------------------------------------------------------

// a 64 x MG Cin by BN Cout tile: MG consumer warpgroups along Cin (each
// 64 rows of dW, sharing the stage's G rows), or, for BN > 128, two along
// Cout (each half the columns, sharing the X rows)
template <int BN, int MG>
struct DTile {
  static constexpr int NG = BN > 128 ? 2 : 1;
  static constexpr int GROUPS = MG * NG;  // consumer warpgroups
  static constexpr int BC = 64 * MG;      // Cin per block
  static constexpr int WN = BN / NG;      // each group's columns: its wgmma N
  static constexpr int THREADS = 128 * GROUPS;
  // G's swizzle atom in columns (a group's columns start on an atom), and
  // its rows' bytes
  static constexpr int ATOM = WN % 64 == 0 ? 64 : WN % 32 == 0 ? 32 : 16;
  static constexpr int ROW = ATOM * 2;
  static constexpr int X_BYTES = BR * BC * 2;  // MG atoms of 64 rows of 128 bytes
  static constexpr int G_BYTES = BR * BN * 2;  // BN / ATOM atoms of 64 rows
  static constexpr int STAGE = X_BYTES + G_BYTES;
  static constexpr int FIXED = 1024 + (2 * CAP + THREADS / 32) * 4;
  // the ring as deep as the shared memory allows (at most 8 stages): two
  // blocks an SM for one warpgroup, else one
  static constexpr int LIMIT = GROUPS == 1 ? 113 * 1024 : 227 * 1024;
  static constexpr int STAGES = (LIMIT - FIXED) / STAGE < 8 ? (LIMIT - FIXED) / STAGE : 8;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGE % 1024 == 0 && WN % 16 == 0 && WN <= 128 && GROUPS <= 2, "tile");
};

template <int BN, int MG>
__global__ void __launch_bounds__(DTile<BN, MG>::THREADS)
conv_dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const int* __restrict__ idx, float* __restrict__ dst, int n_in, int n_out,
                     int k_vol, int cin, int cout, int rows_per_split) {
  using T = DTile<BN, MG>;
  constexpr int THREADS = T::THREADS;
  constexpr int BC = T::BC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [STAGES][X | G]
  int* p_row = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);         // [CAP]
  int* p_o = p_row + CAP;                                                     // [CAP]
  int* warp_counts = p_o + CAP;

  const int tid = threadIdx.x;
  const int group = tid / 128;
  const int mg = group % MG;          // the group's 64 rows (Cin) of the tile
  const int ng = group / MG;          // and its WN columns
  const int warp = (tid % 128) / 32;  // the warp's 16 rows of the group's D
  const int lane = tid % 32;
  const int tiles_n = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / tiles_n) * BC;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int k = blockIdx.y;
  const int* idx_k = idx + static_cast<int64_t>(k) * n_out;
  const int o_begin = blockIdx.z * rows_per_split;
  const int o_end = min(n_out, o_begin + rows_per_split);

  float acc[T::WN / 2];
#pragma unroll
  for (int i = 0; i < T::WN / 2; ++i) acc[i] = 0.f;

  // gather n <= BR compacted rows from the ring at head into buffer b
  auto issue = [&](int b, int head, int n) {
    uint8_t* xd = ring + b * T::STAGE;
    uint8_t* gd = xd + T::X_BYTES;
#pragma unroll
    for (int i = 0; i < BR * (BC / 8) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BC / 8);
      const int cc = e % (BC / 8);  // the 16-byte chunk: atom cc / 8, chunk cc % 8 in it
      const int c = c0 + cc * 8;
      const bool ok = r < n && c < cin;
      const int row = ok ? p_row[(head + r) & (CAP - 1)] : 0;
      cp_async16(xd + (cc / 8) * (BR * 128) + Swizzle<128>::at(r * 128 + (cc % 8) * 16),
                 x + static_cast<int64_t>(row) * cin + (ok ? c : 0), ok);
    }
#pragma unroll 4
    for (int i = 0; i < BR * (BN / 8) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / 8);
      const int j = (e % (BN / 8)) * 8;
      const bool ok = r < n && n0 + j < cout;
      const int o = ok ? p_o[(head + r) & (CAP - 1)] : 0;
      cp_async16(gd + (j / T::ATOM) * (BR * T::ROW) +
                     Swizzle<T::ROW>::at(r * T::ROW + (j % T::ATOM) * 2),
                 g + static_cast<int64_t>(o) * cout + (ok ? n0 + j : 0), ok);
    }
    cp_async_commit();
  };

  // acc += X_b^T G_b for this group's columns; rows past the stage's count are zero
  auto compute = [&](int b) {
    const uint8_t* xb = ring + b * T::STAGE;
    const uint8_t* gb = xb + T::X_BYTES + (ng * T::WN / T::ATOM) * (BR * T::ROW);
    const uint64_t da = smem_desc(xb + mg * BR * 128, BR * 128, 8 * 128, Swizzle<128>::MODE);
    const uint64_t db = smem_desc(gb, BR * T::ROW, 8 * T::ROW, Swizzle<T::ROW>::MODE);
    float part[T::WN / 2];  // this stage's products (see mma_tile.cuh: accumulation)
#pragma unroll
    for (int i = 0; i < T::WN / 2; ++i) part[i] = 0.f;  // scale-d = 0 ignores them; defined
    fence_registers(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BR / 16; ++j)
      wgmma_bf16<T::WN, 1, 1>(part, desc_plus(da, 16 * 128 * j), desc_plus(db, 16 * T::ROW * j),
                              j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(part);
#pragma unroll
    for (int i = 0; i < T::WN / 2; ++i) acc[i] += part[i];
  };

  int head = 0, pending = 0, issued = 0;
  // after each issue: compute the stage issued STAGES - 1 issues ago
  auto advance = [&]() {
    ++issued;
    if (issued >= T::STAGES) {
      cp_async_wait<T::STAGES - 1>();
      fence_proxy_async();
      __syncthreads();
      compute((issued - T::STAGES) % T::STAGES);
      __syncthreads();  // the buffer is refilled by the next issue
    }
  };
  for (int o0 = o_begin; o0 < o_end; o0 += THREADS) {
    pending = compact_scan<THREADS, CAP>(idx_k, o0, o_end, n_in, p_row, p_o, head, pending,
                                         warp_counts);
    while (pending >= BR) {
      issue(issued % T::STAGES, head, BR);
      head += BR;
      pending -= BR;
      advance();
    }
  }
  if (pending > 0) {
    issue(issued % T::STAGES, head, pending);
    advance();
  }
  // the last STAGES - 1 stages
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int q = max(0, issued - T::STAGES + 1); q < issued; ++q) compute(q % T::STAGES);

  // this block's (Cin, Cout) tile of split blockIdx.z; Cout is a multiple
  // of 8, so a column pair is in range or out together
  float* out = dst + (static_cast<int64_t>(blockIdx.z) * k_vol + k) * cin * cout;
  const int gq = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int jb = 0; jb < T::WN / 8; ++jb) {
    const int co = n0 + ng * T::WN + jb * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c0 + mg * 64 + warp * 16 + gq + h * 8;
      if (ci < cin && co < cout)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(ci) * cout + co) =
            make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
  }
}

// --- Cin <= 4 (the stem): mma.sync -------------------------------------------

constexpr int S_THREADS = 128;       // four warps, one per 16 of Cout
constexpr int S_BN = 64;             // Cout per block
constexpr int S_STAGES = 4;          // ring depth
constexpr int S_CAP = 256;           // < BR pending + one 128-row scan
constexpr int S_LDG = S_BN + 8;      // G row stride: 144 bytes, conflict-free ldmatrix
constexpr int S_LDX = 8;             // X row: Cin padded to 8 (16 bytes)

template <int VEC>
__global__ void __launch_bounds__(S_THREADS)
conv_dw_stem_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        const int* __restrict__ idx, float* __restrict__ dst, int n_in,
                        int n_out, int k_vol, int cin, int cout, int rows_per_split) {
  __shared__ __align__(16) bf16 xs[S_STAGES][BR * S_LDX];
  __shared__ __align__(16) bf16 gs[S_STAGES][BR * S_LDG];
  __shared__ int p_row[S_CAP];
  __shared__ int p_o[S_CAP];
  __shared__ int warp_counts[S_THREADS / 32];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * S_BN;
  const int k = blockIdx.y;
  const int* idx_k = idx + static_cast<int64_t>(k) * n_out;
  const int o_begin = blockIdx.z * rows_per_split;
  const int o_end = min(n_out, o_begin + rows_per_split);
  const bool busy = n0 + warp * 16 < cout;  // the warp's 16 Cout hold a column

  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  auto issue = [&](int b, int head, int n) {
    // X: one row per thread, Cin <= 4 elements by plain loads, zero-padded to 8
    if (tid < BR) {
      const int row = tid < n ? p_row[(head + tid) & (S_CAP - 1)] : -1;
      uint32_t v[S_LDX / 2];  // element pairs, low half first
#pragma unroll
      for (int q = 0; q < S_LDX / 2; ++q) {
        uint32_t pair = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * q + h;
          if (row >= 0 && c < cin)
            pair |= static_cast<uint32_t>(
                        __bfloat16_as_ushort(x[static_cast<int64_t>(row) * cin + c]))
                    << (16 * h);
        }
        v[q] = pair;
      }
      *reinterpret_cast<uint4*>(&xs[b][tid * S_LDX]) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    // G: 64 rows x 64 Cout by cp.async (VEC elements a copy), zero-filled
    for (int e = tid; e < BR * (S_BN / VEC); e += S_THREADS) {
      const int r = e / (S_BN / VEC);
      const int j = (e % (S_BN / VEC)) * VEC;
      const bool ok = r < n && n0 + j < cout;
      const int o = ok ? p_o[(head + r) & (S_CAP - 1)] : 0;
      cp_async_vec<VEC>(&gs[b][r * S_LDG + j],
                        g + static_cast<int64_t>(o) * cout + (ok ? n0 + j : 0), ok);
    }
    cp_async_commit();
  };

  // acc += G_b^T X_b on this warp's 16 Cout: A = G^T (Cout x rows) and
  // B = X (rows x 8), both stored along the rows, by ldmatrix.trans
  auto compute = [&](int b) {
    if (!busy) return;
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // this stage's products
    const bf16* gb = &gs[b][warp * 16];
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      uint32_t a[4], bx[2];
      ldmatrix_x4_trans(a, gb + (kk + (lane & 7) + (lane >> 4) * 8) * S_LDG + ((lane >> 3) & 1) * 8);
      ldmatrix_x2_trans(bx, &xs[b][(kk + (lane & 15)) * S_LDX]);
      mma_bf16(part, a, bx);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += part[q];
  };

  int head = 0, pending = 0, issued = 0;
  auto advance = [&]() {
    ++issued;
    if (issued >= S_STAGES) {
      cp_async_wait<S_STAGES - 1>();
      __syncthreads();
      compute((issued - S_STAGES) % S_STAGES);
      __syncthreads();  // the buffer is refilled by the next issue
    }
  };
  for (int o0 = o_begin; o0 < o_end; o0 += S_THREADS) {
    pending = compact_scan<S_THREADS, S_CAP>(idx_k, o0, o_end, n_in, p_row, p_o, head, pending,
                                             warp_counts);
    while (pending >= BR) {
      issue(issued % S_STAGES, head, BR);
      head += BR;
      pending -= BR;
      advance();
    }
  }
  if (pending > 0) {
    issue(issued % S_STAGES, head, pending);
    advance();
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int q = max(0, issued - S_STAGES + 1); q < issued; ++q) compute(q % S_STAGES);

  // D (16 Cout x 8 Cin): c0 (Cout g, Cin 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
  // c3 (g + 8, 2t + 1); dW[k] is (Cin, Cout)
  float* out = dst + (static_cast<int64_t>(blockIdx.z) * k_vol + k) * cin * cout;
  const int gq = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int co = n0 + warp * 16 + gq + (q / 2) * 8;
    const int ci = 2 * t + q % 2;
    if (busy && co < cout && ci < cin) out[static_cast<int64_t>(ci) * cout + co] = acc[q];
  }
}

template <int BN, int MG>
cudaError_t launch_wgmma(dim3 grid, cudaStream_t s, const bf16* x, const bf16* g, const int* idx,
                         float* dst, int n_in, int n_out, int k_vol, int cin, int cout,
                         int rows_per_split) {
  using T = DTile<BN, MG>;
  return launch_dynamic(conv_dw_wgmma_kernel<BN, MG>, grid, T::THREADS, T::SMEM, s, x, g, idx,
                        dst, n_in, n_out, k_vol, cin, cout, rows_per_split);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int rows_per_split(int n_out, int splits) {
  const int scans = (n_out + SCAN - 1) / SCAN;
  return (scans + splits - 1) / splits * SCAN;
}

cudaError_t sum_into(void* workspace, void* out, int k_vol, int cin, int cout, int splits,
                     cudaStream_t s) {
  return sum_splits(static_cast<const float*>(workspace), static_cast<float*>(out),
                    static_cast<int64_t>(k_vol) * cin * cout, splits, s);
}

}  // namespace

// bf16 x and g, float32 out; workspace: (splits, k_vol, cin, cout) float32
// when splits > 1, else unused.  bn: the Cout tile, one of 16, 32, 48, 64,
// 96, 128, 192, 256; bc: the Cin tile, 64, or 128 for bn 64, 96 or 128.
// Takes Cin and Cout multiples of 8 and 16-byte aligned x and g.
extern "C" int me_conv_dw_bf16_wgmma(const void* x, const void* g, const void* idx, void* out,
                                     void* workspace, int n_in, int n_out, int k_vol, int cin,
                                     int cout, int splits, int bn, int bc, void* stream) {
  if (k_vol <= 0 || cin <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || (bc != 64 && bc != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin % 8 != 0 || cout % 8 != 0 || !aligned(x, 16) || !aligned(g, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((cin + bc - 1) / bc * ((cout + bn - 1) / bn), k_vol, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* gt = static_cast<const bf16*>(g);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  const int per = rows_per_split(n_out, splits);
  cudaError_t err = cudaErrorInvalidValue;
#define ME_WGMMA_TILE(N, MG)                                                                    \
  if (bn == N && bc == 64 * MG)                                                                 \
    err = launch_wgmma<N, MG>(grid, s, xt, gt, ii, dst, n_in, n_out, k_vol, cin, cout, per);
  ME_WGMMA_TILE(16, 1)
  ME_WGMMA_TILE(32, 1)
  ME_WGMMA_TILE(48, 1)
  ME_WGMMA_TILE(64, 1)
  ME_WGMMA_TILE(96, 1)
  ME_WGMMA_TILE(128, 1)
  ME_WGMMA_TILE(192, 1)
  ME_WGMMA_TILE(256, 1)
  ME_WGMMA_TILE(64, 2)
  ME_WGMMA_TILE(96, 2)
  ME_WGMMA_TILE(128, 2)
#undef ME_WGMMA_TILE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_into(workspace, out, k_vol, cin, cout, splits, s));
}

// The stem: bf16 x and g with Cin <= 4, float32 out; workspace as above.
// vec: G's copy width, 8 (16 bytes; Cout a multiple of 8, g 16-byte
// aligned), 2 (4 bytes; even Cout) or 1 (plain loads).
extern "C" int me_conv_dw_bf16_stem(const void* x, const void* g, const void* idx, void* out,
                                    void* workspace, int n_in, int n_out, int k_vol, int cin,
                                    int cout, int splits, int vec, void* stream) {
  if (k_vol <= 0 || cin <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (cin > 4 || splits < 1 || (splits > 1 && workspace == nullptr) ||
      (vec != 1 && vec != 2 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (cout % vec != 0 || !aligned(g, 2 * vec)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((cout + S_BN - 1) / S_BN, k_vol, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* gt = static_cast<const bf16*>(g);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  const int per = rows_per_split(n_out, splits);
  if (vec == 8)
    conv_dw_stem_mma_kernel<8><<<grid, S_THREADS, 0, s>>>(xt, gt, ii, dst, n_in, n_out, k_vol,
                                                          cin, cout, per);
  else if (vec == 2)
    conv_dw_stem_mma_kernel<2><<<grid, S_THREADS, 0, s>>>(xt, gt, ii, dst, n_in, n_out, k_vol,
                                                          cin, cout, per);
  else
    conv_dw_stem_mma_kernel<1><<<grid, S_THREADS, 0, s>>>(xt, gt, ii, dst, n_in, n_out, k_vol,
                                                          cin, cout, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_into(workspace, out, k_vol, cin, cout, splits, s));
}
