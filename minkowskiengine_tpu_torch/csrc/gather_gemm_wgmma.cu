// Gather-GEMM for sparse convolution on Hopper (sm_90a), the bf16 body on
// wgmma:
//
//   out[o, :] = sum_k X[idx[k, o], :] @ W[k]        idx = -1: no pair
//
// bf16 X and W, float32 sums, a bf16 output rounded once.  Replaces the
// Pallas forward family of the JAX package on bf16 features,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_fwd_pallas
// (:1105; the bf16 path :797-820), for every call whose Cin and Cout are
// multiples of 8 and whose X and W are 16-byte aligned; the same kernel
// computes the input gradient (the inverse map, W[k] transposed) and the
// transposed conv.  gather_gemm.cu keeps the mma.sync body for odd or
// unaligned widths and the SIMT stem for Cin <= 4.
//
// What bounds it on the H100: moving the operands into shared memory.  The
// bound of a MinkUNet34 step's calls is ~0.28 ms of bf16 tensor work, ~5%
// of what the mma.sync body took on the device.  That body walked (active
// offsets x Cin / 32) stages of 64 rows x 64 bytes through a 3-stage ring,
// each stage waiting on its L2 gathers for 16 mma.sync per warp; it
// gathered every X row once per 64-wide Cout tile (twice for Cout 96,
// four times for 256, sixteen for the FCNN's 1024), and re-read each
// W[k] chunk from L2 for every 64-row tile, which outweighs the X rows
// wherever Cin x Cout is large (the FCNN's conv5 calls: 27 x 336 x 256
// bf16 of W per 64 rows against 27 x 64 x 336 of X).
//
// Design:
//   * one block per 64 x WGS output rows x BN output channels x range of
//     offsets (the offset split), one consumer warpgroup (128 threads) per
//     64 rows, all of them issuing the copies.  BN is Cout rounded up to
//     one of 16, 32, 48, 64, 96, 128, 192, 256 (Cout > 256: the fewest
//     tiles of at most 256), so for Cout <= 256 each X row is gathered once
//     per row tile; the accumulator is BN / 2 floats a thread.  BN >= 96
//     takes two warpgroups (128 rows), which share each stage's W[k] chunk
//     and so read it half as often per row;
//   * the tile's indices for up to 32 offsets go to shared memory, and one
//     vote per offset keeps only the offsets with a pair in the tile;
//   * each stage is one (offset, 64-wide Cin chunk): the gathered X rows,
//     128 bytes each (half the stages of the mma.sync body), and W[k]'s
//     64 x BN chunk, copied with 16-byte cp.async into a 128-byte-swizzled
//     K-major A tile and an MN-major B tile (W[k] as it lies, read through
//     wgmma's imm-trans-b), zero-filled for -1, indices >= N_in and the
//     ragged Cin edge.  The ring is as deep as the shared memory allows
//     (4-8 stages, two blocks an SM for one warpgroup and BN <= 128);
//     STAGES - 2 stages are in flight while a stage's products run, and the
//     products of one stage still run (wgmma.wait_group 1) while the next
//     is waited for and its successor issued;
//   * per stage up to four wgmma m64nBNk16 per warpgroup (one per 16 of Cin
//     present), summed in the wgmma registers across all stages.  The
//     tensor core's float32 accumulation truncates (mma_tile.cuh), so a
//     long sum drifts toward zero by up to an ulp of the sum per product,
//     ~27 x 24 ulps at most here: ~8e-5 relative, far under half a bf16
//     ulp, so the one rounding that follows lands at most one bf16 ulp
//     from the exact sum's (2^-7 of max|ref|, the bound the output is held
//     to), at half the registers of a zeroed partial per stage;
//   * the offset split fills the blocks the SMs hold at most once (no
//     second wave of a few blocks); the tile is rounded to bf16 once, or,
//     with S > 1 offset ranges, written to the float32 (S, N_out, Cout)
//     workspace, whose in-order sum (mma_tile.cuh::sum_splits) rounds
//     once.  No atomics: two launches give the same bits.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // Cin per stage: one 128-byte row of X
constexpr int KG = 32;  // offsets whose indices are staged at once
constexpr int LAG = 1;  // wgmma groups left running into the next stage

// BN output channels by 64 x WGS output rows, one consumer warpgroup per 64
// rows sharing the stage's W[k] chunk
template <int BN, int WGS>
struct WTile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  // B's swizzle atom in columns, and its K rows' bytes
  static constexpr int ATOM = BN % 64 == 0 ? 64 : BN % 32 == 0 ? 32 : 16;
  static constexpr int ROW = ATOM * 2;
  static constexpr int A_BYTES = BM * BK * 2;  // BM rows of 128 bytes
  static constexpr int B_BYTES = BK * BN * 2;  // BN / ATOM atoms of 64 rows
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the 1024-byte alignment slack and the indices beside the ring
  static constexpr int FIXED = 1024 + (KG * BM + 2 * KG + 4) * 4;
  // the ring as deep as the shared memory allows (at most 8 stages): two
  // blocks an SM for one warpgroup and BN <= 128, else one
  static constexpr int LIMIT = WGS == 1 && BN <= 128 ? 113 * 1024 : 227 * 1024;
  static constexpr int STAGES = (LIMIT - FIXED) / STAGE < 8 ? (LIMIT - FIXED) / STAGE : 8;
  static constexpr int AHEAD = STAGES - 1 - LAG;  // stages in flight ahead of the one computed
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGE % 1024 == 0 && BN % 16 == 0 && BN <= 256 && AHEAD >= 2, "tile");
};

template <int BN, int WGS>
__global__ void __launch_bounds__(WTile<BN, WGS>::THREADS)
gather_gemm_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const int* __restrict__ idx, void* __restrict__ dst, int n_in,
                         int n_out, int k_vol, int cin, int cout, int offsets_per_split,
                         int f32_out) {
  using T = WTile<BN, WGS>;
  constexpr int BM = T::BM;
  constexpr int THREADS = T::THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [STAGES][A | B]
  int* rows = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);  // [KG][BM]
  int* has_pair = rows + KG * BM;                                   // [KG]
  int* active = has_pair + KG;  // [KG] offsets (in the group) to run
  int* n_active = active + KG;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int group = tid / 128;        // the warpgroup's 64 rows of the tile
  const int warp = (tid % 128) / 32;  // the warp's 16 rows of the group's
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * offsets_per_split;
  const int k_end = min(k_vol, k_begin + offsets_per_split);
  const int n_chunks = (cin + BK - 1) / BK;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

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
    if (tid < 32) {
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
      uint8_t* a_dst = ring + (s % T::STAGES) * T::STAGE;
      uint8_t* b_dst = a_dst + T::A_BYTES;
      const int* rows_k = rows + kl * BM;
      // A: row m's 16-byte chunk c (Cin c0 + 8c ..) at its swizzled place
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int m = e / 8;
        const int c = c0 + (e % 8) * 8;
        const int r = rows_k[m];
        const bool ok = r >= 0 && c < cin;
        const bf16* src = ok ? x + static_cast<int64_t>(r) * cin + c : x;
        cp_async16(a_dst + Swizzle<128>::at(m * 128 + (e % 8) * 16), src, ok);
      }
      // B: W[k] rows c0 .. c0 + 63, columns n0 .. n0 + BN - 1, by atoms
      const bf16* wk = w + static_cast<int64_t>(kg0 + kl) * cin * cout;
#pragma unroll 4
      for (int i = 0; i < (BK * (BN / 8) + THREADS - 1) / THREADS; ++i) {
        const int e = tid + i * THREADS;
        if (BK * (BN / 8) % THREADS != 0 && e >= BK * (BN / 8)) break;
        const int kk = e / (BN / 8);
        const int j = (e % (BN / 8)) * 8;
        const bool ok = c0 + kk < cin && n0 + j < cout;
        const bf16* src = ok ? wk + static_cast<int64_t>(c0 + kk) * cout + n0 + j : w;
        cp_async16(b_dst + (j / T::ATOM) * (BK * T::ROW) +
                       Swizzle<T::ROW>::at(kk * T::ROW + (j % T::ATOM) * 2),
                   src, ok);
      }
    };

#pragma unroll
    for (int p = 0; p < T::AHEAD; ++p) {
      if (p < stages) issue(p);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      cp_async_wait<T::AHEAD - 1>();  // stage s has landed
      fence_proxy_async();
      // every thread's copies are in; the products of stage s - 1 - LAG are
      // done, so its buffer takes stage s + AHEAD
      __syncthreads();
      if (s + T::AHEAD < stages) issue(s + T::AHEAD);
      cp_async_commit();
      const uint8_t* a_s = ring + (s % T::STAGES) * T::STAGE;
      const uint64_t da = smem_desc(a_s + group * 64 * 128, 16, 1024, Swizzle<128>::MODE);
      const uint64_t db =
          smem_desc(a_s + T::A_BYTES, BK * T::ROW, 8 * T::ROW, Swizzle<T::ROW>::MODE);
      const int k_steps = min(BK, cin - (s % n_chunks) * BK + 15) / 16;
      fence_registers(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        if (j < k_steps)
          wgmma_bf16<BN, 0, 1>(acc, desc_plus(da, 32 * j), desc_plus(db, 16 * T::ROW * j), 1);
      wgmma_commit();
      wgmma_wait<LAG>();
      fence_registers(acc);
    }
    wgmma_wait<0>();  // the ring is refilled by the next group
    fence_registers(acc);
  }

  // this block's tile of split blockIdx.z (the output itself when S = 1);
  // Cout is a multiple of 8, so a column pair is in range or out together
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int col = n0 + jb * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + group * 64 + warp * 16 + g + h * 8;
      if (o >= n_out || col >= cout) continue;
      const float v0 = acc[4 * jb + 2 * h];
      const float v1 = acc[4 * jb + 2 * h + 1];
      const int64_t at = static_cast<int64_t>(o) * cout + col;
      if (f32_out) {
        float* ws = static_cast<float*>(dst) + static_cast<int64_t>(blockIdx.z) * n_out * cout;
        *reinterpret_cast<float2*>(ws + at) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dst) + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BN, int WGS>
cudaError_t launch(dim3 grid, cudaStream_t s, const bf16* x, const bf16* w, const int* idx,
                   void* dst, int n_in, int n_out, int k_vol, int cin, int cout,
                   int offsets_per_split, int f32_out) {
  using T = WTile<BN, WGS>;
  return launch_dynamic(gather_gemm_wgmma_kernel<BN, WGS>, grid, T::THREADS, T::SMEM, s, x, w,
                        idx, dst, n_in, n_out, k_vol, cin, cout, offsets_per_split, f32_out);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// bf16 x, w and out; workspace: (splits, n_out, cout) float32 when splits >
// 1, else unused.  bn: the Cout tile, one of 16, 32, 48, 64, 96, 128, 192,
// 256; bm: the row tile, 64, or 128 for bn >= 96.  Takes Cin and Cout
// multiples of 8 and 16-byte aligned x and w.
extern "C" int me_gather_gemm_bf16_wgmma(const void* x, const void* w, const void* idx,
                                         void* out, void* workspace, int n_in, int n_out,
                                         int k_vol, int cin, int cout, int splits, int bn, int bm,
                                         void* stream) {
  if (n_out <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || k_vol < 1 || (bm != 64 && bm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin % 8 != 0 || cout % 8 != 0 || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int per = (k_vol + splits - 1) / splits;
  const dim3 grid((n_out + bm - 1) / bm, (cout + bn - 1) / bn, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  const int* ii = static_cast<const int*>(idx);
  void* dst = splits > 1 ? workspace : out;
  const int f32_out = splits > 1;
  cudaError_t err = cudaErrorInvalidValue;
#define ME_WGMMA_TILE(N, WGS)                                                                   \
  if (bn == N && bm == 64 * WGS)                                                                \
    err = launch<N, WGS>(grid, s, xt, wt, ii, dst, n_in, n_out, k_vol, cin, cout, per, f32_out);
  ME_WGMMA_TILE(16, 1)
  ME_WGMMA_TILE(32, 1)
  ME_WGMMA_TILE(48, 1)
  ME_WGMMA_TILE(64, 1)
  ME_WGMMA_TILE(96, 1)
  ME_WGMMA_TILE(128, 1)
  ME_WGMMA_TILE(192, 1)
  ME_WGMMA_TILE(256, 1)
  ME_WGMMA_TILE(96, 2)
  ME_WGMMA_TILE(128, 2)
  ME_WGMMA_TILE(192, 2)
  ME_WGMMA_TILE(256, 2)
#undef ME_WGMMA_TILE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(static_cast<const float*>(workspace), static_cast<bf16*>(out),
                                     static_cast<int64_t>(n_out) * cout, splits, s));
}
