// Gather-GEMM for sparse convolution on Hopper (sm_90a), the float32 body on
// wgmma:
//
//   out[o, :] = sum_k X[idx[k, o], :] @ W[k]        idx = -1: no pair
//
// float32 X, W and output, 3xTF32 products with float32 sums.  Replaces the
// Pallas forward family of the JAX package on float32 features,
// minkowskiengine_tpu/ops/pallas/conv_kernel.py::sparse_conv_fwd_pallas
// (:1105), for every call whose Cin and Cout are multiples of 8 and whose X
// and W are 16-byte aligned; the same kernel computes the input gradient
// (the inverse map, W[k] transposed) and the transposed conv.
// gather_gemm.cu keeps the mma.sync body for odd or unaligned widths and
// the SIMT stem for Cin <= 4.
//
// What bounds it on the H100: the tensor work of 3xTF32 (three TF32
// products per multiply-add, so at most a third of the 495 TFLOP/s TF32
// peak) and moving the operands into shared memory, a stage at a time.  On
// a 326,546-row 96 -> 96 call of an earlier layout of this body, the
// products alone ran at 55% of the TF32 peak over the slots computed
// (paired or not) and the copies alone took 70% of the whole time.  The
// mma.sync body (gather_gemm.cu) walked (active offsets x Cin / 32) stages
// of 64 rows through a 3-stage ring, 24 mma.sync per warp and k-step behind
// each stage's L2 gathers, gathered every X row once per 64-wide Cout tile
// (twice for Cout 96 and 128, four times for 256) and padded a 16-wide
// Cout to 64; a MinkUNet34 step took 7.4 + 6.6 ms in it against 0.28 +
// 0.27 ms bounds.
//
// Design:
//   * TF32 wgmma takes only K-major shared operands.  A is the gathered X
//     rows, K-major as they lie; the threads read them from shared memory,
//     split them into tf32 hi = rn(x) and lo = rn(x - hi) in registers and
//     feed wgmma from registers.  B must lie in shared memory in both
//     halves: each stage brings W[k]'s 32 x BN chunk as it lies (Cin rows)
//     through the ring, and, while the stage before runs its products, each
//     thread splits the pieces it copied itself (its own cp.async wait
//     suffices) into hi = rn(w) and lo = w - hi (exact in float32; the
//     tensor core reads its top 19 bits), stored transposed (Cout rows,
//     K-major, 128-byte swizzled) into one of two (hi, lo) tile pairs.
//     W comes from L2 once a stage, as it lies: a preparation launch that
//     wrote W[k]^T's halves to a buffer read them twice a stage and made
//     the stride-1 96-wide calls 15% slower (3.10 against 2.70 ms at
//     326,546 rows on the H100); splitting from registers loaded a stage
//     ahead exposed their latency (3.81 ms).
//   * Within every 8 of Cin the B tiles hold the channels in the order 0,
//     2, 4, 6, 1, 3, 5, 7 (a sum's terms reordered, nothing else), so that
//     a thread's two A values of a k-step (columns t and t + 4 of the
//     fragment) are X's adjacent columns 2t, 2t + 1: one 8-byte load each
//     for rows g and g + 8.  X's 16-byte chunk c of row m lies at chunk
//     c ^ 2 (m % 4), which puts those loads of a half-warp on 32 banks.
//   * one block per 128 output rows x BN output channels x range of
//     offsets (the offset split), two warpgroups of 64 rows sharing each
//     stage's W[k] chunk, one block an SM.  BN is Cout rounded up to one of
//     16, 32, 48, 64, 96, 128 (Cout > 128: the fewest tiles of at most
//     128), so for Cout <= 128 each X row is gathered once per row tile.
//     W[k]'s chunk outweighs the paired X rows of a stage from BN = 32 on
//     (a stride-1 map pairs about a third of the slots), so rows share it
//     rather than channels share the X rows: a 64 x 256 tile of two
//     warpgroups side by side ran at 3 stages with spills (a warpgroup's
//     accumulator and stage partial take BN floats a thread) and took 1.8x
//     the mma.sync body's time on the deep levels;
//   * the tile's indices for up to 32 offsets go to shared memory, and one
//     vote per offset keeps only the offsets with a pair in the tile;
//   * each stage is one (offset, 32-wide Cin chunk): the gathered X rows,
//     128 bytes each, and W[k]'s chunk, copied with 16-byte cp.async,
//     zero-filled for -1, indices >= N_in and the ragged edges; the ring is
//     as deep as the shared memory allows (4-8 stages), STAGES - 1 stages
//     in flight while one is computed; one barrier a stage;
//   * per stage and each of its 4 k-steps of 8 (a ragged Cin chunk's
//     zero-filled k-steps add zeros) three wgmma m64nNk8, lo x hi, hi x lo,
//     hi x hi, into a partial that the stage's first product zeroes
//     (scale-d 0), added to the float32 accumulator with round-to-nearest
//     adds once the stage's products are done: the tensor core's float32
//     accumulation truncates (mma_tile.cuh), and a long running sum would
//     drift toward zero by an ulp of the sum per product;
//   * the tile is written as float32, or, with S > 1 offset ranges, to the
//     (S, N_out, Cout) workspace, whose in-order sum (mma_tile.cuh::
//     sum_splits) gives the output.  No atomics: two launches give the same
//     bits.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = 32;  // Cin per stage: one 128-byte row of X
constexpr int KG = 32;  // offsets whose indices are staged at once

constexpr int BM = 128;       // output rows per block: two warpgroups of 64
constexpr int THREADS = 256;

// BN output channels (wgmma N) by BM output rows
template <int BN>
struct FTile {
  static constexpr int A_BYTES = BM * 128;  // BM rows of 32 floats
  // W[k]'s chunk as it lies: 32 Cin rows of BN, each padded by 16 bytes so
  // that a quarter-warp's 8 rows of 16-byte pieces hit distinct banks
  static constexpr int LDW = BN + 4;
  static constexpr int W_BYTES = BK * LDW * 4;
  static constexpr int STAGE = A_BYTES + W_BYTES;  // a stage of the ring
  static constexpr int B_BYTES = BN * 128;  // one tf32 half of W[k]^T's chunk: BN rows of 32
  // the 1024-byte alignment slack, two (hi, lo) pairs of B tiles, and the
  // indices beside the ring
  static constexpr int FIXED = 1024 + 4 * B_BYTES + (KG * BM + 2 * KG + 4) * 4;
  static constexpr int LIMIT = 227 * 1024;  // one block an SM
  static constexpr int STAGES = (LIMIT - FIXED) / STAGE < 8 ? (LIMIT - FIXED) / STAGE : 8;
  static constexpr int AHEAD = STAGES - 1;  // stages in flight ahead of the one computed
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(B_BYTES % 1024 == 0 && STAGE % 128 == 0 && BN % 16 == 0 && BN <= 128 && STAGES >= 4,
                "tile");
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gather_gemm_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ idx, float* __restrict__ dst, int n_in,
                          int n_out, int k_vol, int cin, int cout, int offsets_per_split) {
  using T = FTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* pairs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [2][hi|lo]
  uint8_t* ring = pairs + 4 * T::B_BYTES;  // [STAGES][A|W]
  int* rows = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);  // [KG][BM]
  int* has_pair = rows + KG * BM;                                   // [KG]
  int* active = has_pair + KG;  // [KG] offsets (in the group) to run
  int* n_active = active + KG;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = tid / 128;           // the warpgroup's 64 rows of the tile
  const int warp = (tid % 128) / 32;  // the warp's 16 rows of the group's
  const int wid = tid / 32;           // the warp in the block
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * offsets_per_split;
  const int k_end = min(k_vol, k_begin + offsets_per_split);
  const int n_chunks = (cin + BK - 1) / BK;
  // W[k]'s chunk is copied and split in warp-wide blocks of 8 Cin rows x 16
  // channels, block wid + 8 i: this thread's 16-byte piece is row wc, and
  // channels wn .. wn + 3 of the block
  const int wc = lane % 8;
  const int wn = 4 * (lane / 8);

  float acc[BN / 2];
  float part[BN / 2];  // one stage's products
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

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

    // stage s: offset active[s / n_chunks], Cin chunk s % n_chunks: its X
    // rows and W[k]'s chunk, by cp.async
    auto issue = [&](int s) {
      const int kl = active[s / n_chunks];
      const int c0 = (s % n_chunks) * BK;
      uint8_t* a_dst = ring + (s % T::STAGES) * T::STAGE;
      uint8_t* w_dst = a_dst + T::A_BYTES;
      const int* rows_k = rows + kl * BM;
      // each thread copies the 16-byte chunk c = tid % 8 (Cin c0 + 4c ..)
      // of rows tid / 8 + 32 i
      const int c = tid % 8;
      const bool c_ok = c0 + 4 * c < cin;
      // A: row m's chunk c at chunk c ^ 2 (m % 4)
#pragma unroll
      for (int i = 0; i < BM / 32; ++i) {
        const int m = tid / 8 + 32 * i;
        const int r = rows_k[m];
        const bool ok = r >= 0 && c_ok;
        const float* src = ok ? x + static_cast<int64_t>(r) * cin + c0 + 4 * c : x;
        cp_async16(a_dst + m * 128 + ((c ^ ((m & 3) << 1)) << 4), src, ok);
      }
      // W[k] rows c0 .. c0 + 31, channels n0 .. n0 + BN - 1, as they lie
      const float* wk = w + static_cast<int64_t>(kg0 + kl) * cin * cout;
#pragma unroll
      for (int i = 0; i < (BN + 31) / 32; ++i) {
        const int b = wid + 8 * i;
        if (BN % 32 != 0 && b >= BN / 4) break;
        const int kk = 8 * (b % 4) + wc;
        const int n = 16 * (b / 4) + wn;
        const bool ok = c0 + kk < cin && n0 + n < cout;
        const float* src = ok ? wk + static_cast<int64_t>(c0 + kk) * cout + n0 + n : w;
        cp_async16(w_dst + (kk * T::LDW + n) * 4, src, ok);
      }
    };
    // this thread's pieces of stage s's W chunk (landed: its own copies),
    // split into tf32 hi and lo = w - hi and stored K-major (W[k]^T) into
    // B pair s % 2, Cin row kk at its place in the Cin order above
    auto split_w = [&](int s) {
      const uint8_t* w_src = ring + (s % T::STAGES) * T::STAGE + T::A_BYTES;
      uint8_t* b_dst = pairs + (s % 2) * 2 * T::B_BYTES;
#pragma unroll
      for (int i = 0; i < (BN + 31) / 32; ++i) {
        const int b = wid + 8 * i;
        if (BN % 32 != 0 && b >= BN / 4) break;
        const int kk = 8 * (b % 4) + wc;
        const int n = 16 * (b / 4) + wn;
        const float4 v = *reinterpret_cast<const float4*>(w_src + (kk * T::LDW + n) * 4);
        const int place = (kk & ~7) | ((kk >> 1) & 3) | ((kk & 1) << 2);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = Swizzle<128>::at((n + j) * 128 + place * 4);
          const float hi = __uint_as_float(to_tf32(vs[j]));
          *reinterpret_cast<float*>(b_dst + at) = hi;
          *reinterpret_cast<float*>(b_dst + T::B_BYTES + at) = vs[j] - hi;
        }
      }
    };

#pragma unroll
    for (int p = 0; p < T::AHEAD; ++p) {
      if (p < stages) issue(p);
      cp_async_commit();
    }
    cp_async_wait<T::AHEAD - 1>();  // stage 0's copies of this thread
    if (stages > 0) split_w(0);
    fence_proxy_async();
    for (int s = 0; s < stages; ++s) {
      // every thread's copies of stage s are in and its B pair is split (and
      // made visible to wgmma), and every warpgroup is done with stage s - 1,
      // so its ring slot takes stage s + AHEAD and its pair stage s + 1
      __syncthreads();
      if (s + T::AHEAD < stages) issue(s + T::AHEAD);
      cp_async_commit();
      const uint8_t* a_s = ring + (s % T::STAGES) * T::STAGE;
      // A fragments of k-step j: rows r0, r0 + 8; fragment columns t, t + 4
      // are X's columns 8j + 2t, 8j + 2t + 1 (the buffer's Cin order)
      uint32_t a_hi[4][4], a_lo[4][4];
      const uint8_t* a_row = a_s + (wm * 64 + warp * 16 + g) * 128 + (t & 1) * 8;
      const int swz = (g & 3) << 1;  // rows g and g + 8 share it
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = *reinterpret_cast<const float2*>(
              a_row + h * 8 * 128 + (((2 * j + (t >> 1)) ^ swz) << 4));
          split_tf32(v.x, a_hi[j][h], a_lo[j][h]);
          split_tf32(v.y, a_hi[j][2 + h], a_lo[j][2 + h]);
        }
      }
      const uint8_t* b_s = pairs + (s % 2) * 2 * T::B_BYTES;
      const uint64_t dh = smem_desc(b_s, 16, 1024, Swizzle<128>::MODE);
      const uint64_t dl = smem_desc(b_s + T::B_BYTES, 16, 1024, Swizzle<128>::MODE);
      fence_registers(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_tf32<BN>(part, a_lo[j], desc_plus(dh, 32 * j), j > 0);
        wgmma_tf32<BN>(part, a_hi[j], desc_plus(dl, 32 * j), 1);
        wgmma_tf32<BN>(part, a_hi[j], desc_plus(dh, 32 * j), 1);
      }
      wgmma_commit();
      // while they run: stage s + 1's W chunk, split into the other pair
      cp_async_wait<T::AHEAD - 1>();
      if (s + 1 < stages) split_w(s + 1);
      fence_proxy_async();
      wgmma_wait<0>();
      fence_registers(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
  }

  // this block's tile of split blockIdx.z (the output itself when S = 1);
  // Cout is a multiple of 8, so a column pair is in range or out together
  float* out = dst + static_cast<int64_t>(blockIdx.z) * n_out * cout;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int col = n0 + jb * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + wm * 64 + warp * 16 + g + h * 8;
      if (o >= n_out || col >= cout) continue;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(o) * cout + col) =
          make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
  }
}

template <int BN>
cudaError_t launch(dim3 grid, cudaStream_t s, const float* x, const float* w, const int* idx,
                   float* dst, int n_in, int n_out, int k_vol, int cin, int cout,
                   int offsets_per_split) {
  return launch_dynamic(gather_gemm_3xtf32_kernel<BN>, grid, THREADS, FTile<BN>::SMEM, s, x, w,
                        idx, dst, n_in, n_out, k_vol, cin, cout, offsets_per_split);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// float32 x, w and out; workspace: (splits, n_out, cout) float32 when
// splits > 1, else unused.  bn: the Cout tile, one of 16, 32,
// 48, 64, 96, 128; bm: the row tile, 128.  Takes Cin and Cout multiples of
// 8 and 16-byte aligned x and w.
extern "C" int me_gather_gemm_f32_wgmma(const void* x, const void* w, const void* idx, void* out,
                                        void* workspace, int n_in, int n_out, int k_vol, int cin,
                                        int cout, int splits, int bn, int bm, void* stream) {
  if (n_out <= 0 || cout <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || k_vol < 1 || bm != BM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin % 8 != 0 || cout % 8 != 0 || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (k_vol + splits - 1) / splits;
  const dim3 grid((n_out + bm - 1) / bm, (cout + bn - 1) / bn, splits);
  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  const int* ii = static_cast<const int*>(idx);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err = cudaErrorInvalidValue;
#define ME_TF32_TILE(N) \
  if (bn == N) err = launch<N>(grid, s, xt, wt, ii, dst, n_in, n_out, k_vol, cin, cout, per);
  ME_TF32_TILE(16)
  ME_TF32_TILE(32)
  ME_TF32_TILE(48)
  ME_TF32_TILE(64)
  ME_TF32_TILE(96)
  ME_TF32_TILE(128)
#undef ME_TF32_TILE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(static_cast<const float*>(workspace), static_cast<float*>(out),
                                     static_cast<int64_t>(n_out) * cout, splits, s));
}
