// Serialized patch attention (Point Transformer V3) on Hopper (sm_90a):
// multi-head attention inside the windows of a window plan
// (coords/serialize.py), forward and backward, float32 by 3xTF32 wgmma.
//
//   for each window w (positions ws .. ws + n - 1 of the plan), head h and
//   position p of w:   O_p = softmax(scale Q_p K^T) V
//
// where Q, K and V are head h's D columns of the q, k and v thirds of
// qkv (N, 3C) at the map rows of the window's positions.  Map row rows[p]
// takes O_p from the position that owns it (the first window that holds
// the row: a scene's shifted last window shares rows with the one before).
//
// It replaces no TPU kernel: the JAX package has no attention.  It was
// added because PyTorch's memory-efficient attention, which the port
// called before, runs float32 on the CUDA cores (CUTLASS's sm80 SIMT
// kernel) and took 55% of the device time of a float32 PTv3 training step
// on 2 cm rooms.
//
// What bounds it on the H100: the products, 4 L^2 D operations a window
// of L rows and head forward (S = Q K^T, O = P V) and 10 L^2 D backward
// (S recomputed, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), in
// 3xTF32 (three TF32 products for each multiply-add, so at most a third of
// the 495 TFLOP/s TF32 peak); and beside them one exponential a score
// forward and one backward on the SFU (16 a clock an SM).  At D = 16 a
// score's two forward products take 0.09 of an SM's tensor clock and its
// exponential 0.06 of an SM clock: neither is far below the other, so the
// softmax has to run while other warps' products do.  Moving the rows is
// small beside both: each row of a window is read once a block of 128
// queries (forward) or 64 keys (backward).
//
// Design:
//   * The plan's gather is in the loads.  ``rows`` (int32; ~row at a
//     position that does not own its row) gives each position's map row;
//     Q, K, V (and dO, O) rows come in by 16-byte cp.async of their D
//     columns, and the output is stored only at the positions that own
//     their row, straight into (N, C).  ``bounds`` (windows + 1) gives each
//     window's positions, so full and short windows go in one launch: keys
//     past a short window's n are masked to -inf (their rows zero-filled),
//     rows past n are not stored.
//   * TF32 wgmma takes shared-memory operands only K-major, and A may come
//     from registers.  So the operand that stays (Q forward; K and V
//     backward) is split into tf32 hi and lo in registers once and fed as
//     A (K and V backward: at each stage); each stage's rows come through a ring of raw cp.async stages, and
//     each thread splits the 16-byte pieces it copied itself (its own
//     cp.async wait suffices) into hi and lo = x - hi tiles: as they lie
//     where the head dimension is the product's K (K for S = Q K^T; Q and
//     dO for S^T = K Q^T and dP^T = V dO^T), transposed where the window's
//     rows are (V^T for P V; Q^T, dO^T for dK, dV; K^T for dQ).  Rows of
//     128 bytes, swizzled as wgmma.cuh describes; a 16-wide head uses half
//     of each row.
//   * Within every 8 columns of a tile the indices lie in the order 0, 2,
//     4, 6, 1, 3, 5, 7 (the order of a sum's terms, nothing else), so that
//     an accumulator's adjacent columns 2t, 2t + 1 are columns t, t + 4 of a
//     tf32 A fragment: P (and dS) go from the accumulator of S (dS^T) into
//     the next product's A without a shuffle, and the row operands load
//     two adjacent values with one 8-byte load.
//   * Every product chain is at most 12 wgmma (4 k-steps of 8, three
//     products each) into a zeroed partial, added to the float32 sum with
//     round-to-nearest adds: the tensor core's accumulation truncates
//     (mma_tile.cuh).
//   * Forward: one block per (128 query rows, head, window), two
//     warpgroups of 64 rows sharing each stage of 64 keys, two blocks an SM
//     at D = 16 (their split
//     tiles are double-buffered: stage s + 1 is split while stage s's
//     products run); online softmax in base 2 (exp2 of scale log2(e) S less
//     the running maximum); the log-sum-exp of each row (base 2) is kept
//     for the backward.
//   * Backward: Delta = rowsum(dO o O) by a small pass first.  Then
//     FlashAttention-2's key-stationary loop: one block per (64 key rows,
//     head, window), one warpgroup, two blocks an SM at D = 16; the block's
//     K and V rows are split into A fragments again at each stage from L1
//     (kept between stages they left a 64-wide head no registers); per stage
//     of 64 queries S^T = K Q^T, P^T = exp2(scale log2(e) S^T - lse),
//     dV += P^T dO, dP^T = V dO^T, dS^T = scale P^T o (dP^T - Delta),
//     dK += dS^T Q; dS^T goes to shared memory as dS (queries x keys, hi and
//     lo) for dQ = dS K.  dO is read only where the position owns its row
//     (zero elsewhere: that position's output is not used), so a shared row
//     is counted once.  dK and dV are written once; dQ is added to the
//     window-order output with float32 atomics (float2), L / 64 additions
//     an element in no fixed order, so two launches may differ in the last
//     bits of dQ (relative 1e-7).  The window-order gradient is summed into
//     the rows by the caller's index_add_.
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int KEYS = 64;     // keys a forward stage, queries a backward stage
constexpr int LIMIT = 227 * 1024;

// where index i of its group of 8 lies in a tile row: 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ int place8(int i) {
  return (i & ~7) | ((i >> 1) & 3) | ((i & 1) << 2);
}

// the tf32 value nearest v (ties away from zero); v - tf32_hi(v) is exact
__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a (hi, lo) pair of tf32 A fragments from four float32 values (a0 .. a3 as
// wgmma.cuh orders them); the tensor core reads lo's top 19 bits
__device__ __forceinline__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0, float a1,
                                     float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_hi(v[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(v[i] - h);
  }
}

// keeps the compiler from moving register operands of an in-flight wgmma
template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// the A fragments of a warp's 16 rows of a stationary operand: rows a (g)
// and b (g + 8), each D columns or null (zero); column t of k-step j is
// the row's column 8j + 2t, column t + 4 its column 8j + 2t + 1
template <int D>
__device__ __forceinline__ void row_frags(uint32_t (&hi)[D / 8][4], uint32_t (&lo)[D / 8][4],
                                          const float* a, const float* b, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 x = a ? __ldg(reinterpret_cast<const float2*>(a + 8 * j + 2 * t)) : float2{0.f, 0.f};
    const float2 y = b ? __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * t)) : float2{0.f, 0.f};
    frag(hi[j], lo[j], x.x, y.x, x.y, y.y);
  }
}

// A ROWS x COLS float32 operand in shared memory, K-major (a row's COLS
// values run along the product's K), in chunks of 32 columns: ROWS rows of
// 128 bytes each, 128-byte swizzled (a 16-column operand fills half of
// each row); column c at place8(c) within its group of 8.  The tf32 hi
// half lies at the base and the lo half BYTES on.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int CHUNK = ROWS * 128;
  static constexpr int BYTES = (COLS + 31) / 32 * CHUNK;
  static_assert(ROWS % 8 == 0 && COLS % 16 == 0 && CHUNK % 1024 == 0, "tile");

  static __device__ __forceinline__ int at(int r, int c) {
    const int b = place8(c) * 4;
    return (b / 128) * CHUNK + Swizzle<128>::at(r * 128 + b % 128);
  }
  // v's halves at byte offset o (``at``); a row 8k further on lies 1024k
  // bytes on, its swizzle unchanged
  static __device__ __forceinline__ void store(uint8_t* base, int o, float v) {
    const float hi = tf32_hi(v);
    *reinterpret_cast<float*>(base + o) = hi;
    *reinterpret_cast<float*>(base + BYTES + o) = v - hi;
  }
  static __device__ __forceinline__ void put(uint8_t* base, int r, int c, float v) {
    store(base, at(r, c), v);
  }
  // the descriptor of k-step j (columns 8j .. 8j + 7) of the hi (lo = 0) or lo half
  static __device__ __forceinline__ uint64_t desc(const uint8_t* base, int lo, int j) {
    return smem_desc(base + lo * BYTES + (j / 4) * CHUNK + 32 * (j % 4), 16, 1024,
                     Swizzle<128>::MODE);
  }
};

__device__ __forceinline__ int row_of(int v) { return v >= 0 ? v : ~v; }

// ---------------------------------------------------------------- forward

constexpr int FWD_THREADS = 256;
constexpr int FWD_ROWS = 128;  // query rows a block: two warpgroups of 64

template <int D>
struct Fwd {
  using KT = Tile<KEYS, D>;  // K rows: B of S = Q K^T
  using VT = Tile<D, KEYS>;  // V^T: B of O = P V
  static constexpr int RAW = 2 * KEYS * D * 4;  // a stage's K and V rows as they lie
  static constexpr int PAIR = 2 * KT::BYTES + 2 * VT::BYTES;
  static constexpr int FIXED = 1024 + 2 * PAIR;
  static constexpr int STAGES = (LIMIT - FIXED) / RAW < 4 ? (LIMIT - FIXED) / RAW : 4;
  static constexpr int AHEAD = STAGES - 1;
  static constexpr int SMEM = FIXED + STAGES * RAW;
  static constexpr int PIECES = KEYS * D / 4 / FWD_THREADS;  // 16-byte pieces of K (and V) a thread
  // two blocks an SM at D = 16 (126 registers, no spills; on the H100 two
  // blocks ran PTv3's level-0 forward calls a quarter faster than one block
  // at 135 registers)
  static constexpr int MIN_BLOCKS = D == 16 ? 2 : 1;
  static_assert(STAGES >= 2 && PIECES >= 1, "forward tiles");
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, Fwd<D>::MIN_BLOCKS)
attention_fwd_3xtf32_kernel(const float* __restrict__ qkv, const int* __restrict__ rows,
                            const int* __restrict__ bounds, float* __restrict__ out,
                            float* __restrict__ lse, int positions, int heads, float scale2) {
  using F = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* pairs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [2][K hi|lo, V^T hi|lo]
  uint8_t* ring = pairs + 2 * F::PAIR;                                         // [STAGES][K | V]

  const int h = blockIdx.y;
  const int ws = bounds[blockIdx.z];
  const int n = bounds[blockIdx.z + 1] - ws;
  const int q0 = blockIdx.x * FWD_ROWS;
  if (q0 >= n) return;
  const int C = heads * D;
  const int C3 = 3 * C;
  const int* win = rows + ws;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int stages = (n + KEYS - 1) / KEYS;

  // Q of this thread's rows qa (g) and qb (g + 8), split once
  const int qa = q0 + wg * 64 + warp * 16 + g;
  const int qb = qa + 8;
  uint32_t q_hi[D / 8][4], q_lo[D / 8][4];
  row_frags<D>(q_hi, q_lo, qa < n ? qkv + static_cast<int64_t>(row_of(win[qa])) * C3 + h * D : nullptr,
               qb < n ? qkv + static_cast<int64_t>(row_of(win[qb])) * C3 + h * D : nullptr, t);

  // this thread's pieces of a stage: key row m = e / (D / 4), 16-byte chunk
  // c = e % (D / 4), e = tid + FWD_THREADS i; the rows of the next stage
  // to issue are read one issue ahead
  int next[F::PIECES];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < F::PIECES; ++i) {
      const int key = s * KEYS + (tid + FWD_THREADS * i) / (D / 4);
      next[i] = key < n ? win[key] : 0;
    }
  };
  auto issue = [&](int s) {
    uint8_t* slot = ring + (s % F::STAGES) * F::RAW;
#pragma unroll
    for (int i = 0; i < F::PIECES; ++i) {
      const int e = tid + FWD_THREADS * i;
      const int m = e / (D / 4);
      const int c = e % (D / 4);
      const bool ok = s * KEYS + m < n;
      const float* src = qkv + static_cast<int64_t>(row_of(next[i])) * C3 + C + h * D + 4 * c;
      cp_async16(slot + (m * D + 4 * c) * 4, ok ? src : qkv, ok);
      cp_async16(slot + (KEYS * D + m * D + 4 * c) * 4, ok ? src + C : qkv, ok);
    }
    fetch(s + 1);
  };
  auto split = [&](int s) {
    const uint8_t* slot = ring + (s % F::STAGES) * F::RAW;
    uint8_t* kt = pairs + (s % 2) * F::PAIR;
    uint8_t* vt = kt + 2 * F::KT::BYTES;
    // piece i's row is m0 + i ROWS_STEP (a multiple of 8 rows), its chunk c
    constexpr int ROWS_STEP = FWD_THREADS / (D / 4);
    const int m0 = tid / (D / 4);
    const int c = tid % (D / 4);
#pragma unroll
    for (int i = 0; i < F::PIECES; ++i) {
      const int m = m0 + ROWS_STEP * i;
      const float4 k = *reinterpret_cast<const float4*>(slot + (m * D + 4 * c) * 4);
      const float4 v = *reinterpret_cast<const float4*>(slot + (KEYS * D + m * D + 4 * c) * 4);
      const float ks[4] = {k.x, k.y, k.z, k.w};
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        F::KT::store(kt, F::KT::at(m0, 4 * c + u) + ROWS_STEP * 128 * i, ks[u]);
        F::VT::put(vt, 4 * c + u, m, vs[u]);
      }
    }
  };

  fetch(0);
#pragma unroll
  for (int p = 0; p < F::AHEAD; ++p) {
    if (p < stages) issue(p);
    cp_async_commit();
  }
  cp_async_wait<F::AHEAD - 1>();  // stage 0's copies of this thread
  split(0);
  fence_proxy_async();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima (base 2) of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  for (int s = 0; s < stages; ++s) {
    // every thread's stage s is split and visible to wgmma, and both
    // warpgroups are done with stage s - 1: its ring slot takes stage
    // s + AHEAD and its pair stage s + 1
    __syncthreads();
    if (s + F::AHEAD < stages) issue(s + F::AHEAD);
    cp_async_commit();
    const uint8_t* kt = pairs + (s % 2) * F::PAIR;
    const uint8_t* vt = kt + 2 * F::KT::BYTES;

    float sc[KEYS / 2];  // S: rows g, g + 8 of the warp; columns 8j + 2t, + 1
    fence_registers(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      wgmma_tf32<KEYS>(sc, q_lo[j], F::KT::desc(kt, 0, j), j > 0);
      wgmma_tf32<KEYS>(sc, q_hi[j], F::KT::desc(kt, 1, j), 1);
      wgmma_tf32<KEYS>(sc, q_hi[j], F::KT::desc(kt, 0, j), 1);
    }
    wgmma_commit();
    // while they run: stage s + 1's rows, split into the other pair
    cp_async_wait<F::AHEAD - 1>();
    if (s + 1 < stages) split(s + 1);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_registers(sc);
    fence_frags(q_hi);
    fence_frags(q_lo);

    const int k0 = s * KEYS;
    if (k0 + KEYS > n) {  // a short window's keys past n
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t + e >= n) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    }
    const float n0 = fmaxf(m0, x0 * scale2);
    const float n1 = fmaxf(m1, x1 * scale2);
    const float a0 = ex2(m0 - n0);
    const float a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale2, -n0));
        sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale2, -n1));
        s0 += sc[4 * j + e];
        s1 += sc[4 * j + 2 + e];
      }
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      acc[4 * jb] *= a0;
      acc[4 * jb + 1] *= a0;
      acc[4 * jb + 2] *= a1;
      acc[4 * jb + 3] *= a1;
    }
    // O += P V, a half of 32 keys at a time into a zeroed partial
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * half + jj;
        frag(p_hi[jj], p_lo[jj], sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]);
      }
      float part[D / 2];
      fence_registers(part);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * half + jj;
        wgmma_tf32<D>(part, p_lo[jj], F::VT::desc(vt, 0, j), jj > 0);
        wgmma_tf32<D>(part, p_hi[jj], F::VT::desc(vt, 1, j), 1);
        wgmma_tf32<D>(part, p_hi[jj], F::VT::desc(vt, 0, j), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(part);
      fence_frags(p_hi);
      fence_frags(p_lo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = r ? qb : qa;
    if (q >= n) continue;
    const float l = r ? l1 : l0;
    if (t == 0) lse[static_cast<int64_t>(h) * positions + ws + q] = (r ? m1 : m0) + log2f(l);
    const int v = win[q];
    if (v < 0) continue;  // another window's position owns the row
    const float inv = 1.f / l;
    float* dst = out + static_cast<int64_t>(v) * C + h * D + 2 * t;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<float2*>(dst + 8 * jb) =
          make_float2(acc[4 * jb + 2 * r] * inv, acc[4 * jb + 2 * r + 1] * inv);
  }
}

// --------------------------------------------------------------- backward

// delta[h, p] = sum over head h's columns of dO o O at position p's row,
// where p owns it; 0 elsewhere
template <int D>
__global__ void attention_bwd_delta_kernel(const float* __restrict__ out,
                                           const float* __restrict__ dout,
                                           const int* __restrict__ rows, float* __restrict__ delta,
                                           int positions, int heads) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(positions) * heads) return;
  const int p = static_cast<int>(e / heads);
  const int h = static_cast<int>(e % heads);
  const int v = rows[p];
  float sum = 0.f;
  if (v >= 0) {
    const int64_t at = static_cast<int64_t>(v) * heads * D + h * D;
    const float4* o = reinterpret_cast<const float4*>(out + at);
    const float4* d = reinterpret_cast<const float4*>(dout + at);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 a = __ldg(o + i);
      const float4 b = __ldg(d + i);
      sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  }
  delta[static_cast<int64_t>(h) * positions + p] = sum;
}

constexpr int BWD_THREADS = 128;  // one warpgroup: 64 key rows a block

template <int D>
struct Bwd {
  using RT = Tile<KEYS, D>;   // Q or dO rows: B of S^T = K Q^T, dP^T = V dO^T
  using CT = Tile<D, KEYS>;   // Q^T or dO^T: B of dK = dS^T Q, dV = P^T dO
  using ST = Tile<KEYS, 64>;  // dS, queries x keys: A of dQ = dS K
  using KT = Tile<D, 64>;     // K^T: B of dQ
  static constexpr int RAW = 2 * KEYS * D * 4;  // a stage's Q and dO rows as they lie
  static constexpr int SPLIT = 4 * RT::BYTES + 4 * CT::BYTES;
  static constexpr int STATS = 2 * 2 * KEYS * 4;  // lse and Delta of a stage, two stages
  static constexpr int FIXED = 1024 + SPLIT + 2 * ST::BYTES + 2 * KT::BYTES + STATS;
  static constexpr int STAGES = (LIMIT - FIXED) / RAW < 2 ? (LIMIT - FIXED) / RAW : 2;
  static constexpr int SMEM = FIXED + STAGES * RAW;
  static constexpr int PIECES = KEYS * D / 4 / BWD_THREADS;
  static constexpr int MIN_BLOCKS = D == 16 ? 2 : 1;
  static_assert(STAGES >= 1 && PIECES >= 1, "backward tiles");
};

template <int D>
__global__ void __launch_bounds__(BWD_THREADS, Bwd<D>::MIN_BLOCKS)
attention_bwd_3xtf32_kernel(const float* __restrict__ qkv, const int* __restrict__ rows,
                            const int* __restrict__ bounds, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dqkv, int positions, int heads, float scale) {
  using B = Bwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qr = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // Q rows hi|lo
  uint8_t* dor = qr + 2 * B::RT::BYTES;                                     // dO rows
  uint8_t* qc = dor + 2 * B::RT::BYTES;                                     // Q^T
  uint8_t* doc = qc + 2 * B::CT::BYTES;                                     // dO^T
  uint8_t* ds = doc + 2 * B::CT::BYTES;                                     // dS
  uint8_t* kt = ds + 2 * B::ST::BYTES;                                      // K^T
  float* stats = reinterpret_cast<float*>(kt + 2 * B::KT::BYTES);  // [2][lse | Delta][KEYS]
  uint8_t* ring = reinterpret_cast<uint8_t*>(stats + 4 * KEYS);    // [STAGES][Q | dO]

  const int h = blockIdx.y;
  const int ws = bounds[blockIdx.z];
  const int n = bounds[blockIdx.z + 1] - ws;
  const int k0 = blockIdx.x * 64;
  if (k0 >= n) return;
  const int C = heads * D;
  const int C3 = 3 * C;
  const int* win = rows + ws;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int stages = (n + KEYS - 1) / KEYS;
  const float scale2 = scale * LOG2E;

  // this thread's key rows ka (g) and kb (g + 8): their K and V are read
  // (from L1) and split into A fragments at each stage, which keeps them
  // out of the registers between stages; K^T is staged once for dQ
  const int la = warp * 16 + g;  // the rows within the block's 64
  const int ka = k0 + la;
  const int kb = ka + 8;
  const float* ra = ka < n ? qkv + static_cast<int64_t>(row_of(win[ka])) * C3 + C + h * D : nullptr;
  const float* rb = kb < n ? qkv + static_cast<int64_t>(row_of(win[kb])) * C3 + C + h * D : nullptr;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 x = ra ? __ldg(reinterpret_cast<const float2*>(ra + 8 * j + 2 * t)) : float2{0.f, 0.f};
    const float2 y = rb ? __ldg(reinterpret_cast<const float2*>(rb + 8 * j + 2 * t)) : float2{0.f, 0.f};
    B::KT::put(kt, 8 * j + 2 * t, la, x.x);
    B::KT::put(kt, 8 * j + 2 * t + 1, la, x.y);
    B::KT::put(kt, 8 * j + 2 * t, la + 8, y.x);
    B::KT::put(kt, 8 * j + 2 * t + 1, la + 8, y.y);
  }

  // this thread's pieces of a stage: query row m = e / (D / 4), chunk c,
  // e = tid + BWD_THREADS i; rows read one issue ahead; lse (threads 0-63)
  // or Delta (64-127) of one query read one split ahead
  int next[B::PIECES];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < B::PIECES; ++i) {
      const int q = s * KEYS + (tid + BWD_THREADS * i) / (D / 4);
      next[i] = q < n ? win[q] : 0;
    }
  };
  auto stat = [&](int s) {
    const int q = s * KEYS + tid % KEYS;
    if (q >= n) return 0.f;
    return (tid < KEYS ? lse : delta)[static_cast<int64_t>(h) * positions + ws + q];
  };
  auto issue = [&](int s) {
    uint8_t* slot = ring + (s % B::STAGES) * B::RAW;
#pragma unroll
    for (int i = 0; i < B::PIECES; ++i) {
      const int e = tid + BWD_THREADS * i;
      const int m = e / (D / 4);
      const int c = e % (D / 4);
      const bool ok = s * KEYS + m < n;
      const bool own = ok && next[i] >= 0;  // dO only where the position owns its row
      const int64_t r = row_of(next[i]);
      const float* q = qkv + r * C3 + h * D + 4 * c;
      const float* d = dout + r * C + h * D + 4 * c;
      cp_async16(slot + (m * D + 4 * c) * 4, ok ? q : qkv, ok);
      cp_async16(slot + (KEYS * D + m * D + 4 * c) * 4, own ? d : dout, own);
    }
    fetch(s + 1);
  };
  float pending = 0.f;  // the next split's lse or Delta
  auto split = [&](int s) {
    const uint8_t* slot = ring + (s % B::STAGES) * B::RAW;
    // piece i's row is m0 + i ROWS_STEP (a multiple of 8 rows), its chunk c
    constexpr int ROWS_STEP = BWD_THREADS / (D / 4);
    const int m0 = tid / (D / 4);
    const int c = tid % (D / 4);
#pragma unroll
    for (int i = 0; i < B::PIECES; ++i) {
      const int m = m0 + ROWS_STEP * i;
      const float4 q = *reinterpret_cast<const float4*>(slot + (m * D + 4 * c) * 4);
      const float4 d = *reinterpret_cast<const float4*>(slot + (KEYS * D + m * D + 4 * c) * 4);
      const float qs[4] = {q.x, q.y, q.z, q.w};
      const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = B::RT::at(m0, 4 * c + u) + ROWS_STEP * 128 * i;
        B::RT::store(qr, o, qs[u]);
        B::RT::store(dor, o, dd[u]);
        const int ot = B::CT::at(4 * c + u, m);
        B::CT::store(qc, ot, qs[u]);
        B::CT::store(doc, ot, dd[u]);
      }
    }
    stats[(s % 2) * 2 * KEYS + tid] = pending;
    pending = stat(s + 1);
  };

  // stage t's rows go to ring slot t % STAGES; the slot takes stage
  // t + STAGES once stage t is split.  One commit group per stage
  fetch(0);
  pending = stat(0);
#pragma unroll
  for (int p = 0; p < B::STAGES; ++p) {
    if (p < stages) issue(p);
    cp_async_commit();
  }
  cp_async_wait<B::STAGES - 1>();
  split(0);
  if (B::STAGES < stages) issue(B::STAGES);
  cp_async_commit();
  fence_proxy_async();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    // stage s is split and visible to wgmma; stage s - 1's dQ is done
    __syncthreads();
    const float* lse_s = stats + (s % 2) * 2 * KEYS;
    const float* delta_s = lse_s + KEYS;
    float st[KEYS / 2], dp[KEYS / 2];  // S^T, dP^T: key rows g, g + 8; query columns
    {
      uint32_t a_hi[D / 8][4], a_lo[D / 8][4];
      row_frags<D>(a_hi, a_lo, ra, rb, t);  // K
      fence_registers(st);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        wgmma_tf32<KEYS>(st, a_lo[j], B::RT::desc(qr, 0, j), j > 0);
        wgmma_tf32<KEYS>(st, a_hi[j], B::RT::desc(qr, 1, j), 1);
        wgmma_tf32<KEYS>(st, a_hi[j], B::RT::desc(qr, 0, j), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(st);
      fence_frags(a_hi);
      fence_frags(a_lo);
    }
    uint32_t v_hi[D / 8][4], v_lo[D / 8][4];
    row_frags<D>(v_hi, v_lo, ra ? ra + C : nullptr, rb ? rb + C : nullptr, t);
    fence_registers(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      wgmma_tf32<KEYS>(dp, v_lo[j], B::RT::desc(dor, 0, j), j > 0);
      wgmma_tf32<KEYS>(dp, v_hi[j], B::RT::desc(dor, 1, j), 1);
      wgmma_tf32<KEYS>(dp, v_hi[j], B::RT::desc(dor, 0, j), 1);
    }
    wgmma_commit();
    // while they run: P^T = exp2(scale log2(e) S^T - lse), query columns 8j + 2t + e
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = lse_s[8 * j + 2 * t + e];
        st[4 * j + e] = ex2(fmaf(st[4 * j + e], scale2, -l));
        st[4 * j + 2 + e] = ex2(fmaf(st[4 * j + 2 + e], scale2, -l));
      }
    // dV += P^T dO: queries 0-31 and 32-63 into two zeroed partials
    {
      uint32_t a_hi[KEYS / 8][4], a_lo[KEYS / 8][4];
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
        frag(a_hi[j], a_lo[j], st[4 * j], st[4 * j + 2], st[4 * j + 1], st[4 * j + 3]);
      float v0[D / 2], v1[D / 2];
      fence_registers(v0);
      fence_registers(v1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        float(&part)[D / 2] = j < 4 ? v0 : v1;
        wgmma_tf32<D>(part, a_lo[j], B::CT::desc(doc, 0, j), j % 4 > 0);
        wgmma_tf32<D>(part, a_hi[j], B::CT::desc(doc, 1, j), 1);
        wgmma_tf32<D>(part, a_hi[j], B::CT::desc(doc, 0, j), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // dP^T's products too
      fence_registers(dp);
      fence_registers(v0);
      fence_registers(v1);
      fence_frags(v_hi);
      fence_frags(v_lo);
      fence_frags(a_hi);
      fence_frags(a_lo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] += v0[i] + v1[i];
    }
    // dS^T = scale P^T o (dP^T - Delta), into st; and as dS (query rows) for
    // dQ: query 8j + 2t + e lies 1024 j bytes after query 2t + e
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oa = B::ST::at(2 * t + e, la);
      const int ob = B::ST::at(2 * t + e, la + 8);
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const float dl = delta_s[8 * j + 2 * t + e];
        st[4 * j + e] = scale * st[4 * j + e] * (dp[4 * j + e] - dl);
        st[4 * j + 2 + e] = scale * st[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl);
        B::ST::store(ds, oa + 1024 * j, st[4 * j + e]);
        B::ST::store(ds, ob + 1024 * j, st[4 * j + 2 + e]);
      }
    }
    fence_proxy_async();
    // dK += dS^T Q: queries 0-31 and 32-63 into two zeroed partials; then,
    // once every warp's dS is written, dQ = dS K, keys 0-31 and 32-63 into
    // two more; one wait for both
    uint32_t a_hi[KEYS / 8][4], a_lo[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
      frag(a_hi[j], a_lo[j], st[4 * j], st[4 * j + 2], st[4 * j + 1], st[4 * j + 3]);
    float dk0[D / 2], dk1[D / 2];
    fence_registers(dk0);
    fence_registers(dk1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      float(&part)[D / 2] = j < 4 ? dk0 : dk1;
      wgmma_tf32<D>(part, a_lo[j], B::CT::desc(qc, 0, j), j % 4 > 0);
      wgmma_tf32<D>(part, a_hi[j], B::CT::desc(qc, 1, j), 1);
      wgmma_tf32<D>(part, a_hi[j], B::CT::desc(qc, 0, j), 1);
    }
    wgmma_commit();
    __syncthreads();
    float dq0[D / 2], dq1[D / 2];
    fence_registers(dq0);
    fence_registers(dq1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32_ss<D>(dq0, B::ST::desc(ds, 1, j), B::KT::desc(kt, 0, j), j > 0);
      wgmma_tf32_ss<D>(dq0, B::ST::desc(ds, 0, j), B::KT::desc(kt, 1, j), 1);
      wgmma_tf32_ss<D>(dq0, B::ST::desc(ds, 0, j), B::KT::desc(kt, 0, j), 1);
    }
#pragma unroll
    for (int j = 4; j < 8; ++j) {
      wgmma_tf32_ss<D>(dq1, B::ST::desc(ds, 1, j), B::KT::desc(kt, 0, j), j > 4);
      wgmma_tf32_ss<D>(dq1, B::ST::desc(ds, 0, j), B::KT::desc(kt, 1, j), 1);
      wgmma_tf32_ss<D>(dq1, B::ST::desc(ds, 0, j), B::KT::desc(kt, 0, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(dq0);
    fence_registers(dq1);
    fence_registers(dk0);
    fence_registers(dk1);
    fence_frags(a_hi);
    fence_frags(a_lo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] += dk0[i] + dk1[i];
    // once every warp is done with the split tiles: stage s + 1's rows,
    // split (ptxas at -O3 fails on this kernel when the split runs while
    // dQ's products do); its ring slot takes a later stage
    __syncthreads();
    if (s + 1 < stages) {
      cp_async_wait<B::STAGES - 1>();
      split(s + 1);
      if (s + 1 + B::STAGES < stages) issue(s + 1 + B::STAGES);
    }
    cp_async_commit();
    fence_proxy_async();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = s * KEYS + warp * 16 + g + 8 * r;
      if (q >= n) continue;
      float* dst = dqkv + static_cast<int64_t>(ws + q) * C3 + h * D + 2 * t;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * jb),
                  make_float2(dq0[i] + dq1[i], dq0[i + 1] + dq1[i + 1]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = r ? kb : ka;
    if (k >= n) continue;
    float* dst = dqkv + static_cast<int64_t>(ws + k) * C3 + C + h * D + 2 * t;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const int i = 4 * jb + 2 * r;
      *reinterpret_cast<float2*>(dst + 8 * jb) = make_float2(dk[i], dk[i + 1]);
      *reinterpret_cast<float2*>(dst + C + 8 * jb) = make_float2(dv[i], dv[i + 1]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int D>
cudaError_t forward(const float* qkv, const int* rows, const int* bounds, float* out, float* lse,
                    int positions, int windows, int max_len, int heads, float scale,
                    cudaStream_t s) {
  const dim3 grid((max_len + FWD_ROWS - 1) / FWD_ROWS, heads, windows);
  return launch_dynamic(attention_fwd_3xtf32_kernel<D>, grid, FWD_THREADS, Fwd<D>::SMEM, s, qkv,
                        rows, bounds, out, lse, positions, heads, scale * LOG2E);
}

template <int D>
cudaError_t backward(const float* qkv, const int* rows, const int* bounds, const float* out,
                     const float* dout, const float* lse, float* delta, float* dqkv, int positions,
                     int windows, int max_len, int heads, float scale, cudaStream_t s) {
  const int64_t pairs = static_cast<int64_t>(positions) * heads;
  attention_bwd_delta_kernel<D><<<static_cast<int>((pairs + 255) / 256), 256, 0, s>>>(
      out, dout, rows, delta, positions, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((max_len + 63) / 64, heads, windows);
  return launch_dynamic(attention_bwd_3xtf32_kernel<D>, grid, BWD_THREADS, Bwd<D>::SMEM, s, qkv,
                        rows, bounds, dout, lse, static_cast<const float*>(delta), dqkv, positions,
                        heads, scale);
}

cudaError_t check(const void* qkv, int positions, int windows, int max_len, int heads, int d) {
  if (d != 16 && d != 32 && d != 64) return cudaErrorInvalidValue;
  if (windows > 65535 || heads > 65535 || max_len < 1 || positions < 1)
    return cudaErrorInvalidValue;
  if (!aligned16(qkv)) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

// qkv (N, 3C) float32, C = heads d, 16-byte aligned; rows (positions)
// int32 (~row where the position does not own its row); bounds (windows +
// 1) int32; out (N, C) float32, written at every owned row; lse (heads,
// positions) float32, the base-2 log-sum-exp of scale log2(e) S a row.
// d: 16, 32 or 64; max_len: the longest window.
extern "C" int me_attention_fwd_f32(const void* qkv, const void* rows, const void* bounds,
                                    void* out, void* lse, int positions, int windows, int max_len,
                                    int heads, int d, float scale, void* stream) {
  if (positions == 0 || windows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = check(qkv, positions, windows, max_len, heads, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const int* r = static_cast<const int*>(rows);
  const int* b = static_cast<const int*>(bounds);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
#define ME_ATTN_FWD(D) \
  if (d == D) err = forward<D>(q, r, b, o, l, positions, windows, max_len, heads, scale, s);
  ME_ATTN_FWD(16)
  ME_ATTN_FWD(32)
  ME_ATTN_FWD(64)
#undef ME_ATTN_FWD
  return static_cast<int>(err);
}

// the forward's arguments, its out and lse, and dout (N, C); delta: a
// (heads, positions) float32 workspace; dqkv (positions, 3C) float32, zero
// on entry: the gradient of each position's q, k and v in window order.
extern "C" int me_attention_bwd_f32(const void* qkv, const void* rows, const void* bounds,
                                    const void* out, const void* dout, const void* lse,
                                    void* delta, void* dqkv, int positions, int windows,
                                    int max_len, int heads, int d, float scale, void* stream) {
  if (positions == 0 || windows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = check(qkv, positions, windows, max_len, heads, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!aligned16(out) || !aligned16(dout)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const int* r = static_cast<const int*>(rows);
  const int* b = static_cast<const int*>(bounds);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dqkv);
#define ME_ATTN_BWD(D)                                                                       \
  if (d == D)                                                                                \
    err = backward<D>(q, r, b, o, g, l, dl, dq, positions, windows, max_len, heads, scale, s);
  ME_ATTN_BWD(16)
  ME_ATTN_BWD(32)
  ME_ATTN_BWD(64)
#undef ME_ATTN_BWD
  return static_cast<int>(err);
}
