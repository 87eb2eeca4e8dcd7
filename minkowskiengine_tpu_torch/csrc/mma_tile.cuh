// Building blocks shared by the sparse-convolution kernels (gather_gemm.cu,
// conv_dw.cu, the bf16 bodies gather_gemm_wgmma.cu, conv_dw_wgmma.cu, and
// the float32 body gather_gemm_wgmma_f32.cu):
// rows gathered by index into shared memory with cp.async, float32
// products on the tensor cores with 3xTF32, bf16 products with ldmatrix and
// mma.sync m16n8k16, the compaction of an index column to its paired rows,
// and the in-order sum over splits.
//
// 3xTF32 ("fast f32"): each float32 operand a is split into
// hi = tf32(a) and lo = tf32(a - hi), and a * b is taken as
// lo*hi + hi*lo + hi*hi with float32 accumulation in mma.sync m16n8k8.
// The dropped lo*lo term and the rounding of lo leave about 2^-21 of each
// product, inside the float32 bounds the kernels are held to.
//
// Accumulation: the tensor core adds into its f32 accumulator with
// truncation, so every mma into a large running sum loses up to an ulp of
// that sum, always toward zero (on an H100, 27 offsets x 12 k-steps x 3 mma
// into one fragment came out 1.8e-5 of max|ref| short of plain).  The
// kernels therefore run each stage's mma into a zeroed fragment and add it
// to the running sum with ordinary round-to-nearest f32 adds.
//
// Fragment layouts of mma.sync.m16n8k8 .tf32 (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// bf16: mma.sync.m16n8k16 .bf16 takes two k-adjacent elements per 32-bit
// register, sums the exact products into a float32 accumulator (C as
// above), and the same truncation applies, so the same zeroed-fragment
// scheme is kept:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//   B (16 x 8, col):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
// The fragments come from shared memory by ldmatrix (four 8 x 8 b16
// matrices, one 16-byte row address per lane): plain for an operand stored
// k-contiguous, .trans for one stored k-major (rows along k), which hands
// each lane the k-adjacent pair.  A row stride of an odd number of 16-byte
// units puts the 8 rows of each matrix on distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4-byte copy global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// VEC floats (4: one 16-byte copy, 1: one 4-byte copy)
template <int VEC>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src, bool ok) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src, ok);
  } else {
    cp_async4(dst, src, ok);
  }
}

// bf16 copies: 8 elements (one 16-byte copy), 2 (one 4-byte copy), or 1 by
// a plain load and store (cp.async has no 2-byte form; odd widths)
template <int VEC>
__device__ __forceinline__ void cp_async_vec(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             bool ok) {
  if constexpr (VEC == 8) {
    cp_async16(dst, src, ok);
  } else if constexpr (VEC == 2) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? *src : __ushort_as_bfloat16(0);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// the one rounding of a float32 sum to the output's type
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

// d += a * b on one m16n8k8 tile, tf32 operands, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the small terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: lane (g, t) gets rows 2t, 2t + 1 of column g
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8 x 8 b16 matrices, each transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a * b on one m16n8k16 tile, bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One scan of THREADS output rows o = o0 + threadIdx.x (< o_end) of an index
// column: the rows with a pair (0 <= idx[o] < n_in) are appended, in order
// of o, to the ring (p_row, p_o) of CAP entries at head + n_pend.  Returns
// the new pending count, the same in every thread.  Two barriers inside:
// every thread of the block calls it.
template <int THREADS, int CAP>
__device__ __forceinline__ int compact_scan(const int* __restrict__ idx_col, int o0, int o_end,
                                            int n_in, int* p_row, int* p_o, int head, int n_pend,
                                            int* warp_counts) {
  static_assert((CAP & (CAP - 1)) == 0, "the ring's size is a power of two");
  constexpr int WARPS = THREADS / 32;
  const int o = o0 + static_cast<int>(threadIdx.x);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r = o < o_end ? idx_col[o] : -1;
  const bool paired = r >= 0 && r < n_in;  // out-of-range rows gather zero: drop them
  const unsigned ballot = __ballot_sync(0xffffffffu, paired);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (paired) {
    const int pos = (head + n_pend + before + __popc(ballot & ((1u << lane) - 1u))) & (CAP - 1);
    p_row[pos] = r;
    p_o[pos] = o;
  }
  __syncthreads();
  return n_pend + total;
}

// out[e] = sum_s ws[s, e] in order s = 0 .. splits-1, rounded once to OutT
template <typename OutT>
__global__ void sum_splits_kernel(const float* __restrict__ ws, OutT* __restrict__ out,
                                  int64_t n, int splits) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += ws[q * n + e];
    store_as(out + e, s);
  }
}

template <typename OutT>
cudaError_t sum_splits(const float* ws, OutT* out, int64_t n, int splits, cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      ws, out, n, splits);
  return cudaGetLastError();
}

// launch with dynamic shared memory, raising the kernel's limit above 48 KB
template <typename Kernel, typename... Args>
cudaError_t launch_dynamic(Kernel kernel, dim3 grid, int threads, int smem_bytes,
                           cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
