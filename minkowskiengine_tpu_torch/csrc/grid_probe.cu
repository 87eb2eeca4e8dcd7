// Kernel maps through dense bbox row grids on Hopper: both halves of a map
// in one launch.
//
//   in_idx[k, o]    = row of (out_coords[o] + off[k]) in the input map,  or -1
//   out_idx_t[k, i] = row of (in_coords[i]  - off[k]) in the output map, or -1
//
// A map's row grid (coords/grid.py::build_row_grid) holds the row of each
// cell of its bounding box, batch-major, in units of its tensor stride, and
// -1 in an empty cell.  A query's row is then one gather from the grid.
//
// Replaces no kernel of the JAX package, which builds its kernel maps in XLA
// ops (minkowskiengine_tpu/coords/kernel_map.py, no Pallas kernel).  It
// replaces the port's plain route, coords/kernel_map.py::_build_in_idx_grid,
// on CUDA tensors: a chain of whole-array ATen ops over (K, N) (each axis
// column, its bound and stride checks, the flat cell, the gather), 31 to 43
// launches a half, each streaming all K * N elements through device memory.
// The plain route stays as the CPU's version and the reference.
//
// What bounds it: bytes.  The output is 2 * K * N int32 (0.33 GB for a 2 cm
// room's k = 5 stem map: K = 125, N ~ 326k); the coordinates, offsets and
// the grid cells it gathers are a small part beside it.  Design:
//   * one thread per (row, range of OFFSETS_PER_BLOCK offsets): it reads its
//     row's D + 1 coordinates once, less the grid's minima, then for each
//     offset forms each axis in registers, checks the batch and each axis'
//     bounds (and the stride lattice where the tensor stride is not 1),
//     folds the flat cell, gathers once from the row grid and stores one
//     int32; consecutive threads hold consecutive rows, so each offset's
//     stores are coalesced;
//   * both halves in one grid: blockIdx.x runs over the first half's row
//     blocks, then the second's; blockIdx.y over the offset ranges;
//   * no (K, N) temporary, no copy from the host and no read back: the
//     arguments are device pointers and values, so a CUDA graph captures the
//     launch (geometry replay's compiled mode);
//   * a row whose valid flag is false (a padded replay map's tail) gets -1
//     in every slot.
// The answer is the plain route's index for index: the same int32
// arithmetic, wrapping on overflow ((a + o) - m == (a - m) + o mod 2^32),
// and the same checks (a negative relative coordinate is off the grid; with
// it excluded, C's division and remainder are the plain route's floor
// forms).
//
// Plain C interface, launched on the caller's stream; returns cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_D = 6;             // the widest grid the 2^24-cell cap admits
constexpr int THREADS = 256;         // rows per block
constexpr int OFFSETS_PER_BLOCK = 8; // offsets a thread walks

}  // namespace

// One half of a map; kernels/grid_probe.py::_Half has this layout.
struct MeGridHalf {
  const int32_t* coords;   // (n, D+1) int32 base rows, batch first
  const uint8_t* valid;    // (n,) bool, or null: every row valid
  const int32_t* offsets;  // (K, D+1) int32, added to each row
  const int32_t* grid;     // (cells + 1,) int32 row grid of the probed map
  const int32_t* mins;     // (D+1,) int32 grid origin
  int32_t* out;            // (K, n) int32
  int32_t n;               // base rows
  int32_t blocks;          // row blocks (set by the launcher)
  int32_t shape[MAX_D + 1];  // B, E_1..E_D
  int32_t stride[MAX_D];     // the probed map's tensor stride, per axis
};

namespace {

struct Halves {
  MeGridHalf h[2];
};

// int32 sums and differences that wrap, as the plain route's ATen ops do
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

template <int D>
__device__ __forceinline__ void probe_half(const MeGridHalf& h, int block, int k_vol) {
  const int r = block * THREADS + threadIdx.x;
  const int k0 = blockIdx.y * OFFSETS_PER_BLOCK;
  if (r >= h.n) return;
  const int n = h.n;
  int32_t* __restrict__ out = h.out + r;
  if (h.valid != nullptr && !h.valid[r]) {
    for (int k = k0; k < min(k0 + OFFSETS_PER_BLOCK, k_vol); ++k)
      out[static_cast<int64_t>(k) * n] = -1;
    return;
  }
  const int32_t* __restrict__ row = h.coords + static_cast<int64_t>(r) * (D + 1);
  const int32_t* __restrict__ grid = h.grid;
  int32_t base[D + 1];
#pragma unroll
  for (int d = 0; d <= D; ++d) base[d] = wrap_sub(row[d], __ldg(h.mins + d));
  // a fixed count, so the gathers of the range are in flight together
#pragma unroll
  for (int j = 0; j < OFFSETS_PER_BLOCK; ++j) {
    const int k = k0 + j;
    if (k >= k_vol) break;
    const int32_t* off = h.offsets + k * (D + 1);
    const int32_t b = wrap_add(base[0], __ldg(off));
    bool ok = b >= 0 && b < h.shape[0];
    uint32_t flat = static_cast<uint32_t>(b);
#pragma unroll
    for (int d = 1; d <= D; ++d) {
      int32_t rel = wrap_add(base[d], __ldg(off + d));
      ok = ok && rel >= 0;
      const int32_t t = h.stride[d - 1];
      if (t != 1) {
        ok = ok && rel % t == 0;
        rel /= t;
      }
      ok = ok && rel < h.shape[d];
      flat = flat * static_cast<uint32_t>(h.shape[d]) + static_cast<uint32_t>(rel);
    }
    out[static_cast<int64_t>(k) * n] = ok ? __ldg(grid + flat) : -1;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) grid_probe_kernel(const Halves halves, int k_vol) {
  const int bx = blockIdx.x;
  if (bx < halves.h[0].blocks)
    probe_half<D>(halves.h[0], bx, k_vol);
  else
    probe_half<D>(halves.h[1], bx - halves.h[0].blocks, k_vol);
}

template <int D>
cudaError_t launch(const Halves& halves, int k_vol, cudaStream_t s) {
  const dim3 grid(halves.h[0].blocks + halves.h[1].blocks,
                  (k_vol + OFFSETS_PER_BLOCK - 1) / OFFSETS_PER_BLOCK);
  grid_probe_kernel<D><<<grid, THREADS, 0, s>>>(halves, k_vol);
  return cudaGetLastError();
}

}  // namespace

// halves: `count` (1 or 2) host structs; k_vol offsets each; dim = D in
// 1..6.  The probed grids hold prod(shape) + 1 cells (the last one -1).
extern "C" int me_grid_probe(const MeGridHalf* halves, int count, int k_vol, int dim,
                             void* stream) {
  if (count < 1 || count > 2 || dim < 1 || dim > MAX_D || k_vol < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Halves hs{};
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    hs.h[i] = halves[i];
    if (hs.h[i].n < 0) return static_cast<int>(cudaErrorInvalidValue);
    hs.h[i].blocks = (hs.h[i].n + THREADS - 1) / THREADS;
    blocks += hs.h[i].blocks;
  }
  if (k_vol == 0 || blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT32_MAX || (k_vol + OFFSETS_PER_BLOCK - 1) / OFFSETS_PER_BLOCK > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: return static_cast<int>(launch<1>(hs, k_vol, s));
    case 2: return static_cast<int>(launch<2>(hs, k_vol, s));
    case 3: return static_cast<int>(launch<3>(hs, k_vol, s));
    case 4: return static_cast<int>(launch<4>(hs, k_vol, s));
    case 5: return static_cast<int>(launch<5>(hs, k_vol, s));
    default: return static_cast<int>(launch<6>(hs, k_vol, s));
  }
}
