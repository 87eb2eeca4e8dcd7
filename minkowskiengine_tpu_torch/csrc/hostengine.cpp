// Host engine: voxel quantization for the data-loader path.
//
// Counterpart of the JAX package's cpp/hostengine.cpp (reference:
// src/quantization.cpp:57-260).  A data loader quantizes each scan's raw
// points on the host before the voxels go to the card; numpy's
// np.unique(axis=0) sorts rows and loses the first-occurrence order the
// reference returns, so this library hashes them instead.
//
// Plain C ABI, loaded with ctypes (utils/hostengine.py): an open-addressing
// table keyed on a 64-bit hash of the row bytes, linear probing, full-row
// comparison on a collision, unique rows in first-occurrence order
// (reference: src/coordinate_map_cpu.hpp:340-380).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (utils/hostengine.py does it at
// first use).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix_hash(const int32_t* row, int64_t d) {
  // FNV-1a over the row bytes, finished with a splitmix64 mixer
  uint64_t h = 14695981039346656037ull;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(row);
  for (int64_t i = 0; i < d * (int64_t)sizeof(int32_t); ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  h ^= h >> 30;
  h *= 0xbf58476d1ce4e5b9ull;
  h ^= h >> 27;
  h *= 0x94d049bb133111ebull;
  h ^= h >> 31;
  return h;
}

inline bool row_equal(const int32_t* a, const int32_t* b, int64_t d) {
  return std::memcmp(a, b, d * sizeof(int32_t)) == 0;
}

inline uint64_t table_capacity(int64_t n) {
  // at most half full (the reference's SPEED_OPTIMIZED occupancy,
  // coordinate_map_manager.hpp:130-156)
  uint64_t cap = 16;
  while (cap < (uint64_t)(n * 2)) cap <<= 1;
  return cap;
}

// The slot of each row: a new slot for a row not seen before (first
// occurrence order), else the slot of its first occurrence.  on_new(i, slot)
// and on_seen(i, slot) let the label variant track its votes.
template <typename OnNew, typename OnSeen>
int64_t unique_rows(const int32_t* coords, int64_t n, int64_t d,
                    int64_t* unique_map, int64_t* inverse, OnNew on_new,
                    OnSeen on_seen) {
  if (n <= 0) return 0;
  const uint64_t mask = table_capacity(n) - 1;
  std::vector<int64_t> table(mask + 1, -1);  // input row of the occupant
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = coords + i * d;
    uint64_t pos = mix_hash(row, d) & mask;
    for (;;) {
      const int64_t occ = table[pos];
      if (occ < 0) {
        table[pos] = i;
        unique_map[n_unique] = i;
        inverse[i] = n_unique;
        on_new(i, n_unique);
        ++n_unique;
        break;
      }
      if (row_equal(coords + occ * d, row, d)) {
        inverse[i] = inverse[occ];
        on_seen(i, inverse[occ]);
        break;
      }
      pos = (pos + 1) & mask;
    }
  }
  return n_unique;
}

}  // namespace

extern "C" {

// unique_map (capacity n): input row of each unique row; inverse (n): unique
// slot of each input row.  Returns the number of unique rows.
int64_t me_quantize_i32(const int32_t* coords, int64_t n, int64_t d,
                        int64_t* unique_map, int64_t* inverse) {
  return unique_rows(coords, n, d, unique_map, inverse,
                     [](int64_t, int64_t) {}, [](int64_t, int64_t) {});
}

// As me_quantize_i32; out_labels (capacity n) gets each unique row's label,
// or ignore_label where the rows of that coordinate carry different labels
// (reference: src/quantization.cpp:141-260).
int64_t me_quantize_label_i32(const int32_t* coords, const int32_t* labels,
                              int64_t n, int64_t d, int32_t ignore_label,
                              int64_t* unique_map, int64_t* inverse,
                              int32_t* out_labels) {
  return unique_rows(
      coords, n, d, unique_map, inverse,
      [&](int64_t i, int64_t slot) { out_labels[slot] = labels[i]; },
      [&](int64_t i, int64_t slot) {
        if (out_labels[slot] != labels[i]) out_labels[slot] = ignore_label;
      });
}

}  // extern "C"
