// The bf16 tile of an N:M (n values per group of m) weight on the walk of
// splitk_gemm.cuh, shared by nm_spmm.cu (one weight) and grouped_spmm.cu
// (expert e's slab of a 2:4 stack, its pointers moved to the expert).
//
// Layout: group_bits (K, N/m) uint8, bit t of byte g marking column m*g+t;
// values (K, N/m*n), a set bit's value at slot n*g + (the popcount of the
// bits below it in its byte), clamped to n - 1 as core/bitmap.nm_decode
// clamps it; a clear bit is 0.  n <= m <= 8.
#pragma once

#include "splitk_gemm.cuh"

namespace salr {
namespace splitk {

struct __align__(16) NMRaw {  // one stage of a tile's compressed rows
  uint8_t bits[BK][BN];   // at most BN / m group bytes a row
  uint16_t vals[BK][BN];  // at most BN / m * n <= BN values a row
};

// Column tile `tile` of an N:M weight, BN / m whole groups (BN - BN % m
// columns) per tile.  FAST: m = 4 and every copy a 16-byte one (the main
// path: 2:4 at smollm's and granite's widths), so a step's group bytes and
// values are one fixed chunk per thread and the decode knows m; otherwise
// any m <= 8 at any alignment.
template <int NK, bool FAST>
struct NMTile {
  using Raw = NMRaw;
  const uint8_t* __restrict__ bits;
  const uint16_t* __restrict__ values;
  int groups, m;
  int g0, gt;      // the tile's first group and its number of groups
  int n0, width;   // its first column and its number of columns
  Chunk<16> bits_chunk, vals_chunk;  // FAST
  __device__ NMTile(const uint8_t* bits_, const bf16* values_, int N, int m_, int tile)
      : bits(bits_), values(reinterpret_cast<const uint16_t*>(values_)), groups(N / m_), m(m_) {
    g0 = tile * (BN / m);
    gt = min(BN / m, groups - g0);
    n0 = g0 * m;
    width = gt * m;
    if constexpr (FAST) {
      bits_chunk = Chunk<16>(BK, BN / 4);
      vals_chunk = Chunk<16>(BK, BN / 4 * NK * 2);
    }
  }
  // Whether the FAST tile applies: m = 4 and the tiles' group bytes and
  // values start and end on 16-byte boundaries in every row.
  __host__ static bool fast(const void* bits, const void* values, int N, int m) {
    return m == 4 && reinterpret_cast<uintptr_t>(bits) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(values) % 16 == 0 && (N / m) % 16 == 0;
  }
  // cp.async rows [k0, k0 + kn) of the tile's group bytes and values.
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const size_t cell = static_cast<size_t>(k0) * groups + g0;
    const size_t vstride = static_cast<size_t>(groups) * NK * 2;
    if constexpr (FAST) {
      bits_chunk.copy(r.bits, BN, bits + cell, groups, kn, BN);
      vals_chunk.copy(r.vals, 2 * BN, values + cell * NK, vstride, kn, 2 * BN);
    } else {
      copy_rows(r.bits, BN, bits + cell, groups, kn, gt, gt);
      copy_rows(r.vals, 2 * BN, values + cell * NK, vstride, kn, gt * NK * 2, gt * NK * 2);
    }
  }
  // w[k][c] = the entry of row k0 + k, column n0 + c; 0 past kn rows and
  // past the tile's width.  A thread writes 8 columns with one 16-byte
  // store.
  __device__ __forceinline__ void decode(const Raw& r, int kn, WTile& w) const {
    if constexpr (FAST) decode_m4(r, kn, w);
    else decode_any(r, kn, w);
  }
  // m = 4: thread (k, j) decodes groups 2j and 2j + 1 of row k from one
  // 2-byte load of their bits and one load of their 2n values.
  __device__ __forceinline__ void decode_m4(const Raw& r, int kn, WTile& w) const {
    static_assert(BK * (BN / 8) == THREADS, "one 8-column chunk a thread");
    const int k = threadIdx.x / (BN / 8), j = threadIdx.x % (BN / 8);
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (k < kn) {
      const uint32_t b2 = *reinterpret_cast<const uint16_t*>(&r.bits[k][2 * j]);
      uint32_t words[NK];  // the two groups' 2n values, two to a word
      const uint16_t* vp = &r.vals[k][2 * j * NK];
      if constexpr (NK == 1) {
        words[0] = *reinterpret_cast<const uint32_t*>(vp);
      } else if constexpr (NK == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(vp);
        words[0] = q.x, words[1] = q.y;
      } else {
        const uint4 q = *reinterpret_cast<const uint4*>(vp);
        words[0] = q.x, words[1] = q.y, words[2] = q.z, words[3] = q.w;
      }
      auto value = [&](int i) { return (words[i / 2] >> (16 * (i & 1))) & 0xFFFFu; };
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b = (b2 >> (8 * h)) & 0xFFu;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int slot = min(__popc(b & ((1u << t) - 1u)), NK - 1);
          uint32_t v = value(h * NK);  // a select, no indexed registers
#pragma unroll
          for (int q = 1; q < NK; ++q)
            if (slot == q) v = value(h * NK + q);
          packed[2 * h + t / 2] |= (((b >> t) & 1u) ? v : 0u) << (16 * (t & 1));
        }
      }
    }
    *reinterpret_cast<uint4*>(&w.v[k][8 * j]) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  // Any m: entry by entry.  Branch-free: a stale row or a column past the
  // width reads in-bounds junk that the select drops.
  __device__ __forceinline__ void decode_any(const Raw& r, int kn, WTile& w) const {
    for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
      const int k = i / (BN / 8), c0 = 8 * (i % (BN / 8));
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t e[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + j + h;
          const int g = c / m, t = c - g * m;
          const uint32_t b = r.bits[k][g];
          const uint32_t v = r.vals[k][g * NK + min(__popc(b & ((1u << t) - 1u)), NK - 1)];
          e[h] = (k < kn && c < width && ((b >> t) & 1u)) ? v : 0u;
        }
        packed[j / 2] = e[0] | (e[1] << 16);
      }
      *reinterpret_cast<uint4*>(&w.v[k][c0]) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
};

}  // namespace splitk
}  // namespace salr
