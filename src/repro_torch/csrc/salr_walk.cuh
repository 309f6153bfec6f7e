// The bf16 split-K tensor-core walk of the SALR op over one tiled-bitmap
// weight, y = x @ W_hat + bf16(x @ A_cat) @ B_cat, shared by salr_spmm.cu
// (salr_spmm, qsalr_spmm) and bitmap_spmm.cu (bitmap_spmm: the same walk
// at R = 0, with no u pass and no adapter term).  salr_spmm.cu's header
// comment sets out the design: the base's K cut into slices by the
// wrapper's plan (ops.salr_plan), an accumulator flushed every CHUNK_K
// rows, the slices and the rows dispatches (ops._walks_rows), which give
// the same bits.  A kernel file instantiates the three bodies (four with
// the u pass) under its op's kernel names, so a profile tells them apart,
// and launches them through launch_bf16 from launch_checked.  At R = 0 the
// walk of a row runs the same k16 steps, chunks, slices and sum order as
// at R > 0, and the adapter term adds exact zeros there, so bitmap_spmm's
// row equals salr_spmm's with zero adapters bit for bit.
#pragma once

#include <cstddef>
#include <type_traits>

#include "adapter_mma.cuh"
#include "expert_mma.cuh"

namespace salr {
namespace walk {

namespace sk = salr::splitk;
using sk::bf16;
using PlainV = salr::PlainValues<bf16>;
using NF4V = salr::NF4Values<bf16>;

// K rows an f32 accumulator runs over at most (grouped_spmm.cu's SLICE_K;
// ops.SALR_CHUNK_K): a split-K slice longer than this is a multiple of it.
constexpr int CHUNK_K = 8 * sk::BK;

// Everything a launch's kernels read: the operands, the workspaces and the
// two plans.  ws_u: u's f32 partials (u_slices, M, R); ws: the base's f32
// partials (slices, M, N) in the slices dispatch, null in the rows one.
template <class V>
struct Args {
  const bf16* x;
  const uint32_t* words;
  V vals;  // NF4: lut unset (the kernels' table in shared memory)
  const bf16* a;
  const bf16* b;
  float* ws_u;
  float* ws;
  bf16* y;
  int M, K, R, n_tiles, wpt;
  int slices, slice_k, u_slices, u_slice_k;
  __host__ __device__ int cols() const { return n_tiles * wpt * 32; }
};

// The cell tile of 64-column block `block`; lut: the NF4 levels in shared
// memory.
template <class V, bool FAST>
struct TileOf;
template <bool FAST>
struct TileOf<PlainV, FAST> {
  using type = sk::PlainCellTile<FAST>;
  __device__ static type make(const Args<PlainV>& p, int block, const float*) {
    return {p.words, p.vals, p.n_tiles, p.wpt, block};
  }
};
template <bool FAST>
struct TileOf<NF4V, FAST> {
  using type = sk::NF4CellTile<FAST>;
  __device__ static type make(const Args<NF4V>& p, int block, const float* lut) {
    NF4V v = p.vals;
    v.lut = lut;
    return {p.words, v, p.n_tiles, p.wpt, block};
  }
};

// A walk's stages: the base's cells, or A_cat's slabs (multiplied in place).
template <class Cells>
struct WalkShared {
  sk::XRing xs;
  union {
    Cells cells[sk::STAGES];
    sk::WTile dense[sk::STAGES];
  } raw;
  sk::WTile w;  // a step's decoded cells
};

template <class Cells>
struct SalrShared {
  union {
    WalkShared<Cells> walk;
    sk::AdapterShared adapter;  // the rows kernel's adapter term, after its walk
  } body;
  float lut[16];  // NF4: the levels
};

struct UShared {
  sk::XRing xs;
  sk::WTile dense[sk::STAGES];
};

// part = the block's rows of x @ the tile over K rows [k_begin, k_end):
// chunks of chunk_k rows on a grid from row 0, each from a zeroed
// accumulator, added in order.
template <class Tile, class XL>
__device__ __forceinline__ void chunked_product(sk::XRing& xs, typename Tile::Raw* raw,
                                                sk::WTile& w, const Tile& tile, const XL& xl,
                                                int K, int k_begin, int k_end, int chunk_k,
                                                float part[sk::WN / 8][4]) {
  sk::walk(xs, raw, w, tile, xl, K, k_begin, k_end, chunk_k, [&](int c, float(*acc)[4]) {
    const bool first = c * chunk_k <= k_begin;
#pragma unroll
    for (int j = 0; j < sk::WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = first ? acc[j][q] : part[j][q] + acc[j][q];
  });
}

// u's partial over slice us at u's 64-column tile ut for the block's row
// tile: ws_u[us] (M, R).
template <bool FAST, class V>
__device__ __forceinline__ void u_block(sk::XRing& xs, sk::WTile* raw, const Args<V>& p, int ut,
                                        int us) {
  const sk::DenseTile<FAST> tile(p.a, p.R, ut);
  const int m0 = blockIdx.y * sk::BM, k_begin = us * p.u_slice_k;
  float part[sk::WN / 8][4];
  // the decode buffer argument is unread: a DenseTile's stage is its tile
  chunked_product(xs, raw, raw[0], tile, sk::RowsX<FAST>(p.x, p.M, p.K, m0), p.K, k_begin,
                  min(p.K, k_begin + p.u_slice_k), min(p.u_slice_k, CHUNK_K), part);
  float* out = p.ws_u + static_cast<size_t>(us) * p.M * p.R + tile.n0;
  sk::for_each_out(part, m0, p.M, tile.width, [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * p.R + col] = v;
  });
}

// The slices dispatch's first launch.  Blocks (column block, row tile, z <
// slices) write the base's partial of slice z to ws[z] (M, N); the blocks
// past them run the u pass, (u column tile, u slice) numbered across x and
// the rest of z.
template <bool FAST, class V>
__device__ __forceinline__ void splitk_body(const Args<V>& p) {
  using Tile = typename TileOf<V, FAST>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<SalrShared<typename Tile::Raw>*>(smem);
  auto& stages = s.body.walk;
  const int z = blockIdx.z;
  if (z >= p.slices) {
    const int u_tiles = (p.R + sk::BN - 1) / sk::BN;
    const int i = (z - p.slices) * gridDim.x + blockIdx.x;
    if (i < u_tiles * p.u_slices) u_block<FAST>(stages.xs, stages.raw.dense, p, i % u_tiles,
                                               i / u_tiles);
    return;
  }
  if constexpr (V::kTable) salr::load_nf4_table(s.lut);  // read after the walk's first barrier
  const int N = p.cols(), m0 = blockIdx.y * sk::BM, n0 = blockIdx.x * sk::BN;
  const Tile tile = TileOf<V, FAST>::make(p, blockIdx.x, s.lut);
  const int k_begin = z * p.slice_k;
  float part[sk::WN / 8][4];
  chunked_product(stages.xs, stages.raw.cells, stages.w, tile,
                  sk::RowsX<FAST>(p.x, p.M, p.K, m0), p.K, k_begin,
                  min(p.K, k_begin + p.slice_k), min(p.slice_k, CHUNK_K), part);
  float* out = p.ws + static_cast<size_t>(z) * p.M * N + n0;
  sk::for_each_out(part, m0, p.M, min(sk::BN, N - n0), [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * N + col] = v;
  });
}

// The slices dispatch's second launch: block (column block, row tile)
// writes y = bf16(((ws[0] + ws[1]) + ... + ws[S-1]) + delta).  delta goes
// from the mma fragments to an f32 tile in shared memory (over the adapter
// product's tiles, once read), so that every thread then sums 4 adjacent
// outputs over the slices, the loads of 8 slices made before their sums
// (FAST: 16-byte loads).  Issuing those loads while B_cat's tile is in
// flight instead made the pass slower (spmm_ab.py, PERF.md).
constexpr int DLD = sk::BN + 4;  // delta tile row pitch (f32): 16-byte rows
static_assert(sk::BM * DLD * 4 <= sizeof(sk::AdapterShared), "delta tile fits");

template <bool FAST>
__device__ __forceinline__ void load4(float v[4], const float* __restrict__ src) {
  if constexpr (FAST) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = src[q];
  }
}

template <bool FAST, class V>
__device__ __forceinline__ void out_body(const Args<V>& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<sk::AdapterShared*>(smem);
  auto* dt = reinterpret_cast<float(*)[DLD]>(smem);
  const int N = p.cols(), m0 = blockIdx.y * sk::BM, n0 = blockIdx.x * sk::BN;
  const int width = min(sk::BN, N - n0), rows = min(sk::BM, p.M - m0);
  if (p.R > 0) {
    float delta[sk::WN / 8][4];
    sk::adapter_product<FAST>(s, p.ws_u, p.u_slices, p.b, p.M, p.R, N, m0, n0, delta);
    __syncthreads();  // every warp is done with u's and B_cat's tiles
    sk::for_each_out(delta, 0, rows, width, [&](int row, int col, float v) { dt[row][col] = v; });
    __syncthreads();
  }
  const size_t MN = static_cast<size_t>(p.M) * N;
  for (int i = threadIdx.x; i < rows * (sk::BN / 4); i += sk::THREADS) {
    const int row = i / (sk::BN / 4), c = (i % (sk::BN / 4)) * 4;
    if (c >= width) continue;  // width: a multiple of 32
    const size_t e = static_cast<size_t>(m0 + row) * N + n0 + c;
    float t[4];
    load4<FAST>(t, p.ws + e);
    for (int s0 = 1; s0 < p.slices; s0 += 8) {
      float v[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < p.slices) load4<FAST>(v[j], p.ws + (s0 + j) * MN + e);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (s0 + j < p.slices) t[q] += v[j][q];
    }
    if (p.R > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] += dt[row][c + q];
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(t[0], t[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(t[2], t[3]);
    *reinterpret_cast<uint2*>(p.y + e) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                    *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// The rows dispatch's first launch: block (u column tile, row tile, u
// slice) runs the u pass.
template <bool FAST, class V>
__device__ __forceinline__ void u_body(const Args<V>& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<UShared*>(smem);
  u_block<FAST>(s.xs, s.dense, p, blockIdx.x, blockIdx.z);
}

// The rows dispatch's second launch: block (column block, row tile) walks
// every slice in order, chunk by chunk: part = c0, part += c1, ... within a
// slice, total = p0, total += p1, ... across them; then total += delta and
// y = bf16(total).
template <bool FAST, class V>
__device__ __forceinline__ void rows_body(const Args<V>& p) {
  using Tile = typename TileOf<V, FAST>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<SalrShared<typename Tile::Raw>*>(smem);
  auto& stages = s.body.walk;
  if constexpr (V::kTable) salr::load_nf4_table(s.lut);  // read after the walk's first barrier
  const int N = p.cols(), m0 = blockIdx.y * sk::BM, n0 = blockIdx.x * sk::BN;
  const Tile tile = TileOf<V, FAST>::make(p, blockIdx.x, s.lut);
  const int chunk_k = min(p.slice_k, CHUNK_K);
  float part[sk::WN / 8][4] = {}, total[sk::WN / 8][4] = {};
  sk::walk(stages.xs, stages.raw.cells, stages.w, tile, sk::RowsX<FAST>(p.x, p.M, p.K, m0), p.K, 0,
           p.K, chunk_k, [&](int c, float(*acc)[4]) {
             const int k0 = c * chunk_k;
             const bool first = k0 % p.slice_k == 0;
             const bool last = (k0 + chunk_k) % p.slice_k == 0 || k0 + chunk_k >= p.K;
             const bool start = k0 < p.slice_k;  // the first slice
#pragma unroll
             for (int j = 0; j < sk::WN / 8; ++j)
#pragma unroll
               for (int q = 0; q < 4; ++q) {
                 part[j][q] = first ? acc[j][q] : part[j][q] + acc[j][q];
                 if (last) total[j][q] = start ? part[j][q] : total[j][q] + part[j][q];
               }
           });
  if (p.R > 0) {
    __syncthreads();  // every warp is done with the walk's stages
    float delta[sk::WN / 8][4];
    sk::adapter_product<FAST>(s.body.adapter, p.ws_u, p.u_slices, p.b, p.M, p.R, N, m0, n0,
                              delta);
#pragma unroll
    for (int j = 0; j < sk::WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[j][q] += delta[j][q];
  }
  bf16* out = p.y + n0;
  sk::for_each_out(total, m0, p.M, min(sk::BN, N - n0), [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * N + col] = __float2bfloat16(v);
  });
}


// The launches of a dispatch (the u pass only where R > 0; U: nullptr for
// an op that has none, bitmap_spmm).
template <bool FAST, auto USplit, auto Out, auto U, auto Rows, class V>
int launch_bf16(const Args<V>& p, cudaStream_t stream) {
  using Shared = SalrShared<typename TileOf<V, FAST>::type::Raw>;
  const int n_blocks = (p.cols() + sk::BN - 1) / sk::BN, m_tiles = (p.M + sk::BM - 1) / sk::BM;
  const int u_blocks = p.R > 0 ? (p.R + sk::BN - 1) / sk::BN * p.u_slices : 0;
  cudaError_t err;
  if (p.ws == nullptr) {  // rows
    if constexpr (!std::is_same_v<decltype(U), std::nullptr_t>) {
      if (p.R > 0) {
        err = sk::launch_with_smem<U, UShared>(
            dim3((p.R + sk::BN - 1) / sk::BN, m_tiles, p.u_slices), stream, p);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    return static_cast<int>(sk::launch_with_smem<Rows, Shared>(dim3(n_blocks, m_tiles), stream, p));
  }
  err = sk::launch_with_smem<USplit, Shared>(
      dim3(n_blocks, m_tiles, p.slices + (u_blocks + n_blocks - 1) / n_blocks), stream, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sk::launch_with_smem<Out, sk::AdapterShared>(dim3(n_blocks, m_tiles), stream, p));
}

// Whether each thread can copy the cells in fixed chunks: rows of words a
// multiple of 8 bytes (an even number of words: tiles of 64, 128, 192 or
// 256 columns) and of values (codes) a multiple of 16, the pointers
// aligned.
inline bool cells_vec(const Args<PlainV>& p) {
  return p.wpt % 2 == 0 && sk::aligned16(p.words) && p.vals.cap_t % 8 == 0 &&
         sk::aligned16(p.vals.values);
}
inline bool cells_vec(const Args<NF4V>& p) {
  return p.wpt % 2 == 0 && sk::aligned16(p.words) && p.vals.cap_t % 32 == 0 &&
         sk::aligned16(p.vals.codes);
}

// Check the plans and call launch(std::true_type) for the FAST kernels
// where every copy can be a 16-byte one, launch(std::false_type) else.  A
// base slice longer than CHUNK_K must be a whole number of chunks, so that
// the rows dispatch's chunks are the slices dispatch's.
template <class V, class Launch>
int launch_checked(const Args<V>& p, Launch launch) {
  const bool chunks_fit = p.slice_k <= CHUNK_K || p.slice_k % CHUNK_K == 0;
  if (!sk::plan_ok(p.K, p.slices, p.slice_k) || !chunks_fit ||
      (p.R > 0 && (p.ws_u == nullptr || !sk::plan_ok(p.K, p.u_slices, p.u_slice_k))))
    return static_cast<int>(cudaErrorInvalidValue);
  using sk::aligned16;
  if (sk::x_vec(p.x, p.K) && p.R % 8 == 0 && cells_vec(p) && aligned16(p.ws) &&
      (p.R == 0 || (aligned16(p.a) && aligned16(p.b) && aligned16(p.ws_u))))
    return launch(std::true_type{});
  return launch(std::false_type{});
}

}  // namespace walk
}  // namespace salr

// A walk kernel's bounds: 256 threads, two blocks an SM
#define SALR_WALK_BOUNDS __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
