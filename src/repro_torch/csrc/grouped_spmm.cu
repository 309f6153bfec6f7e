// grouped_spmm: the SALR op over an MoE expert stack, each row with its
// own expert:
//
//     y[r] = x[r] @ W[e(r)] + round(x[r] @ A_cat[e(r)]) @ B_cat[e(r)]
//
// with W[e] expert e's base decoded inside the GEMM.  One kernel body,
// templated on the expert weights (how a block's slab of W[e] is read)
// and on how a row finds its expert; a bf16 stack whose family has a
// tensor-core tile runs the tensor-core body with it:
//
//   kernel              weights                     bf16 tile        map
//   grouped_salr_spmm   BitmapExperts<PlainValues>  PlainCellTile    TileMap  e(r) = tile_expert[r / block_m]
//   grouped_qsalr_spmm  BitmapExperts<NF4Values>    NF4CellTile      TileMap
//   grouped_dense_spmm  DenseExperts                DenseTile        TileMap
//   grouped_nm_spmm     NMExperts                   NMTile (m | 64)  TileMap
//   decode_salr_spmm    BitmapExperts<PlainValues>  PlainCellTile    RowMap   e(r) = row_expert[r], -1: a pad row
//   decode_qsalr_spmm   BitmapExperts<NF4Values>    NF4CellTile      RowMap
//   decode_dense_spmm   DenseExperts                DenseTile        RowMap
//   decode_nm_spmm      NMExperts                   NMTile (m | 64)  RowMap
//
// Replaces: src/repro/kernels/grouped_spmm.py:grouped_salr_spmm_pallas,
// :grouped_qsalr_spmm_pallas, :grouped_dense_spmm_pallas and
// :grouped_nm_spmm_pallas (models/moe.py _grouped_ffn: expert-sorted,
// block-aligned rows from group_assignments), :decode_salr_spmm_pallas,
// :decode_qsalr_spmm_pallas, :decode_dense_spmm_pallas and
// :decode_nm_spmm_pallas (_decode_grid_ffn: rows in token-major
// assignment order, no grouping).  The dense kernels serve a masked or
// dense stack's base (and a plain {"w"} stack, with no adapter); the N:M
// ones a 2:4 stack, whose groups run along N, the output axis.
//
// Bound on the H100: bytes at decode (64 assignment rows touch ~28 of 32
// experts: their weights and adapters, ~0.6-1.4 MB each by family), a
// mix at batch prefill (8192 rows: ~12-17 GFLOP against ~40-80 MB).
//
// Design.  The TPU's decode grid iterates experts over one M tile and
// masks the rows each step owns, because a Pallas grid cannot gather
// rows.  Here a block of the decode kernel owns (column block, expert e)
// and gathers the rows whose row_expert is e itself: it scans row_expert
// in windows of 1024 rows, compacts the matches into shared memory (a
// block-wide prefix count) and computes them a chunk at a time, so the
// work is k-way, with no sort.  Grid row E (one past the last expert)
// collects the rows of no expert (row_expert outside [0, E), the -1 pad
// rows) and writes exact zeros for them without reading x, so junk or NaN
// in a pad row never reaches the output and expert -1 is never indexed.
// A block of the grouped kernel owns (column block, M tile t): the tile's
// rows are contiguous and belong to expert tile_expert[t]; a tile taller
// than a chunk is walked a chunk at a time, so no chunk straddles two
// tiles (block_m is 8 at decode).  A tile whose expert is out of range
// writes zeros.  Both routes run two launches: the first computes u =
// x[r] @ A_cat[e(r)] into an (M, R) scratch, summed in f32 and rounded
// once to the operand type; the second adds, per row, the base's product
// and u[r] @ B_cat[e][:, cols], each summed in f32 from zero, and rounds y
// once.  One body serves both maps, so the grouped and decode kernels are
// bitwise equal per row by construction and a row does not depend on
// which rows share its block or on M.  No library GEMM computes any part.
//
// Two bodies:
//   - bf16 tiled-bitmap experts, plain and NF4 (grouped_salr_spmm,
//     decode_salr_spmm, grouped_qsalr_spmm, decode_qsalr_spmm), bf16 N:M
//     experts whose m divides 64 (grouped_nm_spmm, decode_nm_spmm: 2:4 on
//     the main path) and bf16 dense experts (grouped_dense_spmm,
//     decode_dense_spmm): the tensor cores (expert_mma.cuh and nm_tile.cuh
//     on splitk_gemm.cuh's walk).  A block owns 64 columns and chunks of up
//     to 64 rows; each 32-row step of K copies the rows' x and the step's
//     encoded rows with cp.async through a 4-stage ring (16-byte chunks on
//     the main path: tile 256, cap_t 160; 2:4 with N/4 a multiple of 16),
//     decodes them into a bf16 (32, 64) tile (a __popc prefix slot per
//     column; a plain cell's or an N:M group's stored bf16 value as it is,
//     an NF4 cell's level from the table in shared memory x its f32 scale,
//     rounded once to bf16: the reference's rounding) and runs mma.sync
//     m16n8k16 in m16 row groups, so a decode tile of block_m 8 leaves 8 of
//     16 rows idle where the scalar body idled 24 of 32.  A plain stage
//     holds one cell on the main path (72 KB for 4 stages at cap_t up to
//     256), so two blocks fit an SM as with NF4; a 2:4 stage is a 64-column
//     block's 16 group bytes and 64 values a row (NMTile, as in nm_spmm);
//     a dense stage is the expert's (32, 64) slab itself, copied straight
//     into the bf16 tile and multiplied as it landed, with no decode step
//     (DenseTile, the u pass's tile).  u and the adapter term run on the
//     same walk, A_cat[e] and B_cat[e] slabs copied straight into the bf16
//     stage; each product is summed in f32 over slices of SLICE_K rows of
//     K.  The grid fills the card at granite's decode (8 x 33 blocks at
//     gate/up), so K is not split.  A
//     grouped chunk whose x rows are all zero (group_assignments' slack
//     tiles, past every expert's rows) skips its walks and stores the zeros
//     they would give.  It replaced the scalar body below: at granite
//     gate/up, 64 rows, grouped / decode 0.2707 / 0.2522 ms -> 0.0510 /
//     0.0516 (plain), 0.3329 / 0.2248 -> 0.0580 / 0.0575 (NF4), 0.2540 /
//     0.2640 -> 0.0382 / 0.0388 (2:4), 0.1968 / 0.1856 -> 0.0370 / 0.0368
//     (dense); at 8192 grouped rows 2.832 -> 0.274 ms (plain), 2.035 ->
//     0.190 (2:4), 1.762 -> 0.158 (dense); plain at deepseek gate/up (E 256,
//     64 rows) 8.80 / 7.25 -> 1.64 / 1.69 ms (NVIDIA H100 80GB HBM3, 700.00
//     W; spmm_ab.py; PERF.md).  An N:M tile owns BN - BN % m columns and the
//     body's blocks BN = 64, so a stack whose m does not divide 64 (m in
//     {3, 5, 6, 7}, which no configuration uses) keeps the scalar body.
//   - f32, and bf16 N:M at those m (the scalar body of
//     salr_spmm.cu, tiled_bitmap.cuh): a block of 128 threads owns 32
//     columns and chunks of 32 rows, stages a BK x BN slab of W[e] into
//     shared memory as f32 (a bitmap slab decoded from its words, an N:M
//     slab from its group bytes, a dense slab as it is) and reduces each
//     row over k in order, one thread per (row, column), on CUDA cores
//     (rows_dense_dot for u, the adapter term and the dense base,
//     rows_bitmap_dot and rows_nm_dot for the encoded bases).  An f32 plain
//     bitmap row there equals what salr_spmm gives for its expert's
//     weights.  f32 is held at 1e-5, which TF32 tensor cores cannot meet.
#include <type_traits>

#include "expert_mma.cuh"
#include "nm_tile.cuh"
#include "tiled_bitmap.cuh"

namespace {

using salr::BK;
using salr::BM;
using salr::BN;
using salr::ROWS_PER_THREAD;
using salr::Smem;
using salr::THREADS;
using salr::WARPS;

constexpr int WINDOW = 1024;  // row_expert entries a decode block compacts at once

// The value loader of expert e's cells (an expert holds K x n_tiles cells).
template <typename T>
__device__ __forceinline__ salr::PlainValues<T> expert_values(const salr::PlainValues<T>& v,
                                                              int e, size_t cells) {
  return {v.values + (size_t)e * cells * v.cap_t, v.cap_t};
}
template <typename T>
__device__ __forceinline__ salr::NF4Values<T> expert_values(const salr::NF4Values<T>& v, int e,
                                                            size_t cells) {
  return {v.codes + (size_t)e * cells * (v.cap_t / 2), v.scales + (size_t)e * cells, v.lut,
          v.cap_t};
}

// Stage rows[0..BM) x cols [k0, k0+BK) of a row-major (., ld) matrix; an
// empty lane (-1) and columns past kmax stage zero.
template <typename T>
__device__ __forceinline__ void load_rows_gather(float (*dst)[BK], const T* __restrict__ src,
                                                 const int* rows, int k0, int kmax, int ld) {
#pragma unroll
  for (int j = 0; j < BM * BK / THREADS; ++j) {
    const int i = threadIdx.x + THREADS * j, r = i / BK, c = i % BK;
    const int m = rows[r], k = k0 + c;
    dst[r][c] = (m >= 0 && k < kmax) ? salr::to_f32(src[(size_t)m * ld + k]) : 0.f;
  }
}

// acc += x[rows] @ D[:, n0:n0+BN] for a dense row-major (K, N) operand D,
// x row-major (., ldx): the reduction over k in order, per row.
template <typename T>
__device__ __forceinline__ void rows_dense_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                               const T* __restrict__ x, int ldx,
                                               const int* rows, const T* __restrict__ d,
                                               int K, int n0, int N) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows_gather(s.a, x, rows, k0, K, ldx);
    salr::load_dense(s.b, d, k0, K, n0, N, N);
    __syncthreads();
    salr::mma_stage(s, acc);
    __syncthreads();
  }
}

// acc += x[rows] @ W_hat[:, block cols] with W_hat one expert's tiled
// bitmap; the block's columns are word wi of column tile ti.
template <typename T, typename V>
__device__ __forceinline__ void rows_bitmap_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                                const T* __restrict__ x, const int* rows,
                                                const uint32_t* __restrict__ words, const V& vals,
                                                int K, int n_tiles, int wpt, int cap_t, int ti,
                                                int wi) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows_gather(s.a, x, rows, k0, K, K);
    salr::load_bitmap(s.b, words, vals, k0, K, n_tiles, wpt, cap_t, ti, wi);
    __syncthreads();
    salr::mma_stage(s, acc);
    __syncthreads();
  }
}

// Decode rows [k0, k0+BK) x cols [n0, n0+BN) of one expert's N:M weight
// (group bytes (K, N/m), NK values per group (K, N/m*NK)) into dense f32.
// Lane l decodes column n0+l: group g = col/m, position t there; a set
// bit's value sits at the exclusive popcount of the bits below t in the
// group byte, clamped to NK - 1 (core/bitmap.nm_decode).  A warp decodes
// rows warp, warp+WARPS, ...: every row's byte load is issued, then every
// row's value load (the lanes of one group share the byte).
template <typename T, int NK>
__device__ __forceinline__ void load_nm(float (*dst)[BN], const uint8_t* __restrict__ bits,
                                        const T* __restrict__ values, int k0, int K, int n0,
                                        int N, int m) {
  constexpr int RPW = BK / WARPS;  // rows per warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = n0 + lane, groups = N / m;
  const bool live = col < N;
  const int g = live ? col / m : 0, t = live ? col % m : 0;
  uint32_t byte[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    byte[i] = (live && k < K) ? bits[(size_t)k * groups + g] : 0u;
  }
  float v[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    const int slot = min(__popc(byte[i] & ((1u << t) - 1u)), NK - 1);
    v[i] = ((byte[i] >> t) & 1u) ? salr::to_f32(values[((size_t)k * groups + g) * NK + slot])
                                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) dst[warp + WARPS * i][lane] = v[i];
}

// acc += x[rows] @ W_hat[:, n0:n0+BN] with W_hat one expert's N:M weight.
template <typename T, int NK>
__device__ __forceinline__ void rows_nm_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                            const T* __restrict__ x, const int* rows,
                                            const uint8_t* __restrict__ bits,
                                            const T* __restrict__ values, int K, int n0, int N,
                                            int m) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows_gather(s.a, x, rows, k0, K, K);
    load_nm<T, NK>(s.b, bits, values, k0, K, n0, N, m);
    __syncthreads();
    salr::mma_stage(s, acc);
    __syncthreads();
  }
}

// The expert weights of a stack, one struct per base family: cols() is
// the output width (grid x covers it in BN-column blocks) and rows_dot()
// adds x[rows] @ W[e][:, n0:n0+BN] to acc.  kTable: the loader reads the
// NF4 level table, which the kernel stages in shared memory and hands
// over through with_lut().

// Tiled bitmaps, words (E, K, n_tiles, wpt) and the values of V.
template <typename T, typename V>
struct BitmapExperts {
  static constexpr bool kTable = V::kTable;
  const uint32_t* __restrict__ words;
  V vals;
  int K, n_tiles, wpt, cap_t;
  __host__ __device__ int cols() const { return n_tiles * wpt * 32; }
  __device__ __forceinline__ BitmapExperts with_lut(const float* lut) const {
    return {words, {vals.codes, vals.scales, lut, vals.cap_t}, K, n_tiles, wpt, cap_t};
  }
  __device__ __forceinline__ void rows_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                           const T* __restrict__ x, const int* rows, int e,
                                           int n0) const {
    const size_t cells = (size_t)K * n_tiles;
    const int blk = n0 / BN;  // the block's word: word wi of column tile ti
    rows_bitmap_dot(s, acc, x, rows, words + (size_t)e * cells * wpt,
                    expert_values(vals, e, cells), K, n_tiles, wpt, cap_t, blk / wpt,
                    blk % wpt);
  }
};

// Dense experts, w (E, K, N) of the operand type.
template <typename T>
struct DenseExperts {
  static constexpr bool kTable = false;
  const T* __restrict__ w;
  int K, N;
  __host__ __device__ int cols() const { return N; }
  __device__ __forceinline__ void rows_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                           const T* __restrict__ x, const int* rows, int e,
                                           int n0) const {
    rows_dense_dot(s, acc, x, K, rows, w + (size_t)e * K * N, K, n0, N);
  }
};

// N:M experts (NK values per group of m), group bytes (E, K, N/m) uint8
// and values (E, K, N/m*NK) of the operand type.
template <typename T, int NK>
struct NMExperts {
  static constexpr bool kTable = false;
  const uint8_t* __restrict__ bits;
  const T* __restrict__ values;
  int K, N, m;
  __host__ __device__ int cols() const { return N; }
  __device__ __forceinline__ void rows_dot(Smem& s, float acc[ROWS_PER_THREAD],
                                           const T* __restrict__ x, const int* rows, int e,
                                           int n0) const {
    const size_t per = (size_t)K * (N / m);  // group bytes of one expert
    rows_nm_dot<T, NK>(s, acc, x, rows, bits + e * per, values + e * per * NK, K, n0, N, m);
  }
};

template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ y, const float acc[ROWS_PER_THREAD],
                                           const int* rows, int N, int n0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = rows[warp + WARPS * i], n = n0 + lane;
    if (m >= 0 && n < N) y[(size_t)m * N + n] = salr::from_f32<T>(acc[i]);
  }
}

// Grouped rows: grid y = M tile t, rows [t*block_m, (t+1)*block_m), all of
// expert tile_expert[t].  Calls body(e, n) once per CHUNK-row chunk with
// the chunk's n rows in rows_s (-1 past the tile); e = -1 for an expert
// out of range.  NT: the block's threads (CHUNK <= NT).
struct TileMap {
  static constexpr bool kSlack = true;  // tiles past every expert's rows hold zero x
  const int* tile_expert;
  int M, E, block_m;

  template <int CHUNK, int NT, typename F>
  __device__ __forceinline__ void for_each_chunk(int* rows_s, int*, F&& body) const {
    const int t = blockIdx.y;
    const int te = tile_expert[t];
    const int e = (te >= 0 && te < E) ? te : -1;
    const int r0 = t * block_m, r1 = min(r0 + block_m, M);
    for (int c0 = r0; c0 < r1; c0 += CHUNK) {
      if (threadIdx.x < CHUNK)
        rows_s[threadIdx.x] = c0 + (int)threadIdx.x < r1 ? c0 + (int)threadIdx.x : -1;
      __syncthreads();
      body(e, min(CHUNK, r1 - c0));
      __syncthreads();
    }
  }
};

// Decode rows: grid y = expert e in [0, E]; the block gathers the rows
// whose row_expert is e (for e = E: outside [0, E), body called with -1),
// in ascending order, CHUNK per chunk, from windows of WINDOW rows.
struct RowMap {
  static constexpr bool kSlack = false;
  const int* row_expert;
  int M, E;

  template <int CHUNK, int NT, typename F>
  __device__ __forceinline__ void for_each_chunk(int* rows_s, int* list, F&& body) const {
    constexpr int PER = WINDOW / NT;  // rows a thread tests per window
    __shared__ int warp_total[NT / 32];
    const int e = blockIdx.y;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int w0 = 0; w0 < M; w0 += WINDOW) {
      // each thread tests PER consecutive rows, then a block-wide prefix
      // count places its matches in the list
      const int base = w0 + (int)threadIdx.x * PER;
      bool own[PER];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int r = base + j;
        const int re = r < M ? row_expert[r] : -1;
        own[j] = r < M && (e < E ? re == e : (re < 0 || re >= E));
        cnt += own[j];
      }
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) warp_total[warp] = incl;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        before += w < warp ? warp_total[w] : 0;
        total += warp_total[w];
      }
      int o = before + incl - cnt;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (own[j]) list[o++] = base + j;
      __syncthreads();
      for (int c0 = 0; c0 < total; c0 += CHUNK) {
        if (threadIdx.x < CHUNK) rows_s[threadIdx.x] =
            c0 + (int)threadIdx.x < total ? list[c0 + threadIdx.x] : -1;
        __syncthreads();
        body(e < E ? e : -1, min(CHUNK, total - c0));
        __syncthreads();
      }
    }
  }
};

// First launch: u[r, r0:r0+BN] = x[r] @ A_cat[e(r)][:, r0:r0+BN], one
// rounding to T; grid (ceil(R/BN), the map's y).  Rows of no expert are
// not written (the second launch never reads them).  W only names the op
// in profiles.
template <typename T, typename W, typename Map>
__global__ void __launch_bounds__(THREADS)
moe_adapter_u_kernel(const T* __restrict__ x, const T* __restrict__ a, T* __restrict__ u,
                     int K, int R, Map map) {
  __shared__ __align__(16) Smem s;
  __shared__ int rows_s[BM];
  __shared__ int list[WINDOW];
  const int r0 = blockIdx.x * BN;
  map.template for_each_chunk<BM, THREADS>(rows_s, list, [&](int e, int) {
    if (e < 0) return;
    float acc[ROWS_PER_THREAD] = {0.f};
    rows_dense_dot(s, acc, x, K, rows_s, a + (size_t)e * K * R, K, r0, R);
    store_rows(u, acc, rows_s, R, r0);
  });
}

// Second launch: y[rows, block cols] for one chunk of expert e's rows
// (zeros for e = -1); grid (ceil(cols/BN) column blocks, the map's y).
template <typename T, typename W, typename Map>
__device__ __forceinline__ void moe_body(Smem& s, int* rows_s, int* list,
                                         const T* __restrict__ x, const W& w,
                                         const T* __restrict__ u, const T* __restrict__ b,
                                         T* __restrict__ y, int R, const Map& map) {
  const int N = w.cols(), n0 = blockIdx.x * BN;
  map.template for_each_chunk<BM, THREADS>(rows_s, list, [&](int e, int) {
    float acc[ROWS_PER_THREAD] = {0.f};
    if (e >= 0) {
      w.rows_dot(s, acc, x, rows_s, e, n0);
      float delta[ROWS_PER_THREAD] = {0.f};
      rows_dense_dot(s, delta, u, R, rows_s, b + (size_t)e * R * N, R, n0, N);
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] += delta[i];
    }
    store_rows(y, acc, rows_s, N, n0);
  });
}

template <typename T, typename W, typename Map>
__global__ void __launch_bounds__(THREADS)
moe_spmm_kernel(const T* __restrict__ x, W w, const T* __restrict__ u,
                const T* __restrict__ b, T* __restrict__ y, int R, Map map) {
  __shared__ __align__(16) Smem s;
  __shared__ int rows_s[BM];
  __shared__ int list[WINDOW];
  if constexpr (W::kTable) {
    __shared__ float lut[16];
    salr::load_nf4_table(lut);
    __syncthreads();
    // weights built here, so the compiler sees lut in shared memory
    moe_body(s, rows_s, list, x, w.with_lut(lut), u, b, y, R, map);
  } else {
    moe_body(s, rows_s, list, x, w, u, b, y, R, map);
  }
}

// bf16 tiled-bitmap experts, plain and NF4, bf16 N:M experts and bf16
// dense experts on the tensor cores (expert_mma.cuh, nm_tile.cuh), both
// maps: the same two launches as above, with 64-column blocks and up to 64
// rows a chunk.
using PlainExperts = BitmapExperts<__nv_bfloat16, salr::PlainValues<__nv_bfloat16>>;
using NF4Experts = BitmapExperts<__nv_bfloat16, salr::NF4Values<__nv_bfloat16>>;
namespace sk = salr::splitk;
template <int NK>
using NMBf16Experts = NMExperts<sk::bf16, NK>;
using DenseBf16Experts = DenseExperts<sk::bf16>;

// The tile of a bf16 stack on the tensor cores; void: the family has none.
template <class W, bool FAST>
struct CellTileOf {
  using type = void;
};
template <bool FAST>
struct CellTileOf<PlainExperts, FAST> {
  using type = sk::PlainCellTile<FAST>;
};
template <bool FAST>
struct CellTileOf<NF4Experts, FAST> {
  using type = sk::NF4CellTile<FAST>;
};
template <int NK, bool FAST>
struct CellTileOf<NMBf16Experts<NK>, FAST> {
  using type = sk::NMTile<NK, FAST>;
};
template <bool FAST>
struct CellTileOf<DenseBf16Experts, FAST> {
  using type = sk::DenseTile<FAST>;  // its stage is the bf16 tile: no decode step
};
template <class W>
constexpr bool kMma = !std::is_void_v<typename CellTileOf<W, false>::type>;

// Expert e's tile of column block `block` (64 columns); lut: the NF4
// levels in shared memory.
template <bool FAST>
__device__ __forceinline__ sk::PlainCellTile<FAST> tile_of(const PlainExperts& w, int e,
                                                           int block, const float*) {
  const size_t cells = (size_t)w.K * w.n_tiles;
  return {w.words + e * cells * w.wpt, expert_values(w.vals, e, cells), w.n_tiles, w.wpt, block};
}
template <bool FAST>
__device__ __forceinline__ sk::NF4CellTile<FAST> tile_of(const NF4Experts& w, int e, int block,
                                                         const float* lut) {
  const size_t cells = (size_t)w.K * w.n_tiles;
  auto vals = expert_values(w.vals, e, cells);
  vals.lut = lut;
  return {w.words + e * cells * w.wpt, vals, w.n_tiles, w.wpt, block};
}
// An N:M tile owns BN / m groups: the block's 64 columns where m divides
// 64 (launch sends the other m to the scalar body).
template <bool FAST, int NK>
__device__ __forceinline__ sk::NMTile<NK, FAST> tile_of(const NMBf16Experts<NK>& w, int e,
                                                        int block, const float*) {
  const size_t per = (size_t)w.K * (w.N / w.m);  // group bytes of one expert
  return {w.bits + e * per, w.values + e * per * NK, w.N, w.m, block};
}
template <bool FAST>
__device__ __forceinline__ sk::DenseTile<FAST> tile_of(const DenseBf16Experts& w, int e,
                                                       int block, const float*) {
  return {w.w + (size_t)e * w.K * w.N, w.N, block};
}

struct MmaUShared {
  sk::XRing xs;
  sk::WTile raw[sk::STAGES];  // A_cat[e]'s slabs, multiplied in place
};

template <class Cells>
struct MmaShared {
  sk::XRing xs;
  union {
    Cells cells[sk::STAGES];      // the base walk's cells
    sk::WTile dense[sk::STAGES];  // the adapter walk's B_cat[e] slabs
  } raw;
  sk::WTile w;  // a step's decoded cells
  float lut[16];  // NF4: the levels
};

// K rows of a slice of chunk_product: 8 pipeline steps, 16 k16 mma steps.
// The sum inside mma.sync is not an f32 add that rounds to nearest, and
// one accumulator over all K drifts from the plain version as K grows
// (deepseek gate/up, K = 7168, 64 rows: rel-L2 4.5e-4 against the 5e-4
// limit, 2.4e-5 in slices).  Slices of 8 steps time within 2% of one
// accumulator, slices of one step 12-18% slower (spmm_ab.py; NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md).
constexpr int SLICE_K = 8 * sk::BK;

// acc = the chunk's x rows @ one column tile of a weight, over all K: one
// walk whose slices of SLICE_K rows each start from a zeroed accumulator,
// acc = p0, then acc += p1, ... in f32, in order.
template <class Tile, class XL>
__device__ __forceinline__ void chunk_product(sk::XRing& xs, typename Tile::Raw* raw,
                                              sk::WTile& w, const Tile& tile, const XL& xl, int K,
                                              float acc[sk::WN / 8][4]) {
  sk::walk(xs, raw, w, tile, xl, K, 0, K, SLICE_K, [&](int s, float(*p)[4]) {
#pragma unroll
    for (int j = 0; j < sk::WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = s == 0 ? p[j][q] : acc[j][q] + p[j][q];
  });
}

// Whether the chunk's x rows are all zero bits.  group_assignments pads
// the grouped rows to a static bound, and its slack tiles (past every
// expert's rows, their expert clamped to E - 1) hold zero x: their rows
// come out exactly +0 (zero products from zeroed accumulators, u = +0), so
// the walks are skipped and zeros stored, the same bits.  A real tile's
// first row is a real token's, whose first nonzero entry ends the check.
template <class Map, bool FAST>
__device__ __forceinline__ bool zero_chunk_rows(const sk::bf16* __restrict__ x, const int* rows,
                                                int n, int K) {
  if constexpr (!Map::kSlack) {
    return false;
  } else {
    // FAST: a row is K / 8 16-byte chunks; else K 2-byte entries
    using V = std::conditional_t<FAST, uint4, uint16_t>;
    const int q = FAST ? K / 8 : K;
    const V* xv = reinterpret_cast<const V*>(x);
    auto nonzero_at = [&](int r, int c) {
      const V v = xv[(size_t)rows[r] * q + c];
      if constexpr (FAST) return (v.x | v.y | v.z | v.w) != 0u;
      else return v != 0;
    };
    bool nonzero = false;
    for (int c = threadIdx.x; c < q; c += sk::THREADS) nonzero |= nonzero_at(0, c);
    if (__syncthreads_or(nonzero)) return false;
    for (int r = threadIdx.x / 32; r < n; r += sk::THREADS / 32)
      for (int c = threadIdx.x % 32; c < q; c += 32) nonzero |= nonzero_at(r, c);
    return !__syncthreads_or(nonzero);
  }
}

// First launch: u[r, r0:r0+64] = x[r] @ A_cat[e(r)][:, r0:r0+64], rounded
// once to bf16; grid (ceil(R/64), the map's y).  W only names the op in
// profiles.
template <class W, class Map, bool FAST>
__global__ void __launch_bounds__(sk::THREADS, sk::MIN_BLOCKS)
moe_mma_u_kernel(const sk::bf16* __restrict__ x, const sk::bf16* __restrict__ a,
                 sk::bf16* __restrict__ u, int K, int R, Map map) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<MmaUShared*>(smem);
  __shared__ int rows_s[sk::BM];
  __shared__ int list[WINDOW];
  map.template for_each_chunk<sk::BM, sk::THREADS>(rows_s, list, [&](int e, int n) {
    if (e < 0 || zero_chunk_rows<Map, FAST>(x, rows_s, n, K)) return;  // u unread there
    const sk::DenseTile<FAST> tile(a + (size_t)e * K * R, R, blockIdx.x);
    float acc[sk::WN / 8][4];
    // the decode buffer argument is unread: a DenseTile's stage is its tile
    chunk_product(s.xs, s.raw, s.raw[0], tile, sk::GatherX<FAST>{x, rows_s, K, n}, K, acc);
    sk::for_each_out(acc, 0, n, tile.width, [&](int row, int col, float v) {
      u[(size_t)rows_s[row] * R + tile.n0 + col] = __float2bfloat16(v);
    });
  });
}

// Second launch: y[rows, 64 columns] for each chunk of expert e's rows:
// the base's product and then u @ B_cat[e], each from a zeroed
// accumulator, added in f32 and rounded once (zeros for e = -1); grid
// (ceil(cols/64), the map's y).
template <class W, class Map, bool FAST>
__global__ void __launch_bounds__(sk::THREADS, sk::MIN_BLOCKS)
moe_mma_spmm_kernel(const sk::bf16* __restrict__ x, W w, const sk::bf16* __restrict__ u,
                    const sk::bf16* __restrict__ b, sk::bf16* __restrict__ y, int R, Map map) {
  using Tile = typename CellTileOf<W, FAST>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<MmaShared<typename Tile::Raw>*>(smem);
  __shared__ int rows_s[sk::BM];
  __shared__ int list[WINDOW];
  if constexpr (W::kTable) salr::load_nf4_table(s.lut);  // read after the map's first barrier
  const int N = w.cols(), n0 = blockIdx.x * sk::BN, width = min(sk::BN, N - n0);
  map.template for_each_chunk<sk::BM, sk::THREADS>(rows_s, list, [&](int e, int n) {
    float acc[sk::WN / 8][4] = {};
    if (e >= 0 && !zero_chunk_rows<Map, FAST>(x, rows_s, n, w.K)) {
      const Tile tile = tile_of<FAST>(w, e, blockIdx.x, s.lut);
      chunk_product(s.xs, s.raw.cells, s.w, tile, sk::GatherX<FAST>{x, rows_s, w.K, n}, w.K,
                    acc);
      if (R > 0) {
        __syncthreads();  // every warp is done with the base walk's stages
        const sk::DenseTile<FAST> bt(b + (size_t)e * R * N, N, blockIdx.x);
        float delta[sk::WN / 8][4];
        chunk_product(s.xs, s.raw.dense, s.w, bt, sk::GatherX<FAST>{u, rows_s, R, n}, R,
                      delta);
#pragma unroll
        for (int j = 0; j < sk::WN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += delta[j][q];
      }
    }
    sk::for_each_out(acc, 0, n, width, [&](int row, int col, float v) {
      y[(size_t)rows_s[row] * N + n0 + col] = __float2bfloat16(v);
    });
  });
}

template <bool FAST, typename W, typename Map>
int launch_mma(const void* x, const W& w, const void* a, const void* b, void* u, void* y,
               const Map& map, int grid_y, int u_grid_y, int K, int R, cudaStream_t stream) {
  using Shared = MmaShared<typename CellTileOf<W, FAST>::type::Raw>;
  const auto* xb = static_cast<const sk::bf16*>(x);
  if (R > 0) {
    const cudaError_t err =
        sk::launch_with_smem<moe_mma_u_kernel<W, Map, FAST>, MmaUShared>(
            dim3((R + sk::BN - 1) / sk::BN, u_grid_y), stream, xb,
            static_cast<const sk::bf16*>(a), static_cast<sk::bf16*>(u), K, R, map);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(sk::launch_with_smem<moe_mma_spmm_kernel<W, Map, FAST>, Shared>(
      dim3((w.cols() + sk::BN - 1) / sk::BN, grid_y), stream, xb, w,
      static_cast<const sk::bf16*>(u), static_cast<const sk::bf16*>(b),
      static_cast<sk::bf16*>(y), R, map));
}

// Whether each thread can copy a stack's encoded rows in fixed 16-byte
// chunks: rows of words and values (codes; N:M: group bytes and values;
// dense: the weight) a multiple of 16 bytes, the pointers aligned.
inline bool cells_vec(const PlainExperts& w) {
  return w.wpt % 4 == 0 && sk::aligned16(w.words) && w.cap_t % 8 == 0 &&
         sk::aligned16(w.vals.values);
}
inline bool cells_vec(const NF4Experts& w) {
  return w.wpt % 4 == 0 && sk::aligned16(w.words) && w.cap_t % 32 == 0 &&
         sk::aligned16(w.vals.codes);
}
template <int NK>
inline bool cells_vec(const NMBf16Experts<NK>& w) {
  return sk::NMTile<NK, true>::fast(w.bits, w.values, w.N, w.m);
}
// a dense expert's rows: N a multiple of 8 bf16, so every expert starts
// 16-byte aligned too
inline bool cells_vec(const DenseBf16Experts& w) { return w.N % 8 == 0 && sk::aligned16(w.w); }

template <class W>
constexpr bool kNM = false;
template <typename T, int NK>
constexpr bool kNM<NMExperts<T, NK>> = true;

// The scalar body: both launches on CUDA cores.
template <typename T, typename W, typename Map>
int launch_scalar(const void* x, const W& w, const void* a, const void* b, void* u, void* y,
                  const Map& map, int grid_y, int u_grid_y, int K, int R, cudaStream_t stream) {
  if (R > 0) {  // a rank-0 stack has no adapter term
    dim3 grid_u((R + BN - 1) / BN, u_grid_y);
    moe_adapter_u_kernel<T, W, Map><<<grid_u, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(a), static_cast<T*>(u), K, R, map);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((w.cols() + BN - 1) / BN, grid_y);
  moe_spmm_kernel<T, W, Map><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(y), R, map);
  return static_cast<int>(cudaGetLastError());
}

// grid_y / u_grid_y: the map's y extent for the two launches (a tile
// count for TileMap; E + 1 and E for RowMap).
template <typename T, typename W, typename Map>
int launch(const void* x, const W& w, const void* a, const void* b, void* u, void* y,
           const Map& map, int grid_y, int u_grid_y, int K, int R, cudaStream_t stream) {
  if constexpr (kMma<W>) {
    if constexpr (kNM<W>) {
      if (sk::BN % w.m != 0)  // an N:M tile would own fewer columns than a block
        return launch_scalar<T>(x, w, a, b, u, y, map, grid_y, u_grid_y, K, R, stream);
    }
    // FAST: 16-byte copies of x, u, the encoded rows and the adapters' rows
    if (sk::x_vec(x, K) && R % 8 == 0 && cells_vec(w) &&
        (R == 0 || (sk::aligned16(a) && sk::aligned16(b) && sk::aligned16(u))))
      return launch_mma<true>(x, w, a, b, u, y, map, grid_y, u_grid_y, K, R, stream);
    return launch_mma<false>(x, w, a, b, u, y, map, grid_y, u_grid_y, K, R, stream);
  } else {
    return launch_scalar<T>(x, w, a, b, u, y, map, grid_y, u_grid_y, K, R, stream);
  }
}

template <typename T>
struct Tag {};

// The entries differ in the weights and the map; dispatch the dtype.
// make(Tag<T>) fills the weights of operand type T from the entry's
// pointers.
template <typename Make, typename Map>
int dispatch(int dtype, const Make& make, const void* x, const void* a, const void* b, void* u,
             void* y, const Map& map, int grid_y, int u_grid_y, int K, int R, int device,
             void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, make(Tag<float>{}), a, b, u, y, map, grid_y, u_grid_y, K, R, st);
  return launch<__nv_bfloat16>(x, make(Tag<__nv_bfloat16>{}), a, b, u, y, map, grid_y,
                               u_grid_y, K, R, st);
}

struct PlainBitmapMaker {
  const void* words;
  const void* values;
  int K, n_tiles, wpt, cap_t;
  template <typename T>
  BitmapExperts<T, salr::PlainValues<T>> operator()(Tag<T>) const {
    return {static_cast<const uint32_t*>(words), {static_cast<const T*>(values), cap_t}, K,
            n_tiles, wpt, cap_t};
  }
};
struct NF4BitmapMaker {
  const void* words;
  const void* codes;
  const void* scales;
  int K, n_tiles, wpt, cap_t;
  template <typename T>
  BitmapExperts<T, salr::NF4Values<T>> operator()(Tag<T>) const {
    return {static_cast<const uint32_t*>(words),
            {static_cast<const uint8_t*>(codes), static_cast<const float*>(scales), nullptr,
             cap_t},
            K, n_tiles, wpt, cap_t};
  }
};
struct DenseMaker {
  const void* w;
  int K, N;
  template <typename T>
  DenseExperts<T> operator()(Tag<T>) const {
    return {static_cast<const T*>(w), K, N};
  }
};
template <int NK>
struct NMMaker {
  const void* bits;
  const void* values;
  int K, N, m;
  template <typename T>
  NMExperts<T, NK> operator()(Tag<T>) const {
    return {static_cast<const uint8_t*>(bits), static_cast<const T*>(values), K, N, m};
  }
};

// n (values per group) is a template argument of the N:M weights: 1, 2
// (2:4) and 4 are built.
template <typename Map>
int dispatch_nm(int n, int dtype, const void* bits, const void* values, const void* x,
                const void* a, const void* b, void* u, void* y, const Map& map, int grid_y,
                int u_grid_y, int K, int R, int N, int m, int device, void* stream) {
  switch (n) {
    case 1:
      return dispatch(dtype, NMMaker<1>{bits, values, K, N, m}, x, a, b, u, y, map, grid_y,
                      u_grid_y, K, R, device, stream);
    case 2:
      return dispatch(dtype, NMMaker<2>{bits, values, K, N, m}, x, a, b, u, y, map, grid_y,
                      u_grid_y, K, R, device, stream);
    case 4:
      return dispatch(dtype, NMMaker<4>{bits, values, K, N, m}, x, a, b, u, y, map, grid_y,
                      u_grid_y, K, R, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Common arguments.  x (M, K) with M = tiles x block_m (grouped) or any M
// (decode); a (E, K, R); b (E, R, N); u (M, R) scratch; y (M, N).
// Grouped: tile_expert (M / block_m,) int32.  Decode: row_expert (M,)
// int32, -1 on pad rows.  dtype: 0 = float32, 1 = bfloat16; device: the
// CUDA ordinal of the tensors.  Each returns cudaGetLastError() after its
// launches.

// words (E, K, n_tiles, wpt) uint32, N = n_tiles*wpt*32; values (E, K,
// n_tiles, cap_t) of the operand type.
extern "C" int grouped_salr_spmm(const void* x, const void* words, const void* values,
                                 const void* a, const void* b, void* u, void* y,
                                 const void* tile_expert, int M, int K, int R, int E,
                                 int n_tiles, int wpt, int cap_t, int block_m, int dtype,
                                 int device, void* stream) {
  const TileMap map{static_cast<const int*>(tile_expert), M, E, block_m};
  return dispatch(dtype, PlainBitmapMaker{words, values, K, n_tiles, wpt, cap_t}, x, a, b, u,
                  y, map, M / block_m, M / block_m, K, R, device, stream);
}

// codes (E, K, n_tiles, cap_t/2) uint8, interleaved (slot 2i low nibble,
// 2i+1 high); scales (E, K, n_tiles) f32.
extern "C" int grouped_qsalr_spmm(const void* x, const void* words, const void* codes,
                                  const void* scales, const void* a, const void* b, void* u,
                                  void* y, const void* tile_expert, int M, int K, int R, int E,
                                  int n_tiles, int wpt, int cap_t, int block_m, int dtype,
                                  int device, void* stream) {
  const TileMap map{static_cast<const int*>(tile_expert), M, E, block_m};
  return dispatch(dtype, NF4BitmapMaker{words, codes, scales, K, n_tiles, wpt, cap_t}, x, a, b,
                  u, y, map, M / block_m, M / block_m, K, R, device, stream);
}

extern "C" int decode_salr_spmm(const void* x, const void* words, const void* values,
                                const void* a, const void* b, void* u, void* y,
                                const void* row_expert, int M, int K, int R, int E, int n_tiles,
                                int wpt, int cap_t, int dtype, int device, void* stream) {
  const RowMap map{static_cast<const int*>(row_expert), M, E};
  return dispatch(dtype, PlainBitmapMaker{words, values, K, n_tiles, wpt, cap_t}, x, a, b, u,
                  y, map, E + 1, E, K, R, device, stream);
}

extern "C" int decode_qsalr_spmm(const void* x, const void* words, const void* codes,
                                 const void* scales, const void* a, const void* b, void* u,
                                 void* y, const void* row_expert, int M, int K, int R, int E,
                                 int n_tiles, int wpt, int cap_t, int dtype, int device,
                                 void* stream) {
  const RowMap map{static_cast<const int*>(row_expert), M, E};
  return dispatch(dtype, NF4BitmapMaker{words, codes, scales, K, n_tiles, wpt, cap_t}, x, a, b,
                  u, y, map, E + 1, E, K, R, device, stream);
}

// w (E, K, N) of the operand type.
extern "C" int grouped_dense_spmm(const void* x, const void* w, const void* a, const void* b,
                                  void* u, void* y, const void* tile_expert, int M, int K, int R,
                                  int E, int N, int block_m, int dtype, int device,
                                  void* stream) {
  const TileMap map{static_cast<const int*>(tile_expert), M, E, block_m};
  return dispatch(dtype, DenseMaker{w, K, N}, x, a, b, u, y, map, M / block_m, M / block_m, K,
                  R, device, stream);
}

extern "C" int decode_dense_spmm(const void* x, const void* w, const void* a, const void* b,
                                 void* u, void* y, const void* row_expert, int M, int K, int R,
                                 int E, int N, int dtype, int device, void* stream) {
  const RowMap map{static_cast<const int*>(row_expert), M, E};
  return dispatch(dtype, DenseMaker{w, K, N}, x, a, b, u, y, map, E + 1, E, K, R, device,
                  stream);
}

// group_bits (E, K, N/m) uint8, bit t of byte g marking column m*g + t;
// values (E, K, N/m*n) of the operand type; n in {1, 2, 4}, m <= 8.
extern "C" int grouped_nm_spmm(const void* x, const void* bits, const void* values,
                               const void* a, const void* b, void* u, void* y,
                               const void* tile_expert, int M, int K, int R, int E, int N, int n,
                               int m, int block_m, int dtype, int device, void* stream) {
  const TileMap map{static_cast<const int*>(tile_expert), M, E, block_m};
  return dispatch_nm(n, dtype, bits, values, x, a, b, u, y, map, M / block_m, M / block_m, K,
                     R, N, m, device, stream);
}

extern "C" int decode_nm_spmm(const void* x, const void* bits, const void* values,
                              const void* a, const void* b, void* u, void* y,
                              const void* row_expert, int M, int K, int R, int E, int N, int n,
                              int m, int dtype, int device, void* stream) {
  const RowMap map{static_cast<const int*>(row_expert), M, E};
  return dispatch_nm(n, dtype, bits, values, x, a, b, u, y, map, E + 1, E, K, R, N, m, device,
                     stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
