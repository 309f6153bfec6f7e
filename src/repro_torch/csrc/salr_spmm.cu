// salr_spmm and qsalr_spmm: the full SALR deployment op,
//     y = x @ W_hat + bf16(x @ A_cat) @ B_cat,
// with W_hat in the tiled bitmap format decoded inside the GEMM; for
// qsalr_spmm the stored values are NF4 codes dequantized in the decode.
//
// Replaces: src/repro/kernels/salr_spmm.py:salr_spmm_pallas (ops.salr_matmul,
// every attention and SwiGLU projection of the main path) and
// src/repro/kernels/qsalr_spmm.py:qsalr_spmm_pallas (ops.qsalr_matmul,
// every decode projection of a mixed-precision plan whose decode repr is
// the NF4 twin, core/salr.py:_qkernel_dispatch).
//
// Bound on the H100: bytes at decode (M = 4..8: the compressed weight,
// ~0.35 MB for a 576 x 768 layer, plus A_cat/B_cat, about 2 flops per
// byte), tensor-core flops at prefill (M = 1024: ~600 flops per byte).
// The NF4 weight costs 4 bits per stored value plus the words and one f32
// scale per (row, tile) cell, about 0.6x the bytes of bf16 values.
//
// Design, bf16: the split-K tensor-core walk of splitk_gemm.cuh (a 4-stage
// cp.async ring, mma.sync m16n8k16, bf16 operands, f32 accumulators) with
// the tiled-bitmap cell tiles of expert_mma.cuh built for one weight:
// PlainCellTile copies a 64-column block's cells (words and stored values)
// and decodes them into a bf16 (32, 64) tile, NF4CellTile the same from NF4
// codes x the cell's f32 scale rounded once to bf16 (the reference rounds
// the decoded weight to x's dtype before its product), the 16 levels in
// shared memory.  Three products:
//   - the base, x @ W_hat: K cut into slices by the wrapper's plan
//     (ops.salr_plan: ops.splitk_plan from (K, N) and the SM count, never
//     from M), so the (column block x slice) blocks fill the card at decode
//     (smollm gate/up: 24 x 6 = 144 blocks, where the scalar body ran 48);
//   - u = x @ A_cat: K cut into at most 8 slices (ops.lora_plan, from K),
//     A_cat's slabs copied by a DenseTile straight into the bf16 stage;
//     each slice's f32 partial goes to a workspace (S_u, M, R);
//   - the adapter term, delta = bf16(u) @ B_cat[:, 64 columns]: u summed
//     from its partials in slice order and rounded once to bf16, then
//     multiplied on the tensor cores (adapter_mma.cuh, fused_lora.cu's
//     output pass).
// No f32 accumulator runs over more than CHUNK_K = 256 rows of K: within a
// slice the walk flushes into a fresh accumulator every 256 rows and adds
// the flushes in order, as the expert body's chunk_product does (one
// accumulator over deepseek's K = 7168 read 4.5e-4 against the 5e-4 limit).
// y = bf16(((p0 + p1) + ... + p(S-1)) + delta), f32 in that order, by
// either of two dispatches, which give the same bits:
//   - slices (small M): *_kernel_splitk, a block per (column block, row
//     tile, slice) writing the base's f32 partial to ws (S, M, N), and
//     beside them the u pass's blocks (the base does not wait on u); then
//     *_kernel_out, a block per (column block, row tile), computes delta and
//     adds it after the partials, summed in slice order.  Two launches.
//   - rows (larger M, where the partials would cost more than the longer
//     walk; ops._walks_rows): *_kernel_u runs the u pass, then
//     *_kernel_rows, a block per (column block, row tile), walks every
//     slice in order and adds delta last.  Two launches.
// No atomics.  mma.sync keeps rows apart and a row meets the same k16
// steps, chunks, slices and sum order at every M and in both dispatches,
// so its bits do not depend on the batch it came in (the engine decodes at
// M = n_slots, greedy_generate at M = batch).  FAST kernels (x, A_cat,
// B_cat, the workspaces, words and values 16-byte aligned; words a tile
// even; cap_t a multiple of 8, NF4 of 32; K and R of 8: every main-path
// shape, tiles 256 and 192 (smollm's wk/wv), cap_t 160 and 128, R 128) give
// each thread fixed chunks per stream and step; the others copy with the
// widest width the addresses allow.  No library GEMM computes any part.
// It replaces a scalar body (a u launch, then a decode-GEMM in which one
// thread reduces each output row over all of K on CUDA cores, 48 blocks at
// smollm gate/up): salr_spmm / qsalr_spmm at smollm gate/up M = 4 0.0789 /
// 0.1121 -> 0.0109 / 0.0111 ms (x @ W: 0.0110), at M = 1024 0.1999 /
// 0.3617 -> 0.0690 / 0.0699, at deepseek's wo (16384 -> 7168) M = 8 2.059
// / 3.008 -> 0.224 / 0.258 (NVIDIA H100 80GB HBM3, 700.00 W; spmm_ab.py;
// PERF.md).
//
// f32 keeps that scalar body (tiled_bitmap.cuh, shared with
// bitmap_spmm.cu): f32 is held at 1e-5, which TF32 tensor cores cannot
// meet.  Its two launches: u = x @ A_cat once per 32-row M block into an
// (M, R) scratch; then the bitmap decode + GEMM with the adapter term
// u @ B_cat reduced in f32 in its epilogue and added before the one
// rounding of y, each output row reduced over k in one fixed order by one
// thread.  The two ops differ only in the value loader the decode is
// instantiated with (PlainValues, NF4Values), which names them in profiles.
#include "adapter_mma.cuh"
#include "expert_mma.cuh"

namespace {

namespace sk = salr::splitk;
using sk::bf16;
using PlainV = salr::PlainValues<bf16>;
using NF4V = salr::NF4Values<bf16>;

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

// V only names the op in profiles: the u launch is the same for both.
template <typename T, typename V>
__global__ void __launch_bounds__(salr::THREADS)
adapter_u_kernel(const T* __restrict__ x, const T* __restrict__ a, T* __restrict__ u,
                 int M, int K, int R) {
  __shared__ __align__(16) salr::Smem s;
  salr::adapter_u(s, x, a, u, M, K, R);
}

template <typename T, typename V>
__global__ void __launch_bounds__(salr::THREADS)
salr_spmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ words, V vals,
                 const T* __restrict__ u, const T* __restrict__ b, T* __restrict__ y, int M,
                 int K, int R, int n_tiles, int wpt, int cap_t) {
  __shared__ __align__(16) salr::Smem s;
  if constexpr (V::kTable) {
    __shared__ float lut[16];
    salr::load_nf4_table(lut);
    __syncthreads();
    // a loader built here, so the compiler sees lut in shared memory
    const V with_lut{vals.codes, vals.scales, lut, vals.cap_t};
    salr::salr_tile(s, x, words, with_lut, u, b, y, M, K, R, n_tiles, wpt, cap_t);
  } else {
    salr::salr_tile(s, x, words, vals, u, b, y, M, K, R, n_tiles, wpt, cap_t);
  }
}

template <typename V>
int launch_f32(const void* x, const void* words, V vals, const void* a, const void* b, void* u,
               void* y, int M, int K, int R, int n_tiles, int wpt, int cap_t,
               cudaStream_t stream) {
  const int m_blocks = (M + salr::BM - 1) / salr::BM;
  if (R > 0) {  // a rank-0 layer has no adapter term
    dim3 grid_u((R + salr::BN - 1) / salr::BN, m_blocks);
    adapter_u_kernel<float, V><<<grid_u, salr::THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(u), M,
        K, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_tiles * wpt, m_blocks);
  salr_spmm_kernel<float, V><<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(words), vals,
      static_cast<const float*>(u), static_cast<const float*>(b), static_cast<float*>(y), M, K,
      R, n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the split-K tensor-core walk
// ---------------------------------------------------------------------------

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

// The kernels, named by op so a profile tells them apart (salr_spmm_kernel
// is a substring of qsalr_spmm_kernel: match the latter first).
#define SALR_BOUNDS __launch_bounds__(sk::THREADS, sk::MIN_BLOCKS)
template <bool FAST>
__global__ void SALR_BOUNDS salr_spmm_kernel_splitk(const Args<PlainV> p) { splitk_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS salr_spmm_kernel_out(const Args<PlainV> p) { out_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS salr_spmm_kernel_u(const Args<PlainV> p) { u_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS salr_spmm_kernel_rows(const Args<PlainV> p) { rows_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS qsalr_spmm_kernel_splitk(const Args<NF4V> p) { splitk_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS qsalr_spmm_kernel_out(const Args<NF4V> p) { out_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS qsalr_spmm_kernel_u(const Args<NF4V> p) { u_body<FAST>(p); }
template <bool FAST>
__global__ void SALR_BOUNDS qsalr_spmm_kernel_rows(const Args<NF4V> p) { rows_body<FAST>(p); }
#undef SALR_BOUNDS

// The two launches of a dispatch (the u pass only where R > 0).
template <bool FAST, auto USplit, auto Out, auto U, auto Rows, class V>
int launch_bf16(const Args<V>& p, cudaStream_t stream) {
  using Shared = SalrShared<typename TileOf<V, FAST>::type::Raw>;
  const int n_blocks = (p.cols() + sk::BN - 1) / sk::BN, m_tiles = (p.M + sk::BM - 1) / sk::BM;
  const int u_blocks = p.R > 0 ? (p.R + sk::BN - 1) / sk::BN * p.u_slices : 0;
  cudaError_t err;
  if (p.ws == nullptr) {  // rows
    if (p.R > 0) {
      err = sk::launch_with_smem<U, UShared>(dim3((p.R + sk::BN - 1) / sk::BN, m_tiles, p.u_slices),
                                             stream, p);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(sk::launch_with_smem<Rows, Shared>(dim3(n_blocks, m_tiles), stream, p));
  }
  err = sk::launch_with_smem<USplit, Shared>(
      dim3(n_blocks, m_tiles, p.slices + (u_blocks + n_blocks - 1) / n_blocks), stream, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sk::launch_with_smem<Out, sk::AdapterShared>(dim3(n_blocks, m_tiles), stream, p));
}

template <bool FAST>
int launch_op(const Args<PlainV>& p, cudaStream_t st) {
  return launch_bf16<FAST, salr_spmm_kernel_splitk<FAST>, salr_spmm_kernel_out<FAST>,
                     salr_spmm_kernel_u<FAST>, salr_spmm_kernel_rows<FAST>>(p, st);
}
template <bool FAST>
int launch_op(const Args<NF4V>& p, cudaStream_t st) {
  return launch_bf16<FAST, qsalr_spmm_kernel_splitk<FAST>, qsalr_spmm_kernel_out<FAST>,
                     qsalr_spmm_kernel_u<FAST>, qsalr_spmm_kernel_rows<FAST>>(p, st);
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

// Check the plans and pick the FAST kernels where every copy can be a
// 16-byte one.  A base slice longer than CHUNK_K must be a whole number of
// chunks, so that the rows dispatch's chunks are the slices dispatch's.
template <class V>
int launch_bf16_checked(const Args<V>& p, cudaStream_t st) {
  const bool chunks_fit = p.slice_k <= CHUNK_K || p.slice_k % CHUNK_K == 0;
  if (!sk::plan_ok(p.K, p.slices, p.slice_k) || !chunks_fit ||
      (p.R > 0 && (p.ws_u == nullptr || !sk::plan_ok(p.K, p.u_slices, p.u_slice_k))))
    return static_cast<int>(cudaErrorInvalidValue);
  using sk::aligned16;
  if (sk::x_vec(p.x, p.K) && p.R % 8 == 0 && cells_vec(p) && aligned16(p.ws) &&
      (p.R == 0 || (aligned16(p.a) && aligned16(p.b) && aligned16(p.ws_u))))
    return launch_op<true>(p, st);
  return launch_op<false>(p, st);
}

}  // namespace

// x (M, K); words (K, n_tiles, wpt) uint32; values (K, n_tiles, cap_t);
// a (K, R); b (R, n_tiles*wpt*32); y (M, n_tiles*wpt*32).  dtype 0 =
// float32: u an (M, R) f32 scratch; ws and the plans are ignored.  dtype 1
// = bfloat16: u an f32 (u_slices, M, R) workspace for u's partials (K cut
// into u_slices slices of u_slice_k rows: ops.lora_plan), ws an f32
// (slices, M, N) workspace for the base's partials in the slices dispatch
// or null for the rows dispatch (K cut into slices of slice_k rows:
// ops.salr_plan).  device: the CUDA ordinal of the tensors.  Returns
// cudaGetLastError() after the launches.
extern "C" int salr_spmm(const void* x, const void* words, const void* values, const void* a,
                         const void* b, void* u, void* y, void* ws, int M, int K, int R,
                         int n_tiles, int wpt, int cap_t, int slices, int slice_k, int u_slices,
                         int u_slice_k, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, words,
                      salr::PlainValues<float>{static_cast<const float*>(values), cap_t}, a, b,
                      u, y, M, K, R, n_tiles, wpt, cap_t, st);
  const Args<PlainV> p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                       PlainV{static_cast<const bf16*>(values), cap_t},
                       static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                       static_cast<float*>(u), static_cast<float*>(ws), static_cast<bf16*>(y),
                       M, K, R, n_tiles, wpt, slices, slice_k, u_slices, u_slice_k};
  return launch_bf16_checked(p, st);
}

// As salr_spmm with the values in NF4: codes (K, n_tiles, cap_t/2) uint8,
// interleaved (slot 2i low nibble, 2i+1 high); scales (K, n_tiles) f32.
extern "C" int qsalr_spmm(const void* x, const void* words, const void* codes,
                          const void* scales, const void* a, const void* b, void* u, void* y,
                          void* ws, int M, int K, int R, int n_tiles, int wpt, int cap_t,
                          int slices, int slice_k, int u_slices, int u_slice_k, int dtype,
                          int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* sc = static_cast<const float*>(scales);
  if (dtype == 0)
    return launch_f32(x, words, salr::NF4Values<float>{c, sc, nullptr, cap_t}, a, b, u, y, M,
                      K, R, n_tiles, wpt, cap_t, st);
  const Args<NF4V> p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                     NF4V{c, sc, nullptr, cap_t}, static_cast<const bf16*>(a),
                     static_cast<const bf16*>(b), static_cast<float*>(u),
                     static_cast<float*>(ws), static_cast<bf16*>(y),
                     M, K, R, n_tiles, wpt, slices, slice_k, u_slices, u_slice_k};
  return launch_bf16_checked(p, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
