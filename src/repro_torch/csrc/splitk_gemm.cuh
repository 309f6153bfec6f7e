// Shared device code of the bf16 nm_spmm and nf4_spmm kernels: y = x @ W
// for a weight W stored compressed (N:M groups, NF4 codes), decoded tile by
// tile into bf16 in shared memory and multiplied on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), with the reduction
// K cut into slices that run on separate blocks.
//
// Split plan: K is cut into S slices of slice_k rows (a multiple of BK; the
// last ends at K), chosen by the wrapper from (K, N) and the card's SM
// count, never from M (ops.splitk_plan).  A block owns one column tile of at
// most BN columns and BM rows of x (rows past M zero), 8 warps of 16 rows x
// 32 columns, and walks its K range in steps of BK rows through a ring of
// STAGES shared-memory stages filled by cp.async, three steps ahead.  The
// weight loader (a Tile: nm_tile.cuh's NMTile, NF4Tile) copies a step's
// compressed rows and decodes them into a bf16 (BK, BN) tile, zero past K
// and past the tile's columns; each warp then multiplies its rows by it,
// k16 step by k16 step (fragments via ldmatrix).  FAST kernels (the main
// path's shapes: every address and stride 16-byte aligned) give each
// thread one fixed 16-byte chunk per stream and step; the others copy with
// the widest width the addresses allow.  A slice's partial starts from a zeroed accumulator, and
// the output is p0 + p1 + ... + p(S-1) in f32, in that order, rounded once
// to bf16.  Two dispatches give the same bits:
//   - slices (slices_block): one block per (column tile, row tile, slice)
//     writes its f32 partial to a workspace (S, M, N); a reduce pass
//     (reduce_slices) sums them in order.  For small M: the column tiles x
//     slices fill the card.
//   - rows (rows_block): one block per (column tile, row tile) walks every
//     slice in order, each into a fresh accumulator added to a running
//     total.  For larger M, where the partials' round trip through memory
//     would cost more than the longer walk (ops._splitk_args).
// No atomics take part.  mma.sync keeps rows apart, and a row meets the same
// k16 steps, slices and sum order in both dispatches and at every M, so its
// bits do not depend on the batch it came in (the engine decodes at M =
// n_slots, greedy_generate at M = batch; their token parity rests on it).
//
// The walk is shared beyond nm_spmm and nf4_spmm: a tile whose stage is
// itself a bf16 WTile (DenseTile: a dense weight's rows, copied with no
// decode) is multiplied straight from its stage (fused_lora.cu), and x's
// rows come from a loader: RowsX (a block's contiguous rows) here,
// GatherX (rows named by a list) in expert_mma.cuh.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

#if !defined(SALR_SPLITK_BN) || !defined(SALR_SPLITK_BK)
#error "build with -DSALR_SPLITK_BN and -DSALR_SPLITK_BK (kernels/build.py sets them)"
#endif

namespace salr {
namespace splitk {

constexpr int THREADS = 256;  // 8 warps: warp w owns rows 16 (w % 4), columns 32 (w / 4)
// The tile's columns and K rows per stage come from the build
// (build.SPLITK_BN / SPLITK_BK), whose values the wrapper's plan reads too
constexpr int BM = 64;              // rows of x per block
constexpr int BN = SALR_SPLITK_BN;  // columns per tile
constexpr int WN = 32;              // columns per warp: 4 mma n-tiles
constexpr int BK = SALR_SPLITK_BK;  // K rows per stage
static_assert(BM == 64 && BN == 2 * WN && BK % 16 == 0,
              "8 warps of 16 rows x WN columns; whole k16 steps");
constexpr int STAGES = 4;     // cp.async ring depth: three steps in flight
constexpr int MIN_BLOCKS = 2; // blocks resident per SM (__launch_bounds__): <= 128 registers
constexpr int XLD = BK + 8;   // x row pitch (bf16): ldmatrix rows on distinct banks
constexpr int WLD = BN + 8;   // decoded tile row pitch (bf16), likewise

using bf16 = __nv_bfloat16;

struct __align__(16) XRing {
  uint16_t v[STAGES][BM][XLD];  // bf16 bits
};
struct __align__(16) WTile {
  uint16_t v[BK][WLD];  // bf16 bits
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void copy_chunk(char* d, const char* s) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d)), "l"(s));
  else if constexpr (W == 8 || W == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(d)), "l"(s),
                 "n"(W));
  else if constexpr (W == 2)
    *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
  else
    *d = *s;
}

template <int W>
__device__ __forceinline__ void zero_chunk(char* d) {
  if constexpr (W == 16) *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (W == 8) *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
  else if constexpr (W == 4) *reinterpret_cast<uint32_t*>(d) = 0u;
  else if constexpr (W == 2) *reinterpret_cast<uint16_t*>(d) = 0;
  else *d = 0;
}

template <int W>
__device__ __forceinline__ void copy_rows_w(char* dst, int pitch, const char* src, size_t stride,
                                            int rows, int bytes, int valid) {
  const int per_row = bytes / W;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * W;
    if (c < valid) copy_chunk<W>(dst + r * pitch + c, src + r * stride + c);
    else zero_chunk<W>(dst + r * pitch + c);
  }
}

// Copy `rows` rows of `bytes` bytes from device memory (row stride `stride`
// bytes) to shared memory (row pitch `pitch` bytes) with the widest
// cp.async (16, 8 or 4 bytes) that every address and length allows, plain
// loads below that; a row's bytes from `valid` on are zero-filled.  All
// threads of the block call it.  The walk at shapes off the main path.
__device__ __forceinline__ void copy_rows(void* dst, int pitch, const void* src, size_t stride,
                                          int rows, int bytes, int valid) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const size_t a = reinterpret_cast<uintptr_t>(s) | stride | static_cast<size_t>(pitch) |
                   static_cast<size_t>(bytes) | static_cast<size_t>(valid);
  if (!(a & 15)) copy_rows_w<16>(d, pitch, s, stride, rows, bytes, valid);
  else if (!(a & 7)) copy_rows_w<8>(d, pitch, s, stride, rows, bytes, valid);
  else if (!(a & 3)) copy_rows_w<4>(d, pitch, s, stride, rows, bytes, valid);
  else if (!(a & 1)) copy_rows_w<2>(d, pitch, s, stride, rows, bytes, valid);
  else copy_rows_w<1>(d, pitch, s, stride, rows, bytes, valid);
}

// A thread's share of one stream of a step in the FAST walk: a stream moves
// at most THREADS chunks of W bytes a step, so a thread copies at most one,
// at a (row, byte) of the step that is fixed for the whole walk and found
// once.
template <int W>
struct Chunk {
  int r = -1, c = 0;  // row of the step and byte of the row; r < 0: none
  Chunk() = default;
  __device__ Chunk(int rows, int bytes) {
    const int per_row = bytes / W, i = threadIdx.x;
    if (i < rows * per_row) {
      r = i / per_row;
      c = (i - r * per_row) * W;
    }
  }
  // The step's rows start at src (row stride `stride`) and land at dst (row
  // pitch `pitch`); rows from `rows` on are skipped, bytes from `valid` on
  // zero-filled.
  __device__ __forceinline__ void copy(void* dst, int pitch, const void* src, size_t stride,
                                       int rows, int valid) const {
    if (r >= 0 && r < rows) {
      char* d = static_cast<char*>(dst) + r * pitch + c;
      if (c < valid) copy_chunk<W>(d, static_cast<const char*>(src) + r * stride + c);
      else zero_chunk<W>(d);
    }
  }
};

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether x's copies can all be 16-byte ones (x 16-byte aligned, rows of
// K bf16 a multiple of 16 bytes).
__host__ inline bool x_vec(const void* x, int K) { return aligned16(x) && K % 8 == 0; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) @ b (16 x 8), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int warp_row0() { return 16 * ((threadIdx.x >> 5) & 3); }
__device__ __forceinline__ int warp_col0() { return WN * (threadIdx.x >> 7); }

// acc[j] += the warp's 16 rows of a (columns [kk, kk + 16)) @ rows [kk, kk
// + 16) of b at its columns [8j, 8j + 8): one k16 step.  a: bf16 rows of
// pitch LDA (the block's BM rows), b: bf16 rows of pitch WLD (BN columns).
// acc[j]: rows g and g + 8 (g = lane / 4), columns 2t and 2t + 1 (t = lane
// % 4) of the warp's n-tile j.
template <int LDA>
__device__ __forceinline__ void mma_k16(const uint16_t (*a)[LDA], const uint16_t (*b)[WLD],
                                        int kk, float acc[WN / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int row = warp_row0() + (lane & 15), col = warp_col0() + 8 * (lane >> 4);
  unsigned af[4];
  ldmatrix_x4(af, &a[row][kk + 8 * (lane >> 4)]);
#pragma unroll
  for (int p = 0; p < WN / 16; ++p) {
    unsigned bf[4];
    ldmatrix_x4_trans(bf, &b[kk + (lane & 15)][col + 16 * p]);
    mma_bf16(acc[2 * p], af, bf[0], bf[1]);
    mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
  }
}

// acc += the warp's 16 rows of x @ its columns, over the stage's BK rows,
// k16 step by k16 step.
__device__ __forceinline__ void mma_stage(const uint16_t (*x)[XLD], const WTile& w,
                                          float acc[WN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) mma_k16<XLD>(x, w.v, kk, acc);
}

// x's rows [m0, m0 + BM) of a row-major (M, K) bf16 x for a walk (rows past
// M zero).  FAST: x 16-byte aligned with rows of a multiple of 16 bytes, so
// a thread copies one fixed 16-byte chunk a step.
template <bool FAST>
struct RowsX {
  const bf16* __restrict__ x;
  int K, m0, rows;  // rows: those of the block inside M
  Chunk<16> xc;     // FAST
  __device__ RowsX(const bf16* x_, int M, int K_, int m0_)
      : x(x_), K(K_), m0(m0_), rows(min(BM, M - m0_)) {
    if constexpr (FAST) xc = Chunk<16>(rows, BK * 2);
  }
  __device__ __forceinline__ int count() const { return rows; }
  // x rows past M, up to the last 16-row band in use, zero in every stage
  // (the copies never write them); the walk's first barrier orders it
  __device__ __forceinline__ void prepare(XRing& xs) const {
    const int pad_end = min(BM, (rows + 15) / 16 * 16);
    for (int i = threadIdx.x; i < STAGES * (pad_end - rows) * (XLD / 8); i += THREADS) {
      const int st = i / ((pad_end - rows) * (XLD / 8)), rem = i % ((pad_end - rows) * (XLD / 8));
      *reinterpret_cast<uint4*>(&xs.v[st][rows + rem / (XLD / 8)][8 * (rem % (XLD / 8))]) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // cp.async columns [k0, k0 + kn) of the rows into a stage, zero past kn.
  __device__ __forceinline__ void load(uint16_t (*dst)[XLD], int k0, int kn) const {
    const bf16* src = x + static_cast<size_t>(m0) * K + k0;
    const size_t stride = static_cast<size_t>(K) * 2;
    if constexpr (FAST) xc.copy(dst, XLD * 2, src, stride, rows, kn * 2);
    else copy_rows(dst, XLD * 2, src, stride, rows, BK * 2, kn * 2);
  }
};

// Column tile `tile` (BN columns from n0) of a dense row-major (K, ld) bf16
// weight: a step's rows are copied with cp.async straight into a bf16
// stage, which the walk multiplies with no decode (Raw is a WTile); zero
// past the weight's columns and past K.  FAST: the weight 16-byte aligned
// and ld a multiple of 8, so a thread copies one fixed 16-byte chunk a
// step.
template <bool FAST>
struct DenseTile {
  using Raw = WTile;
  const bf16* __restrict__ w;
  int ld, n0, width;  // width: the tile's columns inside ld
  __device__ DenseTile(const bf16* w_, int ld_, int tile)
      : w(w_), ld(ld_), n0(tile * BN), width(min(BN, ld_ - tile * BN)) {}
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const char* src = reinterpret_cast<const char*>(w + static_cast<size_t>(k0) * ld + n0);
    const size_t stride = static_cast<size_t>(ld) * 2;
    if constexpr (FAST) {
      static_assert(BK * BN * 2 / 16 == THREADS, "one 16-byte chunk a thread");
      const int row = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 16;
      char* d = reinterpret_cast<char*>(r.v[row]) + c;
      if (row < kn && c < width * 2) copy_chunk<16>(d, src + row * stride + c);
      else zero_chunk<16>(d);
    } else {
      copy_rows(r.v, WLD * 2, src, stride, kn, BN * 2, width * 2);
      for (int i = threadIdx.x; i < (BK - kn) * (WLD / 8); i += THREADS)
        *reinterpret_cast<uint4*>(&r.v[kn + i / (WLD / 8)][8 * (i % (WLD / 8))]) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Walk K rows [k_begin, k_end) of the tile for the rows of x's loader
// (xl: count() rows, prepare(xs) once, load(stage, k0, kn) per step); at
// the end of every slice (a multiple of slice_k, or k_end) call
// flush(slice, acc) with the slice's f32 partial, then restart acc at zero.
// At least one step runs, so an empty range flushes zeros.  While a step is
// decoded and multiplied, the copies of the next three are in flight.  A
// tile whose Raw stage is a WTile is multiplied from its stage as it
// landed.  The walk leaves with no copy in flight but without a closing
// barrier: a second walk in the same block needs a __syncthreads first.
template <class Tile, class XL, class Flush>
__device__ __forceinline__ void walk(XRing& xs, typename Tile::Raw* raw, WTile& w,
                                     const Tile& tile, const XL& xl, int K, int k_begin,
                                     int k_end, int slice_k, Flush flush) {
  constexpr bool direct = std::is_same_v<typename Tile::Raw, WTile>;
  const bool active = warp_row0() < xl.count();
  const int steps = max(1, (k_end - k_begin + BK - 1) / BK);
  auto kn_of = [&](int i) { return max(0, min(BK, K - (k_begin + i * BK))); };
  auto load_step = [&](int i) {  // step i into stage i % STAGES; a group per call
    if (i < steps) {
      xl.load(xs.v[i % STAGES], k_begin + i * BK, kn_of(i));
      tile.load(raw[i % STAGES], k_begin + i * BK, kn_of(i));
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) load_step(i);
  xl.prepare(xs);
  float acc[WN / 8][4] = {};
  int slice = k_begin / slice_k, slice_end = min(k_end, (slice + 1) * slice_k);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // step i has landed
    __syncthreads();              // ... for every thread; step i - 1 is consumed
    load_step(i + STAGES - 1);    // into the stage step i - 1 used
    if constexpr (direct) {
      if (active) mma_stage(xs.v[i % STAGES], raw[i % STAGES], acc);
    } else {
      tile.decode(raw[i % STAGES], kn_of(i), w);
      __syncthreads();
      if (active) mma_stage(xs.v[i % STAGES], w, acc);
    }
    if (k_begin + (i + 1) * BK >= slice_end) {
      flush(slice, acc);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      slice_end = min(k_end, (++slice + 1) * slice_k);
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty; leave none in flight
}

// out(row, col, v) for each element of a thread's accumulators inside (M,
// the tile's width); col is relative to the tile.
template <class Out>
__device__ __forceinline__ void for_each_out(const float acc[WN / 8][4], int m0, int M,
                                             int width, Out out) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + warp_row0() + (lane >> 2), c = warp_col0() + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r + 8 * (q >> 1), col = c + 8 * j + (q & 1);
      if (row < M && col < width) out(row, col, acc[j][q]);
    }
  }
}

// The slices dispatch: block (column tile, row tile, slice) writes the
// slice's partial to ws[slice] (M, N), f32.
template <bool FAST, class Tile>
__device__ __forceinline__ void slices_block(XRing& xs, typename Tile::Raw* raw, WTile& w,
                                             const Tile& tile, const bf16* __restrict__ x,
                                             float* __restrict__ ws, int M, int K, int N,
                                             int slice_k) {
  const int m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k_begin = s * slice_k, k_end = min(K, k_begin + slice_k);
  float* part = ws + static_cast<size_t>(s) * M * N + tile.n0;
  walk(xs, raw, w, tile, RowsX<FAST>(x, M, K, m0), K, k_begin, k_end, slice_k,
       [&](int, float(*acc)[4]) {
         for_each_out(acc, m0, M, tile.width,
                      [&](int row, int col, float v) { part[static_cast<size_t>(row) * N + col] = v; });
       });
}

// The rows dispatch: block (column tile, row tile) walks every slice in
// order, total = p0, then total += p1, ..., and writes y rounded once.
template <bool FAST, class Tile>
__device__ __forceinline__ void rows_block(XRing& xs, typename Tile::Raw* raw, WTile& w,
                                           const Tile& tile, const bf16* __restrict__ x,
                                           bf16* __restrict__ y, int M, int K, int N,
                                           int slice_k) {
  const int m0 = blockIdx.y * BM;
  float total[WN / 8][4] = {};
  walk(xs, raw, w, tile, RowsX<FAST>(x, M, K, m0), K, 0, K, slice_k, [&](int s, float(*acc)[4]) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[j][q] = s == 0 ? acc[j][q] : total[j][q] + acc[j][q];
  });
  bf16* out = y + tile.n0;
  for_each_out(total, m0, M, tile.width, [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * N + col] = __float2bfloat16(v);
  });
}

// The reduce pass of the slices dispatch: y = ws[0] + ws[1] + ... +
// ws[S-1], f32 in that order, rounded once.  The loads of 8 slices are
// made before their sums, so the chain waits on 1/8 of the latencies.
__device__ __forceinline__ void reduce_slices(const float* __restrict__ ws, bf16* __restrict__ y,
                                              int S, size_t MN) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < MN;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float t = ws[e];
    for (int s0 = 1; s0 < S; s0 += 8) {
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = s0 + j < S ? ws[(s0 + j) * MN + e] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < S) t += p[j];
    }
    y[e] = __float2bfloat16(t);
  }
}

constexpr int REDUCE_THREADS = 256;

__host__ inline int reduce_blocks(size_t MN) {
  return static_cast<int>(std::min<size_t>((MN + REDUCE_THREADS - 1) / REDUCE_THREADS, 4096));
}

// The wrapper's plan, checked: S slices of slice_k rows cover [0, K) and
// none is empty.
__host__ inline bool plan_ok(int K, int S, int slice_k) {
  return S >= 1 && slice_k > 0 && slice_k % BK == 0 &&
         static_cast<long long>(S - 1) * slice_k < std::max(K, 1) &&
         static_cast<long long>(S) * slice_k >= K;
}

// Launch split-K kernel `Kernel` with `Shared` in dynamic shared memory
// (beyond the 48 KB of a default launch: allowed once per kernel).
template <auto Kernel, class Shared, class... A>
__host__ inline cudaError_t launch_with_smem(dim3 grid, cudaStream_t stream, A... args) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(Shared)));
  if (allowed != cudaSuccess) return allowed;
  Kernel<<<grid, THREADS, sizeof(Shared), stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace splitk
}  // namespace salr
