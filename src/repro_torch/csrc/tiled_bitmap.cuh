// Shared device code of the tiled-bitmap SpMM kernels (salr_spmm.cu:
// salr_spmm and qsalr_spmm; bitmap_spmm.cu): the tiled-bitmap decode, one
// block-tile GEMM core and the SALR adapter pieces.  The decode is
// templated on how a set bit's value is fetched from its slot
// (PlainValues: a stored value; NF4Values: an NF4 code x cell scale), so
// the native and the NF4 kernels share it.
//
// Block tile: BM output rows x BN = 32 output columns (one bitmap word of
// one column tile), 128 threads = 4 warps.  Lane l owns output column l;
// warp w owns rows w, w+4, ..., w+28.  The reduction dimension streams
// through shared memory in stages of BK = 32 rows, converted to f32 on
// the way in, so every product and sum runs in f32 whatever the operand
// type.  Each output row is reduced over k = 0, 1, ..., K-1 in order by
// one thread, so a row's result does not depend on how many rows M the
// call holds (the engine's token parity with greedy_generate rests on
// that row independence).
#pragma once

#include "common.cuh"

namespace salr {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = BM / WARPS;

struct Smem {
  float a[BM][BK];  // left operand stage: rows x reduction
  float b[BK][BN];  // right operand stage: reduction x the block's 32 columns
};

// Stage rows [m0, m0+BM) x cols [k0, k0+BK) of a row-major (M, ld) matrix,
// zero outside (M, kmax).
template <typename T>
__device__ __forceinline__ void load_rows(float (*dst)[BK], const T* __restrict__ src,
                                          int m0, int M, int k0, int kmax, int ld) {
#pragma unroll
  for (int j = 0; j < BM * BK / THREADS; ++j) {
    int i = threadIdx.x + THREADS * j, r = i / BK, c = i % BK;
    int m = m0 + r, k = k0 + c;
    dst[r][c] = (m < M && k < kmax) ? to_f32(src[(size_t)m * ld + k]) : 0.f;
  }
}

// Stage rows [k0, k0+BK) x cols [n0, n0+BN) of a dense row-major (K, ld)
// matrix, zero outside (kmax, nmax).
template <typename T>
__device__ __forceinline__ void load_dense(float (*dst)[BN], const T* __restrict__ src,
                                           int k0, int kmax, int n0, int nmax, int ld) {
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < BK / WARPS; ++j) {
    int r = warp + WARPS * j, k = k0 + r, n = n0 + lane;
    dst[r][lane] = (k < kmax && n < nmax) ? to_f32(src[(size_t)k * ld + n]) : 0.f;
  }
}

// How a set bit's value is read from its cell's slot: fetch() does the
// slot's device-memory loads, value() turns what they returned into the
// f32 operand.  kTable: the loader reads the NF4 level table from shared
// memory, which the kernel fills and points ``lut`` at.  kFetchAll tells
// the decode to issue every row's fetch before it computes any value.  On
// the H100 that makes the NF4 decode-GEMM about a quarter faster (its
// value needs a dependent table lookup, which otherwise holds each row's
// loads back) but the plain one slower, which therefore keeps the
// single-step form (PERF.md).

// Stored values: values (cells, cap_t) of the operand type.
template <typename T>
struct PlainValues {
  using Raw = T;
  static constexpr bool kTable = false;
  static constexpr bool kFetchAll = false;
  const T* __restrict__ values;
  int cap_t;
  __device__ __forceinline__ Raw fetch(size_t cell, int slot) const {
    return values[cell * cap_t + slot];
  }
  __device__ __forceinline__ float value(Raw r, int) const { return to_f32(r); }
};

// NF4-quantized values: codes (cells, cap_t/2), packed interleaved (slot
// 2i in the low nibble of byte i, 2i+1 in the high), and one f32 absmax
// scale per cell.  The value is level x scale in f32, rounded to the
// operand type T (the reference rounds the decoded tile to x's dtype
// before its product).  ``lut`` is the level table in shared memory.
template <typename T>
struct NF4Values {
  struct Raw {
    uint32_t byte;
    float scale;
  };
  static constexpr bool kTable = true;
  static constexpr bool kFetchAll = true;
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scales;
  const float* lut;
  int cap_t;
  __device__ __forceinline__ Raw fetch(size_t cell, int slot) const {
    return {codes[cell * (cap_t / 2) + slot / 2], scales[cell]};
  }
  __device__ __forceinline__ float value(Raw r, int slot) const {
    const uint32_t nib = (slot & 1) ? (r.byte >> 4) : (r.byte & 0x0Fu);
    return round_to<T>(lut[nib] * r.scale);
  }
};

// Decode rows [k0, k0+BK) of the block's bitmap word into dense f32.
// Cell (k, tile) has wpt words and a compact segment of cap_t slots
// (read through ``vals``); the block's word is word `wi` of tile `ti`.
// Lane l decodes column l: its slot is the popcount of the cell's
// earlier words plus the bits below l in its own word (the exclusive
// prefix popcount), clamped to cap_t - 1.  A warp decodes rows warp,
// warp+WARPS, ...: lane j first loads word j of every row's cell (one
// coalesced load per row, all rows in flight), the earlier words'
// popcounts are summed across lanes, then every lane reads its slot,
// again with all rows' loads in flight.
template <typename V>
__device__ __forceinline__ void load_bitmap(float (*dst)[BN], const uint32_t* __restrict__ words,
                                            const V& vals, int k0, int K, int n_tiles, int wpt,
                                            int cap_t, int ti, int wi) {
  constexpr int RPW = BK / WARPS;  // rows per warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t cell_word[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    const size_t cell = (size_t)k * n_tiles + ti;
    cell_word[i] = (k < K && lane < wpt) ? words[cell * wpt + lane] : 0u;
  }
  typename V::Raw raw[RPW];
  int slot[RPW];
  bool set[RPW];
  float v[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    const size_t cell = (size_t)k * n_tiles + ti;
    const uint32_t word = __shfl_sync(0xffffffffu, cell_word[i], wi);
    const int prefix = __reduce_add_sync(0xffffffffu, lane < wi ? __popc(cell_word[i]) : 0);
    slot[i] = min(prefix + __popc(word & ((1u << lane) - 1u)), cap_t - 1);
    set[i] = k < K && ((word >> lane) & 1u);
    if constexpr (V::kFetchAll) {
      if (set[i]) raw[i] = vals.fetch(cell, slot[i]);
    } else {
      v[i] = set[i] ? vals.value(vals.fetch(cell, slot[i]), slot[i]) : 0.f;
    }
  }
  if constexpr (V::kFetchAll) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) v[i] = set[i] ? vals.value(raw[i], slot[i]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) dst[warp + WARPS * i][lane] = v[i];
}

// acc[i] += sum_k a[warp + WARPS*i][k] * b[k][lane], k ascending.
__device__ __forceinline__ void mma_stage(const Smem& s, float acc[ROWS_PER_THREAD]) {
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < BK; k += 4) {
    float b0 = s.b[k][lane], b1 = s.b[k + 1][lane];
    float b2 = s.b[k + 2][lane], b3 = s.b[k + 3][lane];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      float4 a = *reinterpret_cast<const float4*>(&s.a[warp + WARPS * i][k]);
      acc[i] = fmaf(a.x, b0, acc[i]);
      acc[i] = fmaf(a.y, b1, acc[i]);
      acc[i] = fmaf(a.z, b2, acc[i]);
      acc[i] = fmaf(a.w, b3, acc[i]);
    }
  }
}

// y[m0:m0+BM, n0:n0+BN] of x (M, K) @ W_hat, W_hat in tiled bitmap form,
// accumulated into acc.  Grid x enumerates the (tile, word) column blocks.
template <typename T, typename V>
__device__ __forceinline__ void bitmap_gemm(Smem& s, float acc[ROWS_PER_THREAD],
                                            const T* __restrict__ x,
                                            const uint32_t* __restrict__ words, const V& vals,
                                            int M, int K, int n_tiles, int wpt, int cap_t,
                                            int m0) {
  int ti = blockIdx.x / wpt, wi = blockIdx.x % wpt;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(s.a, x, m0, M, k0, K, K);
    load_bitmap(s.b, words, vals, k0, K, n_tiles, wpt, cap_t, ti, wi);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const float acc[ROWS_PER_THREAD],
                                           int M, int N, int m0, int n0) {
  int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    int m = m0 + warp + WARPS * i, n = n0 + lane;
    if (m < M && n < N) y[(size_t)m * N + n] = from_f32<T>(acc[i]);
  }
}

// u[m0:m0+BM, r0:r0+BN] = x @ A_cat, one rounding to T at the end (the
// body of the SALR kernels' first launch; grid (ceil(R/BN), M blocks)).
template <typename T>
__device__ __forceinline__ void adapter_u(Smem& s, const T* __restrict__ x,
                                          const T* __restrict__ a, T* __restrict__ u, int M,
                                          int K, int R) {
  float acc[ROWS_PER_THREAD] = {0.f};
  int m0 = blockIdx.y * BM, r0 = blockIdx.x * BN;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(s.a, x, m0, M, k0, K, K);
    load_dense(s.b, a, k0, K, r0, R, R);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
  store_tile(u, acc, M, R, m0, r0);
}

// One output tile of y = x @ W_hat + u @ B_cat (the body of the SALR
// kernels' second launch; grid (n_tiles*wpt, M blocks)): the bitmap
// decode-GEMM, then the adapter term reduced in f32 and added before the
// one rounding of y.
template <typename T, typename V>
__device__ __forceinline__ void salr_tile(Smem& s, const T* __restrict__ x,
                                          const uint32_t* __restrict__ words, const V& vals,
                                          const T* __restrict__ u, const T* __restrict__ b,
                                          T* __restrict__ y, int M, int K, int R, int n_tiles,
                                          int wpt, int cap_t) {
  const int N = n_tiles * wpt * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[ROWS_PER_THREAD] = {0.f};
  bitmap_gemm(s, acc, x, words, vals, M, K, n_tiles, wpt, cap_t, m0);
  float delta[ROWS_PER_THREAD] = {0.f};
  for (int r0 = 0; r0 < R; r0 += BK) {
    load_rows(s.a, u, m0, M, r0, R, R);
    load_dense(s.b, b, r0, R, n0, N, N);
    __syncthreads();
    mma_stage(s, delta);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] += delta[i];
  store_tile(y, acc, M, N, m0, n0);
}

}  // namespace salr
