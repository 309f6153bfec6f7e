// Shared device code of the tiled-bitmap SpMM kernels (salr_spmm.cu,
// bitmap_spmm.cu): the tiled-bitmap decode and one block-tile GEMM core.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace salr {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = BM / WARPS;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

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

// Decode rows [k0, k0+BK) of the block's bitmap word into dense f32.
// Cell (k, tile) has wpt words and a compact segment of cap_t values; the
// block's word is word `wi` of tile `ti`.  Lane l decodes column l: its
// slot is the popcount of the cell's earlier words plus the bits below l
// in its own word (the exclusive prefix popcount), clamped to cap_t - 1.
// A warp decodes rows warp, warp+WARPS, ...: lane j first loads word j of
// every row's cell (one coalesced load per row, all rows in flight), the
// earlier words' popcounts are summed across lanes, then every lane
// gathers its value, again with all rows' loads in flight.
template <typename T>
__device__ __forceinline__ void load_bitmap(float (*dst)[BN], const uint32_t* __restrict__ words,
                                            const T* __restrict__ values, int k0, int K,
                                            int n_tiles, int wpt, int cap_t, int ti, int wi) {
  constexpr int RPW = BK / WARPS;  // rows per warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t cell_word[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    const size_t cell = (size_t)k * n_tiles + ti;
    cell_word[i] = (k < K && lane < wpt) ? words[cell * wpt + lane] : 0u;
  }
  float v[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int k = k0 + warp + WARPS * i;
    const size_t cell = (size_t)k * n_tiles + ti;
    const uint32_t word = __shfl_sync(0xffffffffu, cell_word[i], wi);
    const int prefix = __reduce_add_sync(0xffffffffu, lane < wi ? __popc(cell_word[i]) : 0);
    const int slot = min(prefix + __popc(word & ((1u << lane) - 1u)), cap_t - 1);
    v[i] = (k < K && ((word >> lane) & 1u)) ? to_f32(values[cell * cap_t + slot]) : 0.f;
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
template <typename T>
__device__ __forceinline__ void bitmap_gemm(Smem& s, float acc[ROWS_PER_THREAD],
                                            const T* __restrict__ x,
                                            const uint32_t* __restrict__ words,
                                            const T* __restrict__ values, int M, int K,
                                            int n_tiles, int wpt, int cap_t, int m0) {
  int ti = blockIdx.x / wpt, wi = blockIdx.x % wpt;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(s.a, x, m0, M, k0, K, K);
    load_bitmap(s.b, words, values, k0, K, n_tiles, wpt, cap_t, ti, wi);
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

}  // namespace salr
