// Shared device code of the column GEMM kernels (nm_spmm.cu, nf4_spmm.cu,
// fused_lora.cu): y = x @ W for a weight W that is decoded entry by entry
// as it is read (an N:M group, an NF4 code, or a plain dense entry).
//
// Block tile: BM = 8 output rows x THREADS = 128 output columns; thread t
// owns column blockIdx.y * THREADS + t and all BM rows of it, so it reads
// and decodes each weight entry of its column once per row block.  The
// block stages x in steps of KC reduction rows through shared memory
// (converted to f32, transposed so one k's BM values are two float4
// reads); the thread streams its column of W from device memory, FETCH
// rows at a time: every load of a batch is issued before any is used
// (the loads take no branch, a column past N reads column N-1 and is
// never stored), so FETCH loads are in flight where one would otherwise
// wait on the last.  Every product and sum runs in f32, one fmaf per
// term, k = 0, 1, ..., K-1 in order: a row's result does not depend on
// how many rows M the call holds (the engine decodes at M = n_slots,
// greedy_generate at M = batch, and their token parity rests on that).
// BM = 8 fits the main path's decode batches (4 engine slots, 8 greedy
// rows) in one row block.
#pragma once

#include "common.cuh"

namespace salr {
namespace colgemm {

constexpr int THREADS = 128;  // output columns per block, one per thread
constexpr int BM = 8;         // output rows per block
constexpr int KC = 64;        // reduction rows of x staged per step
constexpr int FETCH = 16;     // weight rows a thread loads before using them

struct XStage {
  float v[KC][BM];  // x[m0 + r][k0 + c] at v[c][r]
};

// Stage x rows [m0, m0+BM) x reduction [k0, k0+KC), zero outside (M, K).
template <typename T>
__device__ __forceinline__ void stage_x(XStage& s, const T* __restrict__ x, int m0, int M,
                                        int k0, int K) {
#pragma unroll
  for (int j = 0; j < BM * KC / THREADS; ++j) {
    const int i = threadIdx.x + THREADS * j;
    const int r = i / KC, c = i % KC;  // neighbouring threads read neighbouring k
    const int m = m0 + r, k = k0 + c;
    s.v[c][r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
  }
}

// acc[i] += x[m0 + i][k] * v (the BM rows of one k).
__device__ __forceinline__ void fma_rows(const XStage& s, int c, float v, float acc[BM]) {
  const float4 lo = *reinterpret_cast<const float4*>(&s.v[c][0]);
  const float4 hi = *reinterpret_cast<const float4*>(&s.v[c][4]);
  acc[0] = fmaf(lo.x, v, acc[0]);
  acc[1] = fmaf(lo.y, v, acc[1]);
  acc[2] = fmaf(lo.z, v, acc[2]);
  acc[3] = fmaf(lo.w, v, acc[3]);
  acc[4] = fmaf(hi.x, v, acc[4]);
  acc[5] = fmaf(hi.y, v, acc[5]);
  acc[6] = fmaf(hi.z, v, acc[6]);
  acc[7] = fmaf(hi.w, v, acc[7]);
}

// acc[i] += sum_k x[m0 + i][k] * W[k][col], k ascending.  The loader's
// fetch(k) does the device-memory loads of row k of the thread's column
// (unconditionally), value(raw) turns them into the f32 entry (0 for a
// column past N).  All threads of the block call it: it synchronises.
template <typename T, typename W>
__device__ __forceinline__ void accumulate(XStage& s, float acc[BM], const T* __restrict__ x,
                                           const W& w, int M, int K, int m0) {
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous stage has been read
    stage_x(s, x, m0, M, k0, K);
    __syncthreads();
    const int kn = min(KC, K - k0);
    for (int c0 = 0; c0 < kn; c0 += FETCH) {
      typename W::Raw raw[FETCH];
#pragma unroll
      for (int j = 0; j < FETCH; ++j) raw[j] = w.fetch(k0 + min(c0 + j, kn - 1));
#pragma unroll
      for (int j = 0; j < FETCH; ++j)
        if (c0 + j < kn) fma_rows(s, c0 + j, w.value(raw[j]), acc);
    }
  }
}

// y[m0 + i][n] = acc[i], one rounding to T, inside (M, N).
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ y, const float acc[BM], int M, int N,
                                           int m0, int n) {
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (m0 + i < M) y[(size_t)(m0 + i) * N + n] = from_f32<T>(acc[i]);
}

// Column n of a dense row-major (K, ld) matrix with ld columns; ``live``
// is false for a column past them, which reads column ld - 1.
template <typename T>
struct DenseColumn {
  using Raw = T;
  const T* __restrict__ w;
  int ld, n;
  bool live;
  __device__ DenseColumn(const T* w_, int ld_, int n_)
      : w(w_), ld(ld_), n(min(n_, ld_ - 1)), live(n_ < ld_) {}
  __device__ __forceinline__ Raw fetch(int k) const { return w[(size_t)k * ld + n]; }
  __device__ __forceinline__ float value(Raw r) const { return live ? to_f32(r) : 0.f; }
};

}  // namespace colgemm
}  // namespace salr
