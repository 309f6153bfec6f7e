// fused_lora: the concatenated-adapter term alone,
//     y = bf16(x @ A_cat) @ B_cat,
// with u = x @ A_cat kept on chip.
//
// Replaces: src/repro/kernels/fused_lora.py:fused_lora_pallas
// (ops.lora_matmul, the adapter term of every layer whose base op carries
// none: wo and down under method="nm" beside nm_spmm, and beside nf4_spmm
// under a dense or masked base's NF4 twin; core/salr.py:_kernel_dispatch,
// _qkernel_dispatch).
//
// Rounding, as the TPU kernel's: u is summed in f32 and rounded to B_cat's
// dtype (the operand type T), then u @ B_cat is summed in f32 and rounded
// once to x's.
//
// Bound on the H100: bytes at decode.  A smollm_135m decode step (M = 4..8,
// R = 128: LoRA 64 + residual 64) reads A_cat (K x 128) and B_cat
// (128 x 576) for about 2 x M x (K + N) x R flops: 4..8 flops per byte.
//
// Design: the TPU kernel builds u on its first N pass and reuses it for the
// later N tiles, which needs its grid to run in order.  GPU blocks run in
// no order, so every block computes u for its 8 rows into shared memory
// (thread t owning u's columns t, t + 128, ...: the column GEMM of
// column_gemm.cuh over A_cat), rounds it, then produces its 128 output
// columns from it (thread t owning one, the reduction over R in order).
// At decode N/128 = 5 blocks each recompute the same u, which costs K x R
// x 8 FMAs a block and saves a launch and u's round trip through device
// memory.  Each row is reduced in one fixed order, so a row's result does
// not depend on M.  Up to MAX_RANK = 256 (ops.LORA_MAX_RANK).
#include "column_gemm.cuh"

namespace {

constexpr int MAX_RANK = 256;

template <typename T>
__global__ void __launch_bounds__(salr::colgemm::THREADS)
fused_lora_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ y, int M, int K, int R, int N) {
  using namespace salr::colgemm;
  __shared__ __align__(16) XStage s;
  __shared__ float u[BM][MAX_RANK];
  const int m0 = blockIdx.x * BM;
  for (int r0 = 0; r0 < R; r0 += THREADS) {
    const int r = r0 + threadIdx.x;
    float acc[BM] = {0.f};
    accumulate(s, acc, x, DenseColumn<T>(a, R, r), M, K, m0);
    if (r < R) {
#pragma unroll
      for (int i = 0; i < BM; ++i) u[i][r] = salr::round_to<T>(acc[i]);
    }
  }
  __syncthreads();
  const int n = blockIdx.y * THREADS + threadIdx.x;
  const DenseColumn<T> bcol(b, N, n);
  float acc[BM] = {0.f};
  for (int r0 = 0; r0 < R; r0 += FETCH) {  // FETCH rows of B_cat in flight
    T raw[FETCH];
#pragma unroll
    for (int j = 0; j < FETCH; ++j) raw[j] = bcol.fetch(min(r0 + j, R - 1));
#pragma unroll
    for (int j = 0; j < FETCH; ++j) {
      if (r0 + j < R) {
        const float bv = bcol.value(raw[j]);
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] = fmaf(u[i][r0 + j], bv, acc[i]);
      }
    }
  }
  store_rows(y, acc, M, N, m0, n);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, void* y, int M, int K, int R, int N,
           cudaStream_t stream) {
  using namespace salr::colgemm;
  if (R < 1 || R > MAX_RANK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
  fused_lora_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(y), M, K, R, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K); a (K, R); b (R, N); y (M, N); 1 <= R <= 256.  dtype: 0 =
// float32, 1 = bfloat16; device: the CUDA ordinal of the tensors.  Returns
// cudaGetLastError() after the launch.
extern "C" int fused_lora(const void* x, const void* a, const void* b, void* y, int M, int K,
                          int R, int N, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, b, y, M, K, R, N, st);
  return launch<__nv_bfloat16>(x, a, b, y, M, K, R, N, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
