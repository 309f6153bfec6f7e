// salr_spmm: the full SALR deployment op,
//     y = x @ W_hat + bf16(x @ A_cat) @ B_cat,
// with W_hat in the tiled bitmap format decoded inside the GEMM.
//
// Replaces: src/repro/kernels/salr_spmm.py:salr_spmm_pallas (ops.salr_matmul,
// every attention and SwiGLU projection of the main path).
//
// Bound on the H100: bytes at decode (M = 4..8: the compressed weight,
// ~0.35 MB for a 576 x 768 layer, plus A_cat/B_cat, about 2 flops per
// byte), tensor-core flops at prefill (M = 1024: ~600 flops per byte).
//
// Design: two launches.  The TPU kernel builds u = x @ A_cat on its first
// N pass and reuses it for every later N tile, which needs the grid to
// run in order; blocks on the GPU run in no order, so a first launch
// computes u once per 32-row M block into an (M, R) scratch, rounded to
// the operand type exactly as the TPU kernel's u.astype(b.dtype).  The
// second launch is the bitmap decode + GEMM of bitmap_spmm.cu with the
// adapter term u @ B_cat[:, block] reduced in f32 in its epilogue and
// added to the base sum before the one rounding of the output.  Neither
// launch uses a library GEMM.  Making it fast (wgmma, TMA, a pipelined
// decode) is later work.
#include "tiled_bitmap.cuh"

namespace {

// u[m0:m0+BM, r0:r0+BN] = x @ A_cat, one rounding to T at the end.
template <typename T>
__global__ void __launch_bounds__(salr::THREADS)
adapter_u_kernel(const T* __restrict__ x, const T* __restrict__ a, T* __restrict__ u,
                 int M, int K, int R) {
  __shared__ __align__(16) salr::Smem s;
  float acc[salr::ROWS_PER_THREAD] = {0.f};
  int m0 = blockIdx.y * salr::BM, r0 = blockIdx.x * salr::BN;
  for (int k0 = 0; k0 < K; k0 += salr::BK) {
    salr::load_rows(s.a, x, m0, M, k0, K, K);
    salr::load_dense(s.b, a, k0, K, r0, R, R);
    __syncthreads();
    salr::mma_stage(s, acc);
    __syncthreads();
  }
  salr::store_tile(u, acc, M, R, m0, r0);
}

template <typename T>
__global__ void __launch_bounds__(salr::THREADS)
salr_spmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ words,
                 const T* __restrict__ values, const T* __restrict__ u,
                 const T* __restrict__ b, T* __restrict__ y, int M, int K, int R,
                 int n_tiles, int wpt, int cap_t) {
  __shared__ __align__(16) salr::Smem s;
  const int N = n_tiles * wpt * 32;
  const int m0 = blockIdx.y * salr::BM, n0 = blockIdx.x * salr::BN;
  float acc[salr::ROWS_PER_THREAD] = {0.f};
  salr::bitmap_gemm(s, acc, x, words, values, M, K, n_tiles, wpt, cap_t, m0);
  float delta[salr::ROWS_PER_THREAD] = {0.f};
  for (int r0 = 0; r0 < R; r0 += salr::BK) {
    salr::load_rows(s.a, u, m0, M, r0, R, R);
    salr::load_dense(s.b, b, r0, R, n0, N, N);
    __syncthreads();
    salr::mma_stage(s, delta);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < salr::ROWS_PER_THREAD; ++i) acc[i] += delta[i];
  salr::store_tile(y, acc, M, N, m0, n0);
}

template <typename T>
int launch(const void* x, const void* words, const void* values, const void* a,
           const void* b, void* u, void* y, int M, int K, int R, int n_tiles, int wpt,
           int cap_t, cudaStream_t stream) {
  const int m_blocks = (M + salr::BM - 1) / salr::BM;
  dim3 grid_u((R + salr::BN - 1) / salr::BN, m_blocks);
  adapter_u_kernel<T><<<grid_u, salr::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<T*>(u), M, K, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_tiles * wpt, m_blocks);
  salr_spmm_kernel<T><<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(words),
      static_cast<const T*>(values), static_cast<const T*>(u), static_cast<const T*>(b),
      static_cast<T*>(y), M, K, R, n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K); words (K, n_tiles, wpt) uint32; values (K, n_tiles, cap_t);
// a (K, R); b (R, n_tiles*wpt*32); u (M, R) scratch; y (M, n_tiles*wpt*32).
// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the tensors.  Returns cudaGetLastError() after the launches.
extern "C" int salr_spmm(const void* x, const void* words, const void* values, const void* a,
                         const void* b, void* u, void* y, int M, int K, int R, int n_tiles,
                         int wpt, int cap_t, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, words, values, a, b, u, y, M, K, R, n_tiles, wpt, cap_t, st);
  return launch<__nv_bfloat16>(x, words, values, a, b, u, y, M, K, R, n_tiles, wpt, cap_t,
                               st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
