// bitmap_spmm: y = x @ W_hat with W_hat in the tiled bitmap format, the
// bitmap decode fused into the GEMM.
//
// Replaces: src/repro/kernels/bitmap_spmm.py:bitmap_spmm_pallas (the
// rank-0 route of ops.bitmap_matmul, core/salr.py:267).
//
// Bound on the H100: bytes.  At smollm_135m width a decode step has
// M = 4..8 rows against K x N = 576 x 1536 weights: about 2 flops per
// compressed weight byte, far below the ~295 flop/byte where bf16 tensor
// cores would bind; prefill (M = 1024) reaches ~600 flop/byte, where the
// tensor cores would bind.
//
// Design: the weight is read exactly once per 32-row M block in its
// compressed form (uint32 words + cap_t values per cell) and decoded in
// shared memory by a warp per row (lane = column, __popc prefix slots),
// so device memory never holds a dense W_hat.  One block per (32-column
// word, 32-row M block) gives cols/32 blocks at decode (6..48 at this
// width): simple and right first; split-K, wgmma and a TMA-fed two-stage
// decode/GEMM pipeline are later work.
#include "tiled_bitmap.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(salr::THREADS)
bitmap_spmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ words,
                   const T* __restrict__ values, T* __restrict__ y, int M, int K,
                   int n_tiles, int wpt, int cap_t) {
  __shared__ __align__(16) salr::Smem s;
  float acc[salr::ROWS_PER_THREAD] = {0.f};
  int m0 = blockIdx.y * salr::BM;
  const salr::PlainValues<T> vals{values, cap_t};
  salr::bitmap_gemm(s, acc, x, words, vals, M, K, n_tiles, wpt, cap_t, m0);
  salr::store_tile(y, acc, M, n_tiles * wpt * 32, m0, blockIdx.x * salr::BN);
}

template <typename T>
int launch(const void* x, const void* words, const void* values, void* y, int M, int K,
           int n_tiles, int wpt, int cap_t, cudaStream_t stream) {
  dim3 grid(n_tiles * wpt, (M + salr::BM - 1) / salr::BM);
  bitmap_spmm_kernel<T><<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(words),
      static_cast<const T*>(values), static_cast<T*>(y), M, K, n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the tensors.  Returns cudaGetLastError() after the launch.
extern "C" int bitmap_spmm(const void* x, const void* words, const void* values, void* y,
                           int M, int K, int n_tiles, int wpt, int cap_t, int dtype,
                           int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, words, values, y, M, K, n_tiles, wpt, cap_t, st);
  return launch<__nv_bfloat16>(x, words, values, y, M, K, n_tiles, wpt, cap_t, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
