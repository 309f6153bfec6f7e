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
// Design: two launches.  The TPU kernel builds u = x @ A_cat on its first
// N pass and reuses it for every later N tile, which needs the grid to
// run in order; blocks on the GPU run in no order, so a first launch
// computes u once per 32-row M block into an (M, R) scratch, rounded to
// the operand type exactly as the TPU kernel's u.astype(b.dtype).  The
// second launch is the bitmap decode + GEMM of bitmap_spmm.cu with the
// adapter term u @ B_cat[:, block] reduced in f32 in its epilogue and
// added to the base sum before the one rounding of the output.  The two
// ops differ only in the value loader the decode is instantiated with
// (tiled_bitmap.cuh): PlainValues reads a stored value; NF4Values reads
// NF4_LEVELS[nibble] x the cell's scale in f32 (low nibble for an even
// slot, high for an odd one), rounded to the operand type and widened, as
// the reference rounds the decoded tile to x's dtype before its product,
// with the 16 levels in shared memory.  Both kernels carry the loader in
// their template arguments, so a profile tells the native and NF4 ops
// apart by name.  Each output row is reduced over k in one fixed order by
// one thread, so a row's result does not depend on M (the engine decodes
// at M = n_slots, greedy_generate at M = batch).  Neither launch uses a
// library GEMM.  Making it fast (wgmma, TMA, a pipelined decode) is later
// work.
#include "tiled_bitmap.cuh"

namespace {

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

template <typename T, typename V>
int launch(const void* x, const void* words, V vals, const void* a, const void* b, void* u,
           void* y, int M, int K, int R, int n_tiles, int wpt, int cap_t,
           cudaStream_t stream) {
  const int m_blocks = (M + salr::BM - 1) / salr::BM;
  if (R > 0) {  // a rank-0 layer has no adapter term
    dim3 grid_u((R + salr::BN - 1) / salr::BN, m_blocks);
    adapter_u_kernel<T, V><<<grid_u, salr::THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(a), static_cast<T*>(u), M, K, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_tiles * wpt, m_blocks);
  salr_spmm_kernel<T, V><<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(words), vals,
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<T*>(y), M, K, R,
      n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K); words (K, n_tiles, wpt) uint32; values (K, n_tiles, cap_t);
// a (K, R); b (R, n_tiles*wpt*32); u (M, R) scratch; y (M, n_tiles*wpt*32).
// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors.  Returns cudaGetLastError() after the launches.
extern "C" int salr_spmm(const void* x, const void* words, const void* values, const void* a,
                         const void* b, void* u, void* y, int M, int K, int R, int n_tiles,
                         int wpt, int cap_t, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, words, salr::PlainValues<float>{static_cast<const float*>(values),
                                                             cap_t},
                         a, b, u, y, M, K, R, n_tiles, wpt, cap_t, st);
  using bf16 = __nv_bfloat16;
  return launch<bf16>(x, words, salr::PlainValues<bf16>{static_cast<const bf16*>(values), cap_t},
                      a, b, u, y, M, K, R, n_tiles, wpt, cap_t, st);
}

// As salr_spmm with the values in NF4: codes (K, n_tiles, cap_t/2) uint8,
// interleaved (slot 2i low nibble, 2i+1 high); scales (K, n_tiles) f32.
extern "C" int qsalr_spmm(const void* x, const void* words, const void* codes,
                          const void* scales, const void* a, const void* b, void* u, void* y,
                          int M, int K, int R, int n_tiles, int wpt, int cap_t, int dtype,
                          int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* sc = static_cast<const float*>(scales);
  if (dtype == 0)
    return launch<float>(x, words, salr::NF4Values<float>{c, sc, nullptr, cap_t}, a, b, u, y,
                         M, K, R, n_tiles, wpt, cap_t, st);
  return launch<__nv_bfloat16>(x, words, salr::NF4Values<__nv_bfloat16>{c, sc, nullptr, cap_t},
                               a, b, u, y, M, K, R, n_tiles, wpt, cap_t, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
