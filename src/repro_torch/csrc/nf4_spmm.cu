// nf4_spmm: y = x @ dequant(codes, scales), the NF4 dequantization fused
// into the GEMM.
//
// Replaces: src/repro/kernels/nf4_spmm.py:nf4_spmm_pallas (ops.nf4_matmul,
// the base term of a dense or masked-dense layer's NF4 twin, QDenseWeight,
// at decode under a mixed-precision plan: core/salr.py:_qkernel_dispatch).
//
// Layout: codes (K, N/2) uint8, interleaved (byte i of a row holds column
// 2i in its low nibble and 2i+1 in its high one); scales (K, N/64) f32, one
// absmax per 64 columns of a row.  The weight entry is NF4_LEVELS[nibble]
// x its scale in f32, rounded to x's dtype (the reference rounds the
// dequantized tile to x's dtype before its product) and summed in f32.
// The 16 levels sit in shared memory, not in the TPU kernel's 16-way
// select chain.
//
// Bound on the H100: bytes at decode.  A smollm_135m decode step has
// M = 4..8 rows against K x N = 576 x 576 (wo) or 1536 x 576 (down): half a
// byte per weight entry plus one f32 scale per 64 (0.5625 bytes), 8..16
// flops per byte, far below where bf16 tensor cores bind.
//
// Design: the column GEMM of column_gemm.cuh, one thread per output column
// and 8 rows per block (N/128 = 5 blocks at decode): simple and right
// first; wgmma over a dequantized shared-memory tile and TMA are later
// work.
#include "column_gemm.cuh"

namespace {

constexpr int QBLOCK = 64;  // columns per scale (core/quant.QBLOCK)

// Column col of the 2-D NF4 layout: fetch() loads the row's code byte and
// scale, value() decodes the nibble through the level table.
template <typename T>
struct NF4Column {
  struct Raw {
    uint32_t byte;
    float scale;
  };
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scales;
  const float* lut;  // the 16 levels in shared memory
  int half, nblk;    // code bytes and scales per row
  int byte, shift, blk;
  bool live;
  __device__ NF4Column(const uint8_t* codes_, const float* scales_, const float* lut_, int N,
                       int col)
      : codes(codes_), scales(scales_), lut(lut_), half(N / 2), nblk(N / QBLOCK),
        byte(min(col, N - 1) / 2), shift((min(col, N - 1) & 1) * 4),
        blk(min(col, N - 1) / QBLOCK), live(col < N) {}
  __device__ __forceinline__ Raw fetch(int k) const {
    return {codes[(size_t)k * half + byte], scales[(size_t)k * nblk + blk]};
  }
  __device__ __forceinline__ float value(const Raw& r) const {
    return live ? salr::round_to<T>(lut[(r.byte >> shift) & 0x0Fu] * r.scale) : 0.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(salr::colgemm::THREADS)
nf4_spmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, T* __restrict__ y, int M, int K, int N) {
  using namespace salr::colgemm;
  __shared__ __align__(16) XStage s;
  __shared__ float lut[16];
  salr::load_nf4_table(lut);
  __syncthreads();
  const int m0 = blockIdx.x * BM;
  const int col = blockIdx.y * THREADS + threadIdx.x;
  const NF4Column<T> w(codes, scales, lut, N, col);
  float acc[BM] = {0.f};
  accumulate(s, acc, x, w, M, K, m0);
  store_rows(y, acc, M, N, m0, col);
}

template <typename T>
int launch(const void* x, const void* codes, const void* scales, void* y, int M, int K, int N,
           cudaStream_t stream) {
  using namespace salr::colgemm;
  dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
  nf4_spmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<T*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K); codes (K, N/2) uint8; scales (K, N/64) f32; y (M, N), N a
// multiple of 64.  dtype: 0 = float32, 1 = bfloat16; device: the CUDA
// ordinal of the tensors.  Returns cudaGetLastError() after the launch.
extern "C" int nf4_spmm(const void* x, const void* codes, const void* scales, void* y, int M,
                        int K, int N, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, codes, scales, y, M, K, N, st);
  return launch<__nv_bfloat16>(x, codes, scales, y, M, K, N, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
