// nm_spmm: y = x @ W_hat with W_hat in N:M (2:4) form, the group decode
// fused into the GEMM.
//
// Replaces: src/repro/kernels/nm_spmm.py:nm_spmm_pallas (ops.nm_matmul, the
// base term of every untransposed N:M projection, wo and down, under
// method="nm": core/salr.py:_kernel_dispatch).
//
// Layout: group_bits (K, N/m) uint8, bit t of byte g marking column m*g+t;
// values (K, N/m*n), a set bit's value at slot n*g + (the popcount of the
// bits below it in its byte), clamped to n - 1 as core/bitmap.nm_decode
// clamps it.  The TPU kernel recovers the value with a select network (no
// gather on its vector unit); here a thread loads its group's n values
// beside the byte and selects one by a __popc of the byte.  n = 1, 2, 4
// (a template argument; ops.nm_matmul checks it).
//
// Bound on the H100: bytes at decode.  At smollm_135m width a decode step
// has M = 4..8 rows against K x N = 576 x 576 (wo) or 1536 x 576 (down):
// 2.25 bytes per stored column (1/4 byte of bits, n/m = 1/2 of a bf16
// value), 4..8 flops per weight column per row block, far below the
// ~295 flop/byte where bf16 tensor cores bind.  Prefill (M = 1024) moves
// the same weight for 128x the flops, where tensor cores would bind.
//
// Design: the column GEMM of column_gemm.cuh, one thread per output column
// and 8 rows per block (N/128 = 5 blocks at decode): simple and right
// first.  Its f32 FMAs leave the tensor cores idle; Hopper's sparse
// mma.sp would want the 2:4 pattern along K, and this layout groups along
// N, so a sparse-tensor-core kernel needs another encoding (ROADMAP).
#include "column_gemm.cuh"

namespace {

// Column col of an N:M weight with NK = n values per group of m.  fetch()
// loads the row's group byte and all NK values of the group, which need
// not wait for the byte; value() picks the set bit's slot among them.
template <typename T, int NK>
struct NMColumn {
  struct Raw {
    uint32_t byte;
    T v[NK];
  };
  const uint8_t* __restrict__ bits;
  const T* __restrict__ values;
  int groups;  // N / m: group bytes per row
  int g, t;    // this column's group and its position there
  bool live;
  __device__ NMColumn(const uint8_t* bits_, const T* values_, int N, int m, int col)
      : bits(bits_), values(values_), groups(N / m), g(min(col, N - 1) / m),
        t(min(col, N - 1) % m), live(col < N) {}
  __device__ __forceinline__ Raw fetch(int k) const {
    Raw r;
    const size_t cell = (size_t)k * groups + g;
    r.byte = bits[cell];
#pragma unroll
    for (int j = 0; j < NK; ++j) r.v[j] = values[cell * NK + j];
    return r;
  }
  __device__ __forceinline__ float value(const Raw& r) const {
    if (!live || !((r.byte >> t) & 1u)) return 0.f;
    const int slot = min(__popc(r.byte & ((1u << t) - 1u)), NK - 1);
    float out = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      if (j == slot) out = salr::to_f32(r.v[j]);  // a select, no indexed registers
    return out;
  }
};

template <typename T, int NK>
__global__ void __launch_bounds__(salr::colgemm::THREADS)
nm_spmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ bits,
               const T* __restrict__ values, T* __restrict__ y, int M, int K, int N, int m) {
  using namespace salr::colgemm;
  __shared__ __align__(16) XStage s;
  const int m0 = blockIdx.x * BM;
  const int col = blockIdx.y * THREADS + threadIdx.x;
  const NMColumn<T, NK> w(bits, values, N, m, col);
  float acc[BM] = {0.f};
  accumulate(s, acc, x, w, M, K, m0);
  store_rows(y, acc, M, N, m0, col);
}

template <typename T, int NK>
int launch_n(const void* x, const void* bits, const void* values, void* y, int M, int K, int N,
             int m, cudaStream_t stream) {
  using namespace salr::colgemm;
  dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
  nm_spmm_kernel<T, NK><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(bits),
      static_cast<const T*>(values), static_cast<T*>(y), M, K, N, m);
  return static_cast<int>(cudaGetLastError());
}

// n is a template argument of the kernel: 1, 2 (2:4) and 4 are built.
template <typename T>
int launch(const void* x, const void* bits, const void* values, void* y, int M, int K, int N,
           int n, int m, cudaStream_t stream) {
  switch (n) {
    case 1: return launch_n<T, 1>(x, bits, values, y, M, K, N, m, stream);
    case 2: return launch_n<T, 2>(x, bits, values, y, M, K, N, m, stream);
    case 4: return launch_n<T, 4>(x, bits, values, y, M, K, N, m, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, K); group_bits (K, N/m) uint8; values (K, N/m*n); y (M, N).
// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors.  Returns cudaGetLastError() after the launch.
extern "C" int nm_spmm(const void* x, const void* group_bits, const void* values, void* y,
                       int M, int K, int N, int n, int m, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, group_bits, values, y, M, K, N, n, m, st);
  return launch<__nv_bfloat16>(x, group_bits, values, y, M, K, N, n, m, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
