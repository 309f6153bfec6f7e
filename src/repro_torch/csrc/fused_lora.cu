// fused_lora: the concatenated-adapter term alone,
//     y = bf16(x @ A_cat) @ B_cat.
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
// At prefill size (M = 1024) the same bytes carry 0.6 GFLOP (down).
//
// Design, bf16: two passes on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators), with the split-K walk of splitk_gemm.cuh.
//   1. u = x @ A_cat (fused_lora_kernel_u): A_cat is a dense (K, R) weight,
//      so a DenseTile copies a step's (32, 64) slab of it with 16-byte
//      cp.async straight into the bf16 stage the mma reads, no decode.  The
//      wrapper's plan (ops.lora_plan) cuts K into at most 8 slices of whole
//      32-row steps, from K alone, never from M; a block per (u column
//      tile, row tile, slice) writes the slice's f32 partial to ws (S, M,
//      R): down at M = 4 2 x 8 blocks of 6 steps, where the column GEMM
//      ran 5 blocks over all 1536 rows; at M = 1024 256 blocks.
//   2. fused_lora_kernel_out, a block per (64 output columns, 64 rows):
//      sums the slices in slice order (one round of 16-byte loads), rounds
//      u once to bf16 into shared memory beside a (R, 64) column tile of
//      B_cat copied with cp.async, and multiplies the two with ldmatrix
//      fragments, R / 16 k16 steps (8 at R = 128); writes y once.  The
//      product is adapter_mma.cuh's, which salr_spmm.cu shares.
// Why at most 8 slices, and one dispatch (the spmm_ab.py sweep of M = 4 to
// 1024 on an H100, PERF.md): every output block sums every slice of its
// rows, so the 48 one-step slices of splitk_plan cost more in that sum
// than they save in the u pass (down M = 4: 0.0102 against 0.0080 ms), and
// a block walking all of K (PR 17's rows dispatch for nm_spmm) leaves the
// card idle at M = 1024 (32 blocks: 0.0345 against 0.0189 ms).
// No atomics.  mma.sync keeps rows apart, and a row meets the same slices,
// k16 steps and sum order at every M, so its bits do not depend on the
// batch it came in.  FAST kernels (x, A_cat and B_cat
// 16-byte aligned, K, R and N multiples of 8: every main-path shape) give
// each thread one fixed 16-byte chunk per stream and step; the others copy
// with the widest width the addresses allow.  It replaces a column GEMM,
// one thread per output column, every block recomputing u over all of K
// on CUDA cores (0.1229 ms at down M = 4, 0.1514 at M = 1024; NVIDIA H100
// 80GB HBM3, 700.00 W; spmm_ab.py, PERF.md).  f32 keeps that column GEMM:
// f32 is held at 1e-5, which TF32 tensor cores cannot meet.  Up to
// MAX_RANK = 256 (ops.LORA_MAX_RANK).
#include "adapter_mma.cuh"
#include "column_gemm.cuh"

namespace {

using salr::splitk::bf16;
using salr::splitk::MAX_RANK;

// f32: the column GEMM.  Every block computes u for its 8 rows into shared
// memory (thread t owning u's columns t, t + 128, ...), rounds it, then
// produces its 128 output columns from it (thread t owning one, the
// reduction over R in order).
__global__ void __launch_bounds__(salr::colgemm::THREADS)
fused_lora_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, float* __restrict__ y, int M, int K, int R,
                  int N) {
  using namespace salr::colgemm;
  __shared__ __align__(16) XStage s;
  __shared__ float u[BM][MAX_RANK];
  const int m0 = blockIdx.x * BM;
  for (int r0 = 0; r0 < R; r0 += THREADS) {
    const int r = r0 + threadIdx.x;
    float acc[BM] = {0.f};
    accumulate(s, acc, x, DenseColumn<float>(a, R, r), M, K, m0);
    if (r < R) {
#pragma unroll
      for (int i = 0; i < BM; ++i) u[i][r] = acc[i];
    }
  }
  __syncthreads();
  const int n = blockIdx.y * THREADS + threadIdx.x;
  const DenseColumn<float> bcol(b, N, n);
  float acc[BM] = {0.f};
  for (int r0 = 0; r0 < R; r0 += FETCH) {  // FETCH rows of B_cat in flight
    float raw[FETCH];
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

// bf16, pass 1: the walk over x and A_cat's (K, R) rows.
struct UShared {
  salr::splitk::XRing xs;
  salr::splitk::WTile raw[salr::splitk::STAGES];  // A_cat's slabs, multiplied in place
};

// Block (u column tile, row tile, slice) writes the slice's f32 partial to
// ws[slice] (M, R).
template <bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
fused_lora_kernel_u(const bf16* __restrict__ x, const bf16* __restrict__ a,
                    float* __restrict__ ws, int M, int K, int R, int slice_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<UShared*>(smem);
  const salr::splitk::DenseTile<FAST> tile(a, R, blockIdx.x);
  // the decode buffer argument is unread: a DenseTile's stage is its tile
  salr::splitk::slices_block<FAST>(s.xs, s.raw, s.raw[0], tile, x, ws, M, K, R, slice_k);
}

// bf16, pass 2: block (64 output columns, 64 rows) multiplies its rows of
// u, summed from the slices and rounded once, by B_cat's column tile
// (adapter_mma.cuh) and writes y once.
template <bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
fused_lora_kernel_out(const float* __restrict__ ws, const bf16* __restrict__ b,
                      bf16* __restrict__ y, int S, int M, int R, int N) {
  using namespace salr::splitk;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<AdapterShared*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[WN / 8][4];
  adapter_product<FAST>(s, ws, S, b, M, R, N, m0, n0, acc);
  bf16* out = y + n0;
  for_each_out(acc, m0, M, min(BN, N - n0), [&](int row, int col, float v) {
    out[static_cast<size_t>(row) * N + col] = __float2bfloat16(v);
  });
}

template <bool FAST>
int launch_bf16(const void* x, const void* a, const void* b, void* y, void* ws, int M, int K,
                int R, int N, int slices, int slice_k, cudaStream_t stream) {
  using namespace salr::splitk;
  auto* wsf = static_cast<float*>(ws);
  const cudaError_t err = launch_with_smem<fused_lora_kernel_u<FAST>, UShared>(
      dim3((R + BN - 1) / BN, (M + BM - 1) / BM, slices), stream, static_cast<const bf16*>(x),
      static_cast<const bf16*>(a), wsf, M, K, R, slice_k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_with_smem<fused_lora_kernel_out<FAST>, AdapterShared>(
      dim3((N + BN - 1) / BN, (M + BM - 1) / BM), stream, wsf, static_cast<const bf16*>(b),
      static_cast<bf16*>(y), slices, M, R, N));
}

}  // namespace

// x (M, K); a (K, R); b (R, N); y (M, N); 1 <= R <= 256.  bf16 only: K cut
// into `slices` slices of slice_k rows (ops.lora_plan over K), ws an f32
// (slices, M, R) workspace.  f32 ignores ws and the plan.  dtype: 0 =
// float32, 1 = bfloat16; device: the CUDA ordinal of the tensors.  Returns
// cudaGetLastError() after the launches.
extern "C" int fused_lora(const void* x, const void* a, const void* b, void* y, void* ws, int M,
                          int K, int R, int N, int slices, int slice_k, int dtype, int device,
                          void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (R < 1 || R > MAX_RANK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using namespace salr::colgemm;
    dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
    fused_lora_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(y), M, K, R, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws == nullptr || !salr::splitk::plan_ok(K, slices, slice_k))
    return static_cast<int>(cudaErrorInvalidValue);
  using salr::splitk::aligned16;
  if (salr::splitk::x_vec(x, K) && aligned16(a) && aligned16(b) && R % 8 == 0 && N % 8 == 0)
    return launch_bf16<true>(x, a, b, y, ws, M, K, R, N, slices, slice_k, st);
  return launch_bf16<false>(x, a, b, y, ws, M, K, R, N, slices, slice_k, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
