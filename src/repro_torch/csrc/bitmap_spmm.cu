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
// Design, bf16: it is salr_spmm without the adapter, so it runs
// salr_spmm's split-K tensor-core walk (salr_walk.cuh) at R = 0: the
// weight's cells copied with cp.async through a 4-stage ring, decoded into
// a bf16 (32, 64) tile and multiplied with mma.sync m16n8k16, K cut into
// slices by the wrapper's plan (ops.salr_plan, from (K, N) and the SM
// count, never M), an accumulator flushed every CHUNK_K rows.  Two
// dispatches (ops._walks_rows): slices, bitmap_spmm_kernel_splitk writing
// each slice's f32 partial to ws (S, M, N), then bitmap_spmm_kernel_out
// summing them in slice order and rounding once; rows,
// bitmap_spmm_kernel_rows walking every slice in order.  There is no u
// pass.  A row meets the same k16 steps, chunks, slices and sum order as
// salr_spmm's base at every M and in both dispatches, so its bits equal
// salr_spmm's with zero adapters and do not depend on the batch it came
// in.  It replaced the scalar body below for bf16 (one 128-thread block
// per 32-column word and 32-row M block, 48 blocks at smollm gate/up, each
// walking all of K on CUDA cores): at smollm gate/up 0.0372 -> 0.0078 ms
// at M = 4 (x @ W: 0.0040), 0.1403 -> 0.0490 at M = 1024, below
// salr_spmm's 0.0108 / 0.0681 at every shape and M (NVIDIA H100 80GB
// HBM3, 700.00 W; spmm_ab.py; PERF.md).
//
// f32 keeps that scalar body (tiled_bitmap.cuh): f32 is held at 1e-5,
// which TF32 tensor cores cannot meet.  The weight is read once per
// 32-row M block in its compressed form and decoded in shared memory by
// a warp per row (lane = column, __popc prefix slots), each output row
// reduced over k in one fixed order by one thread.
#include "salr_walk.cuh"

namespace {

using namespace salr::walk;  // the bf16 walk's bodies, shared with salr_spmm.cu

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(salr::THREADS)
bitmap_spmm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ words,
                   const float* __restrict__ values, float* __restrict__ y, int M, int K,
                   int n_tiles, int wpt, int cap_t) {
  __shared__ __align__(16) salr::Smem s;
  float acc[salr::ROWS_PER_THREAD] = {0.f};
  int m0 = blockIdx.y * salr::BM;
  const salr::PlainValues<float> vals{values, cap_t};
  salr::bitmap_gemm(s, acc, x, words, vals, M, K, n_tiles, wpt, cap_t, m0);
  salr::store_tile(y, acc, M, n_tiles * wpt * 32, m0, blockIdx.x * salr::BN);
}

int launch_f32(const void* x, const void* words, const void* values, void* y, int M, int K,
               int n_tiles, int wpt, int cap_t, cudaStream_t stream) {
  dim3 grid(n_tiles * wpt, (M + salr::BM - 1) / salr::BM);
  bitmap_spmm_kernel<<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(words),
      static_cast<const float*>(values), static_cast<float*>(y), M, K, n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: salr_spmm's split-K tensor-core walk at R = 0
// ---------------------------------------------------------------------------

template <bool FAST>
__global__ void SALR_WALK_BOUNDS bitmap_spmm_kernel_splitk(const Args<PlainV> p) {
  splitk_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS bitmap_spmm_kernel_out(const Args<PlainV> p) {
  out_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS bitmap_spmm_kernel_rows(const Args<PlainV> p) {
  rows_body<FAST>(p);
}

template <bool FAST>
int launch_op(const Args<PlainV>& p, cudaStream_t st) {
  return launch_bf16<FAST, bitmap_spmm_kernel_splitk<FAST>, bitmap_spmm_kernel_out<FAST>,
                     nullptr, bitmap_spmm_kernel_rows<FAST>>(p, st);
}

}  // namespace

// x (M, K); words (K, n_tiles, wpt) uint32; values (K, n_tiles, cap_t);
// y (M, n_tiles*wpt*32).  dtype 0 = float32: ws and the plan are ignored.
// dtype 1 = bfloat16: ws an f32 (slices, M, N) workspace for the slices'
// partials in the slices dispatch, or null for the rows dispatch (K cut
// into slices of slice_k rows: ops.salr_plan).  device: the CUDA ordinal
// of the tensors.  Returns cudaGetLastError() after the launches.
extern "C" int bitmap_spmm(const void* x, const void* words, const void* values, void* y,
                           void* ws, int M, int K, int n_tiles, int wpt, int cap_t, int slices,
                           int slice_k, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, words, values, y, M, K, n_tiles, wpt, cap_t, st);
  const Args<PlainV> p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                       PlainV{static_cast<const bf16*>(values), cap_t}, nullptr, nullptr,
                       nullptr, static_cast<float*>(ws), static_cast<bf16*>(y), M, K, 0,
                       n_tiles, wpt, slices, slice_k, 0, 0};
  return launch_checked(p, [&](auto fast) { return launch_op<decltype(fast)::value>(p, st); });
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
