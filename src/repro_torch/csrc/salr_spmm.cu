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
// Design, bf16 (the bodies in salr_walk.cuh, which bitmap_spmm.cu runs at R
// = 0): the split-K tensor-core walk of splitk_gemm.cuh (a 4-stage
// cp.async ring, mma.sync m16n8k16, bf16 operands, f32 accumulators) with
// the tiled-bitmap cell tiles of expert_mma.cuh built for one weight:
// PlainCellTile copies a 64-column block's cells (words and stored values)
// and decodes them into a bf16 (32, 64) tile, NF4CellTile the same from NF4
// codes x the cell's f32 scale rounded once to bf16 (the reference rounds
// the decoded weight to x's dtype before its product), the 16 levels in
// shared memory.  Three products:
//   - the base, x @ W_hat: K cut into slices by the wrapper's plan
//     (ops.salr_plan: ops.splitk_plan from (K, N) and the SM count, never
//     from M), so the (column block x slice) blocks fill the card at decode
//     (smollm gate/up: 24 x 6 = 144 blocks, where the scalar body ran 48);
//   - u = x @ A_cat: K cut into at most 8 slices (ops.lora_plan, from K),
//     A_cat's slabs copied by a DenseTile straight into the bf16 stage;
//     each slice's f32 partial goes to a workspace (S_u, M, R);
//   - the adapter term, delta = bf16(u) @ B_cat[:, 64 columns]: u summed
//     from its partials in slice order and rounded once to bf16, then
//     multiplied on the tensor cores (adapter_mma.cuh, fused_lora.cu's
//     output pass).
// No f32 accumulator runs over more than CHUNK_K = 256 rows of K: within a
// slice the walk flushes into a fresh accumulator every 256 rows and adds
// the flushes in order, as the expert body's chunk_product does (one
// accumulator over deepseek's K = 7168 read 4.5e-4 against the 5e-4 limit).
// y = bf16(((p0 + p1) + ... + p(S-1)) + delta), f32 in that order, by
// either of two dispatches, which give the same bits:
//   - slices (small M): *_kernel_splitk, a block per (column block, row
//     tile, slice) writing the base's f32 partial to ws (S, M, N), and
//     beside them the u pass's blocks (the base does not wait on u); then
//     *_kernel_out, a block per (column block, row tile), computes delta and
//     adds it after the partials, summed in slice order.  Two launches.
//   - rows (larger M, where the partials would cost more than the longer
//     walk; ops._walks_rows): *_kernel_u runs the u pass, then
//     *_kernel_rows, a block per (column block, row tile), walks every
//     slice in order and adds delta last.  Two launches.
// No atomics.  mma.sync keeps rows apart and a row meets the same k16
// steps, chunks, slices and sum order at every M and in both dispatches,
// so its bits do not depend on the batch it came in (the engine decodes at
// M = n_slots, greedy_generate at M = batch).  FAST kernels (x, A_cat,
// B_cat, the workspaces, words and values 16-byte aligned; words a tile
// even; cap_t a multiple of 8, NF4 of 32; K and R of 8: every main-path
// shape, tiles 256 and 192 (smollm's wk/wv), cap_t 160 and 128, R 128) give
// each thread fixed chunks per stream and step; the others copy with the
// widest width the addresses allow.  No library GEMM computes any part.
// It replaces a scalar body (a u launch, then a decode-GEMM in which one
// thread reduces each output row over all of K on CUDA cores, 48 blocks at
// smollm gate/up): salr_spmm / qsalr_spmm at smollm gate/up M = 4 0.0789 /
// 0.1121 -> 0.0109 / 0.0111 ms (x @ W: 0.0110), at M = 1024 0.1999 /
// 0.3617 -> 0.0690 / 0.0699, at deepseek's wo (16384 -> 7168) M = 8 2.059
// / 3.008 -> 0.224 / 0.258 (NVIDIA H100 80GB HBM3, 700.00 W; spmm_ab.py;
// PERF.md).
//
// f32 keeps that scalar body (tiled_bitmap.cuh, shared with
// bitmap_spmm.cu's f32 path): f32 is held at 1e-5, which TF32 tensor cores cannot
// meet.  Its two launches: u = x @ A_cat once per 32-row M block into an
// (M, R) scratch; then the bitmap decode + GEMM with the adapter term
// u @ B_cat reduced in f32 in its epilogue and added before the one
// rounding of y, each output row reduced over k in one fixed order by one
// thread.  The two ops differ only in the value loader the decode is
// instantiated with (PlainValues, NF4Values), which names them in profiles.
#include "salr_walk.cuh"

namespace {

using namespace salr::walk;  // the bf16 walk's bodies, shared with bitmap_spmm.cu

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

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

template <typename V>
int launch_f32(const void* x, const void* words, V vals, const void* a, const void* b, void* u,
               void* y, int M, int K, int R, int n_tiles, int wpt, int cap_t,
               cudaStream_t stream) {
  const int m_blocks = (M + salr::BM - 1) / salr::BM;
  if (R > 0) {  // a rank-0 layer has no adapter term
    dim3 grid_u((R + salr::BN - 1) / salr::BN, m_blocks);
    adapter_u_kernel<float, V><<<grid_u, salr::THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(u), M,
        K, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_tiles * wpt, m_blocks);
  salr_spmm_kernel<float, V><<<grid, salr::THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(words), vals,
      static_cast<const float*>(u), static_cast<const float*>(b), static_cast<float*>(y), M, K,
      R, n_tiles, wpt, cap_t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the split-K tensor-core walk
// ---------------------------------------------------------------------------

// The kernels, named by op so a profile tells them apart (salr_spmm_kernel
// is a substring of qsalr_spmm_kernel: match the latter first).
template <bool FAST>
__global__ void SALR_WALK_BOUNDS salr_spmm_kernel_splitk(const Args<PlainV> p) {
  splitk_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS salr_spmm_kernel_out(const Args<PlainV> p) {
  out_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS salr_spmm_kernel_u(const Args<PlainV> p) {
  u_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS salr_spmm_kernel_rows(const Args<PlainV> p) {
  rows_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS qsalr_spmm_kernel_splitk(const Args<NF4V> p) {
  splitk_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS qsalr_spmm_kernel_out(const Args<NF4V> p) {
  out_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS qsalr_spmm_kernel_u(const Args<NF4V> p) {
  u_body<FAST>(p);
}
template <bool FAST>
__global__ void SALR_WALK_BOUNDS qsalr_spmm_kernel_rows(const Args<NF4V> p) {
  rows_body<FAST>(p);
}

template <bool FAST>
int launch_op(const Args<PlainV>& p, cudaStream_t st) {
  return launch_bf16<FAST, salr_spmm_kernel_splitk<FAST>, salr_spmm_kernel_out<FAST>,
                     salr_spmm_kernel_u<FAST>, salr_spmm_kernel_rows<FAST>>(p, st);
}
template <bool FAST>
int launch_op(const Args<NF4V>& p, cudaStream_t st) {
  return launch_bf16<FAST, qsalr_spmm_kernel_splitk<FAST>, qsalr_spmm_kernel_out<FAST>,
                     qsalr_spmm_kernel_u<FAST>, qsalr_spmm_kernel_rows<FAST>>(p, st);
}

template <class V>
int launch_bf16_checked(const Args<V>& p, cudaStream_t st) {
  return launch_checked(p, [&](auto fast) { return launch_op<decltype(fast)::value>(p, st); });
}

}  // namespace

// x (M, K); words (K, n_tiles, wpt) uint32; values (K, n_tiles, cap_t);
// a (K, R); b (R, n_tiles*wpt*32); y (M, n_tiles*wpt*32).  dtype 0 =
// float32: u an (M, R) f32 scratch; ws and the plans are ignored.  dtype 1
// = bfloat16: u an f32 (u_slices, M, R) workspace for u's partials (K cut
// into u_slices slices of u_slice_k rows: ops.lora_plan), ws an f32
// (slices, M, N) workspace for the base's partials in the slices dispatch
// or null for the rows dispatch (K cut into slices of slice_k rows:
// ops.salr_plan).  device: the CUDA ordinal of the tensors.  Returns
// cudaGetLastError() after the launches.
extern "C" int salr_spmm(const void* x, const void* words, const void* values, const void* a,
                         const void* b, void* u, void* y, void* ws, int M, int K, int R,
                         int n_tiles, int wpt, int cap_t, int slices, int slice_k, int u_slices,
                         int u_slice_k, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, words,
                      salr::PlainValues<float>{static_cast<const float*>(values), cap_t}, a, b,
                      u, y, M, K, R, n_tiles, wpt, cap_t, st);
  const Args<PlainV> p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                       PlainV{static_cast<const bf16*>(values), cap_t},
                       static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                       static_cast<float*>(u), static_cast<float*>(ws), static_cast<bf16*>(y),
                       M, K, R, n_tiles, wpt, slices, slice_k, u_slices, u_slice_k};
  return launch_bf16_checked(p, st);
}

// As salr_spmm with the values in NF4: codes (K, n_tiles, cap_t/2) uint8,
// interleaved (slot 2i low nibble, 2i+1 high); scales (K, n_tiles) f32.
extern "C" int qsalr_spmm(const void* x, const void* words, const void* codes,
                          const void* scales, const void* a, const void* b, void* u, void* y,
                          void* ws, int M, int K, int R, int n_tiles, int wpt, int cap_t,
                          int slices, int slice_k, int u_slices, int u_slice_k, int dtype,
                          int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* sc = static_cast<const float*>(scales);
  if (dtype == 0)
    return launch_f32(x, words, salr::NF4Values<float>{c, sc, nullptr, cap_t}, a, b, u, y, M,
                      K, R, n_tiles, wpt, cap_t, st);
  const Args<NF4V> p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                     NF4V{c, sc, nullptr, cap_t}, static_cast<const bf16*>(a),
                     static_cast<const bf16*>(b), static_cast<float*>(u),
                     static_cast<float*>(ws), static_cast<bf16*>(y),
                     M, K, R, n_tiles, wpt, slices, slice_k, u_slices, u_slice_k};
  return launch_bf16_checked(p, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
