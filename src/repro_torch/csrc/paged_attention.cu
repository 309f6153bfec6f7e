// paged_gqa_attention: one-token GQA decode over paged K/V pools.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_gqa_attention
// (engine decode, models/attention.py:457).
//
// Bound on the H100: bytes.  Per (slot, KV head) the step reads the live
// K and V rows once (2 x d x 2 bytes per position) and does 4 x G x d
// flops per position (G = 3 query heads per KV head): ~3 flops per byte.
//
// Design: one block per (slot b, KV head).  The block reads its own page
// table row and visits only positions 0..pos[b] (pages past pos[b] are
// never read, so NaN or stale data in the null page or a freed page
// cannot reach the output; the TPU kernel instead streams every page and
// masks the scores).  Pass 1: each warp takes positions in turn, the
// lanes split the head dim, and a warp reduction gives the f32 scores of
// all G query heads (scaled by 1/sqrt(d)), kept in shared memory.
// Pass 2: softmax over the live positions per query head.  Pass 3: the
// threads split (position stripe, head dim) and accumulate the f32 PV
// sum, reduced across stripes in a fixed order and cast to the q type.
#include "common.cuh"

namespace {

using salr::from_f32;
using salr::to_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;      // query heads per KV head

// q (B, H, D); pools (P, page_size, KH, D); page_table (B, max_pages);
// pos (B,) last live position; out (B, H, D).  Shared memory: q_s[G*D],
// s[G*max_ctx] scores, red[(THREADS/D)*G*D] PV partial sums.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ page_table,
                 const int* __restrict__ pos, T* __restrict__ out, int H, int KH, int D,
                 int page_size, int max_pages) {
  extern __shared__ __align__(16) float smem[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int max_ctx = max_pages * page_size;
  const int stripes = THREADS / D;
  float* q_s = smem;
  float* s = q_s + G * D;
  float* red = s + G * max_ctx;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = min(pos[b] + 1, max_ctx);
  const int* pt = page_table + (size_t)b * max_pages;
  const float inv = 1.0f / sqrtf(static_cast<float>(D));

  for (int i = threadIdx.x; i < G * D; i += THREADS)
    q_s[i] = to_f32(q[((size_t)b * H + kh * G) * D + i]);
  __syncthreads();

  // pass 1: scores of the live positions (unrolled so that several
  // positions' page-table and K loads are in flight at once)
#pragma unroll 4
  for (int p = warp; p < L; p += WARPS) {
    const int page = pt[p / page_size];
    const T* krow = k_pool + (((size_t)page * page_size + p % page_size) * KH + kh) * D;
    float part[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      float kv = to_f32(krow[d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[g] = fmaf(q_s[g * D + d], kv, part[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      float v = part[g];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && g < G) s[g * max_ctx + p] = v * inv;
    }
  }
  __syncthreads();

  // pass 2: softmax over positions 0..L-1, one warp per query head
  for (int g = warp; g < G; g += WARPS) {
    float* sg = s + g * max_ctx;
    float m = -INFINITY;
    for (int p = lane; p < L; p += 32) m = fmaxf(m, sg[p]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int p = lane; p < L; p += 32) {
      float e = expf(sg[p] - m);
      sg[p] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int p = lane; p < L; p += 32) sg[p] = sg[p] / sum;
  }
  __syncthreads();

  // pass 3: out[g, d] = sum_p prob[g, p] * v[p, d]
  const int d = threadIdx.x % D, stripe = threadIdx.x / D;
  if (stripe < stripes) {
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int p = stripe; p < L; p += stripes) {
      const int page = pt[p / page_size];
      float vv = to_f32(v_pool[(((size_t)page * page_size + p % page_size) * KH + kh) * D + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(s[g * max_ctx + p], vv, acc[g]);
    }
    for (int g = 0; g < G; ++g) red[(stripe * G + g) * D + d] = acc[g];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    float v = 0.f;
    if (L > 0)
      for (int st = 0; st < stripes; ++st) v += red[st * G * D + i];
    out[((size_t)b * H + kh * G) * D + i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* page_table,
           const void* pos, void* out, int B, int H, int KH, int D, int page_size,
           int max_pages, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = sizeof(float) *
      ((size_t)G * D + (size_t)G * max_pages * page_size + (size_t)(THREADS / D) * G * D);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    cudaError_t err = cudaFuncSetAttribute(paged_gqa_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KH, B);
  paged_gqa_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(page_table), static_cast<const int*>(pos), static_cast<T*>(out),
      H, KH, D, page_size, max_pages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper guarantees H % KH == 0, H / KH <= 8, D in {32, 64, 128}.
// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the tensors.  Returns the CUDA error after the launch.
extern "C" int paged_gqa_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* page_table, const void* pos, void* out, int B,
                                   int H, int KH, int D, int page_size, int max_pages,
                                   int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, pos, out, B, H, KH, D, page_size,
                         max_pages, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, pos, out, B, H, KH, D,
                               page_size, max_pages, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
