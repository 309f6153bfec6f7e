// quant_attention: one-token GQA decode over a quantized KV cache.  One
// kernel body, templated on the KV precision and on the addressing:
//
//   ring_quant_gqa_attention   int8,  dense rows (B, W, KH, d)
//   paged_quant_gqa_attention  int8,  paged pools (P, page_size, KH, d)
//   ring_nf4_gqa_attention     NF4,   dense rows (B, W, KH, d/2)
//   paged_nf4_gqa_attention    NF4,   paged pools (P, page_size, KH, d/2)
//
// Replaces: src/repro/kernels/ring_attention.py:ring_quant_gqa_attention
// and :ring_nf4_gqa_attention (greedy_generate's decode over a quantized
// dense cache), src/repro/kernels/paged_attention.py:
// paged_quant_gqa_attention and :paged_nf4_gqa_attention (the engine's
// decode over quantized pools); models/attention.py decode branches.
//
// Bound on the H100: bytes.  Per (slot, KV head) a step reads each live
// position's K and V row once (2 x d bytes in int8, 2 x d/2 in NF4) and
// its two f32 scales, and does 4 x G x d flops per position (G = 3 query
// heads per KV head): ~5 flops per byte in int8, ~8 in NF4.
//
// Design: paged_attention.cu's structure.  One block per (slot b, KV
// head); the block visits only positions 0..pos[b], so whatever a freed
// page, the null page or a ring's tail past pos holds (even NaN, in the
// codes or the scales) never reaches the output.  The address of a
// position is the only thing the two layouts change (Ring / Paged
// below); the per-position code is shared, so the engine (paged) and
// greedy_generate (ring) differ only by addressing.  Dequant follows the
// reference bit for bit: int8 -> f32 x scale -> q's type -> f32; NF4:
// level x scale -> q's type -> f32, the low nibble of byte i giving head
// dim i and the high nibble head dim i + d/2 (split packing).  Pass 1:
// a warp per position, lanes split the head dim, warp-reduced f32 scores
// of the G query heads (for NF4 the two half-width dots are reduced
// apart and added, as the reference splits them), over sqrt(d).  Pass 2:
// softmax per query head.  Pass 3: threads split (position stripe, head
// dim) for the f32 PV sum, reduced across stripes in a fixed order and
// cast to q's type.  Simple and right first; split-K over positions,
// vector loads of the codes and tensor-core dots are later work.
#include "common.cuh"

namespace {

using salr::round_to;
using salr::to_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;  // query heads per KV head

// int8 codes: D bytes per (position, head) row.
struct Int8KV {
  static constexpr int kBytesPerDim2 = 2;  // bytes per 2 head dims
  // The lane's partial dot products, lo[] over the whole row (hi[] unused).
  template <typename T>
  __device__ static void dot(const uint8_t* row, float scale, const float* q_s, int D, int G,
                             const float*, int lane, float lo[MAX_G], float[MAX_G]) {
    const int8_t* r = reinterpret_cast<const int8_t*>(row);
    for (int d = lane; d < D; d += 32) {
      const float kv = round_to<T>(static_cast<float>(r[d]) * scale);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) lo[g] = fmaf(q_s[g * D + d], kv, lo[g]);
    }
  }
  template <typename T>
  __device__ static float value(const uint8_t* row, float scale, int d, int, const float*) {
    return round_to<T>(static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]) * scale);
  }
};

// NF4 codes, split-packed: D/2 bytes per row, byte i = dim i (low nibble)
// and dim i + D/2 (high nibble).
struct NF4KV {
  static constexpr int kBytesPerDim2 = 1;
  // lo[] gathers the dot over dims [0, D/2), hi[] over [D/2, D).
  template <typename T>
  __device__ static void dot(const uint8_t* row, float scale, const float* q_s, int D, int G,
                             const float* lut, int lane, float lo[MAX_G], float hi[MAX_G]) {
    const int half = D / 2;
    for (int i = lane; i < half; i += 32) {
      const uint32_t byte = row[i];
      const float kl = round_to<T>(lut[byte & 0x0Fu] * scale);
      const float kh = round_to<T>(lut[byte >> 4] * scale);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) {
          lo[g] = fmaf(q_s[g * D + i], kl, lo[g]);
          hi[g] = fmaf(q_s[g * D + half + i], kh, hi[g]);
        }
    }
  }
  template <typename T>
  __device__ static float value(const uint8_t* row, float scale, int d, int D,
                                const float* lut) {
    const int half = D / 2;
    const uint32_t byte = row[d < half ? d : d - half];
    return round_to<T>(lut[d < half ? (byte & 0x0Fu) : (byte >> 4)] * scale);
  }
};

// Dense rows: position p of slot b is row b * W + p.
struct Ring {
  int W;
  __device__ int ctx() const { return W; }
  __device__ size_t row(int b, int p) const { return (size_t)b * W + p; }
};

// Paged pools: position p of slot b is offset p % page_size of pool page
// page_table[b, p / page_size].
struct Paged {
  const int* page_table;
  int page_size, max_pages;
  __device__ int ctx() const { return page_size * max_pages; }
  __device__ size_t row(int b, int p) const {
    return (size_t)page_table[(size_t)b * max_pages + p / page_size] * page_size +
           p % page_size;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q (B, H, D); k/v codes (rows, KH, D * kBytesPerDim2 / 2) bytes; scales
// (rows, KH) f32; pos (B,) last live position; out (B, H, D).  Shared
// memory: q_s[G*D], s[G*ctx] scores, red[(THREADS/D)*G*D] PV partial sums.
template <typename KV, typename Addr, typename T>
__global__ void __launch_bounds__(THREADS)
quant_gqa_kernel(const T* __restrict__ q, const uint8_t* __restrict__ k,
                 const uint8_t* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ pos, Addr addr,
                 T* __restrict__ out, int H, int KH, int D) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float lut[16];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int max_ctx = addr.ctx();
  const int stripes = THREADS / D;
  const int row_bytes = D * KV::kBytesPerDim2 / 2;
  float* q_s = smem;
  float* s = q_s + G * D;
  float* red = s + G * max_ctx;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = min(pos[b] + 1, max_ctx);
  const float sqrt_d = sqrtf(static_cast<float>(D));

  salr::load_nf4_table(lut);
  for (int i = threadIdx.x; i < G * D; i += THREADS)
    q_s[i] = to_f32(q[((size_t)b * H + kh * G) * D + i]);
  __syncthreads();

  // pass 1: scores of the live positions
#pragma unroll 4
  for (int p = warp; p < L; p += WARPS) {
    const size_t e = addr.row(b, p) * KH + kh;  // the (position, head) entry
    float lo[MAX_G], hi[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) lo[g] = hi[g] = 0.f;
    KV::template dot<T>(k + e * row_bytes, k_scale[e], q_s, D, G, lut, lane, lo, hi);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      const float sc = warp_sum(lo[g]) + warp_sum(hi[g]);
      if (lane == 0 && g < G) s[g * max_ctx + p] = sc / sqrt_d;
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
      const float ex = expf(sg[p] - m);
      sg[p] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
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
      const size_t e = addr.row(b, p) * KH + kh;
      const float vv = KV::template value<T>(v + e * row_bytes, v_scale[e], d, D, lut);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(s[g * max_ctx + p], vv, acc[g]);
    }
    for (int g = 0; g < G; ++g) red[(stripe * G + g) * D + d] = acc[g];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    float acc = 0.f;
    if (L > 0)
      for (int st = 0; st < stripes; ++st) acc += red[st * G * D + i];
    out[((size_t)b * H + kh * G) * D + i] = salr::from_f32<T>(acc);
  }
}

template <typename KV, typename Addr, typename T>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, Addr addr, int max_ctx, void* out, int B,
           int H, int KH, int D, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)G * max_ctx + (size_t)(THREADS / D) * G * D);
  auto kernel = quant_gqa_kernel<KV, Addr, T>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), addr, static_cast<T*>(out), H, KH, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* pos, Addr addr, int max_ctx, void* out, int B,
             int H, int KH, int D, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<KV, Addr, float>(q, k, v, k_scale, v_scale, pos, addr, max_ctx, out, B, H,
                                   KH, D, st);
  return launch<KV, Addr, __nv_bfloat16>(q, k, v, k_scale, v_scale, pos, addr, max_ctx, out,
                                         B, H, KH, D, st);
}

}  // namespace

// The wrappers guarantee H % KH == 0, H / KH <= 8, D in {32, 64, 128} and
// a score buffer that fits shared memory.  q/out (B, 1, H, D) of dtype
// (0 = float32, 1 = bfloat16); pos (B,) int32; scales f32.  Ring: k/v
// (B, W, KH, D) int8 or (B, W, KH, D/2) uint8, scales (B, W, KH).  Paged:
// pools (P, page_size, KH, ...), scales (P, page_size, KH), page_table
// (B, max_pages) int32.  Each returns the CUDA error after the launch.
extern "C" int ring_quant_gqa_attention(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, const void* pos,
                                        void* out, int B, int H, int KH, int D, int W,
                                        int dtype, int device, void* stream) {
  return dispatch<Int8KV>(q, k, v, ks, vs, pos, Ring{W}, W, out, B, H, KH, D, dtype, device,
                          stream);
}

extern "C" int ring_nf4_gqa_attention(const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs, const void* pos,
                                      void* out, int B, int H, int KH, int D, int W, int dtype,
                                      int device, void* stream) {
  return dispatch<NF4KV>(q, k, v, ks, vs, pos, Ring{W}, W, out, B, H, KH, D, dtype, device,
                         stream);
}

extern "C" int paged_quant_gqa_attention(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs,
                                         const void* page_table, const void* pos, void* out,
                                         int B, int H, int KH, int D, int page_size,
                                         int max_pages, int dtype, int device, void* stream) {
  return dispatch<Int8KV>(q, k, v, ks, vs, pos,
                          Paged{static_cast<const int*>(page_table), page_size, max_pages},
                          page_size * max_pages, out, B, H, KH, D, dtype, device, stream);
}

extern "C" int paged_nf4_gqa_attention(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* page_table,
                                       const void* pos, void* out, int B, int H, int KH, int D,
                                       int page_size, int max_pages, int dtype, int device,
                                       void* stream) {
  return dispatch<NF4KV>(q, k, v, ks, vs, pos,
                         Paged{static_cast<const int*>(page_table), page_size, max_pages},
                         page_size * max_pages, out, B, H, KH, D, dtype, device, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
