// paged_mla_attention: MLA absorbed decode over paged latent pools.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_mla_attention
// (body _mla_kernel; engine decode of an MLA layer,
// models/attention.py:703).
//
// Computes, per slot b and head h, in f32:
//   s[p] = (q_lat[h] . ckv[p] + q_rope[h] . krope[p]) / sqrt(qk_dim)
//   over the live positions p = 0..pos[b], softmax over them, and
//   o_lat[h] = sum_p prob[p] * ckv[p]                     (B, H, R) f32
//
// Bound on the H100: operations.  All H heads of a slot share one latent
// row (R) and one rope key (RD) per position, an MQA shape: per (slot,
// head, live position) 2 (R + RD) flops for the score and 2 R for the
// output against (R + RD) x 2 bytes per position for all heads, so at
// H = 128 some 240 flops per byte, far above the f32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s, 20 flops per byte).
//
// Design: one block per (slot b, tile of HT <= 8 heads).  The block walks
// the slot's live positions in chunks of 32 through its page-table row.
// Each chunk's latent rows and rope keys are read with 16-byte loads (all
// of a thread's loads issued before any is used), widened to f32 once in
// shared memory, and reused by every head of the tile; rows are padded by
// four floats, so the lanes of a warp, one position each, read distinct
// bank groups with 16-byte loads.  A thread per (head, position) takes
// the score's two dot products four columns at a time; a warp per head
// keeps the online softmax (running max and sum, the chunk's
// probabilities); each thread owns up to two latent columns of o_lat for
// every head of the tile, so a latent value is read once per chunk
// position and multiplied by the tile's probabilities (one broadcast
// 32-byte read), rescaled by each chunk's max correction, and divided by
// the running sum at the end.  Positions past pos[b] are never read: the
// chunk's dead rows are not loaded and their probabilities are exactly
// zero, so NaN or stale data in the null page, a freed page or past pos
// cannot reach the output (the TPU kernel gathers every page and masks
// the scores).  No tensor cores: the products stay f32 as the reference
// computes them.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;                      // positions per chunk: one per lane
constexpr int MAX_HT = 8;                      // heads per block
constexpr int MAX_COLS = 512 / THREADS;        // latent columns per thread (R <= 512)
constexpr int UNROLL = 4;                      // 16-byte loads in flight per thread

// 16 bytes of T widened to f32 at dst (16-byte aligned shared memory).
__device__ __forceinline__ void widen(const uint4& raw, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst, __nv_bfloat16) {
  // a bf16 is the high half of the f32 with the same value
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  float4 lo, hi;
  lo.x = __uint_as_float(w[0] << 16); lo.y = __uint_as_float(w[0] & 0xFFFF0000u);
  lo.z = __uint_as_float(w[1] << 16); lo.w = __uint_as_float(w[1] & 0xFFFF0000u);
  hi.x = __uint_as_float(w[2] << 16); hi.y = __uint_as_float(w[2] & 0xFFFF0000u);
  hi.z = __uint_as_float(w[3] << 16); hi.w = __uint_as_float(w[3] & 0xFFFF0000u);
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// q_lat (B, H, R) f32; q_rope (B, H, RD) f32; pools (P, page_size, R|RD);
// page_table (B, max_pages); pos (B,) last live position; out (B, H, R)
// f32.  Shared memory: q_s[HT*K] (K = R + RD), kv_s[CHUNK*KS] (KS = K + 4),
// p_s[CHUNK*MAX_HT] (probabilities, position-major), m_s/l_s/c_s[MAX_HT].
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_mla_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                 const T* __restrict__ ckv_pool, const T* __restrict__ krope_pool,
                 const int* __restrict__ page_table, const int* __restrict__ pos,
                 float* __restrict__ out, int H, int HT, int R, int RD, int page_size,
                 int max_pages, int qk_dim) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  const int K = R + RD, KS = K + 4;
  const int h0 = blockIdx.x * HT, b = blockIdx.y;
  float* q_s = smem;
  float* kv_s = q_s + HT * K;
  float* p_s = kv_s + CHUNK * KS;
  float* m_s = p_s + CHUNK * MAX_HT;
  float* l_s = m_s + MAX_HT;
  float* c_s = l_s + MAX_HT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = min(pos[b] + 1, max_pages * page_size);
  const int* pt = page_table + (size_t)b * max_pages;
  const float scale = sqrtf(static_cast<float>(qk_dim));
  const int rv = R / VEC, nv = (R + RD) / VEC;  // 16-byte vectors per position

  for (int i = threadIdx.x; i < HT * K; i += THREADS) {
    const int h = i / K, k = i % K;
    const size_t row = (size_t)b * H + h0 + h;
    q_s[i] = k < R ? q_lat[row * R + k] : q_rope[row * RD + (k - R)];
  }
  for (int i = threadIdx.x; i < CHUNK * MAX_HT; i += THREADS) p_s[i] = 0.f;
  if (threadIdx.x < MAX_HT) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
    c_s[threadIdx.x] = 0.f;
  }
  float acc[MAX_HT][MAX_COLS];
#pragma unroll
  for (int h = 0; h < MAX_HT; ++h)
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) acc[h][j] = 0.f;

  for (int c0 = 0; c0 < L; c0 += CHUNK) {
    const int live = min(CHUNK, L - c0);
    __syncthreads();  // the previous chunk's readers are done with kv_s and p_s
    // the chunk's live rows: 16-byte vectors, UNROLL loads in flight
    for (int i0 = threadIdx.x; i0 < live * nv; i0 += UNROLL * THREADS) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < live * nv) {
          const int c = i / nv, v = i % nv, p = c0 + c;
          const size_t at = (size_t)pt[p / page_size] * page_size + p % page_size;
          raw[u] = v < rv ? reinterpret_cast<const uint4*>(ckv_pool + at * R)[v]
                          : reinterpret_cast<const uint4*>(krope_pool + at * RD)[v - rv];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < live * nv) widen(raw[u], kv_s + (i / nv) * KS + (i % nv) * VEC, T{});
      }
    }
    __syncthreads();
    // scores of (head h = warp, position c = lane), four columns a step
    for (int i = threadIdx.x; i < HT * CHUNK; i += THREADS) {
      const int h = i / CHUNK, c = i % CHUNK;
      float s = -INFINITY;
      if (c < live) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + h * K);
        const float4* r4 = reinterpret_cast<const float4*>(kv_s + c * KS);
        float sl = 0.f, sr = 0.f;
        for (int k = 0; k < R / 4; ++k) {
          const float4 a = q4[k], x = r4[k];
          sl = fmaf(a.x, x.x, sl); sl = fmaf(a.y, x.y, sl);
          sl = fmaf(a.z, x.z, sl); sl = fmaf(a.w, x.w, sl);
        }
        for (int k = R / 4; k < K / 4; ++k) {
          const float4 a = q4[k], x = r4[k];
          sr = fmaf(a.x, x.x, sr); sr = fmaf(a.y, x.y, sr);
          sr = fmaf(a.z, x.z, sr); sr = fmaf(a.w, x.w, sr);
        }
        s = (sl + sr) / scale;
      }
      p_s[c * MAX_HT + h] = s;
    }
    __syncthreads();
    // online softmax, a warp per head, lane = position in the chunk
    for (int h = warp; h < HT; h += WARPS) {
      const float s = p_s[lane * MAX_HT + h];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);  // finite: the chunk holds a live position
      const float e = lane < live ? expf(s - m_new) : 0.f;
      float sum = e;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[lane * MAX_HT + h] = e;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first chunk
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // o_lat[h, r] = corr[h] * o_lat[h, r] + sum_c p[c, h] * ckv[c, r] for the
    // thread's columns r = threadIdx.x + j * THREADS and every head
#pragma unroll
    for (int h = 0; h < MAX_HT; ++h)
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) acc[h][j] *= c_s[h];
    for (int c = 0; c < live; ++c) {
      float v[MAX_COLS];
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) {
        const int r = threadIdx.x + j * THREADS;
        v[j] = r < R ? kv_s[c * KS + r] : 0.f;
      }
      const float4* p4 = reinterpret_cast<const float4*>(p_s + c * MAX_HT);
      const float4 pa = p4[0], pb = p4[1];
      const float p[MAX_HT] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int h = 0; h < MAX_HT; ++h)
#pragma unroll
        for (int j = 0; j < MAX_COLS; ++j) acc[h][j] = fmaf(p[h], v[j], acc[h][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < MAX_HT; ++h)
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      const int r = threadIdx.x + j * THREADS;
      if (h < HT && r < R) out[((size_t)b * H + h0 + h) * R + r] = acc[h][j] / l_s[h];
    }
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
           const void* krope_pool, const void* page_table, const void* pos, void* out, int B,
           int H, int R, int RD, int page_size, int max_pages, int qk_dim,
           cudaStream_t stream) {
  const int HT = H < MAX_HT ? H : MAX_HT;
  const int K = R + RD;
  const size_t smem = sizeof(float) * ((size_t)HT * K + (size_t)CHUNK * (K + 4) +
                                       (size_t)CHUNK * MAX_HT + 3 * (size_t)MAX_HT);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    cudaError_t err = cudaFuncSetAttribute(paged_mla_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(H / HT, B);
  paged_mla_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const T*>(ckv_pool), static_cast<const T*>(krope_pool),
      static_cast<const int*>(page_table), static_cast<const int*>(pos),
      static_cast<float*>(out), H, HT, R, RD, page_size, max_pages, qk_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper guarantees H <= 8 or H % 8 == 0, R % 32 == 0 with
// 0 < R <= 512, RD % 8 == 0 with 0 < RD <= 128, and 16-byte aligned
// pools.  dtype (of the pools): 0 = float32, 1 = bfloat16; device: the
// CUDA ordinal of the tensors.  Returns the CUDA error after the launch.
extern "C" int paged_mla_attention(const void* q_lat, const void* q_rope, const void* ckv_pool,
                                   const void* krope_pool, const void* page_table,
                                   const void* pos, void* out, int B, int H, int R, int RD,
                                   int page_size, int max_pages, int qk_dim, int dtype,
                                   int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_lat, q_rope, ckv_pool, krope_pool, page_table, pos, out, B, H, R,
                         RD, page_size, max_pages, qk_dim, st);
  return launch<__nv_bfloat16>(q_lat, q_rope, ckv_pool, krope_pool, page_table, pos, out, B,
                               H, R, RD, page_size, max_pages, qk_dim, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
