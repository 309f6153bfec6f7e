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
// heads per KV head): ~5 flops per byte in int8, ~8 in NF4, far below
// the f32 ridge (~20), so CUDA cores suffice.
//
// Design: split positions, online softmax, 16-byte code loads.  The
// context is cut into chunks of whole pages (ops.attention_plan: a
// function of the context, the page size, KH and the SM count, never of
// B or pos); one block per (chunk, KV head x group of <= 4 query heads,
// slot), so a slot's bits do not depend on the batch.  A block whose
// chunk starts past pos[b] returns at once.  A thread owns one 16-byte
// piece of a (position, head) code row (int8: 16 head dims; NF4, split
// packing: 16 dims of each half), a row group of d/16 (int8) or d/32
// (NF4) threads one position a step; the chunk's page-table entries are
// read into shared memory once, and every step's code and scale loads
// are issued one step ahead, before the FMAs that use the previous ones.
// Dequant follows the reference bit for bit: int8 -> f32 x scale -> q's
// type -> f32; NF4: level x scale -> q's type -> f32 through the
// 16-entry table.  A dot is reduced over the row group's threads only
// (log2 of their count shuffles, for the live query heads only); the NF4
// dots over [0, d/2) and [d/2, d) are reduced apart, then added, as the
// reference splits them.  Each row group keeps an online softmax per
// query head (running max, sum and the probability-weighted V piece in
// f32 registers); at the chunk's end the row groups merge in a fixed
// order (xor shuffles in a warp, then the four warps through shared
// memory).  With one chunk the block divides and writes q's type;
// otherwise it writes an f32 (max, sum, acc) partial to the workspace
// and a second launch folds chunks 0 .. pos[b] / chunk in order.
// Positions past pos[b] (the tail of the last live page, freed pages,
// the null page, a ring's tail) are never loaded: their registers hold
// zeros and skip the update, so NaN there cannot reach the output.
#include "common.cuh"

namespace {

using salr::from_f32;
using salr::round_to;
using salr::to_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GB = 4;      // query heads per block; a KV head's G > 4 take ceil(G / 4) blocks
constexpr int PIECE = 16;  // bytes of a code row a thread loads at once
constexpr int QPAD = 4;    // floats after every 16 of a q row in shared memory (bank spread)
constexpr unsigned FULL = 0xffffffffu;

// the codes and scales a thread loads for one position
struct Piece {
  uint4 k, v;
  float ks, vs;
};

// int8 codes: D bytes a row; the piece j holds dims [16j, 16j + 16).
struct Int8KV {
  static constexpr int kHalves = 1;
  template <typename T>
  __device__ static void dequant(const uint4& c, float scale, const float*, float* out) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = round_to<T>(
          static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)))) * scale);
  }
};

// NF4 codes, split-packed: D/2 bytes a row, byte i = dim i (low nibble)
// and dim i + D/2 (high nibble); the piece j holds dims [16j, 16j + 16)
// (out[0..16)) and [D/2 + 16j, D/2 + 16j + 16) (out[16..32)).
struct NF4KV {
  static constexpr int kHalves = 2;
  template <typename T>
  __device__ static void dequant(const uint4& c, float scale, const float* lut, float* out) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
      out[i] = round_to<T>(lut[byte & 0x0Fu] * scale);
      out[16 + i] = round_to<T>(lut[byte >> 4] * scale);
    }
  }
};

// Dense rows: position p of slot b is row b * W + p.
struct Ring {
  int W;
  __device__ int ctx() const { return W; }
  static int table_entries(int) { return 0; }
  __device__ void stage(int*, int, int, int) const {}
  // the row of position c0 + r
  __device__ size_t row(const int*, int b, int c0, int r) const {
    return (size_t)b * W + c0 + r;
  }
};

// Paged pools: position p of slot b is offset p % page_size of pool page
// page_table[b, p / page_size]; a chunk starts on a page.
struct Paged {
  const int* page_table;
  int page_size, max_pages;
  __device__ int ctx() const { return page_size * max_pages; }
  int table_entries(int chunk) const { return (chunk + page_size - 1) / page_size; }
  // the entries of the pages holding positions [c0, c0 + n) into pt_s
  __device__ void stage(int* pt_s, int b, int c0, int n) const {
    const int first = c0 / page_size, pages = (n + page_size - 1) / page_size;
    for (int i = threadIdx.x; i < pages; i += THREADS)
      pt_s[i] = page_table[(size_t)b * max_pages + first + i];
  }
  __device__ size_t row(const int* pt_s, int, int, int r) const {
    return (size_t)pt_s[r / page_size] * page_size + r % page_size;
  }
};

// exp(x - M), 0 for a state that saw no position
__device__ __forceinline__ float weight(float x, float M) {
  return x == -INFINITY ? 0.f : expf(x - M);
}

// The codes and scales of chunk position r (zeros where r is not live).
template <int ROW, typename Addr>
__device__ __forceinline__ void fetch(const Addr& addr, const int* pt_s, const uint8_t* k,
                                      const uint8_t* v, const float* k_scale,
                                      const float* v_scale, int b, int c0, int r, int n, int KH,
                                      int kh, int piece, Piece& pc) {
  pc.k = pc.v = make_uint4(0u, 0u, 0u, 0u);
  pc.ks = pc.vs = 0.f;
  if (r < n) {
    const size_t e = addr.row(pt_s, b, c0, r) * KH + kh;
    pc.k = __ldg(reinterpret_cast<const uint4*>(k + e * ROW) + piece);
    pc.v = __ldg(reinterpret_cast<const uint4*>(v + e * ROW) + piece);
    pc.ks = __ldg(k_scale + e);
    pc.vs = __ldg(v_scale + e);
  }
}

// The scores of a position over sqrt(D) for the Gb live query heads:
// each thread's piece dotted with q, reduced over the row group (the NF4
// halves apart, then added).
template <typename KV, typename T, int D>
__device__ __forceinline__ void dots(const Piece& pc, const float* q_s, const float* lut,
                                     int piece, int Gb, float (&sc)[GB]) {
  constexpr int H2 = KV::kHalves, RT = D / H2 / PIECE, QS = D + D / 16 * QPAD;
  float kv[16 * H2];
  KV::template dequant<T>(pc.k, pc.ks, lut, kv);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < Gb) {
      float dot[H2];
#pragma unroll
      for (int hh = 0; hh < H2; ++hh) {
        const float4* q4 = reinterpret_cast<const float4*>(
            q_s + g * QS + (hh * (D / 2) / 16 + piece) * (16 + QPAD));
        dot[hh] = 0.f;
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const float4 qq = q4[i4];
          const float* kk = kv + hh * 16 + 4 * i4;
          dot[hh] = fmaf(qq.x, kk[0], dot[hh]);
          dot[hh] = fmaf(qq.y, kk[1], dot[hh]);
          dot[hh] = fmaf(qq.z, kk[2], dot[hh]);
          dot[hh] = fmaf(qq.w, kk[3], dot[hh]);
        }
#pragma unroll
        for (int off = 1; off < RT; off <<= 1) dot[hh] += __shfl_xor_sync(FULL, dot[hh], off);
      }
      sc[g] = (H2 == 2 ? dot[0] + dot[H2 - 1] : dot[0]) / sqrtf(static_cast<float>(D));
    } else {
      sc[g] = 0.f;
    }
  }
}

// One live position, of scores sc, into the row group's online softmax:
// the running max m, sum l and probability-weighted V piece acc of each
// query head.
template <typename KV, typename T>
__device__ __forceinline__ void update(const Piece& pc, const float (&sc)[GB], const float* lut,
                                       int Gb, float (&m)[GB], float (&l)[GB],
                                       float (&acc)[GB][16 * KV::kHalves]) {
  constexpr int VD = 16 * KV::kHalves;
  float vv[VD];
  KV::template dequant<T>(pc.v, pc.vs, lut, vv);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < Gb) {
      const float dl = sc[g] - m[g];
      const float e = expf(-fabsf(dl));  // 0 against the first position's -inf
      const bool up = dl > 0.f;
      const float alpha = up ? e : 1.f, p = up ? 1.f : e;
      m[g] = up ? sc[g] : m[g];
      l[g] = fmaf(l[g], alpha, p);
#pragma unroll
      for (int i = 0; i < VD; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i] * alpha);
    }
  }
}

// q (B, H, D); k/v codes (rows, KH, D / kHalves) bytes; scales (rows, KH)
// f32; pos (B,) last live position; out (B, H, D).  ws (multi-chunk
// plans): acc (B, H, chunks, D) then (max, sum) (B, H, chunks, 2), f32.
template <typename KV, typename Addr, typename T, int D>
__global__ void __launch_bounds__(THREADS)
quant_gqa_kernel(const T* __restrict__ q, const uint8_t* __restrict__ k,
                 const uint8_t* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ pos, Addr addr,
                 T* __restrict__ out, float* __restrict__ ws, int H, int KH, int chunk) {
  constexpr int H2 = KV::kHalves;
  constexpr int ROW = D / H2;            // code bytes of a (position, head)
  constexpr int RT = ROW / PIECE;        // threads of a row group
  constexpr int NR = THREADS / RT;       // positions a step
  constexpr int VD = 16 * H2;            // values a piece holds
  constexpr int QS = D + D / 16 * QPAD;  // a padded q row
  static_assert(ROW % PIECE == 0 && RT >= 1 && RT <= 32, "head dim");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                     // [GB][QS]
  float* red = q_s + GB * QS;            // [WARPS][GB][D]
  float* red_m = red + WARPS * GB * D;   // [WARPS][GB]
  float* red_l = red_m + WARPS * GB;     // [WARPS][GB]
  float* lut = red_l + WARPS * GB;       // [16]
  int* pt_s = reinterpret_cast<int*>(lut + 16);

  const int G = H / KH, groups = (G + GB - 1) / GB;
  const int kh = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int b = blockIdx.z, c = blockIdx.x, chunks = gridDim.x;
  const int h0 = kh * G + hg * GB, Gb = min(GB, G - hg * GB);
  const int c0 = c * chunk;
  // pos, q and the chunk's page-table entries are fetched together
  const int last = pos[b];
  if (H2 == 2) salr::load_nf4_table(lut);
  for (int i = threadIdx.x; i < Gb * D; i += THREADS) {
    const int g = i / D, d = i % D;
    q_s[g * QS + d + d / 16 * QPAD] = to_f32(q[((size_t)b * H + h0) * D + i]);
  }
  addr.stage(pt_s, b, c0, min(chunk, addr.ctx() - c0));
  const int n = min(chunk, min(last + 1, addr.ctx()) - c0);  // live positions here
  T* o = out + ((size_t)b * H + h0) * D;
  if (n <= 0) {  // the chunk starts past pos[b]
    if (chunks == 1)
      for (int i = threadIdx.x; i < Gb * D; i += THREADS) o[i] = from_f32<T>(0.f);
    return;
  }
  __syncthreads();

  const int piece = threadIdx.x % RT, rg = threadIdx.x / RT;
  float m[GB], l[GB], acc[GB][VD];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VD; ++i) acc[g][i] = 0.f;
  }

  // a row group takes positions rg, rg + NR, rg + 2 NR, ... in order; the
  // next one's loads are issued before this one's FMAs
  Piece cur, nxt;
  fetch<ROW>(addr, pt_s, k, v, k_scale, v_scale, b, c0, rg, n, KH, kh, piece, cur);
  for (int r = rg; r - rg < n; r += NR) {
    fetch<ROW>(addr, pt_s, k, v, k_scale, v_scale, b, c0, r + NR, n, KH, kh, piece, nxt);
    float sc[GB];  // every lane takes part in its row group's shuffles
    dots<KV, T, D>(cur, q_s, lut, piece, Gb, sc);
    if (r < n) update<KV, T>(cur, sc, lut, Gb, m, l, acc);
    cur = nxt;
  }

  // merge the warp's row groups (xor over the lanes above the row group's)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = RT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < Gb) {
        const float mo = __shfl_xor_sync(FULL, m[g], off);
        const float lo = __shfl_xor_sync(FULL, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float a = weight(m[g], mn), wo = weight(mo, mn);
        l[g] = fmaf(l[g], a, lo * wo);
#pragma unroll
        for (int i = 0; i < VD; ++i)
          acc[g][i] = fmaf(acc[g][i], a, __shfl_xor_sync(FULL, acc[g][i], off) * wo);
        m[g] = mn;
      }
    }
  }
  if (lane < RT) {  // piece == lane
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < Gb) {
        float* dst = red + (warp * GB + g) * D;
#pragma unroll
        for (int hh = 0; hh < H2; ++hh)
#pragma unroll
          for (int i = 0; i < 16; ++i) dst[hh * (D / 2) + piece * 16 + i] = acc[g][hh * 16 + i];
        if (lane == 0) {
          red_m[warp * GB + g] = m[g];
          red_l[warp * GB + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  // the four warps in order
  for (int i = threadIdx.x; i < Gb * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[w * GB + g]);
    float A = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = weight(red_m[w * GB + g], M);
      A = fmaf(red[(w * GB + g) * D + d], wt, A);
      Ls = fmaf(red_l[w * GB + g], wt, Ls);
    }
    if (chunks == 1) {
      o[i] = from_f32<T>(A / Ls);
    } else {
      const size_t at = ((size_t)b * H + h0 + g) * chunks + c;
      ws[at * D + d] = A;
      if (d == 0) {
        float* ml = ws + (size_t)gridDim.z * H * chunks * D;
        ml[at * 2] = M;
        ml[at * 2 + 1] = Ls;
      }
    }
  }
}

// Fold a multi-chunk plan's partials: one block per (head, slot), a
// thread per head dim, chunks 0 .. pos[b] / chunk in order, each merged
// into a running (max, sum, acc); the loads of CB chunks are issued
// together.
template <typename T, int D>
__global__ void __launch_bounds__(D)
quant_gqa_kernel_combine(const float* __restrict__ ws, const int* __restrict__ pos,
                         T* __restrict__ out, int H, int ctx, int chunk, int chunks) {
  constexpr int CB = 8;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int L = min(pos[b] + 1, ctx);
  const int live = L > 0 ? (L + chunk - 1) / chunk : 0;
  const size_t base = ((size_t)b * H + h) * chunks;
  const float2* ml = reinterpret_cast<const float2*>(ws + (size_t)gridDim.y * H * chunks * D);
  float M = -INFINITY, A = 0.f, Ls = 0.f;
  for (int c0 = 0; c0 < live; c0 += CB) {
    float2 st[CB];
    float x[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      if (c0 + u < live) {
        st[u] = ml[base + c0 + u];
        x[u] = ws[(base + c0 + u) * D + d];
      }
    }
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      if (c0 + u < live) {
        const float mn = fmaxf(M, st[u].x);
        const float a = weight(M, mn), wt = weight(st[u].x, mn);
        A = fmaf(x[u], wt, A * a);
        Ls = fmaf(st[u].y, wt, Ls * a);
        M = mn;
      }
    }
  }
  out[((size_t)b * H + h) * D + d] = from_f32<T>(Ls > 0.f ? A / Ls : 0.f);
}

template <typename KV, typename Addr, typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, Addr addr, int ctx, void* out, void* ws,
           int B, int H, int KH, int chunk, int chunks, cudaStream_t stream) {
  const int G = H / KH, groups = (G + GB - 1) / GB;
  const size_t smem = sizeof(float) * ((size_t)GB * (D + D / 16 * QPAD) + (size_t)WARPS * GB * D +
                                       2 * WARPS * GB + 16) +
                      sizeof(int) * (size_t)addr.table_entries(chunk);
  auto kernel = quant_gqa_kernel<KV, Addr, T, D>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(chunks, KH * groups, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), addr, static_cast<T*>(out), static_cast<float*>(ws), H, KH,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  quant_gqa_kernel_combine<T, D><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(pos), static_cast<T*>(out), H, ctx,
      chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, typename Addr, int D>
int by_type(const void* q, const void* k, const void* v, const void* ks, const void* vs,
            const void* pos, Addr addr, int ctx, void* out, void* ws, int B, int H, int KH,
            int chunk, int chunks, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch<KV, Addr, float, D>(q, k, v, ks, vs, pos, addr, ctx, out, ws, B, H, KH, chunk,
                                      chunks, st);
  return launch<KV, Addr, __nv_bfloat16, D>(q, k, v, ks, vs, pos, addr, ctx, out, ws, B, H, KH,
                                            chunk, chunks, st);
}

template <typename KV, typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* pos, Addr addr, int ctx, int page_size, void* out, void* ws, int B,
             int H, int KH, int D, int chunk, int chunks, int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  // a plan of whole pages that covers the context, a workspace where it
  // has more than one chunk
  if (chunk <= 0 || chunk % page_size || chunks < 1 || (long long)chunk * chunks < ctx ||
      (chunks > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return by_type<KV, Addr, 32>(q, k, v, ks, vs, pos, addr, ctx, out, ws, B, H, KH, chunk,
                                   chunks, dtype, st);
    case 64:
      return by_type<KV, Addr, 64>(q, k, v, ks, vs, pos, addr, ctx, out, ws, B, H, KH, chunk,
                                   chunks, dtype, st);
    case 128:
      return by_type<KV, Addr, 128>(q, k, v, ks, vs, pos, addr, ctx, out, ws, B, H, KH, chunk,
                                    chunks, dtype, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The wrappers guarantee H % KH == 0, H / KH <= 8, D in {32, 64, 128},
// pools 16-byte aligned and a plan from ops.attention_plan: chunks of
// `chunk` positions (whole pages), `chunks` of them covering the context,
// and ws, f32 (B, H, chunks, D + 2), where chunks > 1 (else null).  q/out
// (B, 1, H, D) of dtype (0 = float32, 1 = bfloat16); pos (B,) int32;
// scales f32.  Ring: k/v (B, W, KH, D) int8 or (B, W, KH, D/2) uint8,
// scales (B, W, KH).  Paged: pools (P, page_size, KH, ...), scales (P,
// page_size, KH), page_table (B, max_pages) int32.  One launch, or two
// where the plan has more than one chunk; each entry returns the CUDA
// error after them.
extern "C" int ring_quant_gqa_attention(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, const void* pos,
                                        void* out, void* ws, int B, int H, int KH, int D,
                                        int W, int chunk, int chunks, int dtype, int device,
                                        void* stream) {
  return dispatch<Int8KV>(q, k, v, ks, vs, pos, Ring{W}, W, 1, out, ws, B, H, KH, D, chunk,
                          chunks, dtype, device, stream);
}

extern "C" int ring_nf4_gqa_attention(const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs, const void* pos,
                                      void* out, void* ws, int B, int H, int KH, int D, int W,
                                      int chunk, int chunks, int dtype, int device,
                                      void* stream) {
  return dispatch<NF4KV>(q, k, v, ks, vs, pos, Ring{W}, W, 1, out, ws, B, H, KH, D, chunk,
                         chunks, dtype, device, stream);
}

extern "C" int paged_quant_gqa_attention(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs,
                                         const void* page_table, const void* pos, void* out,
                                         void* ws, int B, int H, int KH, int D, int page_size,
                                         int max_pages, int chunk, int chunks, int dtype,
                                         int device, void* stream) {
  return dispatch<Int8KV>(q, k, v, ks, vs, pos,
                          Paged{static_cast<const int*>(page_table), page_size, max_pages},
                          page_size * max_pages, page_size, out, ws, B, H, KH, D, chunk,
                          chunks, dtype, device, stream);
}

extern "C" int paged_nf4_gqa_attention(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* page_table,
                                       const void* pos, void* out, void* ws, int B, int H,
                                       int KH, int D, int page_size, int max_pages, int chunk,
                                       int chunks, int dtype, int device, void* stream) {
  return dispatch<NF4KV>(q, k, v, ks, vs, pos,
                         Paged{static_cast<const int*>(page_table), page_size, max_pages},
                         page_size * max_pages, page_size, out, ws, B, H, KH, D, chunk,
                         chunks, dtype, device, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
