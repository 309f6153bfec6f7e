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
// clamps it; a clear bit is 0.  n = 1, 2, 4 (a template argument;
// ops.nm_matmul checks it), m <= 8.
//
// Bound on the H100.  Decode (M = 4..8) is bytes: at smollm_135m's down
// (K x N = 1536 x 576) the call moves 1.1 MB of weight (1/4 byte of bits
// and n/m = 1/2 of a bf16 value per column) for 4..8 flops per stored
// value, 0.00034 ms at 3.35 TB/s.  Prefill (M = 1024) does 128x the flops
// on the same bytes: 0.9 GFLOP on the stored values (1.8 on the tensor
// cores, which multiply the pruned zeros too), where operations and bytes
// bind about equally (~0.002 ms).
//
// Design, bf16 (splitk_gemm.cuh): K cut into slices, chosen by the wrapper
// from (K, N) and the SM count so that the (64-column tile x slice) blocks
// fill the card at decode (down: 9 x 16 = 144 blocks); a block copies its
// tile's group bytes and values with cp.async (16 bytes where the row
// strides allow: N/m and 2nN/m bytes, 144 and 576 at smollm) through a
// 4-stage ring, decodes 32 rows at a time into a bf16 (32, 64) tile in
// shared memory (the set bit's slot a __popc of the bits below it, clamped
// to n - 1, through NMTile) and runs mma.sync m16n8k16 over it.  Small M:
// a block per (column tile, row tile, slice) writes f32 partials,
// nm_spmm_kernel_reduce sums them in slice order; larger M, where those
// partials would cost more than a longer walk: a block per (column tile,
// row tile) walks the slices in order (nm_spmm_kernel_rows); the same bits
// either way.  It replaces a column GEMM, one thread per column walking
// all of K (5 blocks at decode), which took 0.2291 ms at down M = 4 and
// 0.2583 ms at M = 1024 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 2); this design takes 0.0059 and 0.0451 ms there (PERF.md).  The
// FAST kernels (m = 4, 16-byte aligned: the main path) take half the time
// of the generic ones there.  Hopper's sparse mma.sp would want the 2:4
// pattern along K, and this layout groups along N (ROADMAP).  f32 keeps
// the column GEMM of column_gemm.cuh: f32 is held at 1e-5, which TF32
// tensor cores cannot meet.
#include "column_gemm.cuh"
#include "splitk_gemm.cuh"

namespace {

using salr::splitk::bf16;

// f32: column col of an N:M weight with NK = n values per group of m.
// fetch() loads the row's group byte and all NK values of the group,
// which need not wait for the byte; value() picks the set bit's slot.
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

struct __align__(16) NMRaw {  // one stage of a tile's compressed rows
  uint8_t bits[salr::splitk::BK][salr::splitk::BN];   // at most BN / m group bytes a row
  uint16_t vals[salr::splitk::BK][salr::splitk::BN];  // at most BN / m * n <= BN values a row
};

// bf16: column tile `tile` of an N:M weight, BN / m whole groups (BN - BN %
// m columns) per tile, for the split-K walk.  FAST: m = 4 and every copy a
// 16-byte one (the main path: 2:4 at smollm's and granite's widths), so a
// step's group bytes and values are one fixed chunk per thread and the
// decode knows m; otherwise any m <= 8 at any alignment.
template <int NK, bool FAST>
struct NMTile {
  static constexpr int BN = salr::splitk::BN, BK = salr::splitk::BK;
  using Raw = NMRaw;
  const uint8_t* __restrict__ bits;
  const uint16_t* __restrict__ values;
  int groups, m;
  int g0, gt;      // the tile's first group and its number of groups
  int n0, width;   // its first column and its number of columns
  salr::splitk::Chunk<16> bits_chunk, vals_chunk;  // FAST
  __device__ NMTile(const uint8_t* bits_, const bf16* values_, int N, int m_, int tile)
      : bits(bits_), values(reinterpret_cast<const uint16_t*>(values_)), groups(N / m_), m(m_) {
    g0 = tile * (BN / m);
    gt = min(BN / m, groups - g0);
    n0 = g0 * m;
    width = gt * m;
    if constexpr (FAST) {
      bits_chunk = salr::splitk::Chunk<16>(BK, BN / 4);
      vals_chunk = salr::splitk::Chunk<16>(BK, BN / 4 * NK * 2);
    }
  }
  // Whether the FAST tile applies: m = 4 and the tiles' group bytes and
  // values start and end on 16-byte boundaries in every row.
  __host__ static bool fast(const void* bits, const void* values, int N, int m) {
    return m == 4 && reinterpret_cast<uintptr_t>(bits) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(values) % 16 == 0 && (N / m) % 16 == 0;
  }
  // cp.async rows [k0, k0 + kn) of the tile's group bytes and values.
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const size_t cell = static_cast<size_t>(k0) * groups + g0;
    const size_t vstride = static_cast<size_t>(groups) * NK * 2;
    if constexpr (FAST) {
      bits_chunk.copy(r.bits, BN, bits + cell, groups, kn, BN);
      vals_chunk.copy(r.vals, 2 * BN, values + cell * NK, vstride, kn, 2 * BN);
    } else {
      salr::splitk::copy_rows(r.bits, BN, bits + cell, groups, kn, gt, gt);
      salr::splitk::copy_rows(r.vals, 2 * BN, values + cell * NK, vstride, kn, gt * NK * 2,
                              gt * NK * 2);
    }
  }
  // w[k][c] = the entry of row k0 + k, column n0 + c; 0 past kn rows and
  // past the tile's width.  A thread writes 8 columns with one 16-byte
  // store.
  __device__ __forceinline__ void decode(const Raw& r, int kn, salr::splitk::WTile& w) const {
    if constexpr (FAST) decode_m4(r, kn, w);
    else decode_any(r, kn, w);
  }
  // m = 4: thread (k, j) decodes groups 2j and 2j + 1 of row k from one
  // 2-byte load of their bits and one load of their 2n values.
  __device__ __forceinline__ void decode_m4(const Raw& r, int kn, salr::splitk::WTile& w) const {
    static_assert(BK * (BN / 8) == salr::splitk::THREADS, "one 8-column chunk a thread");
    const int k = threadIdx.x / (BN / 8), j = threadIdx.x % (BN / 8);
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (k < kn) {
      const uint32_t b2 = *reinterpret_cast<const uint16_t*>(&r.bits[k][2 * j]);
      uint32_t words[NK];  // the two groups' 2n values, two to a word
      const uint16_t* vp = &r.vals[k][2 * j * NK];
      if constexpr (NK == 1) {
        words[0] = *reinterpret_cast<const uint32_t*>(vp);
      } else if constexpr (NK == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(vp);
        words[0] = q.x, words[1] = q.y;
      } else {
        const uint4 q = *reinterpret_cast<const uint4*>(vp);
        words[0] = q.x, words[1] = q.y, words[2] = q.z, words[3] = q.w;
      }
      auto value = [&](int i) { return (words[i / 2] >> (16 * (i & 1))) & 0xFFFFu; };
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b = (b2 >> (8 * h)) & 0xFFu;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int slot = min(__popc(b & ((1u << t) - 1u)), NK - 1);
          uint32_t v = value(h * NK);  // a select, no indexed registers
#pragma unroll
          for (int q = 1; q < NK; ++q)
            if (slot == q) v = value(h * NK + q);
          packed[2 * h + t / 2] |= (((b >> t) & 1u) ? v : 0u) << (16 * (t & 1));
        }
      }
    }
    *reinterpret_cast<uint4*>(&w.v[k][8 * j]) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  // Any m: entry by entry.  Branch-free: a stale row or a column past the
  // width reads in-bounds junk that the select drops.
  __device__ __forceinline__ void decode_any(const Raw& r, int kn, salr::splitk::WTile& w) const {
    for (int i = threadIdx.x; i < BK * (BN / 8); i += salr::splitk::THREADS) {
      const int k = i / (BN / 8), c0 = 8 * (i % (BN / 8));
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t e[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + j + h;
          const int g = c / m, t = c - g * m;
          const uint32_t b = r.bits[k][g];
          const uint32_t v = r.vals[k][g * NK + min(__popc(b & ((1u << t) - 1u)), NK - 1)];
          e[h] = (k < kn && c < width && ((b >> t) & 1u)) ? v : 0u;
        }
        packed[j / 2] = e[0] | (e[1] << 16);
      }
      *reinterpret_cast<uint4*>(&w.v[k][c0]) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
};

struct NMShared {
  salr::splitk::XRing xs;
  NMRaw raw[salr::splitk::STAGES];
  salr::splitk::WTile w;
};

// The slices dispatch: block (column tile, row tile, slice) -> ws[slice].
template <int NK, bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
nm_spmm_kernel_splitk(const bf16* __restrict__ x, const uint8_t* __restrict__ bits,
                      const bf16* __restrict__ values, float* __restrict__ ws, int M, int K, int N,
                      int m, int slice_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<NMShared*>(smem);
  const NMTile<NK, FAST> tile(bits, values, N, m, blockIdx.x);
  salr::splitk::slices_block<FAST>(s.xs, s.raw, s.w, tile, x, ws, M, K, N, slice_k);
}

// The rows dispatch: block (column tile, row tile) walks every slice.
template <int NK, bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
nm_spmm_kernel_rows(const bf16* __restrict__ x, const uint8_t* __restrict__ bits,
                    const bf16* __restrict__ values, bf16* __restrict__ y, int M, int K, int N,
                    int m, int slice_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<NMShared*>(smem);
  const NMTile<NK, FAST> tile(bits, values, N, m, blockIdx.x);
  salr::splitk::rows_block<FAST>(s.xs, s.raw, s.w, tile, x, y, M, K, N, slice_k);
}

__global__ void __launch_bounds__(salr::splitk::REDUCE_THREADS)
nm_spmm_kernel_reduce(const float* __restrict__ ws, bf16* __restrict__ y, int S, size_t MN) {
  salr::splitk::reduce_slices(ws, y, S, MN);
}

template <int NK>
int launch_f32(const void* x, const void* bits, const void* values, void* y, int M, int K, int N,
               int m, cudaStream_t stream) {
  using namespace salr::colgemm;
  dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
  nm_spmm_kernel<float, NK><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(bits),
      static_cast<const float*>(values), static_cast<float*>(y), M, K, N, m);
  return static_cast<int>(cudaGetLastError());
}

template <int NK, bool FAST>
int launch_splitk(const void* x, const void* bits, const void* values, void* y, void* ws, int M,
                  int K, int N, int m, int slices, int slice_k, cudaStream_t stream) {
  using namespace salr::splitk;
  const int per = BN / m, groups = N / m;
  const dim3 tiles((groups + per - 1) / per, (M + BM - 1) / BM);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const uint8_t*>(bits);
  const auto* vb = static_cast<const bf16*>(values);
  if (ws == nullptr)
    return static_cast<int>(launch_with_smem<nm_spmm_kernel_rows<NK, FAST>, NMShared>(
        tiles, stream, xb, gb, vb, static_cast<bf16*>(y), M, K, N, m, slice_k));
  const cudaError_t err = launch_with_smem<nm_spmm_kernel_splitk<NK, FAST>, NMShared>(
      dim3(tiles.x, tiles.y, slices), stream, xb, gb, vb, static_cast<float*>(ws), M, K, N, m,
      slice_k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  nm_spmm_kernel_reduce<<<reduce_blocks(mn), REDUCE_THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(y), slices, mn);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_bf16(const void* x, const void* bits, const void* values, void* y, void* ws, int M,
                int K, int N, int m, int slices, int slice_k, cudaStream_t stream) {
  if (!salr::splitk::plan_ok(K, slices, slice_k)) return static_cast<int>(cudaErrorInvalidValue);
  if (salr::splitk::x_vec(x, K) && NMTile<NK, true>::fast(bits, values, N, m))
    return launch_splitk<NK, true>(x, bits, values, y, ws, M, K, N, m, slices, slice_k, stream);
  return launch_splitk<NK, false>(x, bits, values, y, ws, M, K, N, m, slices, slice_k, stream);
}

// n is a template argument of the kernels: 1, 2 (2:4) and 4 are built.
int launch(const void* x, const void* bits, const void* values, void* y, void* ws, int M, int K,
           int N, int n, int m, int slices, int slice_k, int dtype, cudaStream_t st) {
  if (m < 1 || m > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (n) {
      case 1: return launch_f32<1>(x, bits, values, y, M, K, N, m, st);
      case 2: return launch_f32<2>(x, bits, values, y, M, K, N, m, st);
      case 4: return launch_f32<4>(x, bits, values, y, M, K, N, m, st);
    }
  } else {
    switch (n) {
      case 1: return launch_bf16<1>(x, bits, values, y, ws, M, K, N, m, slices, slice_k, st);
      case 2: return launch_bf16<2>(x, bits, values, y, ws, M, K, N, m, slices, slice_k, st);
      case 4: return launch_bf16<4>(x, bits, values, y, ws, M, K, N, m, slices, slice_k, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K); group_bits (K, N/m) uint8; values (K, N/m*n); y (M, N).
// bf16 only: ws, an f32 (slices, M, N) workspace for the slices dispatch,
// or null for the rows dispatch; K cut into `slices` slices of slice_k rows
// (ops.splitk_plan).  f32 ignores ws and the plan.  dtype: 0 = float32, 1
// = bfloat16; device: the CUDA ordinal of the tensors.  Returns
// cudaGetLastError() after the launches.
extern "C" int nm_spmm(const void* x, const void* group_bits, const void* values, void* y,
                       void* ws, int M, int K, int N, int n, int m, int slices, int slice_k,
                       int dtype, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  return launch(x, group_bits, values, y, ws, M, K, N, n, m, slices, slice_k, dtype,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
