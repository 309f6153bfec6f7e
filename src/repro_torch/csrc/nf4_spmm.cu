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
// Bound on the H100.  Decode (M = 4..8) is bytes: at smollm_135m's down
// (K x N = 1536 x 576) the call moves 0.5 MB (half a byte per entry plus
// one f32 scale per 64), 0.00015 ms at 3.35 TB/s, for 8..16 flops per
// byte.  Prefill-sized calls (M = 1024) do 1.8 GFLOP on the same bytes:
// operations bind (0.0018 ms at 989 TFLOP/s bf16).
//
// Design, bf16 (splitk_gemm.cuh): K cut into slices, chosen by the wrapper
// from (K, N) and the SM count so that the (64-column tile x slice) blocks
// fill the card at decode (down: 9 x 16 = 144 blocks); a block copies its
// tile's 32 code bytes a row with 16-byte cp.async (N/2 = 288 bytes a row
// at smollm) and its scale with a 4-byte one through a 4-stage ring,
// decodes 32 rows at a time into a bf16 (32, 64) tile in shared memory
// (level x scale in f32, rounded to bf16, through NF4Tile) and runs
// mma.sync m16n8k16 over it.  Small M: a block per (column tile, row tile,
// slice) writes f32 partials, nf4_spmm_kernel_reduce sums them in slice
// order; larger M, where those partials would cost more than a longer
// walk: a block per (column tile, row tile) walks the slices in order
// (nf4_spmm_kernel_rows); the same bits either way.  It replaces a column
// GEMM, one thread per column walking all of K (5 blocks at decode),
// which took 0.2030 ms at down M = 4 and 0.2767 ms at M = 1024 (NVIDIA
// H100 80GB HBM3, 700.00 W; chip_smoke.py phase 2); this design takes
// 0.0060 and 0.0452 ms there (PERF.md), the FAST kernels (x and the codes
// 16-byte aligned: the main path) half the time of the generic ones.  f32
// keeps the column GEMM of column_gemm.cuh: f32 is held at 1e-5, which
// TF32 tensor cores cannot meet.
#include "column_gemm.cuh"
#include "splitk_gemm.cuh"

namespace {

using salr::splitk::bf16;

constexpr int QBLOCK = 64;  // columns per scale (core/quant.QBLOCK)

// f32: column col of the 2-D NF4 layout: fetch() loads the row's code byte
// and scale, value() decodes the nibble through the level table.
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
    return live ? lut[(r.byte >> shift) & 0x0Fu] * r.scale : 0.f;
  }
};

__global__ void __launch_bounds__(salr::colgemm::THREADS)
nf4_spmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, float* __restrict__ y, int M, int K, int N) {
  using namespace salr::colgemm;
  __shared__ __align__(16) XStage s;
  __shared__ float lut[16];
  salr::load_nf4_table(lut);
  __syncthreads();
  const int m0 = blockIdx.x * BM;
  const int col = blockIdx.y * THREADS + threadIdx.x;
  const NF4Column w(codes, scales, lut, N, col);
  float acc[BM] = {0.f};
  accumulate(s, acc, x, w, M, K, m0);
  store_rows(y, acc, M, N, m0, col);
}

struct __align__(16) NF4Raw {  // one stage of a tile's code bytes and scales
  uint8_t codes[salr::splitk::BK][salr::splitk::BN / 2];
  float scales[salr::splitk::BK];
};

// bf16: column tile `tile` (QBLOCK = BN columns, one scale a row) of the
// 2-D NF4 layout, for the split-K walk.  FAST: the codes 16-byte aligned
// (the main path), so a step's code bytes are one fixed 16-byte chunk per
// thread; its scales always are one fixed 4-byte chunk.
template <bool FAST>
struct NF4Tile {
  static constexpr int BN = salr::splitk::BN, BK = salr::splitk::BK;
  static_assert(BN == QBLOCK, "a tile is one scale block wide");
  using Raw = NF4Raw;
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scales;
  const float* lut;  // the 16 levels in shared memory
  int half, nblk, tile;
  int n0, width;     // the tile's first column and its number of columns
  salr::splitk::Chunk<16> codes_chunk;  // FAST
  salr::splitk::Chunk<4> scales_chunk;
  __device__ NF4Tile(const uint8_t* codes_, const float* scales_, const float* lut_, int N,
                     int tile_)
      : codes(codes_), scales(scales_), lut(lut_), half(N / 2), nblk(N / QBLOCK), tile(tile_),
        n0(tile_ * BN), width(BN), scales_chunk(BK, 4) {
    if constexpr (FAST) codes_chunk = salr::splitk::Chunk<16>(BK, BN / 2);
  }
  // cp.async rows [k0, k0 + kn) of the tile's code bytes and scales.
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const uint8_t* c = codes + static_cast<size_t>(k0) * half + tile * (BN / 2);
    if constexpr (FAST) codes_chunk.copy(r.codes, BN / 2, c, half, kn, BN / 2);
    else salr::splitk::copy_rows(r.codes, BN / 2, c, half, kn, BN / 2, BN / 2);
    scales_chunk.copy(r.scales, 4, scales + static_cast<size_t>(k0) * nblk + tile,
                      static_cast<size_t>(nblk) * 4, kn, 4);
  }
  // w[k][c] = bf16(level of code (k, c) x the row's scale); 0 past kn rows.
  // A thread decodes 4 code bytes into 8 columns, one 16-byte store.
  __device__ __forceinline__ void decode(const Raw& r, int kn, salr::splitk::WTile& w) const {
    for (int i = threadIdx.x; i < BK * (BN / 8); i += salr::splitk::THREADS) {
      const int k = i / (BN / 8), c8 = i % (BN / 8);
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
      if (k < kn) {
        const uint32_t q = *reinterpret_cast<const uint32_t*>(&r.codes[k][4 * c8]);
        const float sc = r.scales[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (q >> (8 * j)) & 0xFFu;
          // low nibble in the low half; one round-to-nearest-even per entry
          const __nv_bfloat162 pair = __floats2bfloat162_rn(lut[b & 0x0Fu] * sc, lut[b >> 4] * sc);
          packed[j] = *reinterpret_cast<const uint32_t*>(&pair);
        }
      }
      *reinterpret_cast<uint4*>(&w.v[k][8 * c8]) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
};

struct NF4Shared {
  salr::splitk::XRing xs;
  NF4Raw raw[salr::splitk::STAGES];
  salr::splitk::WTile w;
  float lut[16];
};

// The slices dispatch: block (column tile, row tile, slice) -> ws[slice].
template <bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
nf4_spmm_kernel_splitk(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
                       const float* __restrict__ scales, float* __restrict__ ws, int M, int K,
                       int N, int slice_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<NF4Shared*>(smem);
  salr::load_nf4_table(s.lut);  // read after the walk's first __syncthreads
  const NF4Tile<FAST> tile(codes, scales, s.lut, N, blockIdx.x);
  salr::splitk::slices_block<FAST>(s.xs, s.raw, s.w, tile, x, ws, M, K, N, slice_k);
}

// The rows dispatch: block (column tile, row tile) walks every slice.
template <bool FAST>
__global__ void __launch_bounds__(salr::splitk::THREADS, salr::splitk::MIN_BLOCKS)
nf4_spmm_kernel_rows(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
                     const float* __restrict__ scales, bf16* __restrict__ y, int M, int K, int N,
                     int slice_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<NF4Shared*>(smem);
  salr::load_nf4_table(s.lut);
  const NF4Tile<FAST> tile(codes, scales, s.lut, N, blockIdx.x);
  salr::splitk::rows_block<FAST>(s.xs, s.raw, s.w, tile, x, y, M, K, N, slice_k);
}

__global__ void __launch_bounds__(salr::splitk::REDUCE_THREADS)
nf4_spmm_kernel_reduce(const float* __restrict__ ws, bf16* __restrict__ y, int S, size_t MN) {
  salr::splitk::reduce_slices(ws, y, S, MN);
}

template <bool FAST>
int launch_splitk(const void* x, const void* codes, const void* scales, void* y, void* ws, int M,
                  int K, int N, int slices, int slice_k, cudaStream_t stream) {
  using namespace salr::splitk;
  const dim3 tiles(N / BN, (M + BM - 1) / BM);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* cb = static_cast<const uint8_t*>(codes);
  const auto* sb = static_cast<const float*>(scales);
  if (ws == nullptr)
    return static_cast<int>(launch_with_smem<nf4_spmm_kernel_rows<FAST>, NF4Shared>(
        tiles, stream, xb, cb, sb, static_cast<bf16*>(y), M, K, N, slice_k));
  const cudaError_t err = launch_with_smem<nf4_spmm_kernel_splitk<FAST>, NF4Shared>(
      dim3(tiles.x, tiles.y, slices), stream, xb, cb, sb, static_cast<float*>(ws), M, K, N,
      slice_k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  nf4_spmm_kernel_reduce<<<reduce_blocks(mn), REDUCE_THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(y), slices, mn);
  return static_cast<int>(cudaGetLastError());
}

// FAST where x and the codes allow 16-byte copies (rows of N/2 code
// bytes, N a multiple of 64, always do).
int launch_bf16(const void* x, const void* codes, const void* scales, void* y, void* ws, int M,
                int K, int N, int slices, int slice_k, cudaStream_t stream) {
  if (N % QBLOCK || !salr::splitk::plan_ok(K, slices, slice_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (salr::splitk::x_vec(x, K) && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_splitk<true>(x, codes, scales, y, ws, M, K, N, slices, slice_k, stream);
  return launch_splitk<false>(x, codes, scales, y, ws, M, K, N, slices, slice_k, stream);
}

int launch_f32(const void* x, const void* codes, const void* scales, void* y, int M, int K, int N,
               cudaStream_t stream) {
  using namespace salr::colgemm;
  dim3 grid((M + BM - 1) / BM, (N + THREADS - 1) / THREADS);
  nf4_spmm_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K); codes (K, N/2) uint8; scales (K, N/64) f32; y (M, N), N a
// multiple of 64.  bf16 only: ws, an f32 (slices, M, N) workspace for the
// slices dispatch, or null for the rows dispatch; K cut into `slices`
// slices of slice_k rows (ops.splitk_plan).  f32 ignores ws and the plan.
// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors.  Returns cudaGetLastError() after the launches.
extern "C" int nf4_spmm(const void* x, const void* codes, const void* scales, void* y, void* ws,
                        int M, int K, int N, int slices, int slice_k, int dtype, int device,
                        void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, codes, scales, y, M, K, N, st);
  return launch_bf16(x, codes, scales, y, ws, M, K, N, slices, slice_k, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
