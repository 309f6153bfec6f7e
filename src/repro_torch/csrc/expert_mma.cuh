// Device pieces of the bf16 tensor-core body of the NF4 tiled-bitmap expert
// kernels (grouped_spmm.cu: grouped_qsalr_spmm, decode_qsalr_spmm) on the
// walk of splitk_gemm.cuh: x's rows gathered by a list, and one expert's
// NF4 bitmap cells decoded into a bf16 tile.
//
// A block owns 64 output columns (two bitmap words) and up to BM = 64
// rows of one expert, which its row map names (TileMap: a tile's
// contiguous rows; RowMap: the rows whose row_expert is the block's
// expert, compacted).  Each step of 32 K rows copies, with cp.async through
// a 4-stage ring, the rows' x (GatherX) and the step's cells (NF4CellTile:
// words, codes and scale of each row's cell), decodes the cells into a
// bf16 (32, 64) tile in shared memory and multiplies it on the tensor cores
// (mma.sync m16n8k16: 8 warps of 16 rows x 32 columns; a warp whose 16 rows
// hold none of the chunk's skips the mma).  mma.sync keeps rows apart and
// every row meets the same k16 steps in the same order from a zeroed
// accumulator, whatever its slot in its row group: a row's bits do not
// depend on which rows share its block, on M, or on the row map.
#pragma once

#include "splitk_gemm.cuh"

namespace salr {
namespace splitk {

// x's rows named by a list: row i of the block is row rows[i] of a
// row-major (., ld) bf16 x, zero where rows[i] < 0 (past the chunk).
// FAST: x 16-byte aligned with rows of a multiple of 16 bytes, so a thread
// copies one fixed 16-byte chunk a step.
template <bool FAST>
struct GatherX {
  const bf16* __restrict__ x;
  const int* rows;  // BM entries in shared memory
  int ld, n;        // n: the chunk's rows, the first n entries of rows
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ void prepare(XRing&) const {}
  template <int W>
  __device__ __forceinline__ void gather(char* dst, const char* src, size_t stride,
                                         int valid) const {
    constexpr int per_row = BK * 2 / W;
    for (int i = threadIdx.x; i < BM * per_row; i += THREADS) {
      const int r = i / per_row, c = (i - r * per_row) * W;
      const int m = rows[r];
      char* d = dst + r * (XLD * 2) + c;
      if (m >= 0 && c < valid) copy_chunk<W>(d, src + m * stride + c);
      else zero_chunk<W>(d);
    }
  }
  // cp.async columns [k0, k0 + kn) of the rows into a stage, zero past kn.
  __device__ __forceinline__ void load(uint16_t (*dst)[XLD], int k0, int kn) const {
    char* d = reinterpret_cast<char*>(dst);
    const char* src = reinterpret_cast<const char*>(x + k0);
    const size_t stride = static_cast<size_t>(ld) * 2;
    if constexpr (FAST) {
      gather<16>(d, src, stride, kn * 2);
    } else {
      const size_t a = reinterpret_cast<uintptr_t>(src) | stride | static_cast<size_t>(kn * 2);
      if (!(a & 15)) gather<16>(d, src, stride, kn * 2);
      else if (!(a & 7)) gather<8>(d, src, stride, kn * 2);
      else if (!(a & 3)) gather<4>(d, src, stride, kn * 2);
      else if (!(a & 1)) gather<2>(d, src, stride, kn * 2);
      else gather<1>(d, src, stride, kn * 2);
    }
  }
};

constexpr int MAX_WPT = 8;      // words a cell: column tiles up to 256 wide
constexpr int MAX_CODES = 128;  // code bytes a cell: cap_t up to 256
// code row pitch: the 4 rows a warp decodes start 16 bytes (4 banks) apart
constexpr int CODES_PITCH = MAX_CODES + 16;

// One stage: for each of a step's BK rows, the cells of the block's two
// words (one cell when both lie in one column tile).
struct __align__(16) NF4Cells {
  uint32_t words[2][BK][MAX_WPT];
  uint8_t codes[2][BK][CODES_PITCH];
  float scales[2][BK];
};

// The block's two words (global words 2 block and 2 block + 1, 64 columns)
// of one expert's NF4 tiled bitmap: words (K, n_tiles, wpt), codes (K,
// n_tiles, cap_t / 2) interleaved (slot 2i in the low nibble of byte i),
// scales (K, n_tiles), each pointer already at the expert.  A set bit's
// slot is the popcount of its cell's earlier words and of the bits below
// it in its word, clamped to cap_t - 1; its value the NF4 level of the
// slot's code x the cell's scale in f32, rounded once to bf16 (the
// reference rounds the decoded weight to x's dtype before its product).
// FAST: wpt and cap_t / 2 multiples of 4 and 16 bytes, the pointers 16-byte
// aligned, so each thread copies one fixed chunk a stream and step (then
// both words always lie in one tile).
template <bool FAST>
struct NF4CellTile {
  using Raw = NF4Cells;
  const uint32_t* __restrict__ words;
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scales;
  const float* lut;  // the 16 levels in shared memory
  int n_tiles, wpt, cap_t;
  int ti0, wi0, ti1, wi1;  // column tile and word in it of the block's two words
  int cells;               // cells a row copies: 2 where the words straddle two tiles
  bool live1;              // the second word lies inside the weight
  int width;               // the block's columns inside the weight: 64 or 32
  Chunk<16> wc, cc;        // FAST: a thread's words / codes chunk
  Chunk<4> sc;             // FAST: its scale
  __device__ NF4CellTile(const uint32_t* words_, const uint8_t* codes_, const float* scales_,
                         const float* lut_, int n_tiles_, int wpt_, int cap_t_, int block)
      : words(words_), codes(codes_), scales(scales_), lut(lut_), n_tiles(n_tiles_),
        wpt(wpt_), cap_t(cap_t_) {
    const int gw = 2 * block;
    live1 = gw + 1 < n_tiles * wpt;
    ti0 = gw / wpt;
    wi0 = gw % wpt;
    ti1 = (gw + 1) / wpt;
    wi1 = (gw + 1) % wpt;
    cells = live1 && ti1 != ti0 ? 2 : 1;
    width = live1 ? 64 : 32;
    if constexpr (FAST) {
      wc = Chunk<16>(BK, wpt * 4);
      cc = Chunk<16>(BK, cap_t / 2);
      sc = Chunk<4>(BK, 4);
    }
  }
  // cp.async rows [k0, k0 + kn) of the block's cells.
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const size_t wstride = static_cast<size_t>(n_tiles) * wpt * 4;
    const size_t cstride = static_cast<size_t>(n_tiles) * (cap_t / 2);
    const size_t sstride = static_cast<size_t>(n_tiles) * 4;
    for (int j = 0; j < (FAST ? 1 : cells); ++j) {  // FAST: one cell
      const size_t cell = static_cast<size_t>(k0) * n_tiles + (j ? ti1 : ti0);
      const uint32_t* ws = words + cell * wpt;
      const uint8_t* cs = codes + cell * (cap_t / 2);
      const float* ss = scales + cell;
      if constexpr (FAST) {
        wc.copy(r.words[j], MAX_WPT * 4, ws, wstride, kn, wpt * 4);
        cc.copy(r.codes[j], CODES_PITCH, cs, cstride, kn, cap_t / 2);
        sc.copy(r.scales[j], 4, ss, sstride, kn, 4);
      } else {
        copy_rows(r.words[j], MAX_WPT * 4, ws, wstride, kn, wpt * 4, wpt * 4);
        copy_rows(r.codes[j], CODES_PITCH, cs, cstride, kn, cap_t / 2, cap_t / 2);
        copy_rows(r.scales[j], 4, ss, sstride, kn, 4, 4);
      }
    }
  }
  // w[k][c] = the decoded bf16 weight of row k, column c; 0 past kn rows
  // and past the weight.  A thread decodes 8 columns of one row (one byte
  // of a word), one 16-byte store.  Each column's slot comes from its own
  // popcount and its code and level are read whether or not its bit is set
  // (the slot clamped inside the cell), so the 8 lookups wait on nothing
  // but the word.
  __device__ __forceinline__ void decode(const Raw& r, int kn, WTile& w) const {
    static_assert(BK * (BN / 8) == THREADS, "one 8-column chunk a thread");
    const int k = threadIdx.x / (BN / 8), c8 = (threadIdx.x % (BN / 8)) * 8;
    const int j = c8 / 32, b0 = c8 % 32;
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (k < kn && (j == 0 || live1)) {
      const int cj = cells == 2 ? j : 0, wi = j ? wi1 : wi0;
      const uint32_t* wd = r.words[cj][k];
      int base = 0;
      for (int q = 0; q < wi; ++q) base += __popc(wd[q]);
      const uint32_t word = wd[wi], bits = word >> b0;
      base += __popc(word & ((1u << b0) - 1u));
      const float scale = r.scales[cj][k];
      const uint8_t* cd = r.codes[cj][k];
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int s = min(base + __popc(bits & ((1u << t) - 1u)), cap_t - 1);
        const uint32_t code = cd[s >> 1];
        const float level = lut[(s & 1) ? (code >> 4) : (code & 0x0Fu)];
        v[t] = ((bits >> t) & 1u) ? level * scale : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        // one round-to-nearest-even per entry, column 2h in the low half
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
        packed[h] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    *reinterpret_cast<uint4*>(&w.v[k][c8]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

}  // namespace splitk
}  // namespace salr
