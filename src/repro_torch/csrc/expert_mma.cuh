// Device pieces of the bf16 tensor-core body of the tiled-bitmap expert
// kernels (grouped_spmm.cu: grouped_salr_spmm, decode_salr_spmm,
// grouped_qsalr_spmm, decode_qsalr_spmm) on the walk of splitk_gemm.cuh:
// x's rows gathered by a list, and one expert's bitmap cells decoded into
// a bf16 tile.
//
// A block owns 64 output columns (two bitmap words) and up to BM = 64
// rows of one expert, which its row map names (TileMap: a tile's
// contiguous rows; RowMap: the rows whose row_expert is the block's
// expert, compacted).  Each step of 32 K rows copies, with cp.async through
// a 4-stage ring, the rows' x (GatherX) and the step's cells (the words of
// each row's cell and its values: PlainCellTile the cell's bf16 values as
// stored, NF4CellTile its codes and scale), decodes the cells into a bf16
// (32, 64) tile in shared memory and multiplies it on the tensor cores
// (mma.sync m16n8k16: 8 warps of 16 rows x 32 columns; a warp whose 16 rows
// hold none of the chunk's skips the mma).  mma.sync keeps rows apart and
// every row meets the same k16 steps in the same order from a zeroed
// accumulator, whatever its slot in its row group: a row's bits do not
// depend on which rows share its block, on M, or on the row map.
#pragma once

#include "splitk_gemm.cuh"
#include "tiled_bitmap.cuh"

namespace salr {
namespace splitk {

// A thread's fixed W-byte chunk of a FAST stream, found once for the
// walk: the byte offsets of its source from the step's first row and of
// its place in a stage; r < 0: none.  The step's rows from kn on are not
// copied.
template <int W>
struct FixedChunk {
  int r = -1;
  uint32_t src = 0, dst = 0;
  FixedChunk() = default;
  __device__ FixedChunk(int i, int rows, int bytes, uint32_t stride, int pitch) {
    const int per_row = bytes / W;
    if (i < rows * per_row) {
      r = i / per_row;
      const int c = (i - r * per_row) * W;
      src = r * stride + c;
      dst = r * pitch + c;
    }
  }
  __device__ __forceinline__ void copy(void* stage, const char* step, int kn) const {
    if (r >= 0 && r < kn) copy_chunk<W>(static_cast<char*>(stage) + dst, step + src);
  }
};
using Chunk16 = FixedChunk<16>;
// A cell's words: 8-byte chunks, so that rows of an even number of words
// (a 192-column tile's 6) copy FAST too
using WordChunk = FixedChunk<8>;

// x's rows named by a list: row i of the block is row rows[i] of a
// row-major (., ld) bf16 x, zero where rows[i] < 0 (past the chunk).
// FAST: x 16-byte aligned with rows of a multiple of 16 bytes, so a thread
// copies one fixed 16-byte chunk a step, its source row found once; the
// rows past the chunk are zeroed once a walk (prepare) and never copied.
template <bool FAST>
struct GatherX {
  static_assert(BM * (BK * 2 / 16) == THREADS, "FAST: one 16-byte chunk a thread");
  const bf16* __restrict__ x;
  const int* rows;  // BM entries in shared memory
  int ld, n;        // n: the chunk's rows, the first n entries of rows
  int r = 0, c = 0;            // FAST: the thread's row of the block and byte of the step
  const char* xrow = nullptr;  // FAST: x's row rows[r] at byte c (r < n)
  __device__ GatherX(const bf16* x_, const int* rows_, int ld_, int n_)
      : x(x_), rows(rows_), ld(ld_), n(n_) {
    if constexpr (FAST) {
      r = threadIdx.x / (BK * 2 / 16);
      c = threadIdx.x % (BK * 2 / 16) * 16;
      if (r < n) xrow = reinterpret_cast<const char*>(x + static_cast<size_t>(rows[r]) * ld) + c;
    }
  }
  __device__ __forceinline__ int count() const { return n; }
  // FAST: the rows past the chunk, zero in every stage; the walk's first
  // barrier orders it
  __device__ __forceinline__ void prepare(XRing& xs) const {
    if constexpr (FAST) {
      if (r >= n)
        for (int st = 0; st < STAGES; ++st)
          zero_chunk<16>(reinterpret_cast<char*>(xs.v[st][r]) + c);
    }
  }
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
    if constexpr (FAST) {
      if (r < n) {
        char* d = reinterpret_cast<char*>(dst[r]) + c;
        if (c < kn * 2) copy_chunk<16>(d, xrow + k0 * 2);
        else zero_chunk<16>(d);
      }
    } else {
      char* d = reinterpret_cast<char*>(dst);
      const char* src = reinterpret_cast<const char*>(x + k0);
      const size_t stride = static_cast<size_t>(ld) * 2;
      const size_t a = reinterpret_cast<uintptr_t>(src) | stride | static_cast<size_t>(kn * 2);
      if (!(a & 15)) gather<16>(d, src, stride, kn * 2);
      else if (!(a & 7)) gather<8>(d, src, stride, kn * 2);
      else if (!(a & 3)) gather<4>(d, src, stride, kn * 2);
      else if (!(a & 1)) gather<2>(d, src, stride, kn * 2);
      else gather<1>(d, src, stride, kn * 2);
    }
  }
};

constexpr int MAX_WPT = 8;    // words a cell: column tiles up to 256 wide
constexpr int MAX_CAP = 256;  // slots a cell: cap_t up to the tile
// row pitches of the codes (bytes) and values (bf16): the 4 rows a warp
// decodes start 16 bytes (4 banks) apart
constexpr int CODES_PITCH = MAX_CAP / 2 + 16;
constexpr int VALUES_PITCH = MAX_CAP + 8;

// Where a block's two words (global words 2 block and 2 block + 1, 64
// columns) lie in a stack of n_tiles column tiles of wpt words each.
struct BlockWords {
  int ti0, wi0, ti1, wi1;  // column tile and word in it of the two words
  int cells;               // cells a row copies: 2 where the words straddle two tiles
  bool live1;              // the second word lies inside the weight
  __device__ BlockWords(int n_tiles, int wpt, int block) {
    const int gw = 2 * block;
    live1 = gw + 1 < n_tiles * wpt;
    ti0 = gw / wpt;
    wi0 = gw % wpt;
    ti1 = (gw + 1) / wpt;
    wi1 = (gw + 1) % wpt;
    cells = live1 && ti1 != ti0 ? 2 : 1;
  }

  // A thread's share of a decode: 8 columns of one row, one byte of a
  // word, stored as one 16-byte chunk at w.v[k][c8].  cell: the stage's
  // cell that holds the byte; base: the slot of its first column (the
  // popcount of the cell's bits before it); bits: the byte's bits from
  // bit 0 (higher bits may follow); live: the row lies inside the step
  // and the word inside the weight.  The stage's word rows are 16-byte
  // aligned, MAX_WPT words each (those past wpt unread).
  struct Byte {
    int k, c8, cell, base;
    uint32_t bits;
    bool live;
  };
  __device__ __forceinline__ Byte byte_of(const uint32_t (*words)[BK][MAX_WPT], int kn) const {
    static_assert(BK * (BN / 8) == THREADS, "one 8-column chunk a thread");
    Byte t{static_cast<int>(threadIdx.x) / (BN / 8),
           static_cast<int>(threadIdx.x) % (BN / 8) * 8, 0, 0, 0u, false};
    const int j = t.c8 / 32, b0 = t.c8 % 32;
    t.live = t.k < kn && (j == 0 || live1);
    if (t.live) {
      t.cell = cells == 2 ? j : 0;
      const int wi = j ? wi1 : wi0;
      // the row's words in two 16-byte reads and a fixed sum: a loop of
      // wi steps compiles to branches
      const uint4* w4 = reinterpret_cast<const uint4*>(words[t.cell][t.k]);
      const uint4 lo = w4[0], hi = w4[1];
      const uint32_t wv[MAX_WPT] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t word = 0u;
#pragma unroll
      for (int q = 0; q < MAX_WPT; ++q) {
        t.base += q < wi ? __popc(wv[q]) : 0;
        word = q == wi ? wv[q] : word;
      }
      t.bits = word >> b0;
      t.base += __popc(word & ((1u << b0) - 1u));
    }
    return t;
  }
};

// The stage of a cell tile: for each of a step's BK rows, the cells of
// the block's two words (one cell when both lie in one column tile).
struct __align__(16) NF4Cells {
  uint32_t words[2][BK][MAX_WPT];
  uint8_t codes[2][BK][CODES_PITCH];
  float scales[2][BK];
};
template <int CELLS>
struct __align__(16) PlainCells {
  uint32_t words[CELLS][BK][MAX_WPT];
  uint16_t values[CELLS][BK][VALUES_PITCH];  // bf16 bits
};

// The block's two words of one expert's plain tiled bitmap: words (K,
// n_tiles, wpt), values (K, n_tiles, cap_t) bf16, each pointer already at
// the expert.  A set bit's value sits at the popcount of its cell's earlier
// words and of the bits below it in its word, clamped to cap_t - 1; it is
// copied as stored (the stored values are the decoded weights), a clear
// bit gives +0, so the tile equals tile_decode's bit for bit.  FAST: wpt
// even, cap_t a multiple of 8 and the pointers 16-byte aligned, so each
// thread copies fixed chunks (words: one of 8 bytes; values: up to VCHUNKS
// of 16) at the same place every step (then both words always lie in one
// tile, and the stage holds one cell: 4 stages take 72 KB, two blocks fit
// an SM).
template <bool FAST>
struct PlainCellTile : BlockWords {
  static constexpr int VCHUNKS = BK * MAX_CAP * 2 / 16 / THREADS;  // a step's values at cap_t 256
  static_assert(BK * MAX_CAP * 2 % (16 * THREADS) == 0, "whole chunks a thread");
  using Raw = PlainCells<FAST ? 1 : 2>;
  const uint32_t* __restrict__ words;
  const uint16_t* __restrict__ values;
  int n_tiles, wpt, cap_t;
  WordChunk wc;                // FAST: a thread's words chunk
  Chunk16 vc[FAST ? VCHUNKS : 1];  // FAST: its values chunks
  __device__ PlainCellTile(const uint32_t* words_, const PlainValues<bf16>& v, int n_tiles_,
                           int wpt_, int block)
      : BlockWords(n_tiles_, wpt_, block), words(words_),
        values(reinterpret_cast<const uint16_t*>(v.values)), n_tiles(n_tiles_), wpt(wpt_),
        cap_t(v.cap_t) {
    if constexpr (FAST) {
      wc = WordChunk(threadIdx.x, BK, wpt * 4, n_tiles * wpt * 4, MAX_WPT * 4);
#pragma unroll
      for (int q = 0; q < VCHUNKS; ++q)
        vc[q] = Chunk16(threadIdx.x + q * THREADS, BK, cap_t * 2, n_tiles * cap_t * 2,
                        VALUES_PITCH * 2);
    }
  }
  // cp.async rows [k0, k0 + kn) of the block's cells.
  __device__ __forceinline__ void load(Raw& r, int k0, int kn) const {
    const size_t wstride = static_cast<size_t>(n_tiles) * wpt * 4;
    const size_t vstride = static_cast<size_t>(n_tiles) * cap_t * 2;
    if constexpr (FAST) {  // one cell
      wc.copy(r.words[0], reinterpret_cast<const char*>(words + ti0 * wpt) + k0 * wstride, kn);
      const char* vs = reinterpret_cast<const char*>(values + ti0 * cap_t) + k0 * vstride;
#pragma unroll
      for (int q = 0; q < VCHUNKS; ++q) vc[q].copy(r.values[0], vs, kn);
    } else {
      for (int j = 0; j < cells; ++j) {
        const size_t cell = static_cast<size_t>(k0) * n_tiles + (j ? ti1 : ti0);
        copy_rows(r.words[j], MAX_WPT * 4, words + cell * wpt, wstride, kn, wpt * 4, wpt * 4);
        copy_rows(r.values[j], VALUES_PITCH * 2, values + cell * cap_t, vstride, kn, cap_t * 2,
                  cap_t * 2);
      }
    }
  }
  // w[k][c] = the stored value of row k, column c; 0 past kn rows and past
  // the weight.  Each column's slot comes from its own popcount and is read
  // whether or not its bit is set (clamped inside the cell), the value then
  // masked by the bit: a read under the bit compiles to a branch a column,
  // the 8 reads no longer issue together, and the kernel runs 25-40%
  // slower (spmm_ab.py).
  __device__ __forceinline__ void decode(const Raw& r, int kn, WTile& w) const {
    const Byte t = byte_of(r.words, kn);
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (t.live) {
      const uint16_t* vd = r.values[t.cell][t.k];
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = min(t.base + __popc(t.bits & ((1u << i) - 1u)), cap_t - 1);
        v[i] = vd[s] & (0u - ((t.bits >> i) & 1u));
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) packed[h] = v[2 * h] | (v[2 * h + 1] << 16);
    }
    *reinterpret_cast<uint4*>(&w.v[t.k][t.c8]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

// The block's two words of one expert's NF4 tiled bitmap: words (K,
// n_tiles, wpt), codes (K, n_tiles, cap_t / 2) interleaved (slot 2i in the
// low nibble of byte i), scales (K, n_tiles), each pointer already at the
// expert.  A set bit's slot as above; its value the NF4 level of the slot's
// code x the cell's scale in f32, rounded once to bf16 (the reference
// rounds the decoded weight to x's dtype before its product).  FAST: wpt
// even, cap_t / 2 a multiple of 16 bytes, the pointers 16-byte aligned, so
// each thread copies one fixed chunk a stream and step (then both words
// always lie in one tile).
template <bool FAST>
struct NF4CellTile : BlockWords {
  using Raw = NF4Cells;
  const uint32_t* __restrict__ words;
  const uint8_t* __restrict__ codes;
  const float* __restrict__ scales;
  const float* lut;  // the 16 levels in shared memory
  int n_tiles, wpt, cap_t;
  WordChunk wc;  // FAST: a thread's words chunk
  Chunk16 cc;    // FAST: its codes chunk
  Chunk<4> sc;   // FAST: its scale
  // words and v.codes / v.scales at the expert, v.lut in shared memory
  __device__ NF4CellTile(const uint32_t* words_, const NF4Values<bf16>& v, int n_tiles_,
                         int wpt_, int block)
      : BlockWords(n_tiles_, wpt_, block), words(words_), codes(v.codes), scales(v.scales),
        lut(v.lut), n_tiles(n_tiles_), wpt(wpt_), cap_t(v.cap_t) {
    if constexpr (FAST) {
      wc = WordChunk(threadIdx.x, BK, wpt * 4, n_tiles * wpt * 4, MAX_WPT * 4);
      cc = Chunk16(threadIdx.x, BK, cap_t / 2, n_tiles * (cap_t / 2), CODES_PITCH);
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
        wc.copy(r.words[j], reinterpret_cast<const char*>(ws), kn);
        cc.copy(r.codes[j], reinterpret_cast<const char*>(cs), kn);
        sc.copy(r.scales[j], 4, ss, sstride, kn, 4);
      } else {
        copy_rows(r.words[j], MAX_WPT * 4, ws, wstride, kn, wpt * 4, wpt * 4);
        copy_rows(r.codes[j], CODES_PITCH, cs, cstride, kn, cap_t / 2, cap_t / 2);
        copy_rows(r.scales[j], 4, ss, sstride, kn, 4, 4);
      }
    }
  }
  // w[k][c] = the decoded bf16 weight of row k, column c; 0 past kn rows
  // and past the weight.  Each column's slot comes from its own popcount
  // and its code and level are read whether or not its bit is set (the
  // slot clamped inside the cell), so the 8 lookups wait on nothing but
  // the word.
  __device__ __forceinline__ void decode(const Raw& r, int kn, WTile& w) const {
    const Byte t = byte_of(r.words, kn);
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (t.live) {
      const float scale = r.scales[t.cell][t.k];
      const uint8_t* cd = r.codes[t.cell][t.k];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = min(t.base + __popc(t.bits & ((1u << i) - 1u)), cap_t - 1);
        const uint32_t code = cd[s >> 1];
        const float level = lut[(s & 1) ? (code >> 4) : (code & 0x0Fu)];
        v[i] = ((t.bits >> i) & 1u) ? level * scale : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        // one round-to-nearest-even per entry, column 2h in the low half
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
        packed[h] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    *reinterpret_cast<uint4*>(&w.v[t.k][t.c8]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

}  // namespace splitk
}  // namespace salr
