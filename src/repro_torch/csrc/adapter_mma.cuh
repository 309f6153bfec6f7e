// The adapter term's second product on the tensor cores, shared by
// fused_lora.cu (its output pass) and salr_spmm.cu (the bf16 salr_spmm and
// qsalr_spmm kernels): for a block's BM rows from m0 and BN columns from n0,
//
//     acc = bf16(u) @ B_cat[:, n0:n0 + BN],  u = ws[0] + ws[1] + ... + ws[S-1],
//
// where ws holds the u pass's f32 partials (S, M, R) of u = x @ A_cat,
// summed in slice order and rounded once to bf16 (the reference's
// u.astype(b.dtype)).  The block's rows of u (all R of them, up to MAX_RANK
// at a time) go to shared memory beside B_cat's (R, BN) column tile, copied
// with cp.async, and the two are multiplied with ldmatrix fragments, R / 16
// k16 steps.  R beyond MAX_RANK is walked MAX_RANK rows at a time, each
// chunk's product from a zeroed accumulator and the chunks added in order,
// so no f32 accumulator runs over more than MAX_RANK rows.  The sums and
// their order depend on neither M nor the block, so a row's bits do not
// depend on the batch it came in.
#pragma once

#include "splitk_gemm.cuh"

namespace salr {
namespace splitk {

constexpr int MAX_RANK = 256;     // rows of B_cat (and columns of u) a chunk holds
constexpr int ULD = MAX_RANK + 8; // u row pitch (bf16): ldmatrix rows on distinct banks

struct AdapterShared {
  uint16_t u[BM][ULD];
  uint16_t b[MAX_RANK][WLD];
};

// u[i][c] = bf16(ws[0][i][c] + ws[1][i][c] + ... + ws[S-1][i][c]) for the
// block's `rows` rows and the chunk's `rc` columns, f32 in slice order.  ws
// points at the block's first row and the chunk's first column; rows are R
// floats apart and slices MR.  With R a multiple of 4, a thread sums 4
// neighbouring entries, SB slices' 16-byte loads made before their adds
// (one round of loads at fused_lora's at most 8 slices).
__device__ __forceinline__ void sum_u(uint16_t (*u)[ULD], const float* __restrict__ ws, int S,
                                      size_t MR, int rows, int rc, int R) {
  constexpr int SB = 8;
  if (R % 4) {  // one entry at a time
    for (int i = threadIdx.x; i < rows * rc; i += THREADS) {
      const int row = i / rc, c = i - row * rc;
      const float* src = ws + static_cast<size_t>(row) * R + c;
      float t = src[0];
      for (int sl = 1; sl < S; ++sl) t += src[sl * MR];
      u[row][c] = __bfloat16_as_ushort(__float2bfloat16(t));
    }
    return;
  }
  const int q = rc / 4;  // ws 16-byte aligned: R floats a row, chunks start at multiples of 4
  for (int i = threadIdx.x; i < rows * q; i += THREADS) {
    const int row = i / q, c = (i - row * q) * 4;
    const float* src = ws + static_cast<size_t>(row) * R + c;
    float4 t = *reinterpret_cast<const float4*>(src);
    for (int s0 = 1; s0 < S; s0 += SB) {
      float4 v[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j)
        if (s0 + j < S) v[j] = *reinterpret_cast<const float4*>(src + (s0 + j) * MR);
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        if (s0 + j < S) {
          t.x += v[j].x;
          t.y += v[j].y;
          t.z += v[j].z;
          t.w += v[j].w;
        }
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(t.x, t.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(t.z, t.w);
    *reinterpret_cast<uint2*>(&u[row][c]) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                       *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// acc = the block's rows [m0, m0 + BM) of bf16(u) @ b[:, n0:n0 + BN] (the
// warp's fragments, as the walk's; rows past M and columns past N give
// zeros), u from the S partials in ws (S, M, R) as above; b is (R, N) bf16.
// FAST: b 16-byte aligned and N a multiple of 8, so B_cat's rows are copied
// in 16-byte chunks.  All threads of the block call it; it leaves after a
// barrier that follows its last write to shared memory, without one after
// its last read.
template <bool FAST>
__device__ __forceinline__ void adapter_product(AdapterShared& s, const float* __restrict__ ws,
                                                int S, const bf16* __restrict__ b, int M, int R,
                                                int N, int m0, int n0,
                                                float acc[WN / 8][4]) {
  const int width = min(BN, N - n0), rows = min(BM, M - m0);
  for (int r0 = 0; r0 < R; r0 += MAX_RANK) {
    const int rc = min(MAX_RANK, R - r0), rp = (rc + 15) / 16 * 16;
    if (r0) __syncthreads();  // every warp is done with the last chunk's tiles
    // B_cat's rows [r0, r0 + rc) at the tile's columns, zero past N and on
    // [rc, rp)
    const char* src = reinterpret_cast<const char*>(b + static_cast<size_t>(r0) * N + n0);
    if constexpr (FAST) {
      for (int i = threadIdx.x; i < rc * (BN / 8); i += THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 16;
        char* d = reinterpret_cast<char*>(s.b[r]) + c;
        if (c < width * 2) copy_chunk<16>(d, src + static_cast<size_t>(r) * N * 2 + c);
        else zero_chunk<16>(d);
      }
    } else {
      copy_rows(s.b, WLD * 2, src, static_cast<size_t>(N) * 2, rc, BN * 2, width * 2);
    }
    for (int i = threadIdx.x; i < (rp - rc) * (WLD / 8); i += THREADS)
      *reinterpret_cast<uint4*>(&s.b[rc + i / (WLD / 8)][8 * (i % (WLD / 8))]) =
          make_uint4(0u, 0u, 0u, 0u);
    cp_async_commit();
    // u = the slices' sum in slice order, rounded once; zero past M and rc
    for (int i = threadIdx.x; i < (BM - rows) * rp; i += THREADS)
      s.u[rows + i / rp][i % rp] = 0;
    for (int i = threadIdx.x; i < rows * (rp - rc); i += THREADS)
      s.u[i / (rp - rc)][rc + i % (rp - rc)] = 0;
    sum_u(s.u, ws + static_cast<size_t>(m0) * R + r0, S, static_cast<size_t>(M) * R, rows, rc,
          R);
    cp_async_wait<0>();
    __syncthreads();
    float part[WN / 8][4] = {};
    if (m0 + warp_row0() < M) {
      for (int kk = 0; kk < rp; kk += 16) mma_k16<ULD>(s.u, s.b, kk, part);
    }
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = r0 == 0 ? part[j][q] : acc[j][q] + part[j][q];
  }
}

}  // namespace splitk
}  // namespace salr
