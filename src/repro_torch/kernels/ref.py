"""Plain PyTorch versions of the CUDA kernels: the same function in
plain tensor ops.  The kernel wrappers (``ops``) run these for tensors on
the CPU; on the GPU they are the yardstick the kernels are held to."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.quant import nf4_dequant_2d, nf4_levels

NEG_INF = -1e30


def bitmap_spmm_ref(x: torch.Tensor, tbw: bm.TiledBitmapWeight) -> torch.Tensor:
    """y = x @ W_hat, f32 accumulation, one rounding to x's dtype."""
    return (x.float() @ bm.tile_decode(tbw).float()).to(x.dtype)


def salr_spmm_ref(x: torch.Tensor, tbw: bm.TiledBitmapWeight,
                  a_cat: torch.Tensor, b_cat: torch.Tensor) -> torch.Tensor:
    """y = x @ W_hat + (x @ A_cat) @ B_cat: f32 sums, u = x @ A_cat rounded
    to the operand dtype before its product with B_cat, one rounding of y."""
    base = x.float() @ bm.tile_decode(tbw).float()
    u = (x.float() @ a_cat.float()).to(b_cat.dtype)
    return (base + u.float() @ b_cat.float()).to(x.dtype)


def qsalr_spmm_ref(x: torch.Tensor, q: bm.QTiledBitmapWeight,
                   a_cat: torch.Tensor, b_cat: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(W_hat) + (x @ A_cat) @ B_cat: each stored value is
    NF4 level x cell scale in f32, rounded to x's dtype (as the weight
    tile enters the product); then the sums and roundings of
    :func:`salr_spmm_ref`."""
    base = x.float() @ bm.qtile_decode(q, dtype=x.dtype).float()
    u = (x.float() @ a_cat.float()).to(b_cat.dtype)
    return (base + u.float() @ b_cat.float()).to(x.dtype)


def _expert_rows_ref(x: torch.Tensor, row_e: torch.Tensor, n_experts: int, weight,
                     a_cat, b_cat, cols: int) -> torch.Tensor:
    """y[r] = x[r] @ W[e] + round(x[r] @ A_cat[e]) @ B_cat[e] for e =
    row_e[r]: f32 sums, u rounded to B_cat's dtype, one rounding of y.
    ``weight(e)`` is expert e's dense (K, cols) weight as it enters the
    product; ``a_cat`` None means no adapter.  Rows of no expert (outside
    [0, E)) come out zero whatever x holds there.  An expert with one row
    is multiplied with a zero row beside it: a one-row product may take
    another summation order than a GEMM (MKL's gemv does), and a row's
    result should not depend on how many rows share its expert."""
    y = torch.zeros((x.shape[0], cols), dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        idx = (row_e == e).nonzero().squeeze(1)
        if not idx.numel():
            continue
        xe = torch.nn.functional.pad(x[idx].float(), (0, 0, 0, int(idx.numel() == 1)))
        acc = xe @ weight(e).float()
        if a_cat is not None:
            u = (xe @ a_cat[e].float()).to(b_cat.dtype)
            acc = acc + u.float() @ b_cat[e].float()
        y[idx] = acc[:idx.numel()]
    return y.to(x.dtype)


def _expert(stack, e: int):
    """Expert e's slice of a stacked (Q)TiledBitmapWeight."""
    return dataclasses.replace(stack, **{f: getattr(stack, f)[e]
                                         for f in ("words", "values", "codes", "scales")
                                         if hasattr(stack, f)})


def _tile_rows(tile_expert: torch.Tensor, block_m: int) -> torch.Tensor:
    return tile_expert.repeat_interleave(block_m)


def grouped_salr_spmm_ref(x: torch.Tensor, tile_expert: torch.Tensor,
                          tbw: bm.TiledBitmapWeight, a_cat, b_cat, block_m: int) -> torch.Tensor:
    """The SALR op over expert-grouped rows: row r uses expert
    ``tile_expert[r // block_m]``'s tiled bitmap and adapters."""
    return _expert_rows_ref(x, _tile_rows(tile_expert, block_m), tbw.words.shape[0],
                            lambda e: bm.tile_decode(_expert(tbw, e)), a_cat, b_cat, tbw.cols)


def decode_salr_spmm_ref(x: torch.Tensor, row_expert: torch.Tensor,
                         tbw: bm.TiledBitmapWeight, a_cat, b_cat) -> torch.Tensor:
    """The SALR op over assignment rows: row r uses expert
    ``row_expert[r]`` (-1: a pad row, exact zeros)."""
    return _expert_rows_ref(x, row_expert, tbw.words.shape[0],
                            lambda e: bm.tile_decode(_expert(tbw, e)), a_cat, b_cat, tbw.cols)


def grouped_qsalr_spmm_ref(x: torch.Tensor, tile_expert: torch.Tensor,
                           q: bm.QTiledBitmapWeight, a_cat, b_cat, block_m: int) -> torch.Tensor:
    """:func:`grouped_salr_spmm_ref` over NF4 values: level x cell scale
    in f32, rounded to x's dtype as the weight enters the product."""
    return _expert_rows_ref(x, _tile_rows(tile_expert, block_m), q.words.shape[0],
                            lambda e: bm.qtile_decode(_expert(q, e), dtype=x.dtype),
                            a_cat, b_cat, q.cols)


def decode_qsalr_spmm_ref(x: torch.Tensor, row_expert: torch.Tensor,
                          q: bm.QTiledBitmapWeight, a_cat, b_cat) -> torch.Tensor:
    """:func:`decode_salr_spmm_ref` over NF4 values."""
    return _expert_rows_ref(x, row_expert, q.words.shape[0],
                            lambda e: bm.qtile_decode(_expert(q, e), dtype=x.dtype),
                            a_cat, b_cat, q.cols)


def grouped_dense_spmm_ref(x: torch.Tensor, tile_expert: torch.Tensor, w: torch.Tensor,
                           a_cat, b_cat, block_m: int) -> torch.Tensor:
    """The SALR op over expert-grouped rows of a dense (E, K, N) stack:
    row r uses expert ``tile_expert[r // block_m]``'s weight (as x's
    dtype) and adapters (``a_cat`` None: no adapter term)."""
    return _expert_rows_ref(x, _tile_rows(tile_expert, block_m), w.shape[0],
                            lambda e: w[e].to(x.dtype), a_cat, b_cat, w.shape[-1])


def decode_dense_spmm_ref(x: torch.Tensor, row_expert: torch.Tensor, w: torch.Tensor,
                          a_cat, b_cat) -> torch.Tensor:
    """The SALR op over assignment rows of a dense stack: row r uses
    expert ``row_expert[r]`` (-1: a pad row, exact zeros)."""
    return _expert_rows_ref(x, row_expert, w.shape[0], lambda e: w[e].to(x.dtype),
                            a_cat, b_cat, w.shape[-1])


def _nm_expert(nmw: bm.NMWeight, e: int, dtype) -> torch.Tensor:
    """Expert e of a stacked N:M weight decoded exactly, as ``dtype``."""
    return bm.nm_decode(dataclasses.replace(nmw, group_bits=nmw.group_bits[e],
                                            values=nmw.values[e])).to(dtype)


def grouped_nm_spmm_ref(x: torch.Tensor, tile_expert: torch.Tensor, nmw: bm.NMWeight,
                        a_cat, b_cat, block_m: int) -> torch.Tensor:
    """The SALR op over expert-grouped rows of an N:M stack (group bits
    (E, K, N/m), values (E, K, N/m*n)), each expert decoded exactly."""
    return _expert_rows_ref(x, _tile_rows(tile_expert, block_m), nmw.group_bits.shape[0],
                            lambda e: _nm_expert(nmw, e, x.dtype), a_cat, b_cat, nmw.cols)


def decode_nm_spmm_ref(x: torch.Tensor, row_expert: torch.Tensor, nmw: bm.NMWeight,
                       a_cat, b_cat) -> torch.Tensor:
    """The SALR op over assignment rows of an N:M stack."""
    return _expert_rows_ref(x, row_expert, nmw.group_bits.shape[0],
                            lambda e: _nm_expert(nmw, e, x.dtype), a_cat, b_cat, nmw.cols)


def nm_spmm_ref(x: torch.Tensor, nmw: bm.NMWeight) -> torch.Tensor:
    """y = x @ W_hat for an N:M base: an exact decode (the weight as x's
    dtype, as the tile enters the product), f32 sum, one rounding."""
    return (x.float() @ bm.nm_decode(nmw).to(x.dtype).float()).to(x.dtype)


def fused_lora_ref(x: torch.Tensor, a_cat: torch.Tensor,
                   b_cat: torch.Tensor) -> torch.Tensor:
    """y = (x @ A_cat) @ B_cat: u = x @ A_cat summed in f32 and rounded to
    B_cat's dtype, then u @ B_cat summed in f32 and rounded to x's."""
    u = (x.float() @ a_cat.float()).to(b_cat.dtype)
    return (u.float() @ b_cat.float()).to(x.dtype)


def nf4_spmm_ref(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(codes, scales): each weight NF4 level x block scale
    in f32, rounded to x's dtype before the product; f32 sum, one rounding."""
    w = nf4_dequant_2d(codes, scales).to(x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a dense cache.

    q: (B, 1, H, dk); caches: (B, W, KH, d); valid: (W,) or (B, W) bool.
    f32 scores over 1/sqrt(dk), NEG_INF where not valid, softmax, f32 PV.
    V rows that are not valid are zeroed first, so whatever a dead
    position holds (even NaN) cannot reach the output."""
    b, _, h, dk = q.shape
    kh = k_cache.shape[2]
    if valid.ndim == 1:
        valid = valid[None].expand(b, -1)
    qg = q.reshape(b, kh, h // kh, dk).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(dk)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    v = torch.where(valid[:, :, None, None], v_cache.float(), 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(b, 1, h, -1).to(q.dtype)


def paged_gqa_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over paged pools: gather each slot's pages
    into a dense (B, max_pages*page_size) cache, attend over positions
    <= pos[b]."""
    k, v = _gather_pages(k_pool, page_table), _gather_pages(v_pool, page_table)
    return decode_attention(q, k, v, _valid(pos, k.shape[1]))


def mla_attention(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
                  krope: torch.Tensor, valid: torch.Tensor, qk_dim: int) -> torch.Tensor:
    """MLA absorbed decode over a dense latent cache, all in f32.

    q_lat: (B, H, R) f32 (q_nope absorbed through W_uk); q_rope: (B, H,
    rd) f32; ckv: (B, W, R); krope: (B, W, rd); valid: (B, W) bool.
    Scores q_lat.ckv + q_rope.krope over sqrt(qk_dim), NEG_INF where not
    valid, softmax, o_lat = p.ckv (B, H, R) f32.  Latent rows that are
    not valid are zeroed first, so whatever a dead position holds (even
    NaN) cannot reach the output."""
    ckv_f = torch.where(valid[..., None], ckv.float(), 0.0)
    s = (torch.einsum("bhr,bkr->bhk", q_lat, ckv_f)
         + torch.einsum("bhd,bkd->bhk", q_rope, krope.float()))
    s = s / math.sqrt(qk_dim)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    return torch.einsum("bhk,bkr->bhr", torch.softmax(s, dim=-1), ckv_f)


def paged_mla_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                            ckv_pool: torch.Tensor, krope_pool: torch.Tensor,
                            page_table: torch.Tensor, pos: torch.Tensor,
                            qk_dim: int) -> torch.Tensor:
    """MLA absorbed decode over paged latent pools: gather each slot's
    pages into a dense (B, max_pages*page_size) latent cache, then
    :func:`mla_attention` over positions <= pos[b]."""
    ckv, krope = _gather_pages(ckv_pool, page_table), _gather_pages(krope_pool, page_table)
    return mla_attention(q_lat, q_rope, ckv, krope, _valid(pos, ckv.shape[1]), qk_dim)


def _valid(pos: torch.Tensor, w: int) -> torch.Tensor:
    return torch.arange(w, device=pos.device)[None, :] <= pos[:, None]


def _gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, ...) pool -> (B, max_pages*ps, ...) dense rows of each slot."""
    g = pool[page_table.long()]
    return g.reshape(page_table.shape[0], -1, *pool.shape[2:])


def ring_quant_gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 k_scale: torch.Tensor, v_scale: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a dense int8 cache: each entry
    dequantized as int8 -> f32 x scale -> q's dtype -> f32, then
    :func:`decode_attention` over positions <= pos[b]."""
    k_read = (k.float() * k_scale[..., None]).to(q.dtype)
    v_read = (v.float() * v_scale[..., None]).to(q.dtype)
    return decode_attention(q, k_read, v_read, _valid(pos, k.shape[1]))


def _nf4_halves(codes: torch.Tensor, scale: torch.Tensor, dtype) -> tuple:
    """Split-packed NF4 rows -> the two head-dim halves (low nibbles ->
    [0, d/2), high -> [d/2, d)), level x scale in f32, rounded to
    ``dtype``, widened to f32."""
    levels = nf4_levels(codes.device)
    lo = levels[(codes & 0x0F).long()] * scale[..., None]
    hi = levels[(codes >> 4).long()] * scale[..., None]
    return lo.to(dtype).float(), hi.to(dtype).float()


def ring_nf4_gqa_attention_ref(q: torch.Tensor, k_codes: torch.Tensor,
                               v_codes: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a dense NF4 cache (split packing): the
    score is the sum of two half-width dots (low and high nibbles), the
    PV product is taken per half; f32 throughout, dead positions masked
    and their V rows zeroed, one rounding to q's dtype."""
    b, _, h, dk = q.shape
    w, kh = k_codes.shape[1], k_codes.shape[2]
    valid = _valid(pos, w)
    k_lo, k_hi = _nf4_halves(k_codes, k_scale, q.dtype)
    v_lo, v_hi = _nf4_halves(v_codes, v_scale, q.dtype)
    qg = q.reshape(b, kh, h // kh, dk).float()
    d2 = dk // 2
    s = (torch.einsum("bhgd,bkhd->bhgk", qg[..., :d2], k_lo)
         + torch.einsum("bhgd,bkhd->bhgk", qg[..., d2:], k_hi)) / math.sqrt(dk)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    live = valid[:, :, None, None]
    out = torch.cat([torch.einsum("bhgk,bkhd->bhgd", p, torch.where(live, vh, 0.0))
                     for vh in (v_lo, v_hi)], dim=-1)
    return out.reshape(b, 1, h, -1).to(q.dtype)


def paged_quant_gqa_attention_ref(q, k_pool, v_pool, ks_pool, vs_pool, page_table,
                                  pos) -> torch.Tensor:
    """:func:`ring_quant_gqa_attention_ref` over each slot's pages
    gathered into dense rows."""
    return ring_quant_gqa_attention_ref(
        q, *(_gather_pages(t, page_table) for t in (k_pool, v_pool, ks_pool, vs_pool)),
        pos)


def paged_nf4_gqa_attention_ref(q, k_pool, v_pool, ks_pool, vs_pool, page_table,
                                pos) -> torch.Tensor:
    """:func:`ring_nf4_gqa_attention_ref` over each slot's pages gathered
    into dense rows."""
    return ring_nf4_gqa_attention_ref(
        q, *(_gather_pages(t, page_table) for t in (k_pool, v_pool, ks_pool, vs_pool)),
        pos)
