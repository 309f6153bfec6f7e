"""Plain PyTorch versions of the CUDA kernels: the same function in
plain tensor ops.  The kernel wrappers (``ops``) run these for tensors on
the CPU; on the GPU they are the yardstick the kernels are held to."""
from __future__ import annotations

import math

import torch

from repro_torch.core import bitmap as bm

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
    b = q.shape[0]
    n_pages, ps = page_table.shape[1], k_pool.shape[1]
    w = n_pages * ps
    k = k_pool[page_table].reshape(b, w, *k_pool.shape[2:])
    v = v_pool[page_table].reshape(b, w, *v_pool.shape[2:])
    valid = torch.arange(w, device=q.device)[None, :] <= pos[:, None]
    return decode_attention(q, k, v, valid)
