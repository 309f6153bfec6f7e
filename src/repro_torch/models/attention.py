"""GQA attention with native-precision KV caches: blockwise (online
softmax) attention for train/prefill, one-token decode over a dense
slot cache (plain torch) or a paged pool (the paged-attention kernel).

Caches are updated IN PLACE at decode (the reference builds new arrays
each step): the engine owns one cache for its lifetime, and an in-place
write saves a full cache copy per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, decode_attention
from repro_torch.models.layers import (apply_linear, apply_rmsnorm, apply_rope,
                                       init_linear, init_rmsnorm)

@dataclasses.dataclass
class KVCache:
    """Full-context cache; position i of row b lives at [b, i]."""
    k: torch.Tensor   # (B, W, KH, dk)
    v: torch.Tensor   # (B, W, KH, dv)


@dataclasses.dataclass
class PagedKVCache:
    """Block-paged cache: a global page pool with no batch axis.  Pool
    page ``page_table[slot, j]`` holds the slot's positions
    [j*page_size, (j+1)*page_size); page 0 is the reserved null page that
    dead page-table entries point at."""
    k: torch.Tensor   # (P, page_size, KH, dk)
    v: torch.Tensor   # (P, page_size, KH, dv)


def pos_vector(pos, batch: int, device) -> torch.Tensor:
    """Decode position(s) -- a scalar or a (B,) vector -- as (B,) int32."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(batch).contiguous()


def _pick_chunk(n: int, pref: int) -> int:
    """Largest chunk <= pref that divides n."""
    c = max(1, min(pref, n))
    while n % c:
        c -= 1
    return c


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention, chunk for chunk the reference's order.

    q: (B, Sq, H, dk); k: (B, Skv, KH, dk); v: (B, Skv, KH, dv); H % KH == 0.
    ``q_offset`` is the absolute position of q[0] (continuation prefill);
    causal masking compares absolute positions.  Scores are f32 sums of
    operand-dtype products; probabilities are cast to v's dtype before
    the f32 PV sum.  Each q chunk visits only the KV blocks it can see.
    Returns (B, Sq, H, dv)."""
    b, sq, h, dk = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    q_chunk = _pick_chunk(sq, q_chunk)
    kv_chunk = _pick_chunk(skv, kv_chunk)
    n_kv = skv // kv_chunk
    scale = 1.0 / math.sqrt(dk)
    qg = q.reshape(b, sq, kh, g, dk)
    dev = q.device

    outs = []
    for q_lo in range(0, sq, q_chunk):
        q_hi_abs = q_offset + q_lo + q_chunk - 1
        blk_hi = min(n_kv, q_hi_abs // kv_chunk + 1) if causal else n_kv
        qc = qg[:, q_lo:q_lo + q_chunk].float()
        q_pos = q_offset + q_lo + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kh, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l_sum = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, q_chunk, dv), dtype=torch.float32, device=dev)
        for blk in range(blk_hi):
            kc = k[:, blk * kv_chunk:(blk + 1) * kv_chunk]
            vc = v[:, blk * kv_chunk:(blk + 1) * kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc.float()) * scale
            if causal:
                k_pos = blk * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = k_pos[None, :] <= q_pos[:, None]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l_sum.clamp(min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def init_gqa(gen: torch.Generator, cfg: ArchConfig, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"norm": init_rmsnorm(d, cfg, device),
            "wq": init_linear(gen, d, cfg.n_heads * hd, cfg, "attn", device),
            "wk": init_linear(gen, d, cfg.n_kv_heads * hd, cfg, "attn", device),
            "wv": init_linear(gen, d, cfg.n_kv_heads * hd, cfg, "attn", device),
            "wo": init_linear(gen, cfg.n_heads * hd, d, cfg, "attn", device)}


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, hd)


def apply_gqa(p, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
              mode: str, cache=None, pos=None, route=None,
              page_table: Optional[torch.Tensor] = None,
              prefix: Optional[KVCache] = None, q_offset: int = 0):
    """GQA self-attention.  mode: train | prefill | decode.  Returns
    (x + y, cache): prefill builds a dense KVCache of this call's
    positions; decode writes the step's K/V into ``cache`` in place.

    ``prefix`` (dense batch=1 KVCache, prefill only) + ``q_offset``:
    continuation prefill for radix prefix sharing -- attend over the
    shared prefix's K/V (absolute positions [0, q_offset)) followed by
    this call's suffix, but cache only the suffix.  ``page_table``
    (decode only) maps slots to pool pages when ``cache`` is paged."""
    hd = cfg.resolved_head_dim
    h, kh = cfg.n_heads, cfg.n_kv_heads
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)
    q = _split_heads(apply_linear(p["wq"], xn, route), h, hd)
    k = _split_heads(apply_linear(p["wk"], xn, route), kh, hd)
    v = _split_heads(apply_linear(p["wv"], xn, route), kh, hd)

    if mode in ("train", "prefill"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if prefix is not None:
            k_att = torch.cat([prefix.k.to(k.dtype), k], dim=1)
            v_att = torch.cat([prefix.v.to(v.dtype), v], dim=1)
        else:
            k_att, v_att = k, v
        y = blockwise_attention(q, k_att, v_att, causal=True, q_offset=q_offset)
        new_cache = KVCache(k=k, v=v) if mode == "prefill" else None
    else:
        b = x.shape[0]
        pv = pos_vector(pos, b, x.device)
        rows = torch.arange(b, device=x.device)
        q = apply_rope(q, pv[:, None], cfg.rope_theta)
        k = apply_rope(k, pv[:, None], cfg.rope_theta)
        if isinstance(cache, PagedKVCache):
            ps = cache.k.shape[1]
            pages = page_table[rows, (pv // ps).long()]
            off = (pv % ps).long()
            cache.k[pages, off] = k[:, 0]
            cache.v[pages, off] = v[:, 0]
            y = ops.paged_gqa_attention(q, cache.k, cache.v, page_table, pv)
        elif isinstance(cache, KVCache):
            cache.k[rows, pv.long()] = k[:, 0]
            cache.v[rows, pv.long()] = v[:, 0]
            valid = torch.arange(cache.k.shape[1], device=x.device)[None, :] <= pv[:, None]
            y = decode_attention(q, cache.k, cache.v, valid)
        else:
            raise TypeError(f"decode needs a KVCache or PagedKVCache, got {type(cache)}")
        new_cache = cache
    y = apply_linear(p["wo"], y.reshape(*y.shape[:2], h * hd), route)
    return x + y, new_cache


def init_gqa_cache(cfg: ArchConfig, batch: int, ctx: int, dtype, device) -> KVCache:
    shape = (batch, ctx, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_paged_gqa_cache(cfg: ArchConfig, n_pages: int, page_size: int, dtype,
                         device) -> PagedKVCache:
    """Global K/V page pool (page 0 = reserved null page)."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))
