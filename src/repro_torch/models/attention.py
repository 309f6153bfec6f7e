"""GQA and MLA attention: blockwise (online softmax) attention for train
and prefill, one-token decode over a dense slot cache or a paged pool.

KV caches come in three precisions: native (the model dtype), int8 and
NF4, each with one f32 absmax scale per (position, KV head).  Decode over
a native dense cache is plain torch; every other decode runs a kernel
(paged native, ring/paged int8, ring/paged NF4) on the kernel route and
that kernel's plain version on the reference route.  NF4 KV codes use the
SPLIT nibble layout (byte i of a head-dim row holds element i low and
element i + d/2 high), unlike the weights' interleaved layout.

MLA (DeepSeek) caches only the compressed latent c_kv and the shared rope
key per position (``LatentCache``, ``PagedLatentCache``), always in the
model dtype; its decode absorbs W_uk into the query and attends in latent
space (``ops.paged_mla_attention`` on paged pools).

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
from repro_torch.core.quant import nf4_index, nf4_levels
from repro_torch.core.salr import SALRLinear, effective_weight
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF, decode_attention, mla_attention
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


@dataclasses.dataclass
class QuantKVCache:
    """int8 dense cache with per-(position, KV head) absmax scales."""
    k: torch.Tensor        # (B, W, KH, dk) int8
    v: torch.Tensor        # (B, W, KH, dv) int8
    k_scale: torch.Tensor  # (B, W, KH) f32
    v_scale: torch.Tensor  # (B, W, KH) f32


@dataclasses.dataclass
class NF4KVCache:
    """NF4 dense cache: split-packed codes with per-(position, KV head)
    absmax scales."""
    k: torch.Tensor        # (B, W, KH, dk/2) uint8
    v: torch.Tensor        # (B, W, KH, dv/2) uint8
    k_scale: torch.Tensor  # (B, W, KH) f32
    v_scale: torch.Tensor  # (B, W, KH) f32


@dataclasses.dataclass
class PagedQuantKVCache:
    """Paged int8 pools + per-(position, KV head) scales."""
    k: torch.Tensor        # (P, page_size, KH, dk) int8
    v: torch.Tensor        # (P, page_size, KH, dv) int8
    k_scale: torch.Tensor  # (P, page_size, KH) f32
    v_scale: torch.Tensor  # (P, page_size, KH) f32


@dataclasses.dataclass
class PagedNF4KVCache:
    """Paged NF4 code pools (split packing) + per-(position, KV head)
    scales."""
    k: torch.Tensor        # (P, page_size, KH, dk/2) uint8
    v: torch.Tensor        # (P, page_size, KH, dv/2) uint8
    k_scale: torch.Tensor  # (P, page_size, KH) f32
    v_scale: torch.Tensor  # (P, page_size, KH) f32


@dataclasses.dataclass
class LatentCache:
    """MLA cache: latent c_kv + shared rope key; position i of row b lives
    at [b, i]."""
    ckv: torch.Tensor     # (B, W, kv_rank)
    krope: torch.Tensor   # (B, W, rope_dim)


@dataclasses.dataclass
class PagedLatentCache:
    """Paged MLA latent pools (page 0 the null page, as ``PagedKVCache``)."""
    ckv: torch.Tensor     # (P, page_size, kv_rank)
    krope: torch.Tensor   # (P, page_size, rope_dim)


def q8(x: torch.Tensor):
    """x: (..., d) -> (int8 codes, f32 scale (...)): absmax / 127 per row,
    round half to even, clip to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dq8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 -> f32 x scale -> ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def qnf4(x: torch.Tensor):
    """x: (..., d) -> (split-packed uint8 codes (..., d/2), f32 absmax
    scale (...)): byte i holds element i low and element i + d/2 high."""
    d = x.shape[-1]
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8)
    idx = nf4_index(xf / scale[..., None])
    return idx[..., :d // 2] | (idx[..., d // 2:] << 4), scale


def dqnf4(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`qnf4`: low nibbles -> head dims [0, d/2), high
    nibbles -> [d/2, d); level x scale in f32, then ``dtype``."""
    levels = nf4_levels(codes.device)
    idx = torch.cat([codes & 0x0F, codes >> 4], dim=-1).long()
    return (levels[idx] * scale[..., None]).to(dtype)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, kv_dtype: str):
    """A dense cache of native K/V at ``kv_dtype`` (native, int8, nf4)."""
    if kv_dtype == "native":
        return KVCache(k=k, v=v)
    fn, cls = {"int8": (q8, QuantKVCache), "nf4": (qnf4, NF4KVCache)}[kv_dtype]
    (kq, ks), (vq, vs) = fn(k), fn(v)
    return cls(k=kq, v=vq, k_scale=ks, v_scale=vs)


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
            "wq": init_linear(gen, d, cfg.n_heads * hd, cfg, "attn", device,
                              transposed=True),
            "wk": init_linear(gen, d, cfg.n_kv_heads * hd, cfg, "attn", device,
                              transposed=True),
            "wv": init_linear(gen, d, cfg.n_kv_heads * hd, cfg, "attn", device,
                              transposed=True),
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
        new_cache = None
        if mode == "prefill":
            new_cache = quantize_kv(k, v, getattr(route, "kv_dtype", "native"))
    else:
        b = x.shape[0]
        pv = pos_vector(pos, b, x.device)
        rows = torch.arange(b, device=x.device)
        q = apply_rope(q, pv[:, None], cfg.rope_theta)
        k = apply_rope(k, pv[:, None], cfg.rope_theta)
        if isinstance(cache, (PagedKVCache, PagedQuantKVCache, PagedNF4KVCache)):
            ps = cache.k.shape[1]
            where = (page_table[rows, (pv // ps).long()], (pv % ps).long())
        elif isinstance(cache, (KVCache, QuantKVCache, NF4KVCache)):
            where = (rows, pv.long())
        else:
            raise TypeError(f"decode needs a KV cache, got {type(cache)}")
        _write(cache, where, quantize_kv(k, v, KV_DTYPE_OF[type(cache)]))
        if type(cache) is KVCache:
            valid = torch.arange(cache.k.shape[1], device=x.device)[None, :] <= pv[:, None]
            y = decode_attention(q, cache.k, cache.v, valid)
        else:
            # the reference route reads the cache through the kernel's
            # plain version, so no kernel takes part in a reference run
            name, paged = _DECODE_ATTENTION[type(cache)]
            fn = (getattr(ref, name + "_ref") if getattr(route, "linear", None) == "reference"
                  else getattr(ops, name))
            kv = [getattr(cache, f.name) for f in dataclasses.fields(cache)]  # k, v[, scales]
            y = fn(q, *kv, *((page_table,) if paged else ()), pv)
        new_cache = cache
    y = apply_linear(p["wo"], y.reshape(*y.shape[:2], h * hd), route)
    return x + y, new_cache


# the KV precision each cache type stores (MLA latents: the model dtype)
KV_DTYPE_OF = {KVCache: "native", QuantKVCache: "int8", NF4KVCache: "nf4",
               PagedKVCache: "native", PagedQuantKVCache: "int8", PagedNF4KVCache: "nf4",
               LatentCache: "native", PagedLatentCache: "native"}
# the decode-attention kernel (ops) and plain version (ref, + "_ref") of
# each cache type a kernel reads, and whether it takes a page table
_DECODE_ATTENTION = {PagedKVCache: ("paged_gqa_attention", True),
                     PagedQuantKVCache: ("paged_quant_gqa_attention", True),
                     PagedNF4KVCache: ("paged_nf4_gqa_attention", True),
                     QuantKVCache: ("ring_quant_gqa_attention", False),
                     NF4KVCache: ("ring_nf4_gqa_attention", False)}


def _write(cache, where: tuple, step) -> None:
    """Write one position per row (``step``: a cache of the same precision
    holding (B, 1, ...) entries) at ``where`` = (row or page, position or
    offset) index tensors, in place."""
    for f in dataclasses.fields(cache):
        getattr(cache, f.name)[where] = getattr(step, f.name)[:, 0]


def _alloc(lead: tuple, cfg: ArchConfig, dtype, kv_dtype: str, device, paged: bool):
    """Zero K/V (and scales) of shape ``lead + (KH, d)`` at ``kv_dtype``."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_dtype == "native":
        cls = PagedKVCache if paged else KVCache
        return cls(*(torch.zeros(lead + (kh, hd), dtype=dtype, device=device)
                     for _ in range(2)))
    if kv_dtype not in ("int8", "nf4"):
        raise ValueError(f"unknown KV dtype {kv_dtype!r}")
    int8 = kv_dtype == "int8"
    cls = {(True, False): QuantKVCache, (False, False): NF4KVCache,
           (True, True): PagedQuantKVCache, (False, True): PagedNF4KVCache}[int8, paged]
    codes = lead + (kh, hd if int8 else hd // 2)
    cdt = torch.int8 if int8 else torch.uint8
    return cls(k=torch.zeros(codes, dtype=cdt, device=device),
               v=torch.zeros(codes, dtype=cdt, device=device),
               k_scale=torch.zeros(lead + (kh,), dtype=torch.float32, device=device),
               v_scale=torch.zeros(lead + (kh,), dtype=torch.float32, device=device))


def init_gqa_cache(cfg: ArchConfig, batch: int, ctx: int, dtype, device,
                   kv_dtype: str = None):
    """Dense (batch, ctx) cache at ``kv_dtype`` (default ``cfg.kv_cache``)."""
    return _alloc((batch, ctx), cfg, dtype, kv_dtype or cfg.kv_cache, device, False)


def init_paged_gqa_cache(cfg: ArchConfig, n_pages: int, page_size: int, dtype,
                         device, kv_dtype: str = None):
    """Global K/V page pool (page 0 = reserved null page) at ``kv_dtype``
    (default ``cfg.kv_cache``)."""
    return _alloc((n_pages, page_size), cfg, dtype, kv_dtype or cfg.kv_cache, device,
                  True)


# ------------------------------------------------------------------ MLA

def init_mla(gen: torch.Generator, cfg: ArchConfig, device):
    """MLA projections: dq, uq, dkv, uk, uv store W^T when flat (the
    reference builds them transposed), wo does not."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def lin(d_in, d_out, transposed=True):
        return init_linear(gen, d_in, d_out, cfg, "attn", device, transposed=transposed)
    return {"norm": init_rmsnorm(d, cfg, device),
            "dq": lin(d, m.q_lora_rank),
            "qnorm": init_rmsnorm(m.q_lora_rank, cfg, device),
            "uq": lin(m.q_lora_rank, h * qk),
            "dkv": lin(d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kvnorm": init_rmsnorm(m.kv_lora_rank, cfg, device),
            "uk": lin(m.kv_lora_rank, h * m.qk_nope_head_dim),
            "uv": lin(m.kv_lora_rank, h * m.v_head_dim),
            "wo": lin(h * m.v_head_dim, d, transposed=False)}


def _mla_q(p, xn: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, route):
    """(q_nope, q_rope) (B, S, H, nope / rope), q_rope rotated."""
    m = cfg.mla
    b, s, _ = xn.shape
    cq = apply_rmsnorm(p["qnorm"], apply_linear(p["dq"], xn, route), cfg.norm_eps)
    q = apply_linear(p["uq"], cq, route).reshape(b, s, cfg.n_heads, -1)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, xn: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, route):
    """(c_kv normed (B, S, R), rope key rotated (B, S, rope))."""
    m = cfg.mla
    ckv, krope = apply_linear(p["dkv"], xn, route).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = apply_rmsnorm(p["kvnorm"], ckv, cfg.norm_eps)
    return ckv, apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]


def _mla_kv(p, ckv: torch.Tensor, krope: torch.Tensor, cfg: ArchConfig, route):
    """Decompressed per-head K (nope through W_uk, the shared rope key
    broadcast) and V (through W_uv) of latents (B, S, R) / (B, S, rope)."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = ckv.shape
    k_nope = apply_linear(p["uk"], ckv, route).reshape(b, s, h, m.qk_nope_head_dim)
    v = apply_linear(p["uv"], ckv, route).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
                   .to(k_nope.dtype)], dim=-1)
    return k, v


def _dense_weight(lin) -> torch.Tensor:
    """The effective dense (d_in, d_out) weight of a (possibly SALR)
    linear, rebuilt on every call as the reference does."""
    return effective_weight(lin) if isinstance(lin, SALRLinear) else lin["w"]


def apply_mla(p, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor, mode: str,
              cache=None, pos=None, route=None, page_table: Optional[torch.Tensor] = None,
              prefix: Optional[LatentCache] = None, q_offset: int = 0):
    """MLA attention.  mode: train | prefill | decode.  Returns (x + y,
    cache).  Prefill decompresses q, k, v and runs blockwise attention,
    caching only (c_kv, k_rope) of this call's positions; a shared
    ``prefix`` (dense batch=1 LatentCache) is decompressed again through
    W_uk / W_uv and attended before the suffix (see ``apply_gqa``).
    Decode writes the step's latents into ``cache`` in place and absorbs
    W_uk into the query (q_lat = q_nope . W_uk^T), attends over the
    latents -- ``ops.paged_mla_attention`` on paged pools (its plain
    version on the reference route), plain torch on a slot
    ``LatentCache`` -- then applies W_uv and wo."""
    m, h = cfg.mla, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)

    if mode in ("train", "prefill"):
        q_nope, q_rope = _mla_q(p, xn, cfg, positions, route)
        ckv, krope = _mla_latent(p, xn, cfg, positions, route)
        k, v = _mla_kv(p, ckv, krope, cfg, route)
        if prefix is not None:
            k_p, v_p = _mla_kv(p, prefix.ckv, prefix.krope, cfg, route)
            k = torch.cat([k_p.to(k.dtype), k], dim=1)
            v = torch.cat([v_p.to(v.dtype), v], dim=1)
        y = blockwise_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
                                q_offset=q_offset)
        new_cache = LatentCache(ckv=ckv, krope=krope) if mode == "prefill" else None
        y = apply_linear(p["wo"], y.reshape(*y.shape[:2], h * m.v_head_dim), route)
        return x + y, new_cache

    b = x.shape[0]
    pv = pos_vector(pos, b, x.device)
    rows = torch.arange(b, device=x.device)
    q_nope, q_rope = _mla_q(p, xn, cfg, pv[:, None], route)
    ckv_new, krope_new = _mla_latent(p, xn, cfg, pv[:, None], route)
    paged = isinstance(cache, PagedLatentCache)
    if paged:
        ps = cache.ckv.shape[1]
        where = (page_table[rows, (pv // ps).long()], (pv % ps).long())
    elif isinstance(cache, LatentCache):
        where = (rows, pv.long())
    else:
        raise TypeError(f"MLA decode needs a latent cache, got {type(cache)}")
    _write(cache, where, LatentCache(ckv=ckv_new, krope=krope_new))

    # absorb: q_lat[h] = q_nope[h] . W_uk[:, h]^T, scored against the latents
    wuk = _dense_weight(p["uk"]).reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wuk.float()).contiguous()
    qr = q_rope[:, 0].float().contiguous()
    if paged:
        fn = (ref.paged_mla_attention_ref if getattr(route, "linear", None) == "reference"
              else ops.paged_mla_attention)
        o_lat = fn(q_lat, qr, cache.ckv, cache.krope, page_table, pv, qk_dim=qk_dim)
    else:
        valid = torch.arange(cache.ckv.shape[1], device=x.device)[None, :] <= pv[:, None]
        o_lat = mla_attention(q_lat, qr, cache.ckv, cache.krope, valid, qk_dim)
    wuv = _dense_weight(p["uv"]).reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wuv.float())
    y = apply_linear(p["wo"], o.reshape(b, 1, h * m.v_head_dim).to(x.dtype), route)
    return x + y, cache


def init_mla_cache(cfg: ArchConfig, batch: int, ctx: int, dtype, device) -> LatentCache:
    """Dense (batch, ctx) latent cache in the model dtype."""
    m = cfg.mla
    return LatentCache(
        ckv=torch.zeros((batch, ctx, m.kv_lora_rank), dtype=dtype, device=device),
        krope=torch.zeros((batch, ctx, m.qk_rope_head_dim), dtype=dtype, device=device))


def init_paged_mla_cache(cfg: ArchConfig, n_pages: int, page_size: int, dtype,
                         device) -> PagedLatentCache:
    """Global latent page pools (page 0 = reserved null page) in the model
    dtype."""
    m = cfg.mla
    return PagedLatentCache(
        ckv=torch.zeros((n_pages, page_size, m.kv_lora_rank), dtype=dtype, device=device),
        krope=torch.zeros((n_pages, page_size, m.qk_rope_head_dim), dtype=dtype,
                          device=device))
