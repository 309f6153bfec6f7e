"""Model assembly for the dense and MoE decoder families: parameters, the
serving entry points (``prefill``, ``decode_step``) and the slot /
paged-slot caches of the continuous-batching engine.

Parameters are plain dicts: ``{"embed": {"table"}, "layers": [...],
"final_norm": {"scale"}, "lm_head": {"w"}}`` with one entry per decoder
layer in execution order (a Python loop where the reference scans over
stacked repeats): ``{"mixer", "mlp_norm", "mlp"}`` for a dense layer,
``{"mixer", "moe"}`` for an MoE layer (the MoE block carries its own
norm).  The mixer is GQA (``attn``) or MLA (``mla``), its cache a K/V
cache or a latent cache.  Caches mirror that: ``{"layers": [{"mixer":
cache}], "page_table": ...}``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execplan
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import (apply_embedding, apply_lm_head, apply_mlp,
                                       apply_rmsnorm, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm, model_dtype)


# mixers whose decode cache lives in global page pools
PAGEABLE_KINDS = ("attn", "mla")


def layer_kinds(cfg: ArchConfig) -> list:
    """(mixer kind, mlp kind) of every decoder layer in execution order.
    Each layer's MLP is its ``LayerGroup``'s (``first_dense_layers`` is
    metadata, as in the reference)."""
    if cfg.family not in ("dense", "moe") or cfg.encoder_groups or cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not yet ported")
    out = []
    for g in cfg.layer_groups:
        mlp = g.mlp if g.mlp is not None else cfg.mlp
        for _ in range(g.repeats):
            for kind in g.pattern:
                if kind not in PAGEABLE_KINDS:
                    raise NotImplementedError(f"mixer {kind!r} is not yet ported")
                out.append((kind, mlp))
    return out


_INIT_MIXER = {"attn": attn.init_gqa, "mla": attn.init_mla}
_APPLY_MIXER = {"attn": attn.apply_gqa, "mla": attn.apply_mla}


def _mixer_kind(p) -> str:
    return "mla" if "dkv" in p else "attn"


def _route(plan: Optional[execplan.ExecutionPlan], cfg: ArchConfig, phase: str):
    return (plan or execplan.current_override()
            or execplan.resolve_plan(cfg)).route(phase)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None):
    """Seeded random weights, every compressible linear compressed through
    ``compress_linear`` (an MoE expert stack through ``compress_stack``).
    Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    layers = []
    for kind, mlp in layer_kinds(cfg):
        layer = {"mixer": _INIT_MIXER[kind](gen, cfg, dev)}
        if mlp == "moe":
            layer["moe"] = moe.init_moe(gen, cfg, dev)
        else:
            layer.update(mlp_norm=init_rmsnorm(cfg.d_model, cfg, dev),
                         mlp=init_mlp(gen, cfg, mlp, dev))
        layers.append(layer)
    return {"embed": init_embedding(gen, cfg, dev),
            "layers": layers,
            "final_norm": init_rmsnorm(cfg.d_model, cfg, dev),
            "lm_head": init_lm_head(gen, cfg, dev)}


def params_device(params) -> torch.device:
    return params["embed"]["table"].device


def apply_layer(p, x, cfg: ArchConfig, *, mode: str, mlp: str, positions=None,
                cache=None, pos=None, route=None, page_table=None, prefix_cache=None,
                q_offset: int = 0):
    """One block: attention (GQA or MLA, by the mixer's parameters) then
    the MLP of kind ``mlp`` (``layer_kinds``) or the MoE layer (which
    follows the route's ``moe``).  Returns (x, new_cache)."""
    x, new_mixer = _APPLY_MIXER[_mixer_kind(p["mixer"])](
        p["mixer"], x, cfg, positions=positions, mode=mode,
        cache=cache["mixer"] if cache else None, pos=pos, route=route,
        page_table=page_table,
        prefix=prefix_cache["mixer"] if prefix_cache else None, q_offset=q_offset)
    if "moe" in p:
        x = moe.apply_moe(p["moe"], x, cfg, route=route)
    else:
        x = x + apply_mlp(p["mlp"], apply_rmsnorm(p["mlp_norm"], x, cfg.norm_eps), mlp,
                          route)
    return x, {"mixer": new_mixer}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, *, logit_index=None,
            plan: Optional[execplan.ExecutionPlan] = None, prefix_cache=None,
            pos_offset: int = 0):
    """Process the prompt; returns (one-position logits (B, 1, V), cache).

    Logits are taken at the last position, or at ``logit_index`` (scalar
    or (B,)) for right-padded prompts.  ``prefix_cache`` (dense batch=1,
    from ``gather_prefix_cache``) + ``pos_offset``: continuation prefill
    over a shared prefix covering positions [0, pos_offset); ``tokens``
    then hold only the suffix and the returned cache covers only it."""
    route = _route(plan, cfg, "prefill")
    x = apply_embedding(params["embed"], tokens)
    b, s, _ = x.shape
    positions = (pos_offset + torch.arange(s, device=x.device)).expand(b, s)
    caches = []
    for i, (lp, (_, mlp)) in enumerate(zip(params["layers"], layer_kinds(cfg), strict=True)):
        pc = prefix_cache["layers"][i] if prefix_cache else None
        x, nc = apply_layer(lp, x, cfg, mode="prefill", mlp=mlp, positions=positions,
                            route=route, prefix_cache=pc, q_offset=pos_offset)
        caches.append(nc)
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logit_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(logit_index, device=x.device).long().expand(b)
        x_last = x[torch.arange(b, device=x.device), idx][:, None]
    return apply_lm_head(params["lm_head"], x_last), {"layers": caches}


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos,
                plan: Optional[execplan.ExecutionPlan] = None):
    """One token step.  tokens: (B, 1); pos: absolute position of this
    token, a scalar or a (B,) vector (each slot at its own position).
    Writes the step's K/V into ``cache`` in place; returns (logits, cache)."""
    route = _route(plan, cfg, "decode")
    x = apply_embedding(params["embed"], tokens)
    pos = attn.pos_vector(pos, x.shape[0], x.device)
    page_table = cache.get("page_table")
    for lp, lc, (_, mlp) in zip(params["layers"], cache["layers"], layer_kinds(cfg),
                                strict=True):
        x, _ = apply_layer(lp, x, cfg, mode="decode", mlp=mlp, positions=pos[:, None],
                           cache=lc, pos=pos, route=route, page_table=page_table)
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return apply_lm_head(params["lm_head"], x), cache


def init_cache(cfg: ArchConfig, batch: int, ctx: int, device, kv_dtype: str = None):
    """Dense decode cache: one (batch, ctx) cache per layer at
    ``kv_dtype`` (default ``cfg.kv_cache``; pass the decode route's); an
    MLA layer's latent cache is in the model dtype whatever ``kv_dtype``."""
    dt = model_dtype(cfg)
    return {"layers": [{"mixer": attn.init_mla_cache(cfg, batch, ctx, dt, device)
                        if kind == "mla" else
                        attn.init_gqa_cache(cfg, batch, ctx, dt, device, kv_dtype=kv_dtype)}
                       for kind, _ in layer_kinds(cfg)]}


def init_slot_cache(cfg: ArchConfig, n_slots: int, ctx: int, device,
                    kv_dtype: str = None):
    """Decode cache of a continuous-batching slot batch: row b serves one
    request at a time and is overwritten by the next."""
    return init_cache(cfg, n_slots, ctx, device, kv_dtype=kv_dtype)


def quantize_request(slot_obj, req_obj):
    """Quantize-at-insert: a native prefill cache headed into a quantized
    decode cache is quantized here, once per position (mixed-precision
    plans prefill at full precision).  A request cache already at the
    slot cache's precision passes through."""
    want = attn.KV_DTYPE_OF[type(slot_obj)]
    have = attn.KV_DTYPE_OF[type(req_obj)]
    if have == want:
        return req_obj
    if have != "native":
        raise TypeError(f"cannot insert a {have} request cache into a {want} cache")
    return attn.quantize_kv(req_obj.k, req_obj.v, want)


def cache_fields(obj) -> list:
    """(name, tensor) of every field of a cache object."""
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def insert_cache_slot(cache, request_cache, slot: int):
    """Write a batch=1 prefill cache into row ``slot`` at time offset 0
    (in place), quantized first if the slot cache is.  Later positions
    keep the previous occupant's entries, which decode masks by the
    slot's position."""
    for lc, rc in zip(cache["layers"], request_cache["layers"]):
        req = quantize_request(lc["mixer"], rc["mixer"])
        for name, t in cache_fields(lc["mixer"]):
            src = getattr(req, name)[0]
            t[slot, :src.shape[0]] = src.to(t.dtype)
    return cache


def init_paged_slot_cache(cfg: ArchConfig, n_slots: int, ctx: int, *,
                          page_size: int, n_pages: int, device, kv_dtype: str = None):
    """Paged decode cache: per layer one global K/V page pool at
    ``kv_dtype`` (default ``cfg.kv_cache``) or, for an MLA layer, latent
    pools in the model dtype, plus ``page_table`` (n_slots,
    ceil(ctx/page_size)) int32.  Pool page 0 is the reserved null page,
    so the all-zero table owns no pages."""
    dt = model_dtype(cfg)
    max_pages = -(-ctx // page_size)
    return {"layers": [{"mixer": attn.init_paged_mla_cache(cfg, n_pages, page_size, dt, device)
                        if kind == "mla" else
                        attn.init_paged_gqa_cache(cfg, n_pages, page_size, dt, device,
                                                  kv_dtype=kv_dtype)}
                       for kind, _ in layer_kinds(cfg)],
            "page_table": torch.zeros((n_slots, max_pages), dtype=torch.int32,
                                      device=device)}


def insert_paged_cache_slot(cache, request_cache, slot: int, start: int):
    """Scatter a batch=1 dense prefill cache into the pool pages slot
    ``slot`` owns (in place), quantized first if the pools are.  The
    slot's ``page_table`` row must be written first: request position
    ``start + t`` lands at page ``page_table[slot, (start+t) // page_size]``,
    offset ``% page_size``; pad-tail positions past the allocation map to
    the null page."""
    page_row = cache["page_table"][slot].long()
    for lc, rc in zip(cache["layers"], request_cache["layers"]):
        pool = lc["mixer"]
        req = quantize_request(pool, rc["mixer"])
        fields = cache_fields(pool)
        first = fields[0][1]
        ps, t = first.shape[1], getattr(req, fields[0][0]).shape[1]
        positions = start + torch.arange(t, device=first.device)
        pages, off = page_row[positions // ps], positions % ps
        for name, dst in fields:
            dst[pages, off] = getattr(req, name)[0].to(dst.dtype)
    return cache


def gather_prefix_cache(cache, page_row: torch.Tensor):
    """Gather the pool pages in ``page_row`` ((n_hit,) int) into a dense
    batch=1 prefix cache for continuation prefill (native K/V or latent
    pools only: prefix sharing is off when decode KV is quantized)."""
    dense_of = {attn.PagedKVCache: attn.KVCache, attn.PagedLatentCache: attn.LatentCache}
    layers = []
    for lc in cache["layers"]:
        pool = lc["mixer"]
        if type(pool) not in dense_of:
            raise TypeError(f"prefix sharing needs native pools, got {type(pool).__name__}")
        gathered = {name: t[page_row].reshape(1, -1, *t.shape[2:])
                    for name, t in cache_fields(pool)}
        layers.append({"mixer": dense_of[type(pool)](**gathered)})
    return {"layers": layers}


def clear_cache_slot(cache, slot: int):
    """Zero row ``slot`` of a dense slot cache (in place).  Not needed for
    correctness -- insert and position masking hide stale state -- but
    useful for tests and debugging."""
    for lc in cache["layers"]:
        for _, t in cache_fields(lc["mixer"]):
            t[slot] = 0
    return cache
