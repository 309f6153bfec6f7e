"""Weight carry-over from the reference package.

``params_from_reference`` takes the reference's parameters as a flat
``{keystr path: numpy array}`` dict -- the keys ``jax.tree_util.keystr``
gives, e.g. ``['groups'][0][0]['mixer']['wq'].base.words`` with a
leading repeats axis, which are also the keys ``repro.checkpoint`` writes
to ``arrays.npz`` -- and returns the port's params.  The port never sees
a JAX object: tests build the dict from the reference's params.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.adapters import LoRAAdapter
from repro_torch.core.bitmap import NMWeight, QTiledBitmapWeight, TiledBitmapWeight
from repro_torch.core.salr import QDenseWeight, SALRConfig, SALRLinear
from repro_torch.device import resolve_device
from repro_torch.models.layers import mlp_linears
from repro_torch.models.model import layer_kinds


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit-exact: bf16 (an ml_dtypes extension type, or the
    fieldless 2-byte void an npz round trip leaves) is bit-cast through
    16-bit integers; uint32 words become int32 with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"cannot carry dtype {a.dtype} over")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


# projections of the attention block (GQA and MLA), the dense MLP and the
# shared experts whose flat (dense, masked or N:M) base the reference
# stores as W^T; taken from the name, as a shape cannot tell (wq is
# square).  wo, down and the routed expert stacks are never transposed
TRANSPOSED = ("wq", "wk", "wv", "dq", "uq", "dkv", "uk", "uv", "gate", "up")
MLA_LINEARS = ("dq", "uq", "dkv", "uk", "uv", "wo")


def _linear(flat: dict, key: str, r: int, d_out: int, cfg: ArchConfig, device,
            transposed: bool = False) -> SALRLinear:
    def leaf(suffix):
        return to_tensor(flat[key + suffix][r], device)

    if key + ".base.words" in flat:         # tiled bitmap: logical orientation
        words, values = leaf(".base.words"), leaf(".base.values")
        n_tiles, wpt = words.shape[-2], words.shape[-1]
        base = TiledBitmapWeight(words=words, values=values, cols=n_tiles * wpt * 32,
                                 tile=wpt * 32, cap_t=values.shape[-1])
        transposed = False
    elif key + ".base.group_bits" in flat:  # N:M, (2, 4) as the reference emits it
        bits, values = leaf(".base.group_bits"), leaf(".base.values")
        m = SALRConfig().nm[1]              # ([E,] rows, groups): the trailing axes
        base = NMWeight(group_bits=bits, values=values, cols=bits.shape[-1] * m,
                        n=values.shape[-1] // bits.shape[-1], m=m)
    else:                                   # dense or masked-dense
        base = leaf(".base")
    lora = LoRAAdapter(a=leaf(".lora.a"), b=leaf(".lora.b"), scale=1.0)
    res = (LoRAAdapter(a=leaf(".res.a"), b=leaf(".res.b"), scale=1.0)
           if key + ".res.a" in flat else None)
    bias = leaf(".bias") if key + ".bias" in flat else None
    qbase = None                            # the NF4 twin of a dual_repr layer
    if key + ".qbase.words" in flat:
        qbase = QTiledBitmapWeight(words=leaf(".qbase.words"), codes=leaf(".qbase.codes"),
                                   scales=leaf(".qbase.scales"), cols=base.cols,
                                   tile=base.tile, cap_t=base.cap_t)
    elif key + ".qbase.codes" in flat:
        codes = leaf(".qbase.codes")
        qbase = QDenseWeight(codes=codes, scales=leaf(".qbase.scales"),
                             shape=(codes.shape[-2], d_out))
    if lora.b.shape[-1] != d_out:
        raise ValueError(f"{key}: adapter width {lora.b.shape[-1]} != d_out {d_out}")
    return SALRLinear(base=base, lora=lora, res=res, bias=bias, d_in=lora.a.shape[-2],
                      d_out=d_out, transposed=transposed, backend=cfg.salr.backend,
                      qbase=qbase)


def _widths(cfg: ArchConfig) -> dict:
    """d_out of every carried linear, by the part of a layer it sits in."""
    hd = cfg.resolved_head_dim
    fs = cfg.moe_d_ff * cfg.n_shared_experts
    out = {"['mixer']": {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
                         "wv": cfg.n_kv_heads * hd, "wo": cfg.d_model},
           "['mlp']": {"gate": cfg.d_ff, "up": cfg.d_ff, "down": cfg.d_model},
           "['moe']": {"gate": cfg.moe_d_ff, "up": cfg.moe_d_ff, "down": cfg.d_model},
           "['moe']['shared']": {"gate": fs, "up": fs, "down": cfg.d_model}}
    if cfg.mla is not None:
        m = cfg.mla
        out["['mixer']"].update(
            dq=m.q_lora_rank, uq=cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim),
            dkv=m.kv_lora_rank + m.qk_rope_head_dim, uk=cfg.n_heads * m.qk_nope_head_dim,
            uv=cfg.n_heads * m.v_head_dim)
    return out


def _carry_linears(flat: dict, pre: str, part: str, names: tuple, r: int, cfg: ArchConfig,
                   device) -> dict:
    """The linears ``names`` under ``pre + part``, a flat base of a name in
    ``TRANSPOSED`` as the W^T it stores (never a routed expert stack's)."""
    widths = _widths(cfg)[part]
    return {n: _linear(flat, f"{pre}{part}['{n}']", r, widths[n], cfg, device,
                       part != "['moe']" and n in TRANSPOSED) for n in names}


def _norm(flat: dict, path: str, r: int, device) -> dict:
    return {"scale": to_tensor(flat[f"{path}['scale']"][r], device)}


def carry_mixer(flat: dict, pre: str, r: int, kind: str, cfg: ArchConfig, device) -> dict:
    """Repeat ``r`` of the ``['mixer']`` leaves under the layer prefix
    ``pre``: GQA (``attn``: norm, wq/wk/wv/wo) or MLA (``mla``: the norms
    norm/qnorm/kvnorm and the linears of ``MLA_LINEARS``)."""
    if kind == "mla":
        return {**{n: _norm(flat, f"{pre}['mixer']['{n}']", r, device)
                   for n in ("norm", "qnorm", "kvnorm")},
                **_carry_linears(flat, pre, "['mixer']", MLA_LINEARS, r, cfg, device)}
    if kind != "attn":
        raise NotImplementedError(f"mixer {kind!r} is not yet ported")
    return {"norm": _norm(flat, f"{pre}['mixer']['norm']", r, device),
            **_carry_linears(flat, pre, "['mixer']", ("wq", "wk", "wv", "wo"), r, cfg, device)}


def carry_moe(flat: dict, pre: str, r: int, cfg: ArchConfig, device) -> dict:
    """Repeat ``r`` of the ``['moe']`` leaves under ``pre``: its norm, the
    f32 router, the gate/up/down expert stacks (leaves keep their expert
    axis) and, with ``n_shared_experts``, the shared gate/up/down."""
    ffn = ("gate", "up", "down")
    out = {"norm": _norm(flat, f"{pre}['moe']['norm']", r, device),
           "router": {"w": to_tensor(flat[f"{pre}['moe']['router']['w']"][r], device)},
           **_carry_linears(flat, pre, "['moe']", ffn, r, cfg, device)}
    if cfg.n_shared_experts:
        out["shared"] = _carry_linears(flat, pre, "['moe']['shared']", ffn, r, cfg, device)
    return out


def params_from_reference(flat: dict, cfg: ArchConfig, device=None):
    """The port's params from the reference's flat keystr dict.  The
    repeats axis of every stacked leaf is unstacked into per-layer
    entries (a dense layer's MLP carries the linears of its kind,
    ``layers.mlp_linears``: a relu2 or gelu MLP has no gate);
    tiled-bitmap static fields derive from the shapes (tile =
    words-per-tile x 32, cap_t from the values, cols = n_tiles x tile),
    d_out from the config, and adapter scales are 1.0 (alpha = rank).  An
    N:M base (``.base.group_bits/values``) and a dense or masked base
    (``.base``) are carried too, a flat base of a projection in
    ``TRANSPOSED`` (attention, MLA, dense MLP and shared-expert gate/up)
    as the W^T it stores (a routed expert stack's never).  A layer's NF4
    twin is carried when the reference emitted one:
    ``.qbase.words/codes/scales`` for a tiled base, ``.qbase.codes/scales``
    (a QDenseWeight) for a dense one.  A layer is ``{"mixer", "moe"}``
    when it has ``['moe']`` leaves (``carry_moe``), else ``{"mixer",
    "mlp_norm", "mlp"}``; its mixer is GQA or MLA by the group pattern
    (``carry_mixer``)."""
    dev = resolve_device(device)
    kinds = iter(layer_kinds(cfg))
    layers = []
    for gi, g in enumerate(cfg.layer_groups):
        for r in range(g.repeats):
            for pi, kind in enumerate(g.pattern):
                _, mlp = next(kinds)
                pre = f"['groups'][{gi}][{pi}]"
                layer = {"mixer": carry_mixer(flat, pre, r, kind, cfg, dev)}
                if pre + "['moe']['router']['w']" in flat:
                    layer["moe"] = carry_moe(flat, pre, r, cfg, dev)
                else:
                    layer.update(mlp_norm=_norm(flat, f"{pre}['mlp_norm']", r, dev),
                                 mlp=_carry_linears(flat, pre, "['mlp']", mlp_linears(mlp),
                                                    r, cfg, dev))
                layers.append(layer)
    return {"embed": {"table": to_tensor(flat["['embed']['table']"], dev)},
            "layers": layers,
            "final_norm": {"scale": to_tensor(flat["['final_norm']['scale']"], dev)},
            "lm_head": {"w": to_tensor(flat["['lm_head']['w']"], dev)}}
