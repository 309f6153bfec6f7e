"""SALRLinear: y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).

W_hat is the statically pruned frozen base, stored in the kernel-native
tiled bitmap (``core.bitmap.TiledBitmapWeight``, always in the logical
(d_in, d_out) orientation); A_cat/B_cat fuse the task LoRA adapter with
the sparsity-preservation residual adapter into one GEMM pair.  With
``dual_repr`` a layer also carries ``qbase``, an NF4-requantized twin of
the base (``QTiledBitmapWeight``, the same words) that a mixed-precision
plan streams at decode; the adapters are shared.

``apply_salr`` dispatches on the execution route: ``kernel`` runs the
fused SpMM (``kernels.ops.salr_matmul``, ``bitmap_matmul`` for a layer
whose adapter rank is 0, ``qsalr_matmul`` for the NF4 twin),
``reference`` decodes the base dense and runs plain GEMMs.  Only the
bitmap method is ported so far; the kernel wrappers are forward-only
(the autograd Function, whose backward replays the reference
formulation, comes with the fine-tuning slice).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import prune
from repro_torch.core.adapters import LoRAAdapter, init_lora
from repro_torch.core.residual import truncated_svd_adapter


@dataclasses.dataclass(frozen=True)
class SALRConfig:
    """Static compression configuration for one family of linear layers."""
    sparsity: float = 0.5
    method: str = "bitmap"        # only the bitmap method is ported
    lora_rank: int = 64
    res_rank: int = 64
    dtype: str = "float32"
    backend: str = "kernel"       # the layers' default route
    # also emit ``SALRLinear.qbase``, the NF4 twin a quantized decode
    # route (PhaseRoute.repr) reads
    dual_repr: bool = False


@dataclasses.dataclass(frozen=True)
class SALRLinear:
    """Frozen tiled-bitmap base + fused adapters.  ``backend`` records the
    layer's default execution route; ``qbase`` is the optional NF4 twin of
    ``base`` (same sparse structure, requantized payload)."""
    base: bm.TiledBitmapWeight
    lora: LoRAAdapter
    res: Optional[LoRAAdapter]
    bias: Optional[torch.Tensor]
    d_in: int
    d_out: int
    backend: str = "reference"
    qbase: Optional[bm.QTiledBitmapWeight] = None


def materialize_base(base) -> torch.Tensor:
    """Dense W_hat (d_in, cols) with the tile zero-padding still on (f32
    for the NF4 twin, whose levels x scales are computed in f32)."""
    if isinstance(base, bm.QTiledBitmapWeight):
        return bm.qtile_decode(base)
    return bm.tile_decode(base)


def adapter_cat(layer: SALRLinear) -> tuple:
    """A_cat/B_cat fusing the LoRA and residual adapters (scales folded
    into B)."""
    if layer.res is None:
        return layer.lora.a, layer.lora.b * layer.lora.scale
    a_cat = torch.cat([layer.lora.a, layer.res.a], dim=1)
    b_cat = torch.cat([layer.lora.b * layer.lora.scale,
                       layer.res.b * layer.res.scale], dim=0)
    return a_cat, b_cat


def delta_w(layer: SALRLinear) -> torch.Tensor:
    """Effective dense update contributed by the fused adapters."""
    a_cat, b_cat = adapter_cat(layer)
    return a_cat @ b_cat


def _resolve_backend(layer: SALRLinear, backend: Optional[str]) -> str:
    b = backend
    if b is None:
        from repro_torch.core import execplan
        override = execplan.current_override()
        if override is not None:
            # a direct call carries no phase: a scope plan reads as prefill
            b = override.linear_backend("prefill")
    if b is None:
        b = layer.backend
    if b not in ("kernel", "reference"):
        raise ValueError(f"unknown SALR backend {b!r}")
    return b


def _resolve_repr(base_repr: Optional[str]) -> str:
    if base_repr is None:
        from repro_torch.core import execplan
        override = execplan.current_override()
        if override is not None:
            # same phase convention as _resolve_backend
            base_repr = override.base_repr("prefill")
    return base_repr or "native"


def _apply_reference(x: torch.Tensor, layer: SALRLinear, base=None) -> torch.Tensor:
    """Dense decode + GEMM (the differentiable oracle path).  ``base``
    substitutes another representation of the frozen base (the
    quantized-repr oracle passes ``layer.qbase``)."""
    if base is None:
        base = layer.base
    w = materialize_base(base)[:, :layer.d_out].to(x.dtype)
    a_cat, b_cat = adapter_cat(layer)
    y = x @ w + (x @ a_cat) @ b_cat
    if layer.bias is not None:
        y = y + layer.bias
    return y


def _kernel_dispatch(x: torch.Tensor, layer: SALRLinear) -> torch.Tensor:
    """Route the forward to the fused SpMM for the tiled base."""
    from repro_torch.kernels import ops
    a_cat, b_cat = adapter_cat(layer)
    if a_cat.shape[1] == 0:
        y = ops.bitmap_matmul(x, layer.base)[..., :layer.d_out]
    else:
        y = ops.salr_matmul(x, layer.base, a_cat, b_cat)[..., :layer.d_out]
    if layer.bias is not None:
        y = y + layer.bias
    return y


def _qkernel_dispatch(x: torch.Tensor, layer: SALRLinear) -> torch.Tensor:
    """The fused NF4 op over the twin ``layer.qbase``; the adapters and
    bias are the native path's."""
    from repro_torch.kernels import ops
    a_cat, b_cat = adapter_cat(layer)
    y = ops.qsalr_matmul(x, layer.qbase, a_cat, b_cat)[..., :layer.d_out]
    if layer.bias is not None:
        y = y + layer.bias
    return y


def apply_salr(x: torch.Tensor, layer: SALRLinear, backend: Optional[str] = None,
               base_repr: Optional[str] = None) -> torch.Tensor:
    """y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).  x: (..., d_in).

    ``backend`` (explicit argument, usually the threaded plan route's
    ``linear``; then any active plan scope; then ``layer.backend``)
    selects the fused kernel or the dense reference path.  ``base_repr``
    (the route's ``repr``, then any plan scope, then ``native``): a
    quantized repr reads the NF4 twin ``layer.qbase`` -- through
    ``qsalr_matmul`` on the kernel route, dequantized on the reference
    route; a layer without a twin reads its native base."""
    b = _resolve_backend(layer, backend)
    if _resolve_repr(base_repr) != "native" and layer.qbase is not None:
        if b == "kernel":
            return _qkernel_dispatch(x, layer)
        return _apply_reference(x, layer, base=layer.qbase)
    if b == "kernel":
        return _kernel_dispatch(x, layer)
    return _apply_reference(x, layer)


def compress_linear(gen: torch.Generator, w: torch.Tensor, cfg: SALRConfig,
                    bias: Optional[torch.Tensor] = None) -> SALRLinear:
    """Compress a dense weight W (d_in, d_out) into a SALRLinear.

    Magnitude-prune -> tile-encode the base (kernel-native storage) ->
    truncated-SVD the total residual (pruned entries + capacity spill)
    into the ``res`` adapter -> fresh LoRA adapter drawn from ``gen`` (a
    CPU generator).  ``w`` is cast to the model dtype before the mask,
    so at bf16 the mask is taken on bf16-rounded magnitudes."""
    if cfg.method != "bitmap":
        raise NotImplementedError(
            f"SALR method {cfg.method!r} is not yet ported (bitmap only)")
    d_in, d_out = w.shape
    dtype = getattr(torch, cfg.dtype)
    base, e = _tiled_encode(w.to(dtype), cfg)
    res_ad = (truncated_svd_adapter(e, cfg.res_rank, dtype=dtype)
              if cfg.res_rank > 0 else None)
    lora = init_lora(gen, d_in, d_out, cfg.lora_rank, dtype=dtype,
                     device=w.device)
    layer = SALRLinear(base=base, lora=lora, res=res_ad,
                       bias=None if bias is None else bias.to(dtype),
                       d_in=d_in, d_out=d_out, backend=cfg.backend)
    if cfg.dual_repr:
        layer = dataclasses.replace(layer, qbase=attach_qbase(layer))
    return layer


def attach_qbase(layer: SALRLinear) -> bm.QTiledBitmapWeight:
    """NF4 twin of a tiled-bitmap base for mixed-precision routes: the
    words are shared, each cell's values requantized.  The quantization
    error is not folded into the residual adapter (the adapters are
    shared with the native base), so the route's error is exactly the
    NF4 roundtrip."""
    if isinstance(layer.base, bm.TiledBitmapWeight):
        return bm.tile_quantize_nf4(layer.base)[0]
    raise NotImplementedError(
        f"the NF4 twin of a {type(layer.base).__name__} base (QDenseWeight, "
        "ops.nf4_matmul) is not yet ported")


def _tiled_encode(w: torch.Tensor, cfg: SALRConfig):
    """Tile-encode a logical (d_in, d_out) weight with static capacity.
    Returns (TiledBitmapWeight, residual incl. spill)."""
    d_in, d_out = w.shape
    tile = bm.default_tile(d_out)
    mask = prune.magnitude_mask(w, cfg.sparsity)
    cap_t = bm.tiled_capacity(tile, cfg.sparsity)
    w_hat = prune.apply_mask(w, mask)
    pad = bm.round_up(d_out, tile) - d_out
    w_hat = torch.nn.functional.pad(w_hat, (0, pad))
    mask_p = torch.nn.functional.pad(mask, (0, pad))
    tbw, spill = bm.tile_encode(w_hat, mask_p, tile, cap_t)
    return tbw, prune.residual(w, mask) + spill[:, :d_out]
