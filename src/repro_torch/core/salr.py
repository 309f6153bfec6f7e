"""SALRLinear: y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).

W_hat is the statically pruned frozen base, stored in the kernel-native
tiled bitmap (``core.bitmap.TiledBitmapWeight``, always in the logical
(d_in, d_out) orientation); A_cat/B_cat fuse the task LoRA adapter with
the sparsity-preservation residual adapter into one GEMM pair.

``apply_salr`` dispatches on the execution route: ``kernel`` runs the
fused SpMM (``kernels.ops.salr_matmul``, or ``bitmap_matmul`` for a layer
whose adapter rank is 0), ``reference`` decodes W_hat dense and runs
plain GEMMs.  Only the bitmap method is ported so far; the kernel
wrappers are forward-only (the autograd Function, whose backward replays
the reference formulation, comes with the fine-tuning slice).
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


@dataclasses.dataclass(frozen=True)
class SALRLinear:
    """Frozen tiled-bitmap base + fused adapters.  ``backend`` records the
    layer's default execution route."""
    base: bm.TiledBitmapWeight
    lora: LoRAAdapter
    res: Optional[LoRAAdapter]
    bias: Optional[torch.Tensor]
    d_in: int
    d_out: int
    backend: str = "reference"


def materialize_base(base: bm.TiledBitmapWeight) -> torch.Tensor:
    """Dense W_hat (d_in, cols) with the tile zero-padding still on."""
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


def _apply_reference(x: torch.Tensor, layer: SALRLinear) -> torch.Tensor:
    """Dense decode + GEMM (the differentiable oracle path)."""
    w = materialize_base(layer.base)[:, :layer.d_out].to(x.dtype)
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


def apply_salr(x: torch.Tensor, layer: SALRLinear,
               backend: Optional[str] = None) -> torch.Tensor:
    """y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).  x: (..., d_in).

    ``backend`` (explicit argument, usually the threaded plan route's
    ``linear``; then any active plan scope; then ``layer.backend``)
    selects the fused kernel or the dense reference path."""
    if _resolve_backend(layer, backend) == "kernel":
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
    return SALRLinear(base=base, lora=lora, res=res_ad,
                      bias=None if bias is None else bias.to(dtype),
                      d_in=d_in, d_out=d_out, backend=cfg.backend)


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
