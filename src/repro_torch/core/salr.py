"""SALRLinear: y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).

W_hat is the statically pruned frozen base; A_cat/B_cat fuse the task
LoRA adapter with the sparsity-preservation residual adapter into one
GEMM pair.  The base is stored by method:

    bitmap  TiledBitmapWeight, always in the logical (d_in, d_out)
            orientation                        -> ops.salr_matmul
    nm      NMWeight (2:4) for a projection stored as W (wo, down)
                                       -> ops.nm_matmul + ops.lora_matmul;
            a transposed projection (wq/wk/wv/gate/up) takes its N:M mask
            along d_in and is re-encoded as a tiled bitmap -> salr_matmul
    dense   the dense weight                   -> dense GEMM
    mask    the magnitude-masked dense weight  -> dense GEMM

A flat (dense, mask, N:M) base of a ``transposed`` layer stores W^T, so
its rows run along d_out as the reference's sharding convention has it.
With ``dual_repr`` a layer also carries ``qbase``, an NF4-requantized
twin of the base that a mixed-precision plan streams at decode: a
``QTiledBitmapWeight`` (the same words) for a tiled base, read by
``ops.qsalr_matmul``; a ``QDenseWeight`` for the dense base of an
untransposed layer, read by ``ops.nf4_matmul`` + ``ops.lora_matmul``.
Other bases get no twin and decode from their native base.  The adapters
are shared.

An MoE expert stack is one ``SALRLinear`` whose every tensor leaf
carries a leading E axis (``compress_stack``), always untransposed: a
tiled-bitmap base with 4-D words/values (all experts share ``tile`` and
``cap_t``), an N:M base with 3-D group bits/values (groups along d_out),
or a dense / masked (E, d_in, d_out) tensor; adapters (E, d_in, r) /
(E, r, d_out); and the stacked NF4 twin (a tiled or dense base's);
``d_in`` and ``d_out`` are one expert's.  ``models.moe`` runs it.

``apply_salr`` dispatches on the execution route: ``kernel`` runs the
layer's CUDA op where one exists for its base (``bitmap_matmul`` for a
tiled layer whose adapter rank is 0), ``reference`` decodes the base
dense and runs plain GEMMs, as does a base with no kernel.  Where the
kernel route adds two ops' outputs, each is rounded to the model dtype
and the sum is taken there, as the reference does.  The kernel wrappers
are forward-only (the autograd Function, whose backward replays the
reference formulation, comes with the fine-tuning slice).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import prune
from repro_torch.core.adapters import LoRAAdapter, init_lora
from repro_torch.core.quant import QBLOCK, nf4_dequant_2d
from repro_torch.core.residual import truncated_svd_adapter


@dataclasses.dataclass(frozen=True)
class SALRConfig:
    """Static compression configuration for one family of linear layers."""
    sparsity: float = 0.5
    method: str = "bitmap"        # dense | mask | bitmap | nm
    lora_rank: int = 64
    res_rank: int = 64
    nm: tuple = (2, 4)
    dtype: str = "float32"
    # the layers' default route; "kernel" also emits kernel-ready storage
    # (a transposed N:M layer re-encoded as a tiled bitmap)
    backend: str = "kernel"
    # also emit ``SALRLinear.qbase``, the NF4 twin a quantized decode
    # route (PhaseRoute.repr) reads
    dual_repr: bool = False


@dataclasses.dataclass(frozen=True)
class QDenseWeight:
    """Dense base NF4-requantized into the 2-D kernel layout
    (``ops.nf4_matmul``): codes ([E,] K, Np/2) uint8, interleaved, and
    scales ([E,] K, Np/QBLOCK) f32, Np the logical column count padded up
    to a QBLOCK multiple (padded columns quantize to exact zeros and are
    sliced off after the GEMM).  ``shape`` is one expert's."""
    codes: torch.Tensor
    scales: torch.Tensor
    shape: tuple                  # logical (K, N)


@dataclasses.dataclass(frozen=True)
class SALRLinear:
    """Frozen base + fused adapters.  ``transposed``: a flat base stores
    W^T (a tiled base is always in the logical orientation, and its layer
    reports False).  ``backend`` records the layer's default execution
    route; ``qbase`` is the optional NF4 twin of ``base``."""
    base: object                  # TiledBitmapWeight | NMWeight | Tensor
    lora: LoRAAdapter
    res: Optional[LoRAAdapter]
    bias: Optional[torch.Tensor]
    d_in: int
    d_out: int
    transposed: bool = False
    backend: str = "reference"
    qbase: object = None          # QTiledBitmapWeight | QDenseWeight | None


def _is_tiled(base) -> bool:
    return isinstance(base, (bm.TiledBitmapWeight, bm.QTiledBitmapWeight))


def materialize_base(base) -> torch.Tensor:
    """Dense W_hat in the storage orientation.  A tiled base keeps its
    tile zero-padding and a QDenseWeight is cut to its logical width; the
    NF4 twins decode in f32 (levels x scales are computed in f32)."""
    if isinstance(base, bm.TiledBitmapWeight):
        return bm.tile_decode(base)
    if isinstance(base, bm.QTiledBitmapWeight):
        return bm.qtile_decode(base)
    if isinstance(base, bm.NMWeight):
        return bm.nm_decode(base)
    if isinstance(base, QDenseWeight):
        return nf4_dequant_2d(base.codes, base.scales)[..., :base.shape[1]]
    return base                   # dense / masked-dense tensor


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


def effective_weight(layer: SALRLinear) -> torch.Tensor:
    """Dense W_hat + A_cat B_cat in the logical (d_in, d_out) orientation:
    the base decoded (a tiled base cut to its logical width, a flat base
    of a ``transposed`` layer turned back) plus the adapters' update, in
    the layer's dtype.  MLA's absorbed decode needs the matrix itself."""
    w = materialize_base(layer.base)
    if _is_tiled(layer.base):
        w = w[:, :layer.d_out]
    if layer.transposed:
        w = w.T
    return w + delta_w(layer)


def slice_stack(obj, sl: slice):
    """Experts ``sl`` of an expert stack (or of one of its leaves): every
    tensor leaf sliced on dim 0, every static field kept."""
    if isinstance(obj, torch.Tensor):
        return obj[sl]
    if not dataclasses.is_dataclass(obj):
        return obj
    return dataclasses.replace(obj, **{f.name: slice_stack(getattr(obj, f.name), sl)
                                       for f in dataclasses.fields(obj) if f.init})


def cat_stacks(parts: list):
    """Expert stacks (or their leaves) concatenated along the expert axis:
    every tensor leaf of the dataclasses is joined on dim 0, every static
    field taken from the first part."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=0)
    if not dataclasses.is_dataclass(first):
        return first
    return dataclasses.replace(first, **{
        f.name: cat_stacks([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first) if f.init})


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
    w = materialize_base(base)
    if _is_tiled(base):
        w = w[:, :layer.d_out]            # drop the tile zero-padding
    w = w.to(x.dtype)
    y = x @ (w.T if layer.transposed else w)
    a_cat, b_cat = adapter_cat(layer)
    y = y + (x @ a_cat) @ b_cat
    if layer.bias is not None:
        y = y + layer.bias
    return y


def _kernel_capable(layer: SALRLinear) -> bool:
    """Whether a CUDA op exists for this base layout.  A dense or masked
    base has none (its GEMM is the reference's), nor has a transposed
    N:M base."""
    return (_is_tiled(layer.base)
            or (isinstance(layer.base, bm.NMWeight) and not layer.transposed))


def _kernel_dispatch(x: torch.Tensor, layer: SALRLinear) -> torch.Tensor:
    """Route the forward to the CUDA op for the layer's base."""
    from repro_torch.kernels import ops
    base = layer.base
    a_cat, b_cat = adapter_cat(layer)
    if isinstance(base, bm.TiledBitmapWeight):
        if a_cat.shape[1] == 0:
            y = ops.bitmap_matmul(x, base)[..., :layer.d_out]
        else:
            y = ops.salr_matmul(x, base, a_cat, b_cat)[..., :layer.d_out]
    elif isinstance(base, bm.NMWeight) and not layer.transposed:
        y = ops.nm_matmul(x, base)
        if a_cat.shape[1]:
            y = y + ops.lora_matmul(x, a_cat, b_cat)
    else:
        raise TypeError(f"no CUDA op for base {type(base).__name__} "
                        f"(transposed={layer.transposed})")
    if layer.bias is not None:
        y = y + layer.bias
    return y


def _qkernel_dispatch(x: torch.Tensor, layer: SALRLinear) -> torch.Tensor:
    """The CUDA op over the twin ``layer.qbase``; the adapters and bias
    are the native path's."""
    from repro_torch.kernels import ops
    qb = layer.qbase
    a_cat, b_cat = adapter_cat(layer)
    if isinstance(qb, bm.QTiledBitmapWeight):
        y = ops.qsalr_matmul(x, qb, a_cat, b_cat)[..., :layer.d_out]
    elif isinstance(qb, QDenseWeight):
        y = ops.nf4_matmul(x, qb.codes, qb.scales)[..., :layer.d_out]
        if a_cat.shape[1]:
            y = y + ops.lora_matmul(x, a_cat, b_cat)
    else:
        raise TypeError(f"no CUDA op for qbase {type(qb).__name__}")
    if layer.bias is not None:
        y = y + layer.bias
    return y


def apply_salr(x: torch.Tensor, layer: SALRLinear, backend: Optional[str] = None,
               base_repr: Optional[str] = None) -> torch.Tensor:
    """y = x @ W_hat + (x @ A_cat) @ B_cat (+ bias).  x: (..., d_in).

    ``backend`` (explicit argument, usually the threaded plan route's
    ``linear``; then any active plan scope; then ``layer.backend``)
    selects the CUDA op or the dense reference path; a base with no CUDA
    op takes the reference path whatever the route.  ``base_repr`` (the
    route's ``repr``, then any plan scope, then ``native``): a quantized
    repr reads the NF4 twin ``layer.qbase`` -- through its CUDA op on the
    kernel route, dequantized on the reference route; a layer without a
    twin reads its native base."""
    b = _resolve_backend(layer, backend)
    if _resolve_repr(base_repr) != "native" and layer.qbase is not None:
        if b == "kernel":
            return _qkernel_dispatch(x, layer)
        return _apply_reference(x, layer, base=layer.qbase)
    if b == "kernel" and _kernel_capable(layer):
        return _kernel_dispatch(x, layer)
    return _apply_reference(x, layer)


def compress_linear(gen: torch.Generator, w: torch.Tensor, cfg: SALRConfig,
                    bias: Optional[torch.Tensor] = None,
                    transposed: bool = False) -> SALRLinear:
    """Compress a dense weight W (d_in, d_out) into a SALRLinear.

    Prune -> encode the base (``cfg.method``) -> truncated-SVD the total
    residual (pruned entries + capacity spill) into the ``res`` adapter
    -> fresh LoRA adapter drawn from ``gen`` (a CPU generator).  A flat
    base of a ``transposed`` layer stores W^T and takes its mask in that
    orientation.  The bitmap and N:M bases are encoded from ``w`` cast to
    the model dtype (at bf16 the mask is taken on bf16-rounded
    magnitudes); the masked-dense base takes its mask on ``w`` as given.
    With ``cfg.backend == "kernel"`` the bitmap base and a transposed N:M
    base are emitted as logical-orientation tiled bitmaps (the layer then
    reports ``transposed=False``)."""
    d_in, d_out = w.shape
    dtype = getattr(torch, cfg.dtype)
    store = w.T if transposed else w
    kernel_ready = cfg.backend == "kernel"
    res_ad = None
    out_transposed = transposed
    if cfg.method == "dense":
        base = store.to(dtype)
    elif cfg.method == "mask":
        mask = prune.magnitude_mask(store, cfg.sparsity)
        base = prune.apply_mask(store, mask).to(dtype)
        res_ad = _res_adapter(prune.residual(store, mask), cfg, transposed, dtype)
    elif cfg.method == "bitmap":
        base, e = _tiled_encode(w.to(dtype), cfg)
        res_ad = _res_adapter(e, cfg, False, dtype)
        out_transposed = False
    elif cfg.method == "nm":
        n, m = cfg.nm
        if kernel_ready and transposed:
            base, e = _tiled_nm_base(w, cfg, dtype)
            res_ad = _res_adapter(e, cfg, False, dtype)
            out_transposed = False
        else:
            base, e = bm.nm_encode(store.to(dtype), n=n, m=m)
            res_ad = _res_adapter(e, cfg, transposed, dtype)
    else:
        raise NotImplementedError(f"SALR method {cfg.method!r} is not yet ported "
                                  "(dense, mask, bitmap, nm)")
    lora = init_lora(gen, d_in, d_out, cfg.lora_rank, dtype=dtype,
                     device=w.device)
    layer = SALRLinear(base=base, lora=lora, res=res_ad,
                       bias=None if bias is None else bias.to(dtype),
                       d_in=d_in, d_out=d_out, transposed=out_transposed,
                       backend=cfg.backend)
    if cfg.dual_repr:
        layer = dataclasses.replace(layer, qbase=attach_qbase(layer))
    return layer


def compress_stack(gen: torch.Generator, w: torch.Tensor, cfg: SALRConfig) -> SALRLinear:
    """Compress an expert stack W (E, d_in, d_out) into one stacked
    SALRLinear, each expert exactly as ``compress_linear`` compresses an
    untransposed layer: under ``bitmap`` its own magnitude mask and a
    tiled bitmap at the shared capacity ``tiled_capacity(tile, p)``, whose
    spill folds into its residual; under ``nm`` 2:4 groups along d_out of
    the cast weight; under ``mask`` its own magnitude mask taken on the
    weight as given, then cast; under ``dense`` the cast weight and no
    residual adapter.  Then a truncated-SVD residual adapter, a fresh LoRA
    adapter (drawn expert by expert from ``gen``) and, with
    ``dual_repr``, the stacked NF4 twin (``attach_qbase``).  The mask, the
    encode and the SVD run over the whole stack at once."""
    e, d_in, d_out = w.shape
    dtype = getattr(torch, cfg.dtype)
    res = None
    if cfg.method == "bitmap":
        wd = w.to(dtype)
        cap_t = bm.tiled_capacity(bm.default_tile(d_out), cfg.sparsity)
        mask = prune.magnitude_mask(wd, cfg.sparsity, batch_dims=1)
        flat, res = _tiled_encode(wd.reshape(e * d_in, d_out), cfg,
                                  mask=mask.reshape(e * d_in, d_out), cap_t=cap_t)
        base = bm.TiledBitmapWeight(
            words=flat.words.reshape(e, d_in, *flat.words.shape[1:]),
            values=flat.values.reshape(e, d_in, *flat.values.shape[1:]),
            cols=flat.cols, tile=flat.tile, cap_t=flat.cap_t)
        res = res.reshape(e, d_in, d_out)
    elif cfg.method == "nm":
        base, res = bm.nm_encode(w.to(dtype), n=cfg.nm[0], m=cfg.nm[1])
    elif cfg.method == "mask":
        mask = prune.magnitude_mask(w, cfg.sparsity, batch_dims=1)
        base = prune.apply_mask(w, mask).to(dtype)
        res = prune.residual(w, mask)
    elif cfg.method == "dense":
        base = w.to(dtype)
    else:
        raise NotImplementedError(f"expert stacks under SALR method {cfg.method!r} are "
                                  "not yet ported (dense, mask, bitmap, nm)")
    res_ad = None if res is None else _res_adapter(res, cfg, False, dtype)
    loras = [init_lora(gen, d_in, d_out, cfg.lora_rank, dtype=dtype, device=w.device)
             for _ in range(e)]
    lora = LoRAAdapter(a=torch.stack([lo.a for lo in loras]),
                       b=torch.stack([lo.b for lo in loras]), scale=loras[0].scale)
    layer = SALRLinear(base=base, lora=lora, res=res_ad, bias=None, d_in=d_in, d_out=d_out,
                       backend=cfg.backend)
    if cfg.dual_repr:
        layer = dataclasses.replace(layer, qbase=attach_qbase(layer))
    return layer


def attach_qbase(layer: SALRLinear):
    """NF4 twin of a layer's base for mixed-precision routes, or None.

    A tiled-bitmap base requantizes per cell (``QTiledBitmapWeight``
    sharing the words); the dense or masked base of an untransposed layer
    requantizes into the ``ops.nf4_matmul`` layout (``QDenseWeight``,
    columns zero-padded to a ``QBLOCK`` multiple, where they quantize to
    exact zeros), an expert stack's expert by expert.  Other bases (N:M,
    transposed flat) get no twin: their quantized route reads the native
    base.  The quantization error is not folded into the residual adapter
    (the adapters are shared with the native base), so the route's error
    is exactly the NF4 roundtrip."""
    base = layer.base
    if isinstance(base, bm.TiledBitmapWeight):
        return bm.tile_quantize_nf4(base)[0]
    if isinstance(base, torch.Tensor) and base.ndim in (2, 3) and not layer.transposed:
        from repro_torch.kernels import ops
        kdim, n = base.shape[-2:]
        wp = torch.nn.functional.pad(base.float(), (0, (-n) % QBLOCK))
        codes, scales = ops.nf4_encode_2d(wp)
        return QDenseWeight(codes=codes, scales=scales, shape=(kdim, n))
    return None


def _tiled_encode(w: torch.Tensor, cfg: SALRConfig, mask=None, cap_t=None):
    """Tile-encode a logical (d_in, d_out) weight with static capacity
    (``mask`` and ``cap_t`` default to the magnitude mask at
    ``cfg.sparsity`` and its tiled capacity).  Returns (TiledBitmapWeight,
    residual incl. spill)."""
    d_in, d_out = w.shape
    tile = bm.default_tile(d_out)
    if mask is None:
        mask = prune.magnitude_mask(w, cfg.sparsity)
    if cap_t is None:
        cap_t = bm.tiled_capacity(tile, cfg.sparsity)
    w_hat = prune.apply_mask(w, mask)
    pad = bm.round_up(d_out, tile) - d_out
    w_hat = torch.nn.functional.pad(w_hat, (0, pad))
    mask_p = torch.nn.functional.pad(mask, (0, pad))
    tbw, spill = bm.tile_encode(w_hat, mask_p, tile, cap_t)
    return tbw, prune.residual(w, mask) + spill[:, :d_out]


def _tiled_nm_base(w: torch.Tensor, cfg: SALRConfig, dtype):
    """A transposed N:M layer, kernel-ready: the N:M mask is taken in the
    storage orientation (groups along d_in), then the masked weight is
    re-encoded as a logical tiled bitmap (capacity at sparsity 1 - n/m)."""
    n, m = cfg.nm
    wd = w.to(dtype)
    mask_store = prune.nm_mask(wd.T, n=n, m=m)
    cap_t = bm.tiled_capacity(bm.default_tile(w.shape[1]), 1.0 - n / m)
    return _tiled_encode(wd, cfg, mask=mask_store.T, cap_t=cap_t)


def _res_adapter(e_store: torch.Tensor, cfg: SALRConfig, transposed: bool, dtype):
    """The residual adapter of E given in the storage orientation."""
    if cfg.res_rank <= 0:
        return None
    e = e_store.T if transposed else e_store    # back to (d_in, d_out)
    return truncated_svd_adapter(e, cfg.res_rank, dtype=dtype)
