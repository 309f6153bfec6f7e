"""Model building blocks: SALR-aware linears, RMSNorm, RoPE, the MLPs
(SwiGLU, squared ReLU, GELU), embedding and LM head.

Every projection goes through ``init_linear``/``apply_linear``: a linear
of a compressed target family is a ``SALRLinear`` (frozen base in the
config's SALR method + fused adapters), any other linear a plain
``{"w": (d_in, d_out)}``.
Weights are drawn from an explicit CPU ``torch.Generator`` (the same
draws on every device) and then moved to ``device``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.salr import SALRConfig, SALRLinear, apply_salr, compress_linear


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def salr_cfg_for(cfg: ArchConfig) -> SALRConfig:
    """The compression config of every target family (attn, mlp and the
    MoE expert stacks alike)."""
    s = cfg.salr
    # a quantized decode repr needs the twin, so it switches dual_repr on
    dual = s.dual_repr or s.decode_repr not in (None, "native")
    return SALRConfig(sparsity=s.sparsity, method=s.method,
                      lora_rank=s.lora_rank, res_rank=s.res_rank,
                      dtype=cfg.dtype, backend=s.backend, dual_repr=dual)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, cfg: ArchConfig,
                target: str, device, transposed: bool = False):
    """A model linear, W ~ N(0, 1/d_in): SALR-compressed when the target
    family is enabled.  ``transposed``: a flat base stores W^T (the
    reference passes it for wq/wk/wv and gate/up)."""
    w = (torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)).to(device)
    if cfg.salr.enabled and target in cfg.salr.targets:
        return compress_linear(gen, w, salr_cfg_for(cfg), transposed=transposed)
    return {"w": w.to(model_dtype(cfg))}


def apply_linear(p, x: torch.Tensor, route=None, backend=None,
                 base_repr=None) -> torch.Tensor:
    """SALR layers follow the explicit ``backend`` / ``base_repr``, else
    the threaded phase ``route`` (``core.execplan.PhaseRoute``: its
    ``linear`` and ``repr``), else the plan scope and the layer's own."""
    if isinstance(p, SALRLinear):
        if backend is None and route is not None:
            backend = route.linear
        if base_repr is None and route is not None:
            base_repr = route.repr
        return apply_salr(x, p, backend=backend, base_repr=base_repr)
    return x @ p["w"]


def init_rmsnorm(d: int, cfg: ArchConfig, device):
    return {"scale": torch.ones(d, dtype=model_dtype(cfg), device=device)}


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, the scale multiplied in the model dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Angles in f32, the rotation
    in the activation dtype."""
    hd = x.shape[-1]
    ang = positions[..., None].float() * rope_freqs(hd, theta, x.device)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_mlp(gen: torch.Generator, cfg: ArchConfig, kind: str, device):
    """The linears of ``mlp_linears(kind)``, drawn in that order; gate and
    up transposed, as the reference draws them."""
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"gate": (d, f, True), "up": (d, f, True), "down": (f, d, False)}
    return {n: init_linear(gen, shapes[n][0], shapes[n][1], cfg, "mlp", device,
                           transposed=shapes[n][2]) for n in mlp_linears(kind)}


def mlp_linears(kind: str) -> tuple:
    """The linears of an MLP of ``kind``: SwiGLU gate, up and down; relu2
    and gelu up and down."""
    if kind == "swiglu":
        return ("gate", "up", "down")
    if kind in ("relu2", "gelu"):
        return ("up", "down")
    raise ValueError(f"mlp kind {kind!r}")


def apply_mlp(p, x: torch.Tensor, kind: str, route=None) -> torch.Tensor:
    """SwiGLU ``down(silu(gate(x)) * up(x))``, relu2 ``down(relu(up(x))^2)``,
    gelu ``down(gelu(up(x)))`` with the tanh approximation (the default of
    ``jax.nn.gelu``, which the reference calls)."""
    if kind == "swiglu":
        h = torch.nn.functional.silu(apply_linear(p["gate"], x, route)) * \
            apply_linear(p["up"], x, route)
    elif kind == "relu2":
        h = torch.relu(apply_linear(p["up"], x, route)).square()
    elif kind == "gelu":
        h = torch.nn.functional.gelu(apply_linear(p["up"], x, route), approximate="tanh")
    else:
        raise ValueError(f"mlp kind {kind!r}")
    return apply_linear(p["down"], h, route)


def padded_vocab(cfg: ArchConfig, mult: int = 256) -> int:
    return ((cfg.vocab_size + mult - 1) // mult) * mult


def init_embedding(gen: torch.Generator, cfg: ArchConfig, device):
    emb = torch.randn((padded_vocab(cfg), cfg.d_model), generator=gen) * 0.02
    return {"table": emb.to(device=device, dtype=model_dtype(cfg))}


def apply_embedding(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def init_lm_head(gen: torch.Generator, cfg: ArchConfig, device):
    w = torch.randn((cfg.d_model, padded_vocab(cfg)), generator=gen) / math.sqrt(cfg.d_model)
    return {"w": w.to(device=device, dtype=model_dtype(cfg))}


def apply_lm_head(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
