"""Phase-aware execution plans: the one place that decides which route a
forward takes.

``resolve_plan`` maps a model config to a :class:`PhaseRoute` per phase
(prefill, decode, train); the model entry points read their phase's route
and thread it down to every linear and attention call.  Routes:

  linear    ``kernel`` (CUDA SpMM and decode-attention kernels) |
            ``reference`` (dense decode + GEMM and the attention kernels'
            plain versions, the differentiable oracle)
  kv        ``dense`` (slot-indexed cache) | ``paged`` (global page pool
            + per-slot page table, read by the paged-attention kernels)
  repr      ``native`` (the layer's base) | ``nf4`` / ``bitmap_nf4``
            (the layer's NF4 twin ``SALRLinear.qbase``)
  kv_dtype  ``native`` | ``int8`` | ``nf4``: the precision of the
            phase's KV cache, dequantized inside the decode kernels

MoE routes come with the MoE slice.

Precedence: explicit per-call argument > threaded plan route > active
``plan_scope`` > ``resolve_plan(cfg)`` default.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

LINEAR_ROUTES = ("kernel", "reference")
KV_ROUTES = ("dense", "paged")
REPR_ROUTES = ("native", "nf4", "bitmap_nf4")
KV_DTYPES = ("native", "int8", "nf4")
PHASES = ("prefill", "decode", "train")


@dataclasses.dataclass(frozen=True)
class PhaseRoute:
    """Concrete routes for one phase: every SALR linear follows ``linear``
    and reads the base ``repr``; the phase's KV cache has layout ``kv``
    and precision ``kv_dtype``."""
    linear: str                    # kernel | reference
    kv: str = "dense"              # dense | paged
    repr: str = "native"
    kv_dtype: str = "native"

    def __post_init__(self):
        if self.linear not in LINEAR_ROUTES:
            raise ValueError(f"unknown linear route {self.linear!r}")
        if self.kv not in KV_ROUTES:
            raise ValueError(f"unknown KV route {self.kv!r}")
        if self.repr not in REPR_ROUTES:
            raise ValueError(f"unknown base repr {self.repr!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown KV dtype {self.kv_dtype!r}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolved per-phase routes for one model."""
    prefill: PhaseRoute
    decode: PhaseRoute
    train: PhaseRoute

    def route(self, phase: str) -> PhaseRoute:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r} (want one of {PHASES})")
        return getattr(self, phase)

    def linear_backend(self, phase: str) -> str:
        return self.route(phase).linear

    def kv_layout(self, phase: str) -> str:
        return self.route(phase).kv

    def base_repr(self, phase: str) -> str:
        return self.route(phase).repr

    def kv_dtype(self, phase: str) -> str:
        return self.route(phase).kv_dtype

    def describe(self) -> dict:
        """JSON-stable summary (serve logging, engine metrics)."""
        return {ph: dataclasses.asdict(self.route(ph)) for ph in PHASES}


def resolve_plan(cfg, *, backend: Optional[str] = None,
                 overrides: Optional[dict] = None) -> ExecutionPlan:
    """Resolve a model's execution plan; the only reader of
    ``cfg.salr.backend``.

    Prefill and decode follow the backend; train always takes the
    reference formulation.  Decode resolves to the ``paged`` KV layout
    under both backends (the layout is storage, not arithmetic); prefill
    and train stay ``dense``.  ``overrides`` ({phase: {field: value}})
    apply last, e.g. ``{"decode": {"kv": "dense"}}`` for a run without
    paging.

    Precision: ``cfg.kv_cache`` sets the KV dtype of both cache-writing
    phases (prefill builds the cache decode reads);
    ``cfg.decode_kv_cache`` quantizes only decode (prefill stays native
    and the cache is quantized on its way into the decode cache);
    ``cfg.salr.decode_repr`` serves decode linears from the NF4 twin
    while prefill reads the native base.  Train never quantizes."""
    b = backend if backend is not None else cfg.salr.backend
    if b not in LINEAR_ROUTES:
        raise ValueError(f"unknown SALR backend {b!r}")
    kv_dt = cfg.kv_cache if cfg.kv_cache in KV_DTYPES else "native"
    dec_kv = cfg.decode_kv_cache or kv_dt
    dec_repr = cfg.salr.decode_repr or "native"
    routes = {
        "prefill": PhaseRoute(b, kv_dtype=kv_dt),
        "decode": PhaseRoute(b, kv="paged", repr=dec_repr, kv_dtype=dec_kv),
        "train": PhaseRoute("reference"),
    }
    for ph, ov in (overrides or {}).items():
        if ph not in PHASES:
            raise ValueError(f"unknown phase {ph!r} in overrides")
        routes[ph] = dataclasses.replace(routes[ph], **ov)
    return ExecutionPlan(**routes)


_PLAN_OVERRIDE: list = []          # stack of ExecutionPlan


@contextlib.contextmanager
def plan_scope(plan: ExecutionPlan):
    """Scoped plan override consulted by calls that were not handed an
    explicit route (model entry points read their own phase from it;
    direct ``apply_salr`` calls read its prefill route)."""
    _PLAN_OVERRIDE.append(plan)
    try:
        yield
    finally:
        _PLAN_OVERRIDE.pop()


def current_override() -> Optional[ExecutionPlan]:
    """Innermost active ``plan_scope`` plan, or None."""
    return _PLAN_OVERRIDE[-1] if _PLAN_OVERRIDE else None
