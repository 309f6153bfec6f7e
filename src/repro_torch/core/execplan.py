"""Phase-aware execution plans: the one place that decides which route a
forward takes.

``resolve_plan`` maps a model config to a :class:`PhaseRoute` per phase
(prefill, decode, train); the model entry points read their phase's route
and thread it down to every linear, MoE and attention call.  Routes:

  linear    ``kernel`` (CUDA SpMM and decode-attention kernels) |
            ``reference`` (dense decode + GEMM and the attention kernels'
            plain versions, the differentiable oracle)
  moe       ``grouped`` (expert-sorted, block-aligned rows; the grouped
            SALR kernels) | ``decode_grid`` (rows in assignment order,
            each kernel block gathers its expert's rows) |
            ``dense_masked`` (every expert over every token, the oracle)
  kv        ``dense`` (slot-indexed cache) | ``paged`` (global page pool
            + per-slot page table, read by the paged-attention kernels)
  repr      ``native`` (the layer's base) | ``nf4`` / ``bitmap_nf4``
            (the layer's NF4 twin ``SALRLinear.qbase``)
  kv_dtype  ``native`` | ``int8`` | ``nf4``: the precision of the
            phase's KV cache, dequantized inside the decode kernels

The MoE route of a kernel plan follows the phase's token count through
``MoECrossover``: ``grouped`` at the extremes, ``decode_grid`` in the
8-256 token band.  The two kernel routes are bitwise equal per row, so
the plan may cross between them without changing a served token.

Precedence: explicit per-call argument > threaded plan route > active
``plan_scope`` > ``resolve_plan(cfg)`` default.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

LINEAR_ROUTES = ("kernel", "reference")
MOE_ROUTES = ("grouped", "decode_grid", "dense_masked")
KV_ROUTES = ("dense", "paged")
REPR_ROUTES = ("native", "nf4", "bitmap_nf4")
KV_DTYPES = ("native", "int8", "nf4")
PHASES = ("prefill", "decode", "train")

# characteristic token counts when the caller does not know the phase's
# real shape: prefill/train batches are large (grouped regime), a decode
# tick advances one token per slot
_DEFAULT_PHASE_TOKENS = {"prefill": 4096, "decode": 1, "train": 4096}


@dataclasses.dataclass(frozen=True)
class MoECrossover:
    """Token-count crossover of the MoE kernel routes: ``route_for(n)`` is
    ``mid_route`` for n in [``grid_min_tokens``, ``grid_max_tokens``],
    ``small_route`` below and ``large_route`` above.  The defaults are the
    reference's committed table."""
    grid_min_tokens: int = 8
    grid_max_tokens: int = 256
    small_route: str = "grouped"
    mid_route: str = "decode_grid"
    large_route: str = "grouped"

    def __post_init__(self):
        for r in (self.small_route, self.mid_route, self.large_route):
            if r not in MOE_ROUTES:
                raise ValueError(f"unknown MoE route {r!r}")

    def route_for(self, n_tokens: int) -> str:
        if n_tokens < self.grid_min_tokens:
            return self.small_route
        if n_tokens <= self.grid_max_tokens:
            return self.mid_route
        return self.large_route

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_CROSSOVER = MoECrossover()


@dataclasses.dataclass(frozen=True)
class PhaseRoute:
    """Concrete routes for one phase: every SALR linear follows ``linear``
    and reads the base ``repr``, every MoE layer follows ``moe``; the
    phase's KV cache has layout ``kv`` and precision ``kv_dtype``."""
    linear: str                    # kernel | reference
    moe: str                       # grouped | decode_grid | dense_masked
    kv: str = "dense"              # dense | paged
    repr: str = "native"
    kv_dtype: str = "native"

    def __post_init__(self):
        if self.linear not in LINEAR_ROUTES:
            raise ValueError(f"unknown linear route {self.linear!r}")
        if self.moe not in MOE_ROUTES:
            raise ValueError(f"unknown MoE route {self.moe!r}")
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
    crossover: MoECrossover = DEFAULT_CROSSOVER

    def route(self, phase: str) -> PhaseRoute:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r} (want one of {PHASES})")
        return getattr(self, phase)

    def linear_backend(self, phase: str) -> str:
        return self.route(phase).linear

    def moe_route(self, phase: str) -> str:
        return self.route(phase).moe

    def kv_layout(self, phase: str) -> str:
        return self.route(phase).kv

    def base_repr(self, phase: str) -> str:
        return self.route(phase).repr

    def kv_dtype(self, phase: str) -> str:
        return self.route(phase).kv_dtype

    def describe(self) -> dict:
        """JSON-stable summary (serve logging, engine metrics), the
        reference's fields: each phase's routes and the crossover table."""
        return {**{ph: dataclasses.asdict(self.route(ph)) for ph in PHASES},
                "crossover": self.crossover.as_dict()}


def resolve_plan(cfg, *, backend: Optional[str] = None,
                 phase_tokens: Optional[dict] = None,
                 crossover: Optional[MoECrossover] = None,
                 overrides: Optional[dict] = None) -> ExecutionPlan:
    """Resolve a model's execution plan; the only reader of
    ``cfg.salr.backend``.

    Prefill and decode follow the backend; train always takes the
    reference formulation (``reference`` linears, ``dense_masked`` MoE).
    Under the kernel backend a phase's MoE route is
    ``crossover.route_for`` of its token count: ``phase_tokens`` (the
    engine passes its largest prefill bucket and its slot count), else
    the defaults (prefill and train large, decode 1); the reference
    backend's is ``dense_masked``.

    Decode resolves to the ``paged`` KV layout under both backends (the
    layout is storage, not arithmetic); prefill and train stay ``dense``.
    ``overrides`` ({phase: {field: value}}) apply last, e.g.
    ``{"decode": {"kv": "dense"}}`` for a run without paging.

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
    xo = crossover or DEFAULT_CROSSOVER
    toks = {**_DEFAULT_PHASE_TOKENS, **(phase_tokens or {})}

    def moe(phase):
        return xo.route_for(toks[phase]) if b == "kernel" else "dense_masked"
    routes = {
        "prefill": PhaseRoute(b, moe("prefill"), kv_dtype=kv_dt),
        "decode": PhaseRoute(b, moe("decode"), kv="paged", repr=dec_repr,
                             kv_dtype=dec_kv),
        "train": PhaseRoute("reference", "dense_masked"),
    }
    for ph, ov in (overrides or {}).items():
        if ph not in PHASES:
            raise ValueError(f"unknown phase {ph!r} in overrides")
        routes[ph] = dataclasses.replace(routes[ph], **ov)
    return ExecutionPlan(crossover=xo, **routes)


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
