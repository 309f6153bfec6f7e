"""Mixture-of-Experts layer: per-token top-k routing and SALR-compressed
expert stacks, with three expert-compute routes (the reference's
``repro.models.moe``).

Routing is strictly per token: a token's experts and combine weights are
functions of its own router logits only, never of which tokens share the
batch, so a prefill of S tokens, a bucket-padded engine prefill and a
decode tick of n_slots tokens route a token alike.  Expert compute
follows the phase's ``PhaseRoute.moe``:

  ``grouped``       assignments stable-sorted by expert into block-aligned
                    groups (``group_assignments``, on the device, no host
                    sync); ``ops.grouped_{salr,qsalr,nm,dense}_matmul``, by
                    the stack's base, run gate, up and down over the
                    grouped rows (k-way work)
  ``decode_grid``   rows in plain token-major assignment order, a
                    ``row_expert`` map with -1 on pad rows;
                    ``ops.decode_{salr,qsalr,nm,dense}_matmul``
  ``dense_masked``  every expert over every token, the combine zeroing the
                    unselected (E-way): the reference formulation

Both kernel routes reduce every row in the same fixed order, so they are
bitwise equal per row and bitwise invariant to co-batched tokens; each
combines a token's k expert outputs in top-k slot order 0..k-1.  A
quantized base repr (the phase's ``repr``) reads a tiled stack's NF4
twin on the kernel routes and any stack's twin on the oracle, as the
reference does.  Shared experts (DeepSeek) are one dense SwiGLU of width
``moe_d_ff x n_shared_experts`` over every token, through
``apply_linear``, added to the routed experts' output.  The kernel
wrappers are forward-only.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import bitmap as bm
from repro_torch.core import execplan
from repro_torch.core import salr
from repro_torch.core.salr import SALRLinear
from repro_torch.models.layers import (apply_linear, apply_rmsnorm, init_linear, init_rmsnorm,
                                       model_dtype, salr_cfg_for)

# the most weights of an expert stack drawn, compressed or decoded at once:
# a larger stack (deepseek_v3_671b's 256 x 7168 x 2048) is handled in
# chunks along E; an expert's compress and its product depend on its own
# weights only, so chunking changes no expert's value
STACK_CHUNK_ELEMS = 1 << 28

# the open ``router_logits_tap`` lists, each collecting route_tokens' logits
_TAPS: list = []


class RouterTap(list):
    """The (N, E) f32 router logits of every ``route_tokens`` call made
    while the tap is open, in call order (a forward routes its MoE layers
    in order).  The call numbered ``swap_at`` gives its last token the
    (k+1)-th expert in place of the k-th: the other side of a top-k
    near-tie."""

    def __init__(self, swap_at: Optional[int] = None):
        super().__init__()
        self.swap_at = swap_at


@contextlib.contextmanager
def router_logits_tap(swap_at: Optional[int] = None):
    """Open a ``RouterTap`` for the calls made inside the block.
    ``serve.parity_report`` reads a token's top-k margin here and replays
    the step with a tied pair swapped."""
    tap = RouterTap(swap_at)
    _TAPS.append(tap)
    try:
        yield tap
    finally:
        _TAPS.remove(tap)


def route_tokens(router_w: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig):
    """Per-token top-k routing.  tokens: (N, d).  Returns (top_i (N, k)
    int64, weights (N, k) f32, keep (N, k) bool).

    The logits are summed in float64 and rounded to float32: the products
    of f32 inputs are exact in f64, so however a library orders the sum,
    it rounds to the same f32 logit (short of a sum within ~1e-13 of a
    rounding boundary), and a token's logits do not depend on how many
    tokens share the product, which f32 GEMMs do not promise.  Softmax in
    f32; top-k by a stable descending sort (the lower expert first on a
    tie, as ``jax.lax.top_k``); an assignment below
    ``cfg.moe_drop_threshold`` is dropped and the kept weights are
    renormalized, their sum taken in slot order."""
    logits = (tokens.double() @ router_w.double()).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    for tap in _TAPS:
        if tap.swap_at == len(tap):
            for t in (top_p, top_i):
                t[-1, [k - 1, k]] = t[-1, [k, k - 1]]
        tap.append(logits)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    keep = top_p >= cfg.moe_drop_threshold
    w = torch.where(keep, top_p, torch.zeros((), dtype=top_p.dtype, device=top_p.device))
    total = w[:, 0]
    for j in range(1, k):
        total = total + w[:, j]
    return top_i, w / total.clamp(min=1e-9)[:, None], keep


def combine_weights(top_i: torch.Tensor, w: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Scatter per-assignment weights into a dense (N, E) combine matrix
    (a row's top-k experts are distinct)."""
    c = torch.zeros((top_i.shape[0], n_experts), dtype=w.dtype, device=w.device)
    return c.scatter_add_(1, top_i, w)


def init_moe(gen: torch.Generator, cfg: ArchConfig, device):
    """Router (d, E) f32, the MoE norm, and the gate/up (E, d, moe_d_ff)
    and down (E, moe_d_ff, d) expert stacks, each W ~ N(0, 1/d_in),
    compressed through ``salr.compress_stack`` when the ``expert`` target
    is enabled (else a plain ``{"w"}`` stack in the model dtype), in
    chunks of experts of at most ``STACK_CHUNK_ELEMS`` weights, each chunk
    drawn on ``device`` from a generator seeded from ``gen`` (a deepseek
    stack is too large to draw on the host in time); with
    ``n_shared_experts``, the shared SwiGLU's gate/up (stored W^T when
    flat, as the reference builds them) and down."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    compress = cfg.salr.enabled and "expert" in cfg.salr.targets

    def expert_stack(d_in, d_out):
        chunk = max(1, STACK_CHUNK_ELEMS // (d_in * d_out))
        parts = []
        for e0 in range(0, e, chunk):
            dgen = torch.Generator(device).manual_seed(
                int(torch.randint(1 << 62, (1,), generator=gen)))
            w = torch.randn((min(chunk, e - e0), d_in, d_out), generator=dgen,
                            device=device) / math.sqrt(d_in)
            parts.append(salr.compress_stack(gen, w, salr_cfg_for(cfg)) if compress
                         else w.to(model_dtype(cfg)))
            del w
        stack = parts[0] if len(parts) == 1 else salr.cat_stacks(parts)
        return stack if compress else {"w": stack}

    router = torch.randn((d, e), generator=gen) / math.sqrt(d)
    p = {"norm": init_rmsnorm(d, cfg, device),
         "router": {"w": router.to(device=device, dtype=torch.float32)},
         "gate": expert_stack(d, f), "up": expert_stack(d, f), "down": expert_stack(f, d)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "gate": init_linear(gen, d, fs, cfg, "expert", device, transposed=True),
            "up": init_linear(gen, d, fs, cfg, "expert", device, transposed=True),
            "down": init_linear(gen, fs, d, cfg, "expert", device)}
    return p


# ---------------------------------------------------------------------------
# dense_masked: every expert over every token (the reference formulation)
# ---------------------------------------------------------------------------

def _stacked_adapter_cat(stack: SALRLinear) -> tuple:
    """A_cat (E, d_in, R) / B_cat (E, R, d_out) of an expert stack: the
    LoRA and residual adapters concatenated along the trailing rank axes
    (scales folded into B)."""
    lora, res = stack.lora, stack.res
    if res is None:
        return lora.a, lora.b * lora.scale
    return (torch.cat([lora.a, res.a], dim=-1),
            torch.cat([lora.b * lora.scale, res.b * res.scale], dim=-2))


def _expert_matmul(stack, x: torch.Tensor, base_repr=None) -> torch.Tensor:
    """Every expert applied to its input: x (N, d_in) shared by all, or
    (E, N, d_in) per expert.  Returns (E, N, d_out): the stack decoded
    dense and multiplied as the reference's per-expert
    ``_apply_reference`` does (a quantized ``base_repr`` decodes the NF4
    twin, a dense or masked stack's ``QDenseWeight`` included), a chunk of
    experts at a time."""
    if not isinstance(stack, SALRLinear):
        return x @ stack["w"].to(x.dtype)
    quant = salr._resolve_repr(base_repr) != "native" and stack.qbase is not None
    base = stack.qbase if quant else stack.base
    a_cat, b_cat = _stacked_adapter_cat(stack)
    # decoded STACK_CHUNK_ELEMS weights at a time (one chunk below that)
    chunk = max(1, STACK_CHUNK_ELEMS // (stack.d_in * stack.d_out))
    outs = []
    for e0 in range(0, a_cat.shape[0], chunk):
        sl = slice(e0, e0 + chunk)
        w = salr.materialize_base(salr.slice_stack(base, sl))[..., :stack.d_out]
        xe = x if x.ndim == 2 else x[sl]
        outs.append(xe @ w.to(x.dtype) + (xe @ a_cat[sl]) @ b_cat[sl])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _experts_reference(p, tokens: torch.Tensor, top_i: torch.Tensor, w: torch.Tensor,
                       cfg: ArchConfig, base_repr=None) -> torch.Tensor:
    """E-way dense masked compute: every expert over the full token set,
    the combine einsum zeroing the experts a token did not select.  It
    takes the reference formulation whatever the phase's linear route
    (under a kernel linear route the reference runs each expert's fused
    kernel here instead; the numbers agree within ``method:*``)."""
    cw = combine_weights(top_i, w, cfg.n_experts).to(tokens.dtype)
    gate = _expert_matmul(p["gate"], tokens, base_repr)
    up = _expert_matmul(p["up"], tokens, base_repr)
    out = _expert_matmul(p["down"], torch.nn.functional.silu(gate) * up,
                         base_repr)                                  # (E, N, d)
    return torch.einsum("ne,end->nd", cw, out)


# ---------------------------------------------------------------------------
# kernel routes: grouped rows and the decode grid
# ---------------------------------------------------------------------------

class GroupedAssignments(NamedTuple):
    """Static-shape grouping of (token, expert) assignment pairs.
    ``tok``/``dst`` are indexed by sorted assignment position: position p
    reads token row ``tok[p]`` and lands on grouped row ``dst[p]``;
    ``inv`` maps assignment order back to sorted position;
    ``tile_expert[i]`` owns grouped rows [i*block_m, (i+1)*block_m) (slack
    tiles are clamped to expert E-1 and hold zero rows)."""
    tok: torch.Tensor           # (A,) int64
    inv: torch.Tensor           # (A,) int64
    dst: torch.Tensor           # (A,) int64
    tile_expert: torch.Tensor   # (m_pad / block_m,) int32
    m_pad: int
    block_m: int


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _group_block_m(n_assign: int, n_experts: int) -> int:
    """M-tile height near the mean group size: 8 at decode, up to 128."""
    mean = -(-n_assign // max(n_experts, 1))
    return max(8, min(128, _round_up(mean, 8)))


def group_assignments(top_i: torch.Tensor, n_experts: int, block_m: int) -> GroupedAssignments:
    """Sort token-expert pairs into contiguous, ``block_m``-aligned expert
    groups (a stable sort keeps an expert's assignments in token order),
    on top_i's device without a host sync: ``m_pad`` is the static bound
    ``A + min(E, A) * (block_m - 1)`` rounded up, the group sizes a
    scatter-add (not ``bincount``, which reads the maximum back)."""
    n, k = top_i.shape
    a = n * k
    dev = top_i.device
    e_flat = top_i.reshape(a).long()
    order = torch.argsort(e_flat, stable=True)                # sorted -> assignment
    e_sorted = e_flat[order]
    sizes = torch.zeros(n_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    padded = (sizes + block_m - 1) // block_m * block_m
    ends_pad = torch.cumsum(padded, 0)
    starts_pad = ends_pad - padded
    starts_raw = torch.cumsum(sizes, 0) - sizes
    arange = torch.arange(a, device=dev)
    dst = starts_pad[e_sorted] + arange - starts_raw[e_sorted]
    m_pad = _round_up(a + min(n_experts, a) * (block_m - 1), block_m)
    tile_start = torch.arange(0, m_pad, block_m, device=dev)
    tile_expert = torch.searchsorted(ends_pad, tile_start, right=True)
    tile_expert = tile_expert.clamp(max=n_experts - 1).to(torch.int32)
    inv = torch.empty_like(order).scatter_(0, order, arange)
    return GroupedAssignments(tok=order // k, inv=inv, dst=dst, tile_expert=tile_expert,
                              m_pad=m_pad, block_m=block_m)


def _grouped_capable(stack) -> bool:
    """Whether a grouped/decode-grid kernel exists for this stack's base
    layout (the reference's capability rule): tiled bitmaps, untransposed
    N:M, dense or masked tensors and plain ``{"w"}`` stacks; flat bitmap
    storage has none."""
    if not isinstance(stack, SALRLinear):
        return True
    base = stack.base
    if isinstance(base, (bm.TiledBitmapWeight, bm.QTiledBitmapWeight)):
        return True
    if isinstance(base, bm.NMWeight):
        return not stack.transposed
    return not isinstance(base, bm.BitmapWeight)


def _repr_base(stack: SALRLinear, base_repr: str):
    """The base the kernel routes stream under ``base_repr``: a quantized
    repr reads the stacked NF4 twin where it is a tiled one (a kernel
    exists for it); every other stack, a dense or masked one with a
    ``QDenseWeight`` twin included, reads its native base, as the
    reference's kernel routes do."""
    if base_repr != "native" and isinstance(stack.qbase, bm.QTiledBitmapWeight):
        return stack.qbase
    return stack.base


# (the op's family in ops: grouped_* / decode_*) by base type
_OP_FAMILY = ((bm.TiledBitmapWeight, "salr"), (bm.QTiledBitmapWeight, "qsalr"),
              (bm.NMWeight, "nm"), (torch.Tensor, "dense"))


def _expert_op(route: str, stack, xs: torch.Tensor, base_repr: str) -> tuple:
    """(op, base, A_cat, B_cat) of one expert-stack matmul on a kernel
    route ("grouped" or "decode"), dispatched on the base layout: a plain
    ``{"w"}`` stack takes the dense op without adapters, a dense or masked
    base the dense op as x's dtype."""
    from repro_torch.kernels import ops
    if not isinstance(stack, SALRLinear):
        return getattr(ops, f"{route}_dense_matmul"), stack["w"].to(xs.dtype), None, None
    base = _repr_base(stack, base_repr)
    family = next(f for t, f in _OP_FAMILY if isinstance(base, t))
    if family == "dense":
        base = base.to(xs.dtype)
    return (getattr(ops, f"{route}_{family}_matmul"), base, *_stacked_adapter_cat(stack))


def _d_out(stack) -> Optional[int]:
    return stack.d_out if isinstance(stack, SALRLinear) else None


def _grouped_linear(stack, xs: torch.Tensor, g: GroupedAssignments,
                    base_repr: str = "native") -> torch.Tensor:
    op, base, a_cat, b_cat = _expert_op("grouped", stack, xs, base_repr)
    return op(xs, g.tile_expert, base, a_cat, b_cat, block_m=g.block_m)[:, :_d_out(stack)]


def _decode_grid_linear(stack, xs: torch.Tensor, row_expert: torch.Tensor,
                        base_repr: str = "native") -> torch.Tensor:
    op, base, a_cat, b_cat = _expert_op("decode", stack, xs, base_repr)
    return op(xs, row_expert, base, a_cat, b_cat)[:, :_d_out(stack)]


def _combine(w: torch.Tensor, per: torch.Tensor) -> torch.Tensor:
    """sum_j w[:, j] * per[:, j] taken elementwise in slot order 0..k-1 in
    f32, the weights first rounded to the activation dtype, one rounding
    of the sum: a fixed order per token, whatever the batch."""
    wf = w.to(per.dtype).float()
    pf = per.float()
    y = wf[:, 0, None] * pf[:, 0]
    for j in range(1, per.shape[1]):
        y.addcmul_(wf[:, j, None], pf[:, j])
    return y.to(per.dtype)


def _ffn(linear, p, xs: torch.Tensor, emap, base_repr: str) -> torch.Tensor:
    gate = linear(p["gate"], xs, emap, base_repr)
    up = linear(p["up"], xs, emap, base_repr)
    return linear(p["down"], torch.nn.functional.silu(gate) * up, emap, base_repr)


def _grouped_ffn(cfg: ArchConfig, p, tokens: torch.Tensor, top_i: torch.Tensor,
                 w: torch.Tensor, base_repr: str = "native") -> torch.Tensor:
    """k-way expert FFN over the grouped row buffer: token rows gathered
    into block-aligned expert groups (pad rows zero), gate/up/down as
    grouped GEMMs, each assignment's output gathered back and combined in
    slot order."""
    n, k = top_i.shape
    g = group_assignments(top_i, cfg.n_experts, _group_block_m(n * k, cfg.n_experts))
    xs = tokens.new_zeros((g.m_pad, tokens.shape[-1]))
    xs.index_copy_(0, g.dst, tokens.index_select(0, g.tok))
    out = _ffn(_grouped_linear, p, xs, g, base_repr)               # (m_pad, d)
    per = out.index_select(0, g.dst[g.inv]).reshape(n, k, -1)     # assignment order
    return _combine(w, per)


def _decode_grid_ffn(cfg: ArchConfig, p, tokens: torch.Tensor, top_i: torch.Tensor,
                     w: torch.Tensor, base_repr: str = "native") -> torch.Tensor:
    """Expert FFN over assignment-order rows: row a is token a // k's
    assignment a % k, rows padded to a multiple of 8 with ``row_expert``
    -1; per row bitwise equal to :func:`_grouped_ffn`."""
    n, k = top_i.shape
    a = n * k
    m_pad = _round_up(a, 8)
    xs = tokens[:, None, :].expand(n, k, tokens.shape[-1]).reshape(a, -1)
    xs = torch.nn.functional.pad(xs, (0, 0, 0, m_pad - a))
    row_expert = torch.nn.functional.pad(top_i.reshape(a).to(torch.int32), (0, m_pad - a),
                                         value=-1)
    out = _ffn(_decode_grid_linear, p, xs, row_expert, base_repr)
    return _combine(w, out[:a].reshape(n, k, -1))


_KERNEL_FFNS = {"grouped": _grouped_ffn, "decode_grid": _decode_grid_ffn}

_ROUTE_DESCRIPTIONS = {
    "grouped": "grouped ragged GEMM, k-way work (csrc/grouped_spmm.cu, TileMap)",
    "decode_grid": "decode grid, each block gathering its expert's assignment rows "
                   "(csrc/grouped_spmm.cu, RowMap)",
    "dense_masked": "dense masked einsum over the expert stack (E-way oracle)",
}


def _resolve_moe_route(cfg: ArchConfig, route, backend: Optional[str]) -> str:
    """Explicit ``route`` (a string or a threaded ``PhaseRoute``) >
    explicit ``backend`` ("kernel": grouped, "reference": the oracle) >
    plan scope > ``resolve_plan(cfg)``; a call with no phase context
    resolves as prefill."""
    if isinstance(route, execplan.PhaseRoute):
        route = route.moe
    if route is None and backend is not None:
        if backend not in ("kernel", "reference"):
            raise ValueError(f"unknown MoE backend {backend!r}")
        route = "grouped" if backend == "kernel" else "dense_masked"
    if route is None:
        pl = execplan.current_override() or execplan.resolve_plan(cfg)
        route = pl.moe_route("prefill")
    if route not in execplan.MOE_ROUTES:
        raise ValueError(f"unknown MoE route {route!r}")
    return route


def moe_route_description(cfg: ArchConfig, route) -> str:
    """What an MoE layer runs under ``route`` (a string or PhaseRoute)."""
    return _ROUTE_DESCRIPTIONS[_resolve_moe_route(cfg, route, None)]


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig, route=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, d) -> x + moe(x).  Every token is routed on its own
    (``route_tokens``); expert compute follows the resolved MoE route,
    reading the base repr of a threaded ``PhaseRoute`` (native
    otherwise).  Shared experts follow the phase's linear route."""
    b, s, d = x.shape
    xn = apply_rmsnorm(p["norm"], x, cfg.norm_eps)
    tokens = xn.reshape(b * s, d)
    top_i, w, _ = route_tokens(p["router"]["w"], tokens, cfg)
    r = _resolve_moe_route(cfg, route, backend)
    phase = route if isinstance(route, execplan.PhaseRoute) else None
    base_repr = phase.repr if phase else "native"
    if r != "dense_masked" and not all(_grouped_capable(p[t]) for t in ("gate", "up", "down")):
        r = "dense_masked"
    if r == "dense_masked":
        y = _experts_reference(p, tokens, top_i, w, cfg, base_repr=base_repr)
    else:
        y = _KERNEL_FFNS[r](cfg, p, tokens, top_i, w, base_repr)
    y = y.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        hs = (torch.nn.functional.silu(apply_linear(sh["gate"], xn, phase))
              * apply_linear(sh["up"], xn, phase))
        y = y + apply_linear(sh["down"], hs, phase)
    return x + y
