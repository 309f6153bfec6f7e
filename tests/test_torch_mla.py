"""deepseek_v3_671b's MLA slice against the reference on the smoke widths,
from identical numpy inputs and the reference's own parameters carried
over through ``repro_torch.bridge``: the plain ``paged_mla_attention``
against the reference's Pallas kernel in interpret mode (finite junk in
dead pages; NaN there on the port alone), ``apply_mla`` prefill (with and
without a shared prefix) and decode (slot latent cache and paged pools),
``effective_weight``, ``apply_moe`` with the shared expert, and the
bridge's orientation of every MLA projection and shared-expert linear
under the bitmap, N:M and masked-dense methods.  No whole-model init:
the reference's ``init_mla`` / ``init_moe`` per method only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bitmap as jbm
from repro.core import execplan as jplan
from repro.core import salr as jsalr
from repro.kernels import paged_attention as jpaged
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.bridge import MLA_LINEARS, TRANSPOSED, _carry_linears, carry_mixer, carry_moe
from repro_torch.core import execplan as tplan
from repro_torch.core import salr as tsalr
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe

ARCH = "deepseek_v3_671b"
# the port's native routes against the reference's formulation
BUDGET = ERROR_BUDGETS["method:bitmap"]
# the attention alone: f32 throughout, so only the summation order differs
ATT_BUDGET = ERROR_BUDGETS["method:dense"]
PROMPT = 12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(**fields):
    """The smoke arch in both packages, SALR fields replaced."""
    out = []
    for configs in (jconfigs, tconfigs):
        cfg = configs.get(ARCH, smoke=True)
        out.append(cfg.with_(salr=dataclasses.replace(cfg.salr, **fields)))
    return out


def _flat(tree, part: str) -> dict:
    """A reference subtree as the bridge's flat keystr dict under ``part``
    with a one-entry repeats axis."""
    return {part + jax.tree_util.keystr(p): np.asarray(leaf)[None]
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def carried():
    """The reference's MLA mixer and MoE block (with its shared expert) per
    method, and their ports; built once per method."""
    built = {}

    def get(method):
        if method not in built:
            jcfg, tcfg = _cfgs(method=method)
            jm = jattn.init_mla(jax.random.PRNGKey(1), jcfg)
            tm = carry_mixer(_flat(jm, "['mixer']"), "", 0, "mla", tcfg, "cpu")
            if method == "bitmap":
                jmo = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
                tmo = carry_moe(_flat(jmo, "['moe']"), "", 0, tcfg, "cpu")
            else:       # the shared expert alone: the routed stacks have tests of their own
                f = jcfg.moe_d_ff * jcfg.n_shared_experts
                ks = jax.random.split(jax.random.PRNGKey(3), 3)
                jmo = {"shared": {
                    "gate": jlayers.init_linear(ks[0], jcfg.d_model, f, jcfg, "expert",
                                                transposed=True),
                    "up": jlayers.init_linear(ks[1], jcfg.d_model, f, jcfg, "expert",
                                              transposed=True),
                    "down": jlayers.init_linear(ks[2], f, jcfg.d_model, jcfg, "expert")}}
                tmo = {"shared": _carry_linears(_flat(jmo["shared"], "['moe']['shared']"), "",
                                                "['moe']['shared']", ("gate", "up", "down"), 0,
                                                tcfg, "cpu")}
            built[method] = (jcfg, tcfg, jm, tm, jmo, tmo)
        return built[method]
    return get


def _paged_case(seed: int, h: int, r: int, rd: int, ps: int = 4, b: int = 3):
    """Pools with junk in the null page and a freed page, a shuffled page
    table whose entries past each slot's last live page point at those, and
    f32 queries (numpy)."""
    rng = np.random.default_rng(seed)
    max_pages = 5
    n_pages = b * max_pages + 2
    ckv = rng.standard_normal((n_pages, ps, r)).astype(np.float32)
    kr = rng.standard_normal((n_pages, ps, rd)).astype(np.float32)
    table = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    pos = np.array([max_pages * ps - 1, 6, 0][:b], np.int32)
    for i in range(b):
        table[i, pos[i] // ps + 1:] = 0 if i % 2 == 0 else n_pages - 1
    for pool in (ckv, kr):
        pool[[0, n_pages - 1]] = 1e3 * rng.standard_normal(pool[[0, n_pages - 1]].shape)
    q_lat = rng.standard_normal((b, h, r)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, rd)).astype(np.float32)
    return q_lat, q_rope, ckv, kr, table, pos


# (H, kv_rank, rope, qk_dim): the smoke widths and a wider one
SHAPES = {"smoke": (4, 32, 16, 48), "wider": (8, 64, 32, 96)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_mla_attention_matches_reference_kernel(shape):
    """The plain version against the reference's Pallas kernel (interpret
    mode) with finite junk in the null page, a freed page and past each
    slot's position; NaN there (the reference would pass it on through
    0 x NaN) leaves the port's output bitwise unchanged."""
    h, r, rd, qk = SHAPES[shape]
    case = _paged_case(0, h, r, rd)
    args = [torch.from_numpy(a) for a in case]
    y = ops.paged_mla_attention(*args, qk_dim=qk)
    yj = jpaged.paged_mla_attention(*(jnp.asarray(a) for a in case), qk_dim=qk,
                                    interpret=True)
    assert y.shape == (3, h, r) and y.dtype == torch.float32
    assert _rel(y.numpy(), yj) <= ATT_BUDGET
    _, _, ckv, kr, table, pos = case
    live = np.zeros(ckv.shape[:2], bool)
    for i in range(len(pos)):
        for p in range(pos[i] + 1):
            live[table[i, p // ckv.shape[1]], p % ckv.shape[1]] = True
    for t in args[2:4]:
        t[torch.from_numpy(~live)] = float("nan")
    dirty = ops.paged_mla_attention(*args, qk_dim=qk)
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, y, rtol=0, atol=0)


def _mla_inputs(jcfg, seed: int):
    x = (np.random.default_rng(seed).standard_normal((2, PROMPT, jcfg.d_model)) / 2)
    return x.astype(np.float32)


def _routes(jcfg, tcfg, phase: str, backend: str):
    return (jplan.resolve_plan(jcfg, backend="reference").route(phase),
            tplan.resolve_plan(tcfg, backend=backend).route(phase))


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_apply_mla_prefill_matches_reference(carried, backend):
    """Prefill: the output and the latent cache (c_kv, k_rope); then a
    continuation prefill over the first 8 positions as a shared prefix,
    which the reference decompresses again through W_uk / W_uv."""
    jcfg, tcfg, jm, tm, _, _ = carried("bitmap")
    x = _mla_inputs(jcfg, 0)
    jr, tr = _routes(jcfg, tcfg, "prefill", backend)
    positions = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (2, PROMPT))
    jy, jc = jattn.apply_mla(jm, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
                             mode="prefill", route=jr)
    with torch.inference_mode():
        ty, tc = tattn.apply_mla(tm, torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(positions.copy()),
                                 mode="prefill", route=tr)
    assert _rel(ty.numpy(), jy) <= BUDGET
    assert isinstance(tc, tattn.LatentCache)
    assert _rel(tc.ckv.numpy(), jc.ckv) <= BUDGET and _rel(tc.krope.numpy(), jc.krope) <= BUDGET
    lp = 8
    jprefix = jattn.LatentCache(ckv=jc.ckv[:1, :lp], krope=jc.krope[:1, :lp])
    suffix_pos = jnp.arange(lp, PROMPT, dtype=jnp.int32)[None]
    jy2, _ = jattn.apply_mla(jm, jnp.asarray(x[:1, lp:]), jcfg, positions=suffix_pos,
                             mode="prefill", route=jr, prefix=jprefix, q_offset=lp)
    tprefix = tattn.LatentCache(ckv=torch.from_numpy(np.array(jprefix.ckv)),
                                krope=torch.from_numpy(np.array(jprefix.krope)))
    with torch.inference_mode():
        ty2, tc2 = tattn.apply_mla(tm, torch.from_numpy(x[:1, lp:].copy()), tcfg,
                                   positions=torch.from_numpy(np.array(suffix_pos)),
                                   mode="prefill", route=tr, prefix=tprefix, q_offset=lp)
    assert tc2.ckv.shape == (1, PROMPT - lp, tcfg.mla.kv_lora_rank)
    assert _rel(ty2.numpy(), jy2) <= BUDGET
    # the continuation equals the full prefill's rows, as the reference's does
    assert _rel(ty2.numpy(), jy[:1, lp:]) <= BUDGET


def _latent_state(jcfg, seed: int, ctx: int):
    """A (2, ctx) latent cache of seeded values (numpy) and each row's
    decode position."""
    rng = np.random.default_rng(seed)
    m = jcfg.mla
    ckv = rng.standard_normal((2, ctx, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, ctx, m.qk_rope_head_dim)).astype(np.float32)
    return ckv, kr, np.array([PROMPT, 9], np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_apply_mla_decode_matches_reference(carried, monkeypatch, paged, backend):
    """One decode step at per-slot positions over the same latents, on a
    slot LatentCache (plain attention) and on paged pools (the kernel's
    wrapper on the kernel route, its plain version on the reference
    route); the step's latents land where the reference writes them."""
    jcfg, tcfg, jm, tm, _, _ = carried("bitmap")
    ctx, ps = 16, 4
    ckv, kr, pos = _latent_state(jcfg, 1, ctx)
    x = _mla_inputs(jcfg, 2)[:, :1]
    jr, tr = _routes(jcfg, tcfg, "decode", backend)
    calls = []
    real = ops.paged_mla_attention
    monkeypatch.setattr(ops, "paged_mla_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if paged:
        # pool pages in a shuffled order, page 0 the null page
        order = np.random.default_rng(3).permutation(2 * ctx // ps) + 1
        table = order.reshape(2, ctx // ps).astype(np.int32)
        n_pages = 2 * ctx // ps + 1
        pools = [np.zeros((n_pages, ps, a.shape[-1]), np.float32) for a in (ckv, kr)]
        for pool, dense in zip(pools, (ckv, kr)):
            pool[table.reshape(-1)] = dense.reshape(2 * ctx // ps, ps, -1)
        jcache = jattn.PagedLatentCache(ckv=jnp.asarray(pools[0]), krope=jnp.asarray(pools[1]))
        tcache = tattn.PagedLatentCache(*(torch.from_numpy(p.copy()) for p in pools))
        extra = {"page_table": table}
    else:
        jcache = jattn.LatentCache(ckv=jnp.asarray(ckv), krope=jnp.asarray(kr))
        tcache = tattn.LatentCache(ckv=torch.from_numpy(ckv.copy()),
                                   krope=torch.from_numpy(kr.copy()))
        extra = {}
    jy, jc = jattn.apply_mla(jm, jnp.asarray(x), jcfg, positions=jnp.asarray(pos[:, None]),
                             mode="decode", cache=jcache, pos=jnp.asarray(pos), route=jr,
                             **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.inference_mode():
        ty, tc = tattn.apply_mla(tm, torch.from_numpy(x.copy()), tcfg,
                                 positions=torch.from_numpy(pos[:, None].copy()),
                                 mode="decode", cache=tcache, pos=torch.from_numpy(pos),
                                 route=tr, **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert tc is tcache                              # written in place
    assert _rel(ty.numpy(), jy) <= BUDGET
    assert _rel(tc.ckv.numpy(), jc.ckv) <= BUDGET and _rel(tc.krope.numpy(), jc.krope) <= BUDGET
    assert len(calls) == (1 if paged and backend == "kernel" else 0)


@pytest.mark.parametrize("name", MLA_LINEARS)
def test_effective_weight_matches_reference(carried, name):
    jcfg, tcfg, jm, tm, _, _ = carried("bitmap")
    w = tsalr.effective_weight(tm[name])
    jw = jsalr.effective_weight(jm[name])
    assert w.shape == (tm[name].d_in, tm[name].d_out) == jw.shape
    assert _rel(w.numpy(), jw) <= BUDGET


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_apply_moe_with_shared_expert_matches_reference(carried, backend):
    """The routed experts plus the shared SwiGLU, the port's grouped (kernel
    route) and oracle routes against the reference's oracle."""
    jcfg, tcfg, _, _, jmo, tmo = carried("bitmap")
    x = _mla_inputs(jcfg, 4)[:, :5]
    jy = jmoe.apply_moe(jmo, jnp.asarray(x), jcfg,
                        route=jplan.resolve_plan(jcfg, backend="reference").route("prefill"))
    with torch.inference_mode():
        route = tplan.resolve_plan(tcfg, backend=backend).route("prefill")
        ty = tmoe.apply_moe(tmo, torch.from_numpy(x), tcfg, route=route)
        # the shared expert's share: without it the output moves well past the budget
        bare = tmoe.apply_moe({k: v for k, v in tmo.items() if k != "shared"},
                              torch.from_numpy(x), tcfg, route=route)
    assert _rel(ty.numpy(), jy) <= BUDGET
    assert _rel(bare.numpy(), jy) > 100 * BUDGET


@pytest.mark.parametrize("method", ["bitmap", "nm", "mask"])
def test_bridge_orients_mla_and_shared_expert(carried, method):
    """Every MLA projection and shared-expert linear keeps the reference's
    ``transposed`` (a flat base of dq/uq/dkv/uk/uv and the shared gate/up
    stores W^T, wo and the shared down do not; a tiled base is logical),
    takes a kernel where the reference has one, and computes the
    reference's output on the same input."""
    jcfg, tcfg, jm, tm, jmo, tmo = carried(method)
    rng = np.random.default_rng(5)
    layers = [(jm[n], tm[n]) for n in MLA_LINEARS]
    layers += [(jmo["shared"][n], tmo["shared"][n]) for n in ("gate", "up", "down")]
    names = list(MLA_LINEARS) + ["shared gate", "shared up", "shared down"]
    for name, (jl, tl) in zip(names, layers):
        assert tl.transposed == bool(jl.transposed), name
        tiled = isinstance(jl.base, jbm.TiledBitmapWeight)
        if method == "mask":
            assert tl.transposed == (name.split()[-1] in TRANSPOSED), name
        assert tsalr._kernel_capable(tl) == (tiled or (method == "nm" and not tl.transposed)), name
        x = rng.standard_normal((3, tl.d_in)).astype(np.float32)
        jy = jsalr.apply_salr(jnp.asarray(x), jl, backend="reference")
        with torch.inference_mode():
            ty = tsalr.apply_salr(torch.from_numpy(x), tl, backend="kernel")
        assert _rel(ty.numpy(), jy) <= BUDGET, name


def test_expert_stacks_in_chunks(carried, monkeypatch):
    """An expert stack drawn, compressed and decoded in chunks along E:
    ``slice_stack`` / ``cat_stacks`` round-trip every leaf, the oracle's
    chunked expert products equal its one-chunk products bitwise, and a
    chunked init gives a stack of the full expert count."""
    jcfg, tcfg, _, _, _, tmo = carried("bitmap")
    st = tmo["gate"]
    e = st.lora.a.shape[0]
    back = tsalr.cat_stacks([tsalr.slice_stack(st, slice(i, i + 3)) for i in range(0, e, 3)])
    for name in ("words", "values"):
        assert torch.equal(getattr(back.base, name), getattr(st.base, name))
    assert torch.equal(back.res.b, st.res.b) and back.d_out == st.d_out
    x = torch.from_numpy(_mla_inputs(jcfg, 6)[0, :5])
    whole = tmoe._expert_matmul(st, x)
    monkeypatch.setattr(tmoe, "STACK_CHUNK_ELEMS", 3 * st.d_in * st.d_out)
    assert torch.equal(tmoe._expert_matmul(st, x), whole)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert p["gate"].base.words.shape[0] == tcfg.n_experts == p["down"].res.a.shape[0]
    assert set(p["shared"]) == {"gate", "up", "down"}
