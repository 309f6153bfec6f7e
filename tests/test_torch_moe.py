"""The port's MoE layer against the reference (``repro.models.moe``) on
granite_moe_1b_a400m's smoke widths, from identical numpy inputs:
routing, grouping, the stacked compress (bit-exact encodings), the four
expert-stack ops' plain versions against the reference's Pallas kernels
in interpret mode, ``apply_moe`` on each route within ``method:*``, and
the resolved plans against the reference's and its committed snapshot."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import execplan as jplan
from repro.core import salr as jsalr
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.bridge import _linear, to_tensor
from repro_torch.core import execplan as tplan
from repro_torch.core import salr as tsalr
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe

BUDGET = ERROR_BUDGETS["method:bitmap"]
ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_moe_1b_a400m"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bits(a) -> np.ndarray:
    """Raw bits of an array or tensor (bf16 via int16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _cfgs(**fields):
    """The smoke arch in both packages, SALR fields replaced."""
    out = []
    for configs in (jconfigs, tconfigs):
        cfg = configs.get(ARCH, smoke=True)
        out.append(cfg.with_(salr=dataclasses.replace(cfg.salr, **fields)))
    return out


def _carry_stack(jstack, tcfg, d_out: int):
    """A reference expert stack carried to the port (the bridge's leaf
    reader over a one-repeat dict)."""
    flat = {"['s']" + jax.tree_util.keystr(p): np.asarray(leaf)[None]
            for p, leaf in jax.tree_util.tree_flatten_with_path(jstack)[0]}
    return _linear(flat, "['s']", 0, d_out, tcfg, "cpu")


@pytest.fixture(scope="module")
def carried():
    """The reference's MoE block (with the NF4 twin) and its port."""
    jcfg, tcfg = _cfgs(dual_repr=True)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = {"norm": {"scale": to_tensor(np.asarray(jp["norm"]["scale"]), "cpu")},
          "router": {"w": to_tensor(np.asarray(jp["router"]["w"]), "cpu")},
          **{n: _carry_stack(jp[n], tcfg, tcfg.d_model if n == "down" else tcfg.moe_d_ff)
             for n in ("gate", "up", "down")}}
    x = (np.random.default_rng(0).standard_normal((2, 9, jcfg.d_model)) / 2).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


# ----------------------------------------------------------------- routing

@pytest.mark.parametrize("n_exp,k,thresh", [(8, 2, 0.0), (32, 8, 0.0), (32, 8, 0.03)])
def test_route_tokens_match_reference(n_exp, k, thresh):
    """top_i equal wherever the sorted probabilities of the first k + 1
    experts are apart by more than 1e-6 or exactly tied (a tie goes to the
    lower expert in both); weights within 1e-6 everywhere."""
    jcfg, tcfg = (c.with_(n_experts=n_exp, experts_per_token=k, moe_drop_threshold=thresh)
                  for c in _cfgs())
    rng = np.random.default_rng(n_exp + k)
    tokens = rng.standard_normal((96, 64)).astype(np.float32)
    router = (rng.standard_normal((64, n_exp)) / 8).astype(np.float32)
    router[:, 1] = router[:, 0]                   # experts 0 and 1 tie exactly
    jt, jw, jkeep = jmoe.route_tokens(jnp.asarray(router), jnp.asarray(tokens), jcfg)
    tt, tw, tkeep = tmoe.route_tokens(torch.from_numpy(router), torch.from_numpy(tokens), tcfg)
    logits = tokens.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)[:, :k + 1]
    gaps = p[:, :-1] - p[:, 1:]
    clear = ((gaps > 1e-6) | (gaps == 0)).all(axis=1)
    assert clear.sum() >= 80
    np.testing.assert_array_equal(tt.numpy()[clear], np.asarray(jt)[clear])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tkeep.numpy()[clear], np.asarray(jkeep)[clear])
    assert (thresh > 0) == (not tkeep.all())


def test_route_tokens_rows_independent_of_batch():
    """A token's experts and weights are bitwise the same whether it is
    routed alone or among others (f64 logits)."""
    _, tcfg = _cfgs()
    tcfg = tcfg.with_(n_experts=32, experts_per_token=8)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    router = torch.from_numpy((rng.standard_normal((128, 32)) / 8).astype(np.float32))
    ti, w, _ = tmoe.route_tokens(router, tokens, tcfg)
    for m, start in ((1, 0), (1, 17), (4, 3), (8, 40), (33, 31)):
        ts, ws, _ = tmoe.route_tokens(router, tokens[start:start + m], tcfg)
        assert torch.equal(ts, ti[start:start + m]) and torch.equal(ws, w[start:start + m])


def test_combine_weights_match_reference():
    rng = np.random.default_rng(2)
    top_i = np.stack([rng.permutation(8)[:2] for _ in range(10)])
    w = rng.random((10, 2)).astype(np.float32)
    j = jmoe.combine_weights(jnp.asarray(top_i), jnp.asarray(w), 8)
    t = tmoe.combine_weights(torch.from_numpy(top_i), torch.from_numpy(w), 8)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n,k,n_exp", [(1, 8, 32), (8, 8, 32), (33, 2, 8), (128, 8, 32),
                                       (1024, 8, 32)])
def test_group_assignments_identical(n, k, n_exp):
    rng = np.random.default_rng(n)
    top_i = np.stack([rng.permutation(n_exp)[:k] for _ in range(n)]).astype(np.int32)
    top_i[: n // 2, 0] = 0                        # a crowded expert
    bm_ = tmoe._group_block_m(n * k, n_exp)
    assert bm_ == jmoe._group_block_m(n * k, n_exp)
    j = jmoe.group_assignments(jnp.asarray(top_i), n_exp, bm_)
    t = tmoe.group_assignments(torch.from_numpy(top_i), n_exp, bm_)
    assert (t.m_pad, t.block_m) == (j.m_pad, j.block_m)
    for f in ("tok", "inv", "dst", "tile_expert"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert t.tile_expert.dtype == torch.int32


# ---------------------------------------------------------- stacked compress

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_stack_bit_exact(dtype):
    """Masks (through the words), values, and the NF4 twin's codes and
    scales are bit-exact against the reference's vmapped compress_linear
    and the port's own per-expert compress_linear; the residual adapter
    through delta_w within method:* (bf16 factors: within bf16's 2e-2)."""
    n_exp, d_in, d_out, rank = 4, 64, 96, 4
    w = (np.random.default_rng(5).standard_normal((n_exp, d_in, d_out))
         / np.sqrt(d_in)).astype(np.float32)
    kw = dict(sparsity=0.5, method="bitmap", lora_rank=rank, res_rank=rank, dtype=dtype,
              backend="kernel", dual_repr=True)
    jcfg, tcfg = jsalr.SALRConfig(**kw), tsalr.SALRConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), n_exp)
    js = jax.vmap(lambda kk, ww: jsalr.compress_linear(kk, ww, jcfg))(keys, jnp.asarray(w))
    ts = tsalr.compress_stack(torch.Generator().manual_seed(0), torch.from_numpy(w), tcfg)
    assert (ts.base.tile, ts.base.cap_t, ts.base.cols) == (js.base.tile, js.base.cap_t,
                                                          js.base.cols)
    for got, want in ((ts.base.words, js.base.words), (ts.base.values, js.base.values),
                      (ts.qbase.codes, js.qbase.codes), (ts.qbase.scales, js.qbase.scales)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    budget = BUDGET if dtype == "float32" else 2e-2
    jd = np.asarray(jnp.einsum("edr,erf->edf", js.res.a, js.res.b), np.float32)
    td = (ts.res.a.float() @ ts.res.b.float()).numpy()
    for e in range(n_exp):
        assert _rel(td[e], jd[e]) <= budget
        one = tsalr.compress_linear(torch.Generator().manual_seed(0),
                                    torch.from_numpy(w[e]), tcfg)
        for got, want in ((ts.base.words[e], one.base.words),
                          (ts.base.values[e], one.base.values),
                          (ts.qbase.codes[e], one.qbase.codes),
                          (ts.qbase.scales[e], one.qbase.scales)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        assert _rel(td[e], (one.res.a.float() @ one.res.b.float()).numpy()) <= budget
    assert ts.lora.a.shape == (n_exp, d_in, rank) and not ts.lora.b.any()


def test_compress_stack_rejects_unported_method():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tsalr.compress_stack(torch.Generator(), torch.zeros(2, 32, 32),
                             tsalr.SALRConfig(method="bitmap_nf4"))


# ------------------------------------------------- the four expert-stack ops

@pytest.fixture(scope="module")
def op_stacks():
    """Reference expert stacks (8 experts, K 64; the NF4 twin too) at
    d_out 64 (one tile) and 40 (B_cat padded to the 64-wide tile), and
    with rank-0 adapters, each with its port."""
    _, tcfg = _cfgs()
    out = {}
    for name, d_out, rank in (("r8", 64, 4), ("pad", 40, 4), ("rank0", 64, 0)):
        jcfg = jsalr.SALRConfig(lora_rank=rank, res_rank=rank, dual_repr=True)
        w = (np.random.default_rng(d_out + rank).standard_normal((8, 64, d_out))
             / 8).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(1), 8)
        js = jax.vmap(lambda kk, ww: jsalr.compress_linear(kk, ww, jcfg))(keys, jnp.asarray(w))
        if rank:   # a nonzero LoRA B, so both adapters carry weight
            js = dataclasses.replace(js, lora=dataclasses.replace(
                js.lora, b=jnp.asarray(np.random.default_rng(9).standard_normal(
                    js.lora.b.shape).astype(np.float32) / 8)))
        out[name] = (js, _carry_stack(js, tcfg, d_out))
    return out


@pytest.mark.parametrize("stack", ["r8", "pad", "rank0"])
@pytest.mark.parametrize("kind", ["salr", "qsalr"])
@pytest.mark.parametrize("route", ["grouped", "decode"])
def test_expert_ops_match_reference_kernels(op_stacks, stack, kind, route):
    """The port's plain version vs the reference's Pallas kernel (interpret
    mode) on the same assignment rows, within method:*."""
    js, ts = op_stacks[stack]
    rng = np.random.default_rng(7)
    n_tok, topk = 12, 2
    top_i = np.stack([rng.permutation(8)[:topk] for _ in range(n_tok)]).astype(np.int32)
    x = (rng.standard_normal((n_tok, 64)) / 2).astype(np.float32)
    jbase = js.qbase if kind == "qsalr" else js.base
    tbase = ts.qbase if kind == "qsalr" else ts.base
    ja, jb = jmoe._stacked_adapter_cat(js)
    ta, tb = tmoe._stacked_adapter_cat(ts)
    if route == "grouped":
        bm_ = jmoe._group_block_m(n_tok * topk, 8)
        g = jmoe.group_assignments(jnp.asarray(top_i), 8, bm_)
        xs = jnp.zeros((g.m_pad, 64)).at[g.dst].set(jnp.asarray(x)[g.tok])
        jy = getattr(jops, f"grouped_{kind}_matmul")(xs, g.tile_expert, jbase, ja, jb,
                                                     block_m=bm_)
        ty = getattr(tops, f"grouped_{kind}_matmul")(
            torch.from_numpy(np.array(xs)), torch.from_numpy(np.array(g.tile_expert)),
            tbase, ta, tb, block_m=bm_)
    else:
        xd = np.repeat(x, topk, axis=0)
        row_e = top_i.reshape(-1)
        jy = getattr(jops, f"decode_{kind}_matmul")(jnp.asarray(xd), jnp.asarray(row_e), jbase,
                                                    ja, jb)
        ty = getattr(tops, f"decode_{kind}_matmul")(torch.from_numpy(xd),
                                                    torch.from_numpy(row_e), tbase, ta, tb)
    assert ty.shape == jy.shape
    assert _rel(ty.numpy(), jy) <= BUDGET


def test_decode_op_pad_rows_exact_zero(op_stacks):
    """Rows past the row map (and -1 rows) come out exactly zero whatever
    x holds there; the real rows do not change."""
    _, ts = op_stacks["r8"]
    a, b = tmoe._stacked_adapter_cat(ts)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((10, 64)).astype(np.float32))
    row_e = torch.tensor([0, 3, -1, 7, 7, 2, 5, -1], dtype=torch.int32)
    y = tops.decode_salr_matmul(x, row_e, ts.base, a, b)
    junk = x.clone()
    junk[[2, 7, 8, 9]] = float("nan")
    yj = tops.decode_salr_matmul(junk, row_e, ts.base, a, b)
    assert torch.equal(yj, y) and not yj[[2, 7, 8, 9]].any()
    assert y[[0, 1, 3]].abs().sum() > 0


def test_expert_op_wrappers_check_their_inputs(op_stacks):
    _, ts = op_stacks["r8"]
    a, b = tmoe._stacked_adapter_cat(ts)
    x = torch.zeros((16, 64))
    with pytest.raises(TypeError, match="int32"):
        tops.decode_salr_matmul(x, torch.zeros(16, dtype=torch.int64), ts.base, a, b)
    with pytest.raises(ValueError, match="tile_expert"):
        tops.grouped_salr_matmul(x, torch.zeros(3, dtype=torch.int32), ts.base, a, b,
                                 block_m=8)
    with pytest.raises(ValueError, match="x has K"):
        tops.decode_salr_matmul(torch.zeros((16, 32)), torch.zeros(16, dtype=torch.int32),
                                ts.base, a, b)
    with pytest.raises(RuntimeError, match="forward-only"):
        tops.decode_salr_matmul(x.requires_grad_(), torch.zeros(16, dtype=torch.int32),
                                ts.base, a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.decode_salr_matmul(x.detach().to("meta"),
                                torch.zeros(16, dtype=torch.int32, device="meta"),
                                *(dataclasses.replace(ts.base, words=ts.base.words.to("meta"),
                                                      values=ts.base.values.to("meta")),
                                  a.to("meta"), b.to("meta")))


# -------------------------------------------------------------- apply_moe

@pytest.mark.parametrize("repr_", ["native", "bitmap_nf4"])
@pytest.mark.parametrize("route", ["dense_masked", "grouped", "decode_grid"])
def test_apply_moe_routes_match_reference(carried, route, repr_):
    """apply_moe on each route and base repr vs the reference's, within
    method:* (the reference's kernel routes run Pallas in interpret mode;
    the dense masked oracle runs reference linears on both sides)."""
    jcfg, tcfg, jp, tp, x = carried
    linear = "reference" if route == "dense_masked" else "kernel"
    jr = jplan.PhaseRoute(linear, route, repr=repr_)
    tr = tplan.PhaseRoute(linear, route, repr=repr_)
    jy = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, route=jr)
    with torch.inference_mode():
        ty = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, route=tr)
    assert _rel(ty.numpy(), jy) <= BUDGET
    assert _rel(ty.numpy() - x, np.asarray(jy) - x) <= BUDGET       # the MoE term alone


def test_kernel_routes_bitwise_equal(carried):
    """The grouped and decode-grid routes give the same bits per token
    (on the CPU through the plain versions, whose products are row
    independent), and a token's output does not depend on its batch."""
    _, tcfg, _, tp, x = carried
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        outs = {r: tmoe.apply_moe(tp, xt, tcfg, route=r) for r in ("grouped", "decode_grid")}
        assert torch.equal(outs["grouped"], outs["decode_grid"])
        for r in ("grouped", "decode_grid"):
            one = tmoe.apply_moe(tp, xt[1:2, 3:7], tcfg, route=r)
            assert torch.equal(one, outs[r][1:2, 3:7])


def test_moe_route_resolution():
    _, tcfg = _cfgs()
    assert tmoe._resolve_moe_route(tcfg, None, "kernel") == "grouped"
    assert tmoe._resolve_moe_route(tcfg, None, "reference") == "dense_masked"
    assert tmoe._resolve_moe_route(tcfg, tplan.PhaseRoute("kernel", "decode_grid"),
                                   "reference") == "decode_grid"
    assert tmoe._resolve_moe_route(tcfg, None, None) == "grouped"     # prefill default
    with tplan.plan_scope(tplan.resolve_plan(tcfg, backend="reference")):
        assert tmoe._resolve_moe_route(tcfg, None, None) == "dense_masked"
    with pytest.raises(ValueError, match="unknown MoE route"):
        tmoe._resolve_moe_route(tcfg, "ragged", None)
    assert "grouped" in tmoe.moe_route_description(tcfg, "grouped")
    # shared experts are ported (deepseek_v3_671b): one dense SwiGLU of
    # width moe_d_ff x n_shared_experts beside the routed stacks
    p = tmoe.init_moe(torch.Generator(), tcfg.with_(n_shared_experts=2), "cpu")
    assert p["shared"]["gate"].d_out == 2 * tcfg.moe_d_ff == p["shared"]["down"].d_in


# ------------------------------------------------------------------ plans

def test_resolve_plan_matches_committed_snapshot():
    """The port's plans at the snapshot's phase tokens equal
    experiments/baselines/PLAN_snapshot.json on every field, for both
    archs the snapshot covers."""
    snap = json.loads((ROOT / "experiments" / "baselines" / "PLAN_snapshot.json").read_text())
    assert set(snap) == set(jplan.PLAN_SNAPSHOT_ARCHS)
    for arch in jplan.PLAN_SNAPSHOT_ARCHS:
        got = tplan.resolve_plan(tconfigs.get(arch),
                                 phase_tokens=jplan.PLAN_SNAPSHOT_TOKENS).describe()
        assert got == snap[arch], arch


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("case", [
    {}, {"phase_tokens": {"decode": 7}}, {"phase_tokens": {"decode": 8, "prefill": 256}},
    {"phase_tokens": {"prefill": 257, "decode": 1024}},
    {"overrides": {"decode": {"moe": "dense_masked"}}},
    {"crossover": "mid_dense"}])
def test_resolve_plan_moe_matches_reference(case, backend):
    kw = dict(case)
    if kw.get("crossover") == "mid_dense":
        kw["crossover"] = {"grid_min_tokens": 4, "grid_max_tokens": 64,
                           "mid_route": "dense_masked"}
    out = []
    for plan_mod, configs in ((jplan, jconfigs), (tplan, tconfigs)):
        k = dict(kw)
        if "crossover" in k:
            k["crossover"] = plan_mod.MoECrossover(**k["crossover"])
        out.append(plan_mod.resolve_plan(configs.get(ARCH), backend=backend, **k).describe())
    assert out[0] == out[1]
    assert tplan.MoECrossover().route_for(8) == "decode_grid"
    with pytest.raises(ValueError, match="unknown MoE route"):
        tplan.PhaseRoute("kernel", "ragged")
