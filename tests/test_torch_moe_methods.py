"""granite_moe_1b_a400m's expert stacks under the N:M (2:4), masked-dense
and dense methods: the port against the reference (``repro.models.moe``,
``repro.core.salr``) on the smoke widths, from identical numpy inputs.
The bridge carries a stacked N:M base and a stacked ``QDenseWeight``
twin with the reference's fields and orientation; ``compress_stack`` is
bit-exact with the reference's vmapped ``compress_linear``; the four
dense and N:M expert ops' plain versions agree with the reference's
Pallas kernels (interpret mode); ``apply_moe`` agrees with the
reference's on every route and its two kernel routes with each other."""
import dataclasses

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
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.bridge import _linear, params_from_reference, to_tensor
from repro_torch.core import bitmap as tbm
from repro_torch.core import execplan as tplan
from repro_torch.core import salr as tsalr
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe

ARCH = "granite_moe_1b_a400m"
N_EXP = 8


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


def _ref_stack(method: str, w: np.ndarray, rank: int, dtype: str = "float32",
               dual: bool = False, key: int = 0):
    """The reference's vmapped compress_linear over an (E, d_in, d_out)
    stack."""
    jcfg = jsalr.SALRConfig(sparsity=0.5, method=method, lora_rank=rank, res_rank=rank,
                            dtype=dtype, backend="kernel", dual_repr=dual)
    keys = jax.random.split(jax.random.PRNGKey(key), w.shape[0])
    return jax.vmap(lambda kk, ww: jsalr.compress_linear(kk, ww, jcfg))(keys, jnp.asarray(w))


# ------------------------------------------- the bridge (repair of three faults)

@pytest.fixture(scope="module")
def bridged():
    """The reference's whole smoke model under ``nm`` and under ``mask``
    with the NF4 twin, each with the port's params carried over by
    ``params_from_reference`` (built on first use)."""
    cache = {}

    def get(method):
        if method not in cache:
            extra = {"dual_repr": True} if method == "mask" else {}
            jcfg, tcfg = _cfgs(method=method, **extra)
            jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
            flat = {jax.tree_util.keystr(p): np.asarray(leaf)
                    for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
            cache[method] = (jp, params_from_reference(flat, tcfg, device="cpu"))
        return cache[method]
    return get


@pytest.mark.parametrize("method", ["nm", "mask"])
def test_bridge_keeps_reference_orientation(bridged, method):
    """Every carried projection and expert stack has the reference's
    ``transposed``: expert stacks never are (gate/up included), while a
    flat wq/wk/wv is; every expert stack takes the kernel routes."""
    jp, tp = bridged(method)
    jl = jp["groups"][0][0]
    for r, lp in enumerate(tp["layers"]):
        for part, names in (("mixer", ("wq", "wk", "wv", "wo")), ("moe", ("gate", "up", "down"))):
            for name in names:
                assert lp[part][name].transposed == bool(jl[part][name].transposed), \
                    (r, part, name)
        for name in ("gate", "up", "down"):
            assert not lp["moe"][name].transposed and tmoe._grouped_capable(lp["moe"][name])
    if method == "mask":
        assert tp["layers"][0]["mixer"]["wq"].transposed


@pytest.mark.parametrize("name", ["gate", "up", "down"])
def test_bridge_carries_stacked_nm_fields(bridged, name):
    """A stacked N:M base keeps the reference's per-expert static fields
    (cols, n, m; rows = K) and its leaves bit for bit."""
    jp, tp = bridged("nm")
    for r, lp in enumerate(tp["layers"]):
        jst, st = jp["groups"][0][0]["moe"][name], lp["moe"][name]
        assert isinstance(st.base, tbm.NMWeight)
        assert (st.base.cols, st.base.n, st.base.m) == (jst.base.cols, jst.base.n, jst.base.m)
        assert st.base.rows == jst.d_in == jst.base.group_bits.shape[-2]
        np.testing.assert_array_equal(st.base.group_bits.numpy(),
                                      np.asarray(jst.base.group_bits[r]))
        np.testing.assert_array_equal(_bits(st.base.values), _bits(jst.base.values[r]))
        assert tbm.nm_decode(st.base).shape == (N_EXP, jst.d_in, jst.d_out)


@pytest.mark.parametrize("name", ["gate", "up", "down"])
def test_bridge_carries_stacked_dense_twin(bridged, name):
    """A masked stack's QDenseWeight twin keeps one expert's logical shape
    (K, N), as the reference records it, and decodes to (E, K, N)
    equal, expert by expert, to the reference's decode."""
    jp, tp = bridged("mask")
    for r, lp in enumerate(tp["layers"]):
        jst, st = jp["groups"][0][0]["moe"][name], lp["moe"][name]
        np.testing.assert_array_equal(_bits(st.base), _bits(jst.base[r]))
        assert st.qbase.shape == tuple(jst.qbase.shape) == (jst.d_in, jst.d_out)
        np.testing.assert_array_equal(st.qbase.codes.numpy(), np.asarray(jst.qbase.codes[r]))
        np.testing.assert_array_equal(st.qbase.scales.numpy(), np.asarray(jst.qbase.scales[r]))
        got = tsalr.materialize_base(st.qbase).numpy()
        for e in range(N_EXP):
            one = jax.tree_util.tree_map(lambda t: t[r, e], jst.qbase)
            np.testing.assert_array_equal(got[e], np.asarray(jsalr.materialize_base(one)))


# ------------------------------------------------------------ stacked compress

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["nm", "mask", "dense"])
def test_compress_stack_bit_exact(method, dtype):
    """N:M bits/values, masked and dense bases, and the stacked
    QDenseWeight twin's codes/scales are bit-exact with the reference's
    vmapped compress_linear (the masked stack takes its mask on the
    uncast weight); the residual adapter through delta_w within
    method:* (bf16 factors: within bf16's 2e-2); dense has none."""
    d_in, d_out, rank = 64, 96, 4
    w = (np.random.default_rng(6).standard_normal((4, d_in, d_out))
         / np.sqrt(d_in)).astype(np.float32)
    js = _ref_stack(method, w, rank, dtype=dtype, dual=method != "nm")
    ts = tsalr.compress_stack(torch.Generator().manual_seed(0), torch.from_numpy(w),
                              tsalr.SALRConfig(method=method, lora_rank=rank, res_rank=rank,
                                               dtype=dtype, dual_repr=True))
    assert not ts.transposed and ts.d_in == d_in and ts.d_out == d_out
    if method == "nm":
        assert (ts.base.cols, ts.base.n, ts.base.m) == (js.base.cols, js.base.n, js.base.m)
        for got, want in ((ts.base.group_bits, js.base.group_bits),
                          (ts.base.values, js.base.values)):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        assert ts.qbase is None and js.qbase is None
    else:
        np.testing.assert_array_equal(_bits(ts.base), _bits(js.base))
        assert ts.qbase.shape == tuple(js.qbase.shape) == (d_in, d_out)
        np.testing.assert_array_equal(ts.qbase.codes.numpy(), np.asarray(js.qbase.codes))
        np.testing.assert_array_equal(ts.qbase.scales.numpy(), np.asarray(js.qbase.scales))
    if method == "dense":
        assert ts.res is None and js.res is None
    else:
        budget = ERROR_BUDGETS[f"method:{method}"] if dtype == "float32" else 2e-2
        jd = np.asarray(jnp.einsum("edr,erf->edf", js.res.a, js.res.b), np.float32)
        td = (ts.res.a.float() @ ts.res.b.float()).numpy()
        for e in range(4):
            assert _rel(td[e], jd[e]) <= budget
    assert ts.lora.a.shape == (4, d_in, rank) and not ts.lora.b.any()


def test_mask_stack_masks_the_uncast_weight():
    """In bf16 the masked stack takes its mask on the weight as given, not
    on the cast one: on magnitudes that bf16 rounds all alike the two
    masks differ, and the port's base is the reference's bit for bit."""
    rng = np.random.default_rng(8)
    w = (1.0 + rng.permutation(2 * 64 * 64).reshape(2, 64, 64) * 1e-6).astype(np.float32)
    w *= rng.choice([-1.0, 1.0], size=w.shape).astype(np.float32)
    ts = tsalr.compress_stack(torch.Generator(), torch.from_numpy(w),
                              tsalr.SALRConfig(method="mask", lora_rank=4, res_rank=4,
                                               dtype="bfloat16"))
    from repro_torch.core import prune
    wt = torch.from_numpy(w)
    kept = ts.base != 0
    assert torch.equal(kept, prune.magnitude_mask(wt, 0.5, batch_dims=1))
    assert not torch.equal(kept, prune.magnitude_mask(wt.bfloat16(), 0.5, batch_dims=1))
    js = _ref_stack("mask", w, 4, dtype="bfloat16")
    np.testing.assert_array_equal(_bits(ts.base), _bits(js.base))


# ------------------------------------------- the four dense and N:M expert ops

@pytest.fixture(scope="module")
def op_stacks():
    """Reference expert stacks (8 experts, K 64) under nm and mask at d_out
    64 and 128, with a nonzero LoRA B, each with its port."""
    _, tcfg = _cfgs()
    out = {}
    for method in ("nm", "mask"):
        for d_out in (64, 128):
            w = (np.random.default_rng(d_out).standard_normal((N_EXP, 64, d_out))
                 / 8).astype(np.float32)
            js = _ref_stack(method, w, 4, key=1)
            js = dataclasses.replace(js, lora=dataclasses.replace(
                js.lora, b=jnp.asarray(np.random.default_rng(9).standard_normal(
                    js.lora.b.shape).astype(np.float32) / 8)))
            out[method, d_out] = (js, _carry_stack(js, tcfg, d_out))
    return out


def _assignments(n_tok: int = 12, topk: int = 2, seed: int = 7):
    rng = np.random.default_rng(seed)
    top_i = np.stack([rng.permutation(N_EXP)[:topk] for _ in range(n_tok)]).astype(np.int32)
    x = (rng.standard_normal((n_tok, 64)) / 2).astype(np.float32)
    return top_i, x


@pytest.mark.parametrize("adapters", [True, False], ids=["adapters", "no_adapter"])
@pytest.mark.parametrize("d_out", [64, 128])
@pytest.mark.parametrize("method", ["nm", "mask"])
@pytest.mark.parametrize("route", ["grouped", "decode"])
def test_expert_ops_match_reference_kernels(op_stacks, route, method, d_out, adapters):
    """grouped_/decode_{nm,dense}_matmul's plain versions vs the
    reference's Pallas kernels (interpret mode) on the same assignment
    rows, within method:*; without adapters both drop the adapter term."""
    js, ts = op_stacks[method, d_out]
    family = "nm" if method == "nm" else "dense"
    top_i, x = _assignments()
    n_tok, topk = top_i.shape
    ja, jb = jmoe._stacked_adapter_cat(js) if adapters else (None, None)
    ta, tb = tmoe._stacked_adapter_cat(ts) if adapters else (None, None)
    jop = getattr(jops, f"{route}_{family}_matmul")
    top = getattr(tops, f"{route}_{family}_matmul")
    if route == "grouped":
        bm_ = jmoe._group_block_m(n_tok * topk, N_EXP)
        g = jmoe.group_assignments(jnp.asarray(top_i), N_EXP, bm_)
        xs = jnp.zeros((g.m_pad, 64)).at[g.dst].set(jnp.asarray(x)[g.tok])
        jy = jop(xs, g.tile_expert, js.base, ja, jb, block_m=bm_)
        ty = top(torch.from_numpy(np.array(xs)), torch.from_numpy(np.array(g.tile_expert)),
                 ts.base, ta, tb, block_m=bm_)
    else:
        xd = np.repeat(x, topk, axis=0)
        row_e = top_i.reshape(-1)
        jy = jop(jnp.asarray(xd), jnp.asarray(row_e), js.base, ja, jb)
        ty = top(torch.from_numpy(xd), torch.from_numpy(row_e), ts.base, ta, tb)
    assert ty.shape == jy.shape
    assert _rel(ty.numpy(), jy) <= ERROR_BUDGETS[f"method:{method}"]


@pytest.mark.parametrize("method", ["nm", "mask"])
def test_decode_op_pad_rows_exact_zero(op_stacks, method):
    """Rows past the row map and -1 rows come out exactly zero whatever x
    holds there (NaN included); the real rows do not change; the grouped
    op gives the decode op's rows bitwise."""
    _, ts = op_stacks[method, 64]
    op = tops.decode_nm_matmul if method == "nm" else tops.decode_dense_matmul
    a, b = tmoe._stacked_adapter_cat(ts)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((10, 64)).astype(np.float32))
    row_e = torch.tensor([0, 3, -1, 7, 7, 2, 5, -1], dtype=torch.int32)
    y = op(x, row_e, ts.base, a, b)
    junk = x.clone()
    junk[[2, 7, 8, 9]] = float("nan")
    yj = op(junk, row_e, ts.base, a, b)
    assert torch.equal(yj, y) and not yj[[2, 7, 8, 9]].any()
    assert y[[0, 1, 3]].abs().sum() > 0
    grouped = tops.grouped_nm_matmul if method == "nm" else tops.grouped_dense_matmul
    te = torch.tensor([3, 7], dtype=torch.int32)
    yg = grouped(x[:8], te, ts.base, a, b, block_m=4)
    assert torch.equal(yg, op(x[:8], te.repeat_interleave(4), ts.base, a, b))


def test_dense_expert_wrappers_check_their_inputs(op_stacks):
    _, nm_st = op_stacks["nm", 64]
    _, mask_st = op_stacks["mask", 64]
    a, b = tmoe._stacked_adapter_cat(mask_st)
    x = torch.zeros((16, 64))
    re_ = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be \\(E, K, N\\)"):
        tops.decode_dense_matmul(x, re_, mask_st.base[0], a, b)
    with pytest.raises(TypeError, match="dense stack must be"):
        tops.decode_dense_matmul(x, re_, mask_st.base.double(), a, b)
    with pytest.raises(ValueError, match="x has K"):
        tops.grouped_nm_matmul(torch.zeros((16, 32)), torch.zeros(2, dtype=torch.int32),
                               nm_st.base, block_m=8)
    with pytest.raises(TypeError, match="values must be"):
        tops.decode_nm_matmul(x.double(), re_, nm_st.base)
    with pytest.raises(ValueError, match="adapter shapes"):
        tops.decode_dense_matmul(x, re_, mask_st.base, a[:, :32], b)
    with pytest.raises(TypeError, match="no expert-stack kernel"):
        tops.decode_dense_matmul(x, re_, object(), a, b)
    with pytest.raises(RuntimeError, match="forward-only"):
        tops.decode_nm_matmul(x.requires_grad_(), re_, nm_st.base)


# ------------------------------------------------------------------- apply_moe

@pytest.fixture(scope="module")
def carried():
    """The reference's MoE block under nm, mask (with its NF4 twin) and
    dense, and under a plain {"w"} expert stack (the expert target off),
    each with its port."""
    x = (np.random.default_rng(0).standard_normal((2, 9, 128)) / 2).astype(np.float32)
    out = {}
    for label, fields in (("nm", {"method": "nm"}),
                          ("mask", {"method": "mask", "dual_repr": True}),
                          ("dense", {"method": "dense"}),
                          ("plain", {"targets": ("attn", "mlp")})):
        jcfg, tcfg = _cfgs(**fields)
        jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
        tp = {"norm": {"scale": to_tensor(np.asarray(jp["norm"]["scale"]), "cpu")},
              "router": {"w": to_tensor(np.asarray(jp["router"]["w"]), "cpu")}}
        for n in ("gate", "up", "down"):
            if label == "plain":
                tp[n] = {"w": to_tensor(np.asarray(jp[n]["w"]), "cpu")}
            else:
                tp[n] = _carry_stack(jp[n], tcfg, tcfg.d_model if n == "down"
                                     else tcfg.moe_d_ff)
        out[label] = (jcfg, tcfg, jp, tp)
    return out, x


# the expert op family each method's kernel routes call
_FAMILY = {"nm": "nm", "mask": "dense", "dense": "dense", "plain": "dense"}


@pytest.mark.parametrize("route", ["dense_masked", "grouped", "decode_grid"])
@pytest.mark.parametrize("method", ["nm", "mask", "dense", "plain"])
def test_apply_moe_routes_match_reference(carried, monkeypatch, method, route):
    """apply_moe on each route vs the reference's, within method:* (the
    reference's kernel routes run Pallas in interpret mode, its oracle the
    per-expert linears); each kernel route calls its family's op for
    gate, up and down, and nothing falls back to the oracle."""
    blocks, x = carried
    jcfg, tcfg, jp, tp = blocks[method]
    linear = "reference" if route == "dense_masked" else "kernel"
    jy = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, route=jplan.PhaseRoute(linear, route))
    calls = []
    if route != "dense_masked":
        name = f"{'grouped' if route == 'grouped' else 'decode'}_{_FAMILY[method]}_matmul"
        op = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, **k: calls.append(1) or op(*a, **k))
    with torch.inference_mode():
        ty = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg,
                            route=tplan.PhaseRoute(linear, route))
    assert len(calls) == (0 if route == "dense_masked" else 3)
    budget = ERROR_BUDGETS[f"method:{_FAMILY[method] if method == 'plain' else method}"]
    assert _rel(ty.numpy(), jy) <= budget
    assert _rel(ty.numpy() - x, np.asarray(jy) - x) <= budget       # the MoE term alone


@pytest.mark.parametrize("route", ["dense_masked", "grouped", "decode_grid"])
def test_masked_stack_under_nf4_repr_mirrors_reference(carried, route):
    """Under decode_repr nf4 a masked stack's kernel routes read the native
    base (no kernel reads its QDenseWeight twin), while the oracle reads
    the twin, on both sides: each route agrees with the reference's, and
    the oracle differs from the native kernel route by the NF4 roundtrip."""
    blocks, x = carried
    jcfg, tcfg, jp, tp = blocks["mask"]
    linear = "reference" if route == "dense_masked" else "kernel"
    jy = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, route=jplan.PhaseRoute(linear, route,
                                                                         repr="nf4"))
    with torch.inference_mode():
        ty = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg,
                            route=tplan.PhaseRoute(linear, route, repr="nf4"))
        native = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg,
                                route=tplan.PhaseRoute(linear, route))
    assert _rel(ty.numpy() - x, np.asarray(jy) - x) <= ERROR_BUDGETS["method:mask"]
    gap = _rel(ty.numpy() - x, native.numpy() - x)
    if route == "dense_masked":
        assert 1e-3 < gap <= ERROR_BUDGETS["repr:nf4"]
    else:
        assert gap == 0.0


@pytest.mark.parametrize("method", ["nm", "mask", "dense", "plain"])
def test_kernel_routes_bitwise_equal(carried, method):
    """The grouped and decode-grid routes give the same bits per token (on
    the CPU through the plain versions, whose products are row
    independent), and a token's output does not depend on its batch."""
    blocks, x = carried
    _, tcfg, _, tp = blocks[method]
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        outs = {r: tmoe.apply_moe(tp, xt, tcfg, route=r) for r in ("grouped", "decode_grid")}
        assert torch.equal(outs["grouped"], outs["decode_grid"])
        for r in ("grouped", "decode_grid"):
            one = tmoe.apply_moe(tp, xt[1:2, 3:7], tcfg, route=r)
            assert torch.equal(one, outs[r][1:2, 3:7])
