"""The port's mixed-precision path against the reference: NF4 levels and
budgets, the NF4 tiled-bitmap twin and the int8 / NF4 KV encodings bit
for bit, the plain versions of ``qsalr_spmm`` and of the four quantized
decode-attention kernels within ``method:*`` of the reference's kernels
(Pallas in interpret mode), ``apply_salr`` under the ``bitmap_nf4`` repr,
the resolved plans, and the model under the mixed plans (decode linears
from the NF4 twin, decode KV in int8 or NF4) on the smoke arch."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bitmap as jbm
from repro.core import execplan as jplan
from repro.core import quant as jquant
from repro.core import salr as jsalr
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpaged
from repro.kernels import ring_attention as jring
from repro.models import attention as jatt
from repro.models import model as JM
from repro.train.step import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.core import bitmap as tbm
from repro_torch.core import execplan as tplan
from repro_torch.core import quant as tquant
from repro_torch.core import salr as tsalr
from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models import model as TM
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = tquant.ERROR_BUDGETS["method:bitmap_nf4"]
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _mixed(cfg, kv: str):
    """``cfg`` with decode linears on the NF4 twin and decode KV at ``kv``."""
    return cfg.with_(decode_kv_cache=kv,
                     salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4"))


def _encoded(k, n, tile, seed, dtype="float32"):
    """The reference's tiled encoding of a pruned random (k, n) weight and
    the same encoding carried over to the port."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jt, _ = jbm.tile_encode_from_dense(jnp.asarray(w).astype(DTYPES[dtype]), 0.5, tile=tile)
    tt = tbm.TiledBitmapWeight(words=_t(jt.words), values=_t(jt.values), cols=jt.cols,
                               tile=jt.tile, cap_t=jt.cap_t)
    return jt, tt, rng


def test_nf4_levels_and_budget_lookups_equal_reference():
    np.testing.assert_array_equal(tquant.NF4_LEVELS.numpy(), jquant.NF4_LEVELS)
    assert tquant.NF4_LEVELS.dtype == torch.float32
    for kind in ("method", "repr", "kv"):
        for name in ("native", "dense", "bitmap", "bitmap_nf4", "nf4", "int8", "nm", "x"):
            assert tquant.has_budget(kind, name) == jquant.has_budget(kind, name)
            if jquant.has_budget(kind, name):
                assert tquant.error_budget(kind, name) == jquant.error_budget(kind, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [32, 96, 192, 256])
def test_tile_quantize_nf4_bit_exact(tile, dtype):
    jt, tt, _ = _encoded(40, 2 * tile, tile, tile, dtype)
    jq, jerr = jbm.tile_quantize_nf4(jt)
    tq, terr = tbm.tile_quantize_nf4(tt)
    assert tq.words is tt.words and (tq.cols, tq.tile, tq.cap_t) == (jq.cols, jq.tile, jq.cap_t)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(terr.float().numpy(), np.asarray(jerr, np.float32))
    for dt in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            tbm.qtile_decode(tq, getattr(torch, dt)).float().numpy(),
            np.asarray(jbm.qtile_decode(jq, jnp.dtype(DTYPES[dt])), np.float32))


def test_nf4_ties_go_to_the_lower_level():
    """A value exactly between two levels takes the first, as jnp.argmin."""
    lv = tquant.NF4_LEVELS
    mid = (lv[:-1] + lv[1:]) / 2
    idx = tquant.nf4_index(mid)
    dist = (mid[:, None] - lv).abs()
    ties = dist.min(dim=1).values[:, None] == dist
    assert torch.equal(idx.long(), ties.float().argmax(dim=1))
    ji = jnp.argmin(jnp.abs(jnp.asarray(mid.numpy())[:, None] - jquant.NF4_LEVELS), axis=-1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantizers_bit_exact(dtype):
    x = jnp.asarray(np.random.default_rng(1).standard_normal((3, 7, 2, 64)) * 3).astype(
        DTYPES[dtype])
    xt = _t(x)
    for jq, tq, jdq, tdq in ((jatt._q8, tatt.q8, jatt._dq8, tatt.dq8),
                             (jatt._qnf4, tatt.qnf4, jatt._dqnf4, tatt.dqnf4)):
        (jc, js), (tc, ts) = jq(x), tq(xt)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tdq(tc, ts, xt.dtype).float().numpy(),
                                      np.asarray(jdq(jc, js, x.dtype), np.float32))


@pytest.mark.parametrize("m,tile", [(1, 32), (7, 96), (13, 192)])
def test_plain_qsalr_matches_reference(m, tile):
    k, n, r = 96, 2 * tile, 8
    jt, tt, rng = _encoded(k, n, tile, m * 1000 + tile)
    jq, _ = jbm.tile_quantize_nf4(jt)
    tq, _ = tbm.tile_quantize_nf4(tt)
    x = (rng.standard_normal((m, k)) / 4).astype(np.float32)
    a = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((r, n - 5)) / np.sqrt(r)).astype(np.float32)  # padded by the op
    y = ops.qsalr_matmul(torch.from_numpy(x), tq, torch.from_numpy(a), torch.from_numpy(b))
    yj = jops.qsalr_matmul(jnp.asarray(x), jq, jnp.asarray(a), jnp.asarray(b))
    assert y.shape == (m, n)
    assert _rel(y.numpy(), yj) <= BUDGET
    # a rank-0 layer: the reference pads a zero adapter, the port has none
    y0 = ops.qsalr_matmul(torch.from_numpy(x), tq, torch.zeros(k, 0), torch.zeros(0, n))
    yj0 = jops.qsalr_matmul(jnp.asarray(x), jq, jnp.zeros((k, 0)), jnp.zeros((0, n)))
    assert _rel(y0.numpy(), yj0) <= BUDGET


def test_qsalr_wrapper_checks():
    _, tt, _ = _encoded(64, 96, 96, 3)
    tq, _ = tbm.tile_quantize_nf4(tt)
    x = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.qsalr_matmul(x, tq, torch.randn(64, 8), torch.randn(8, 96))
    with torch.no_grad():
        with pytest.raises(ValueError, match="K=32"):
            ops.qsalr_matmul(torch.randn(4, 32), tq, torch.randn(32, 8), torch.randn(8, 96))
        bad = dataclasses.replace(tq, scales=tq.scales.double())
        with pytest.raises(TypeError, match="float32"):
            ops.qsalr_matmul(torch.randn(4, 64), bad, torch.randn(64, 8), torch.randn(8, 96))
        y = ops.qsalr_matmul(torch.randn(2, 3, 64), tq, torch.randn(64, 8), torch.randn(8, 96))
        assert y.shape == (2, 3, 96)


def _quant_case(kv: str, paged: bool, seed: int, b=3, h=6, kh=2, d=32, ps=4, max_pages=5):
    """Inputs of a quantized decode-attention call (numpy, reference
    layout).  Dead data -- the null page, pages past a slot's last live
    one, ring positions past pos -- holds finite junk codes and scales."""
    rng = np.random.default_rng(seed)
    quant = jatt._q8 if kv == "int8" else jatt._qnf4
    pos = np.array([max_pages * ps - 1, 6, 0][:b], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    lead = (b * max_pages + 1, ps) if paged else (b, max_pages * ps)
    kq, ks = (np.asarray(t) for t in quant(jnp.asarray(rng.standard_normal(lead + (kh, d)),
                                                      jnp.float32)))
    vq, vs = (np.asarray(t) for t in quant(jnp.asarray(rng.standard_normal(lead + (kh, d)),
                                                      jnp.float32)))
    ks, vs = ks.copy(), vs.copy()
    if not paged:
        for i in range(b):
            ks[i, pos[i] + 1:] = 1e3 * rng.random(ks[i, pos[i] + 1:].shape)
            vs[i, pos[i] + 1:] = 1e3 * rng.random(vs[i, pos[i] + 1:].shape)
        return (q, kq, vq, ks, vs, pos), None
    table = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    dead = [0]
    for i in range(b):
        dead += list(table[i, pos[i] // ps + 1:])
        table[i, pos[i] // ps + 1:] = 0 if i % 2 else table[i, pos[i] // ps + 1:]
    ks[dead] = 1e3 * rng.random(ks[dead].shape)          # junk scales in dead pages
    vs[dead] = 1e3 * rng.random(vs[dead].shape)
    return (q, kq, vq, ks, vs, table, pos), dead


_JAX_ATTENTION = {("int8", False): jring.ring_quant_gqa_attention,
                  ("nf4", False): jring.ring_nf4_gqa_attention,
                  ("int8", True): jpaged.paged_quant_gqa_attention,
                  ("nf4", True): jpaged.paged_nf4_gqa_attention}
_PORT_ATTENTION = {("int8", False): ops.ring_quant_gqa_attention,
                   ("nf4", False): ops.ring_nf4_gqa_attention,
                   ("int8", True): ops.paged_quant_gqa_attention,
                   ("nf4", True): ops.paged_nf4_gqa_attention}


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_plain_quant_attention_matches_reference_and_ignores_dead_data(kv, paged):
    args, dead = _quant_case(kv, paged, seed=len(kv) + paged)
    targs = [_t(a) for a in args]
    y = _PORT_ATTENTION[kv, paged](*targs)
    yj = _JAX_ATTENTION[kv, paged](*(jnp.asarray(a) for a in args), interpret=True)
    assert y.shape == args[0].shape
    assert _rel(y.numpy(), yj) <= BUDGET
    # NaN in every dead scale (and, paged, junk codes in dead pages) leaves
    # the plain version's output finite and unchanged; the reference
    # kernel would pass the NaN through its masked 0 x NaN product
    pos = args[-1]
    if paged:
        targs[1][dead] = 7 if kv == "int8" else 0x77
        targs[3][dead] = float("nan")
        targs[4][dead] = float("nan")
    else:
        for i, p in enumerate(pos):
            targs[3][i, p + 1:] = float("nan")
            targs[4][i, p + 1:] = float("nan")
    dirty = _PORT_ATTENTION[kv, paged](*targs)
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, y, rtol=0, atol=0)


def test_quant_attention_wrapper_checks():
    args, _ = _quant_case("int8", True, seed=9)
    q, k, v, *rest = [_t(a) for a in args]
    with pytest.raises(TypeError, match="int8"):
        ops.paged_quant_gqa_attention(q, k.view(torch.uint8), v.view(torch.uint8), *rest)
    with pytest.raises(ValueError, match="shapes"):       # int8 rows to the NF4 kernel
        ops.paged_nf4_gqa_attention(q, k, v, *rest)
    args, _ = _quant_case("nf4", True, seed=9)
    targs = [_t(a) for a in args]
    with pytest.raises(ValueError, match="shapes"):
        ops.ring_nf4_gqa_attention(targs[0], *targs[1:5], targs[6])   # pools as a ring
    with pytest.raises(TypeError, match="int32"):
        ops.paged_nf4_gqa_attention(*targs[:5], targs[5].long(), targs[6])


@pytest.fixture(scope="module")
def carried():
    """The reference's smoke params compressed with the NF4 twin, carried
    over to the port, and one prompt batch."""
    jcfg = _mixed(jconfigs.get("smollm_135m", smoke=True), "int8")
    tcfg = _mixed(tconfigs.get("smollm_135m", smoke=True), "int8")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_reference(flat, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def test_bridge_carries_the_nf4_twin(carried):
    _, _, jp, tp, _ = carried
    wq, jwq = tp["layers"][1]["mixer"]["wq"], jp["groups"][0][0]["mixer"]["wq"]
    assert isinstance(wq.qbase, tbm.QTiledBitmapWeight)
    np.testing.assert_array_equal(wq.qbase.codes.numpy(), np.asarray(jwq.qbase.codes[1]))
    np.testing.assert_array_equal(wq.qbase.scales.numpy(), np.asarray(jwq.qbase.scales[1]))
    assert (wq.qbase.cols, wq.qbase.tile, wq.qbase.cap_t) == (96, 96, 72)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_apply_salr_bitmap_nf4_repr(backend):
    """The NF4-twin route of a dual_repr layer within ``method:*`` of the
    reference's (on the same codes), and within ``repr:bitmap_nf4`` of the
    native base's output."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((96, 160)) / np.sqrt(96)).astype(np.float32)
    jl = jsalr.compress_linear(jax.random.PRNGKey(1), jnp.asarray(w), jsalr.SALRConfig(
        lora_rank=4, res_rank=4, dual_repr=True))
    jl = dataclasses.replace(jl, lora=dataclasses.replace(
        jl.lora, b=jnp.asarray(rng.standard_normal(jl.lora.b.shape) / 8, jnp.float32)))
    flat = {f"['groups'][0][0]['mixer']['wq']{jax.tree_util.keystr(p)}": np.asarray(leaf)[None]
            for p, leaf in jax.tree_util.tree_flatten_with_path(jl)[0]}
    cfg = tconfigs.get("smollm_135m", smoke=True)
    from repro_torch.bridge import _linear
    tl = _linear(flat, "['groups'][0][0]['mixer']['wq']", 0, 160, cfg, "cpu")
    x = (rng.standard_normal((5, 96)) / 4).astype(np.float32)
    xt = torch.from_numpy(x)
    yq = tsalr.apply_salr(xt, tl, backend=backend, base_repr="bitmap_nf4")
    yj = jsalr.apply_salr(jnp.asarray(x), jl, backend="reference", base_repr="bitmap_nf4")
    assert _rel(yq.numpy(), yj) <= BUDGET
    native = tsalr.apply_salr(xt, tl, backend=backend)
    err = _rel(yq.numpy(), native.numpy())
    assert 0 < err <= tquant.error_budget("repr", "bitmap_nf4")
    # the repr also comes from a plan scope, and a layer without a twin
    # reads its native base
    plan = tplan.resolve_plan(cfg, backend=backend,
                              overrides={"prefill": {"repr": "bitmap_nf4"}})
    with tplan.plan_scope(plan):
        torch.testing.assert_close(tsalr.apply_salr(xt, tl), yq, rtol=0, atol=0)
    bare = dataclasses.replace(tl, qbase=None)
    torch.testing.assert_close(tsalr.apply_salr(xt, bare, backend=backend,
                                                base_repr="bitmap_nf4"), native,
                               rtol=0, atol=0)


def test_compress_linear_emits_the_twin():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 96) / 8
    layer = tsalr.compress_linear(gen, w, tsalr.SALRConfig(lora_rank=4, res_rank=4,
                                                           dual_repr=True))
    q = layer.qbase
    assert q.words is layer.base.words
    ref_q, _ = tbm.tile_quantize_nf4(layer.base)
    assert torch.equal(q.codes, ref_q.codes) and torch.equal(q.scales, ref_q.scales)
    assert tsalr.compress_linear(gen, w, tsalr.SALRConfig(lora_rank=4, res_rank=4)).qbase is None


_PLANS = {"native": {}, "kv_cache int8": {"kv_cache": "int8"},
          "decode_kv_cache nf4": {"decode_kv_cache": "nf4"},
          "decode_repr bitmap_nf4": {"decode_repr": "bitmap_nf4"}}


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("case", list(_PLANS))
def test_resolve_plan_describe_equal_reference(case, backend):
    """Every field the port's plans carry resolves as the reference's,
    the ``moe`` routes and the crossover table included."""
    kw = dict(_PLANS[case])
    out = []
    for configs in (jconfigs, tconfigs):
        cfg = configs.get("smollm_135m")
        if "decode_repr" in kw:
            cfg = cfg.with_(salr=dataclasses.replace(cfg.salr, decode_repr=kw["decode_repr"]))
        cfg = cfg.with_(**{k: v for k, v in kw.items() if k != "decode_repr"})
        out.append(cfg)
    jd = jplan.resolve_plan(out[0], backend=backend).describe()
    td = tplan.resolve_plan(out[1], backend=backend).describe()
    assert td == jd
    assert set(td["decode"]) == {"linear", "moe", "kv", "repr", "kv_dtype"}


def _decode_cache_from_reference(jcfg, tcfg, jc, kv: str, s: int, ctx: int):
    """The reference's quantized decode cache (its prefill cache quantized
    at insert) and the same cache carried over to the port."""
    jsk = JM.init_cache(jcfg, 2, ctx, kv_dtype=kv)
    slot = jsk["groups"][0][0]["mixer"]
    req = JM._quantize_request(slot, jc["groups"][0][0]["mixer"])
    leaves = {f.name: getattr(slot, f.name).at[:, :, :s].set(getattr(req, f.name))
              for f in dataclasses.fields(slot)}
    jsk["groups"][0][0]["mixer"] = type(slot)(**leaves)
    tcache = TM.init_cache(tcfg, 2, ctx, "cpu", kv_dtype=kv)
    for i, lc in enumerate(tcache["layers"]):
        for name, t in TM.cache_fields(lc["mixer"]):
            t.copy_(_t(leaves[name][i]))
    return jsk, tcache


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_mixed_plan_logits_match_reference(carried, kv, backend):
    """Prefill (native) and one decode step over the quantized cache with
    the NF4 twin's linears, within ``method:*`` of the reference.  The
    decode step starts from the reference's own quantized cache: the two
    prefills agree to ~6e-7, enough to flip a code at a rounding
    boundary, which the encodings' bit-exactness tests cover apart."""
    jcfg, tcfg, jp, tp, prompt = carried
    jcfg, tcfg = _mixed(jcfg, kv), _mixed(tcfg, kv)
    jpl = jplan.resolve_plan(jcfg, backend="reference")
    tpl = tplan.resolve_plan(tcfg, backend=backend)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt), plan=jpl)
    jsk, tcache = _decode_cache_from_reference(jcfg, tcfg, jc, kv, 12, 16)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jd, _ = JM.decode_step(jp, jcfg, jsk, jnp.asarray(tok), 12, plan=jpl)
    with torch.inference_mode():
        tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tpl)
        assert type(tc["layers"][0]["mixer"]) is tatt.KVCache     # prefill stays native
        assert _rel(tl.numpy(), jl) <= BUDGET
        td, tcache = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=tpl)
    assert _rel(td.numpy(), jd) <= BUDGET
    # the step's K/V were quantized into position 12
    assert tcache["layers"][0]["mixer"].k_scale[:, 12].gt(0).all()


@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_greedy_tokens_equal_reference_quantized(carried, kv):
    jcfg, tcfg, jp, tp, prompt = carried
    jcfg, tcfg = _mixed(jcfg, kv), _mixed(tcfg, kv)
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    for backend in ("reference", "kernel"):
        tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                     plan=tplan.resolve_plan(tcfg, backend=backend))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_kv_cache_int8_quantizes_at_prefill(carried):
    """``kv_cache="int8"`` quantizes both phases: prefill builds the int8
    cache itself, bit for bit the quantized native prefill cache."""
    _, tcfg, _, tp, prompt = carried
    cfg = tcfg.with_(kv_cache="int8", decode_kv_cache=None)
    plan = tplan.resolve_plan(cfg)
    assert (plan.kv_dtype("prefill"), plan.kv_dtype("decode")) == ("int8", "int8")
    with torch.inference_mode():
        _, qc = TM.prefill(tp, cfg, torch.from_numpy(prompt), plan=plan)
        _, nc = TM.prefill(tp, tcfg, torch.from_numpy(prompt))
    for q, n in zip(qc["layers"], nc["layers"]):
        want = tatt.quantize_kv(n["mixer"].k, n["mixer"].v, "int8")
        assert type(q["mixer"]) is tatt.QuantKVCache
        for (_, a), (_, b) in zip(TM.cache_fields(q["mixer"]), TM.cache_fields(want)):
            assert torch.equal(a, b)
