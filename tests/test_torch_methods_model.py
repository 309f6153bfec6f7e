"""The port's model and engines under the two serving plans of the N:M
and masked-dense methods, on the smoke arch, against the reference:

  nm        ``method="nm"`` (2:4), native plan: wq/wk/wv/gate/up on tiled
            bitmaps (``salr_spmm``), wo/down on N:M bases (``nm_spmm`` +
            ``fused_lora``);
  mask+nf4  ``method="mask"``, ``decode_repr="nf4"``: prefill a dense GEMM
            on the masked bases, decode wo/down from their NF4 twins
            (``nf4_spmm`` + ``fused_lora``).

The reference's parameters are carried over through the bridge; its
kernel route runs its Pallas kernels in interpret mode."""
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
from repro.models import model as JM
from repro.train.step import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_reference
from repro_torch.core import bitmap as tbm
from repro_torch.core import execplan as tplan
from repro_torch.core import salr as tsalr
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = ERROR_BUDGETS["method:nm"]                 # = method:mask
PLANS = {"nm": {"method": "nm"}, "mask+nf4": {"method": "mask", "decode_repr": "nf4"}}
TRANSPOSED = ("wq", "wk", "wv", "gate", "up")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfg(configs, plan: str, full: bool = False):
    cfg = configs.get("smollm_135m", smoke=not full)
    return cfg.with_(salr=dataclasses.replace(cfg.salr, **PLANS[plan]))


@pytest.fixture(scope="module", params=list(PLANS))
def carried(request):
    """The reference's smoke params under one plan's method, carried over
    to the port, and one prompt batch."""
    jcfg, tcfg = _cfg(jconfigs, request.param), _cfg(tconfigs, request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_reference(flat, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    return request.param, jcfg, tcfg, jp, tp, prompt


def _linears(tp, jp, layer: int):
    for part in ("mixer", "mlp"):
        for name, tl in tp["layers"][layer][part].items():
            if isinstance(tl, tsalr.SALRLinear):
                jl = jp["groups"][0][0][part][name]
                yield name, tl, jax.tree_util.tree_map(lambda a: a[layer], jl)


def test_layers_carry_each_method_base(carried):
    plan, _, _, jp, tp, _ = carried
    for name, tl, jl in _linears(tp, jp, 1):
        assert tl.transposed is jl.transposed
        np.testing.assert_array_equal(tsalr.materialize_base(tl.base).numpy(),
                                      np.asarray(jsalr.materialize_base(jl.base)))
        if plan == "nm":
            want = tbm.TiledBitmapWeight if name in TRANSPOSED else tbm.NMWeight
            assert isinstance(tl.base, want) and not tl.transposed
            assert tl.qbase is None
        else:
            assert isinstance(tl.base, torch.Tensor) and tl.transposed == (name in TRANSPOSED)
            if name in TRANSPOSED:
                assert tl.qbase is None and jl.qbase is None
            else:
                assert isinstance(tl.qbase, tsalr.QDenseWeight)
                assert isinstance(jl.qbase, jsalr.QDenseWeight)
                np.testing.assert_array_equal(tl.qbase.codes.numpy(), np.asarray(jl.qbase.codes))
                np.testing.assert_array_equal(tl.qbase.scales.numpy(),
                                              np.asarray(jl.qbase.scales))
                assert tl.qbase.codes.shape == (tl.d_in, 64)      # 96 columns pad to 128


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_and_decode_logits_match_reference(carried, backend):
    """Prefill and one decode step, each route of the port against the
    same route of the reference (its kernels in interpret mode)."""
    _, jcfg, tcfg, jp, tp, prompt = carried
    jpl = jplan.resolve_plan(jcfg, backend=backend)
    tpl = tplan.resolve_plan(tcfg, backend=backend)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt), plan=jpl)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jcache = JM.init_cache(jcfg, 2, 16)
    jk, jc0 = jc["groups"][0][0]["mixer"], jcache["groups"][0][0]["mixer"]
    jc0.k = jc0.k.at[:, :, :12].set(jk.k)
    jc0.v = jc0.v.at[:, :, :12].set(jk.v)
    jd, _ = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), 12, plan=jpl)
    with torch.inference_mode():
        tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tpl)
        tcache = TM.init_cache(tcfg, 2, 16, "cpu")
        for lc, rc in zip(tcache["layers"], tc["layers"]):
            lc["mixer"].k[:, :12] = rc["mixer"].k
            lc["mixer"].v[:, :12] = rc["mixer"].v
        td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=tpl)
    assert _rel(tl.numpy(), jl) <= BUDGET
    assert _rel(td.numpy(), jd) <= BUDGET


def test_greedy_tokens_equal_reference(carried):
    _, jcfg, tcfg, jp, tp, prompt = carried
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    for backend in ("reference", "kernel"):
        tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                     plan=tplan.resolve_plan(tcfg, backend=backend))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_engine_tokens_equal_greedy(plan, kv_layout):
    """The port's own smoke params: engine tokens equal greedy_generate's
    under the same plan; under mask+nf4 the first token is the native
    plan's (prefill reads the masked base) and decode reads the twin."""
    cfg = _cfg(tconfigs, plan)
    params = TM.init_params(cfg, seed=0, device="cpu")
    prompts = serve.request_prompts(cfg, 6, 16, seed=1, shared_prefix=8)
    pl = tplan.resolve_plan(cfg, overrides={"decode": {"kv": kv_layout}})
    with torch.inference_mode():
        greedy, _ = serve.run_batch(cfg, params, prompts, 8, 6, pl)
        ops.reset_launches()
        eng, results, metrics = serve.run_continuous(cfg, params, prompts, 8, 4, plan=pl)
        assert not any(ops.LAUNCHES.values())   # the CPU runs the plain versions
        for i in range(6):
            assert results[i].tokens == greedy[i].tolist(), i
        if plan == "mask+nf4":
            assert metrics["precision"]["decode"]["repr"] == "nf4"
            native = dataclasses.replace(cfg.salr, decode_repr=None)
            native_greedy, _ = serve.run_batch(cfg.with_(salr=native), params, prompts, 8, 6,
                                               tplan.resolve_plan(cfg.with_(salr=native)))
            np.testing.assert_array_equal(greedy[:, 0], native_greedy[:, 0])
            assert not np.array_equal(greedy, native_greedy)     # decode did change
        elif kv_layout == "paged":                  # prefix sharing works as native
            assert eng.sharable and metrics["prefix_hit_rate"] > 0


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_resolve_plan_describe_equal_reference(plan, backend):
    """Every field the port's plans carry resolves as the reference's, at
    full width (the ``moe`` routes and the crossover table included)."""
    jd = jplan.resolve_plan(_cfg(jconfigs, plan, full=True), backend=backend).describe()
    td = tplan.resolve_plan(_cfg(tconfigs, plan, full=True), backend=backend).describe()
    assert td == jd


def test_route_line_names_the_twin_op_by_base():
    """A dense or masked base's twin is read by nf4_matmul, never by the
    tiled bitmap's qsalr_matmul; an N:M layer's decode keeps nm_matmul."""
    lines = {p: serve.route_line(_cfg(tconfigs, p, full=True),
                                 tplan.resolve_plan(_cfg(tconfigs, p, full=True)))
             for p in PLANS}
    decode = {p: line.split("route[decode]=")[1] for p, line in lines.items()}
    assert "ops.nf4_matmul + ops.lora_matmul" in decode["mask+nf4"]
    assert "qsalr" not in decode["mask+nf4"] and "salr_matmul" not in decode["mask+nf4"]
    assert "dense GEMM" in lines["mask+nf4"].split("route[decode]")[0]
    assert "ops.nm_matmul + ops.lora_matmul" in decode["nm"]
    nm_nf4 = _cfg(tconfigs, "nm", full=True)
    nm_nf4 = nm_nf4.with_(salr=dataclasses.replace(nm_nf4.salr, decode_repr="nf4"))
    line = serve.route_line(nm_nf4, tplan.resolve_plan(nm_nf4)).split("route[decode]=")[1]
    assert "ops.qsalr_matmul" in line and "ops.nm_matmul" in line


def test_nm_layer_twin_exists_only_for_tiled_projections():
    """Under nm with a twin, wq/wk/wv/gate/up (tiled) get a tiled NF4 twin
    as the reference's do, wo/down (N:M) none."""
    jcfg, tcfg = _cfg(jconfigs, "nm"), _cfg(tconfigs, "nm")
    jcfg = jcfg.with_(salr=dataclasses.replace(jcfg.salr, dual_repr=True))
    tcfg = tcfg.with_(salr=dataclasses.replace(tcfg.salr, dual_repr=True))
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    for name, tl in {**tp["layers"][0]["mixer"], **tp["layers"][0]["mlp"]}.items():
        if not isinstance(tl, tsalr.SALRLinear):
            continue
        part = "mlp" if name in ("gate", "up", "down") else "mixer"
        jq = jp["groups"][0][0][part][name].qbase
        assert (tl.qbase is None) == (jq is None) == (name in ("wo", "down"))
        if jq is not None:
            assert isinstance(tl.qbase, tbm.QTiledBitmapWeight)
            assert isinstance(jq, jbm.QTiledBitmapWeight)
