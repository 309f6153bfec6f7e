"""The port's MoE model (granite_moe_1b_a400m smoke, compressed with the
NF4 twin) against the reference: the reference's parameters carried over
through ``repro_torch.bridge``, prefill / decode logits within
``method:*`` on every MoE route, greedy tokens equal to the reference's
under the native and the twin plan, and the continuous engine's tokens
equal to the port's ``greedy_generate`` at 4 and 8 slots (the grouped
and the decode-grid decode route; greedy keeps its own plan, so the two
cross MoE routes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import execplan as jplan
from repro.models import model as JM
from repro.train.step import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_reference
from repro_torch.core import execplan as tplan
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = ERROR_BUDGETS["method:bitmap"]
ARCH = "granite_moe_1b_a400m"


def _twin(cfg):
    """The mixed-precision plan's config: decode from the NF4 twin, int8
    decode KV."""
    return cfg.with_(decode_kv_cache="int8",
                     salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def carried():
    cfgs = []
    for configs in (jconfigs, tconfigs):
        cfg = configs.get(ARCH, smoke=True)
        cfgs.append(cfg.with_(salr=dataclasses.replace(cfg.salr, dual_repr=True)))
    jcfg, tcfg = cfgs
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_reference(flat, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def test_bridge_carries_moe_layers(carried):
    jcfg, tcfg, jp, tp, _ = carried
    assert len(tp["layers"]) == tcfg.n_layers == 2
    lp = tp["layers"][1]
    assert set(lp) == {"mixer", "moe"}
    jm = jp["groups"][0][0]["moe"]
    for name, d_out in (("gate", tcfg.moe_d_ff), ("down", tcfg.d_model)):
        st = lp["moe"][name]
        assert st.base.words.shape[0] == tcfg.n_experts and st.d_out == d_out
        np.testing.assert_array_equal(st.base.words.numpy().view(np.uint32),
                                      np.asarray(jm[name].base.words[1]))
        np.testing.assert_array_equal(st.qbase.codes.numpy(), np.asarray(jm[name].qbase.codes[1]))
        np.testing.assert_array_equal(st.res.a.numpy(), np.asarray(jm[name].res.a[1]))
    np.testing.assert_array_equal(lp["moe"]["router"]["w"].numpy(),
                                  np.asarray(jm["router"]["w"][1]))
    assert lp["moe"]["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("backend,tokens", [("reference", {}), ("kernel", {}),
                                            ("kernel", {"prefill": 16, "decode": 8})],
                         ids=["dense_masked", "grouped", "decode_grid"])
def test_prefill_and_decode_logits_match_reference(carried, backend, tokens):
    """Prefill, then one decode step at position 12 over the reference's
    own prefill cache, within method:* (the reference runs its dense
    masked formulation; the port each of its MoE routes)."""
    jcfg, tcfg, jp, tp, prompt = carried
    jpl = jplan.resolve_plan(jcfg, backend="reference")
    tpl = tplan.resolve_plan(tcfg, backend=backend, phase_tokens=tokens)
    want = {"reference": "dense_masked", "kernel": "decode_grid" if tokens else "grouped"}
    assert tpl.moe_route("prefill") == tpl.moe_route("decode") == want[backend]
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt), plan=jpl)
    jcache = JM.init_cache(jcfg, 2, 16)
    jk, jc0 = jc["groups"][0][0]["mixer"], jcache["groups"][0][0]["mixer"]
    jc0.k = jc0.k.at[:, :, :12].set(jk.k)
    jc0.v = jc0.v.at[:, :, :12].set(jk.v)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jd, _ = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), 12, plan=jpl)
    tcache = TM.init_cache(tcfg, 2, 16, "cpu")
    for i, lc in enumerate(tcache["layers"]):
        lc["mixer"].k[:, :12] = torch.from_numpy(np.array(jk.k[i]))
        lc["mixer"].v[:, :12] = torch.from_numpy(np.array(jk.v[i]))
    with torch.inference_mode():
        tl, _ = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tpl)
        td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=tpl)
    assert _rel(tl.numpy(), jl) <= BUDGET
    assert _rel(td.numpy(), jd) <= BUDGET


@pytest.mark.parametrize("plan", ["native", "twin"])
def test_greedy_tokens_equal_reference(carried, plan):
    """Greedy tokens equal the reference's (its dense masked formulation)
    under the native plan and under the NF4 twin with int8 decode KV, on
    the port's reference and kernel routes."""
    jcfg, tcfg, jp, tp, prompt = carried
    if plan == "twin":
        jcfg, tcfg = _twin(jcfg), _twin(tcfg)
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                         plan=tplan.resolve_plan(tcfg, backend=backend))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("plan", ["native", "twin"])
@pytest.mark.parametrize("n_slots", [4, 8])
def test_engine_tokens_equal_greedy(carried, n_slots, plan):
    """The engine resolves its own plan (decode at 4 slots: grouped; at 8:
    the decode grid; prefill at its largest bucket: the decode grid);
    greedy_generate keeps the default plan (grouped), so tokens are
    compared across MoE routes, at M >= 2 rows everywhere."""
    _, tcfg, _, tp, _ = carried
    cfg = _twin(tcfg) if plan == "twin" else tcfg
    prompts = serve.request_prompts(cfg, 4, 12, seed=2, shared_prefix=8)
    gplan = tplan.resolve_plan(cfg)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(cfg, tp, prompts, 6, 4, gplan)
        eng, results, metrics = serve.run_continuous(cfg, tp, prompts, 6, n_slots)
    assert eng.plan.moe_route("decode") == ("grouped" if n_slots < 8 else "decode_grid")
    assert eng.plan.moe_route("prefill") == "decode_grid"
    assert gplan.moe_route("prefill") == gplan.moe_route("decode") == "grouped"
    assert metrics["precision"]["decode"]["repr"] == ("bitmap_nf4" if plan == "twin"
                                                      else "native")
    for i in range(len(prompts)):
        assert results[i].tokens == greedy[i].tolist(), i
    if plan == "native":
        assert metrics["prefix_hit_rate"] > 0
    assert not any(ops.LAUNCHES.values())        # CPU tensors: the plain versions


def test_route_line_and_parity_report_on_moe(carried):
    _, tcfg, _, tp, _ = carried
    eng_plan = tplan.resolve_plan(tcfg, phase_tokens={"prefill": 20, "decode": 8})
    line = serve.route_line(tcfg, eng_plan)
    assert "moe=ops.decode_salr_matmul" in line.split("route[decode]")[1]
    twin = _twin(tcfg)
    line = serve.route_line(twin, tplan.resolve_plan(twin))
    pre, dec = line.split("route[decode]")
    assert "moe=ops.grouped_salr_matmul" in pre and "moe=ops.grouped_qsalr_matmul" in dec
    assert "dense decode + GEMM over every expert" in serve.route_line(
        tcfg, tplan.resolve_plan(tcfg, backend="reference"))
    prompts = serve.request_prompts(tcfg, 2, 12, seed=3)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(tcfg, tp, prompts, 4, 2, tplan.resolve_plan(tcfg))
    wrong = {i: type("R", (), {"tokens": list(greedy[i][:1]) + [(greedy[i][1] + 1) % 512]
                               + list(greedy[i][2:])})() for i in range(2)}
    report = serve.parity_report(tcfg, tp, prompts, greedy, wrong, tplan.resolve_plan(tcfg))
    assert [r[:2] for r in report] == [(0, 1), (1, 1)]
    assert all(np.isfinite(r[2]) and r[3] >= 0 for r in report)


def test_parity_report_accepts_a_router_near_tie(carried):
    """A divergence to the token that the step gives with its k-th and
    (k+1)-th experts swapped at an MoE layer is a near-tie ("router")
    where that layer's router ties the two, and not with the router as
    drawn; a divergence to another token is not, tie or no tie.  The
    router logits come from ``moe.router_logits_tap``: one (N, E) per MoE
    layer and forward while the tap is open, none after."""
    _, tcfg, _, tp, _ = carried
    prompts = serve.request_prompts(tcfg, 1, 12, seed=2)
    plan = tplan.resolve_plan(tcfg)
    k = tcfg.experts_per_token
    pt = torch.from_numpy(prompts)
    with torch.inference_mode():
        with tmoe.router_logits_tap() as calls:
            TM.prefill(tp, tcfg, pt, plan=plan)
        assert [c.shape for c in calls] == [(12, tcfg.n_experts)] * tcfg.n_layers
        TM.prefill(tp, tcfg, pt, plan=plan)
        assert len(calls) == tcfg.n_layers
        order = calls[0][-1].argsort(descending=True)
        w = tp["layers"][0]["moe"]["router"]["w"].clone()
        w[:, order[k]] = w[:, order[k - 1]]
        layer0 = {**tp["layers"][0], "moe": {**tp["layers"][0]["moe"], "router": {"w": w}}}
        tied = {**tp, "layers": [layer0, *tp["layers"][1:]]}
        verdicts = []
        for params in (tp, tied):
            greedy, _ = serve.run_batch(tcfg, params, prompts, 2, 1, plan)
            with tmoe.router_logits_tap(swap_at=0):
                swapped = int(TM.prefill(params, tcfg, pt, plan=plan)[0][0, -1].argmax())
            assert swapped != greedy[0][0]
            for tok in (swapped, (swapped + 1) % tcfg.vocab_size):
                wrong = {0: type("R", (), {"tokens": [tok, greedy[0][1]]})()}
                [d] = serve.parity_report(tcfg, params, prompts, greedy, wrong, plan)
                assert (d.rid, d.step) == (0, 0) and d.gap > d.limit
                verdicts.append(d.near_tie)
    assert verdicts == [False, False, "router", False] and d.router_margin == 0


def test_serve_cli_runs_the_moe_arch():
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "both",
                       "--requests", "1", "--batch", "2", "--gen", "3"]) == 0
