"""The port's MoE model (granite_moe_1b_a400m smoke) under the N:M (2:4)
and masked-dense methods against the reference: the reference's
parameters carried over through ``repro_torch.bridge``, prefill / decode
logits within ``method:*`` on every MoE route, greedy tokens equal to
the reference's, and the continuous engine's tokens equal to the port's
``greedy_generate`` at 4 and 8 slots (the engine's decode on the grouped
and on the decode-grid expert ops; greedy keeps its own plan, so the two
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
from repro_torch.train.step import greedy_generate as tgreedy

ARCH = "granite_moe_1b_a400m"
# the expert-stack op family each method's kernel routes run
FAMILY = {"nm": "nm", "mask": "dense"}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def carried():
    """Per method (built on first use): the reference's smoke model, its
    port through the bridge, and a (2, 12) prompt."""
    cache = {}

    def get(method):
        if method not in cache:
            cfgs = []
            for configs in (jconfigs, tconfigs):
                cfg = configs.get(ARCH, smoke=True)
                cfgs.append(cfg.with_(salr=dataclasses.replace(cfg.salr, method=method)))
            jcfg, tcfg = cfgs
            jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
            flat = {jax.tree_util.keystr(p): np.asarray(leaf)
                    for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
            tp = params_from_reference(flat, tcfg, device="cpu")
            prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12),
                                                       dtype=np.int32)
            cache[method] = (jcfg, tcfg, jp, tp, prompt)
        return cache[method]
    return get


def _count_expert_ops(monkeypatch, family: str) -> dict:
    """Wrap the grouped and decode op of ``family`` so each call counts."""
    calls = {"grouped": 0, "decode": 0}
    for route in calls:
        name = f"{route}_{family}_matmul"
        op = getattr(ops, name)

        def counted(*a, route=route, op=op, **k):
            calls[route] += 1
            return op(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("backend,tokens", [("reference", {}), ("kernel", {}),
                                            ("kernel", {"prefill": 16, "decode": 8})],
                         ids=["dense_masked", "grouped", "decode_grid"])
@pytest.mark.parametrize("method", ["nm", "mask"])
def test_prefill_and_decode_logits_match_reference(carried, monkeypatch, method, backend,
                                                   tokens):
    """Prefill, then one decode step at position 12 over the reference's
    own prefill cache, within method:* (the reference runs its dense
    masked formulation; the port each of its MoE routes, whose expert
    stacks all go through the method's op: 3 per layer per forward)."""
    jcfg, tcfg, jp, tp, prompt = carried(method)
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
    calls = _count_expert_ops(monkeypatch, FAMILY[method])
    with torch.inference_mode():
        tl, _ = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tpl)
        td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=tpl)
    per_forward = 3 * tcfg.n_layers
    assert calls == {"grouped": 2 * per_forward if want[backend] == "grouped" else 0,
                     "decode": 2 * per_forward if want[backend] == "decode_grid" else 0}
    budget = ERROR_BUDGETS[f"method:{method}"]
    assert _rel(tl.numpy(), jl) <= budget
    assert _rel(td.numpy(), jd) <= budget


@pytest.mark.parametrize("method", ["nm", "mask"])
def test_greedy_tokens_equal_reference(carried, method):
    """Greedy tokens equal the reference's (its dense masked formulation)
    on the port's reference and kernel routes."""
    jcfg, tcfg, jp, tp, prompt = carried(method)
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                         plan=tplan.resolve_plan(tcfg, backend=backend))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("n_slots", [4, 8])
@pytest.mark.parametrize("method", ["nm", "mask"])
def test_engine_tokens_equal_greedy(carried, monkeypatch, method, n_slots):
    """The engine resolves its own plan (decode at 4 slots: grouped; at 8:
    the decode grid; prefill at its largest bucket: the decode grid);
    greedy_generate keeps the default plan (grouped), so tokens are
    compared across MoE routes, and both routes' ops of the method run."""
    _, tcfg, _, tp, _ = carried(method)
    prompts = serve.request_prompts(tcfg, 4, 12, seed=2, shared_prefix=8)
    gplan = tplan.resolve_plan(tcfg)
    calls = _count_expert_ops(monkeypatch, FAMILY[method])
    with torch.inference_mode():
        greedy, _ = serve.run_batch(tcfg, tp, prompts, 6, 4, gplan)
        eng, results, metrics = serve.run_continuous(tcfg, tp, prompts, 6, n_slots)
    assert eng.plan.moe_route("decode") == ("grouped" if n_slots < 8 else "decode_grid")
    assert eng.plan.moe_route("prefill") == "decode_grid"
    assert gplan.moe_route("prefill") == gplan.moe_route("decode") == "grouped"
    assert calls["grouped"] > 0 and calls["decode"] > 0
    for i in range(len(prompts)):
        assert results[i].tokens == greedy[i].tolist(), i
    assert metrics["prefix_hit_rate"] > 0
    assert not any(ops.LAUNCHES.values())        # CPU tensors: the plain versions


@pytest.mark.parametrize("method", ["nm", "mask"])
def test_route_line_names_the_expert_ops(carried, method):
    _, tcfg, _, _, _ = carried(method)
    family = FAMILY[method]
    pre, dec = serve.route_line(tcfg, tplan.resolve_plan(
        tcfg, phase_tokens={"prefill": 20, "decode": 8})).split("route[decode]")
    assert f"moe=ops.decode_{family}_matmul" in pre and f"moe=ops.decode_{family}_matmul" in dec
    line = serve.route_line(tcfg, tplan.resolve_plan(tcfg))
    assert line.count(f"moe=ops.grouped_{family}_matmul") == 2
    if method == "nm":   # wq/wk/wv tiled, wo on its 2:4 base; gate/up/down are experts
        assert "(wq/wk/wv," in line and "(wo, 2:4 base)" in line and "gate" not in line
