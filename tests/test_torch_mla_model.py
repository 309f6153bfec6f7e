"""The port's MLA model (deepseek_v3_671b smoke: one dense MLA layer, two
MLA + MoE layers with a shared expert) against the reference, its
parameters carried over through ``repro_torch.bridge``: prefill and
decode logits within ``method:bitmap`` on each linear route, greedy
tokens equal to the reference's, and the continuous engine's tokens on
paged latent pools equal to the port's ``greedy_generate`` at 4 slots
with a prefix hit, every engine tick reading the pools through
``ops.paged_mla_attention`` once per MLA layer."""
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
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = ERROR_BUDGETS["method:bitmap"]
ARCH = "deepseek_v3_671b"
PROMPT = 12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = jconfigs.get(ARCH, smoke=True), tconfigs.get(ARCH, smoke=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_reference(flat, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, PROMPT), dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def test_bridge_carries_mla_layers(carried):
    """Three MLA layers: the first with the dense SwiGLU, the other two
    MoE layers with routed stacks and the shared expert."""
    _, tcfg, _, tp, _ = carried
    assert [tuple(sorted(lp)) for lp in tp["layers"]] == \
        [("mixer", "mlp", "mlp_norm"), ("mixer", "moe"), ("mixer", "moe")]
    assert TM.layer_kinds(tcfg) == [("mla", "swiglu"), ("mla", "moe"), ("mla", "moe")]
    for lp in tp["layers"]:
        assert {"dq", "uq", "dkv", "uk", "uv", "wo", "qnorm", "kvnorm"} <= set(lp["mixer"])
    assert set(tp["layers"][1]["moe"]["shared"]) == {"gate", "up", "down"}
    assert tp["layers"][2]["moe"]["shared"]["gate"].d_out == tcfg.moe_d_ff


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_and_decode_logits_match_reference(carried, backend):
    """Prefill, then one decode step at position 12 over the reference's
    own prefill latents, in a dense cache, within method:bitmap."""
    jcfg, tcfg, jp, tp, prompt = carried
    jpl = jplan.resolve_plan(jcfg, backend="reference")
    tpl = tplan.resolve_plan(tcfg, backend=backend)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt), plan=jpl)
    jcache = JM.init_cache(jcfg, 2, 16)
    tcache = TM.init_cache(tcfg, 2, 16, "cpu")
    tlayers = iter(tcache["layers"])
    for gi, g in enumerate(jcfg.layer_groups):
        src, dst = jc["groups"][gi][0]["mixer"], jcache["groups"][gi][0]["mixer"]
        dst.ckv = dst.ckv.at[:, :, :PROMPT].set(src.ckv)
        dst.krope = dst.krope.at[:, :, :PROMPT].set(src.krope)
        for r in range(g.repeats):
            lc = next(tlayers)["mixer"]
            assert isinstance(lc, tattn.LatentCache)
            lc.ckv[:, :PROMPT] = torch.from_numpy(np.array(src.ckv[r]))
            lc.krope[:, :PROMPT] = torch.from_numpy(np.array(src.krope[r]))
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jd, _ = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), PROMPT, plan=jpl)
    with torch.inference_mode():
        tl, _ = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tpl)
        td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), PROMPT, plan=tpl)
    assert _rel(tl.numpy(), jl) <= BUDGET
    assert _rel(td.numpy(), jd) <= BUDGET


def test_greedy_tokens_equal_reference(carried):
    jcfg, tcfg, jp, tp, prompt = carried
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                         plan=tplan.resolve_plan(tcfg, backend=backend))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_engine_on_paged_latents_equals_greedy(carried, monkeypatch):
    """4 slots over paged latent pools with prefix sharing: tokens equal
    greedy_generate's under the engine's own plan, a prefix hit happens,
    and every decode tick calls ``ops.paged_mla_attention`` once per MLA
    layer (the kernel's wrapper; on CPU tensors its plain version)."""
    _, tcfg, _, tp, _ = carried
    prompts = serve.request_prompts(tcfg, 6, 12, seed=2, shared_prefix=8)
    calls = []
    real = ops.paged_mla_attention
    monkeypatch.setattr(ops, "paged_mla_attention",
                        lambda *a, **k: calls.append(a[2].shape) or real(*a, **k))
    with torch.inference_mode():
        eng, results, metrics = serve.run_continuous(tcfg, tp, prompts, 6, 4)
        n_ticks = metrics["n_decode_ticks"]
        attention_calls = len(calls)
        greedy, _ = serve.run_batch(tcfg, tp, prompts, 6, 6, eng.plan)
    assert eng.paged and eng.sharable and metrics["kv_layout"] == "paged"
    assert isinstance(eng.cache["layers"][0]["mixer"], tattn.PagedLatentCache)
    assert metrics["prefix_hit_rate"] > 0
    for i in range(len(prompts)):
        assert results[i].tokens == greedy[i].tolist(), i
    assert n_ticks > 0 and attention_calls == tcfg.n_layers * n_ticks
    assert len(calls) == attention_calls          # greedy_generate reads a dense cache
    assert not any(ops.LAUNCHES.values())          # CPU tensors: the plain versions
    line = serve.route_line(tcfg, eng.plan)
    assert "attention=ops.paged_mla_attention" in line.split("route[decode]")[1]


def test_serve_cli_runs_deepseek():
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "both",
                       "--requests", "1", "--batch", "2", "--gen", "3"]) == 0
