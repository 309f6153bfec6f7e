"""The dense decoder archs beyond smollm_135m against the reference:
llama3_8b_proxy (SwiGLU, rope theta 5e5) and nemotron_4_340b (squared
ReLU) at smoke size on the reference's parameters carried over through
``repro_torch.bridge`` (prefill / decode_step logits within
``method:*``, greedy tokens equal), the relu2 and gelu MLPs alone on
carried weights, and RoPE at theta 5e5.  internlm2_1_8b's and
mistral_large_123b's smoke configs have llama's shapes and MLP, so the
llama case stands for them."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import execplan as jplan
from repro.models import layers as JL
from repro.models import model as JM
from repro.train.step import greedy_generate as jgreedy
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core import execplan as tplan
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = ERROR_BUDGETS["method:bitmap"]


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.cache
def _carried(name: str) -> tuple:
    """One reference init per config, shared by every case that needs it."""
    jcfg = jconfigs.get(name, smoke=True)
    tcfg = tconfigs.get(name, smoke=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_reference(_flat(jp), tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name,mlp", [("llama3_8b_proxy", "swiglu"),
                                      ("nemotron_4_340b", "relu2")])
def test_model_matches_reference(name, mlp):
    """Prefill and one decode step's logits on both port routes within the
    budget of the reference formulation's, and greedy tokens equal to
    ``repro.train.step.greedy_generate``'s."""
    jcfg, tcfg, jp, tp, prompt = _carried(name)
    assert {m for _, m in TM.layer_kinds(tcfg)} == {mlp}
    assert set(tp["layers"][0]["mlp"]) == set(TL.mlp_linears(mlp))
    ref = jplan.resolve_plan(jcfg, backend="reference")
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt), plan=ref)
    # one decode step at position 12 over a dense cache of 16
    jcache = JM.init_cache(jcfg, 2, 16)
    jk = jc["groups"][0][0]["mixer"]
    jc0 = jcache["groups"][0][0]["mixer"]           # (repeats, B, W, KH, d)
    jc0.k = jc0.k.at[:, :, :12].set(jk.k)
    jc0.v = jc0.v.at[:, :, :12].set(jk.v)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jd, _ = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), 12, plan=ref)
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20, plan=ref)
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            plan = tplan.resolve_plan(tcfg, backend=backend)
            tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=plan)
            assert _rel(tl.numpy(), jl) <= BUDGET
            tcache = TM.init_cache(tcfg, 2, 16, "cpu")
            for lc, rc in zip(tcache["layers"], tc["layers"]):
                lc["mixer"].k[:, :12] = rc["mixer"].k
                lc["mixer"].v[:, :12] = rc["mixer"].v
            td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=plan)
            assert _rel(td.numpy(), jd) <= BUDGET
            tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20, plan=plan)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("kind", ["relu2", "gelu"])
def test_mlp_matches_reference(kind):
    """The reference's ``init_mlp`` of ``kind`` (up and down, SALR-compressed
    at llama3_8b_proxy's smoke widths) carried over: the port's
    ``apply_mlp`` within the budget of the reference's on both routes.  No
    dense config of the reference uses gelu (seamless_m4t_medium does, an
    encoder-decoder), so it is held here alone."""
    jcfg = jconfigs.get("llama3_8b_proxy", smoke=True)
    tcfg = tconfigs.get("llama3_8b_proxy", smoke=True)
    jp = JL.init_mlp(jax.random.PRNGKey(1), jcfg, kind)
    # the bridge reads a layer's leaves under ['mlp'] with a leading repeats axis
    flat = {"['mlp']" + k: v[None] for k, v in _flat(jp).items()}
    tp = bridge._carry_linears(flat, "", "['mlp']", TL.mlp_linears(kind), 0, tcfg, "cpu")
    x = np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jy = JL.apply_mlp(jp, jnp.asarray(x), kind,
                      route=jplan.resolve_plan(jcfg, backend="reference").route("prefill"))
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            route = tplan.resolve_plan(tcfg, backend=backend).route("prefill")
            ty = TL.apply_mlp(tp, torch.from_numpy(x), kind, route)
            assert _rel(ty.numpy(), jy) <= BUDGET


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does the
    port's gelu MLP; the exact erf GELU lies well outside f32 rounding of it."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    jy = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, jy, rtol=0, atol=2e-6)
    assert np.abs(exact - jy).max() > 1e-4


def test_rope_at_llama_theta():
    """RoPE at llama3_8b_proxy's theta (5e5) and head dim 128, positions
    across an 8192-token context, f32: the port's rotation within f32
    rounding of the reference's."""
    theta = tconfigs.get("llama3_8b_proxy").rope_theta
    assert theta == jconfigs.get("llama3_8b_proxy").rope_theta == 5e5
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 128)).astype(np.float32)
    positions = rng.integers(0, 8192, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope_freqs(128, theta, "cpu").numpy(), np.asarray(JL.rope_freqs(128, theta)),
        rtol=1e-6, atol=0)
    jy = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta))
    ty = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta).numpy()
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
