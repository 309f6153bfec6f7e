"""The port's model against the reference on the smoke arch: the
reference's parameters carried over through ``repro_torch.bridge``,
prefill / decode_step logits within ``method:*``, greedy tokens equal."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import execplan as jplan
from repro.models import model as JM
from repro.train.step import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.core import execplan as tplan
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.models import model as TM
from repro_torch.train.step import greedy_generate as tgreedy

BUDGET = ERROR_BUDGETS["method:bitmap"]


@pytest.fixture(scope="module")
def carried():
    jcfg = jconfigs.get("smollm_135m", smoke=True)
    tcfg = tconfigs.get("smollm_135m", smoke=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = params_from_reference(flat, tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bridge_unstacks_layers(carried):
    jcfg, tcfg, jp, tp, _ = carried
    assert len(tp["layers"]) == tcfg.n_layers == 2
    wq = tp["layers"][1]["mixer"]["wq"]
    jwq = jp["groups"][0][0]["mixer"]["wq"]
    assert (wq.base.tile, wq.base.cap_t, wq.base.cols, wq.d_out) == (96, 72, 96, 96)
    np.testing.assert_array_equal(wq.base.words.numpy().view(np.uint32),
                                  np.asarray(jwq.base.words[1]))
    np.testing.assert_array_equal(wq.res.a.numpy(), np.asarray(jwq.res.a[1]))


def test_bridge_bf16_through_npz(tmp_path):
    """bf16 leaves survive both spellings: ml_dtypes and npz void bytes."""
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    np.savez(tmp_path / "a.npz", x=a)
    void = np.load(tmp_path / "a.npz")["x"]
    assert void.dtype.kind == "V"
    for arr in (a, void):
        t = to_tensor(arr, "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_and_decode_logits_match_reference(carried, backend):
    jcfg, tcfg, jp, tp, prompt = carried
    # the reference runs its reference formulation (its kernel route is
    # Pallas in interpret mode); the port runs each of its routes
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompt),
                        plan=jplan.resolve_plan(jcfg, backend="reference"))
    tplan_ = tplan.resolve_plan(tcfg, backend=backend)
    with torch.inference_mode():
        tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompt), plan=tplan_)
        assert _rel(tl.numpy(), jl) <= BUDGET
        # one decode step at position 12 over a dense cache of 16
        jcache = JM.init_cache(jcfg, 2, 16)
        jk = jc["groups"][0][0]["mixer"]
        jc0 = jcache["groups"][0][0]["mixer"]           # (repeats, B, W, KH, d)
        jc0.k = jc0.k.at[:, :, :12].set(jk.k)
        jc0.v = jc0.v.at[:, :, :12].set(jk.v)
        tcache = TM.init_cache(tcfg, 2, 16, "cpu")
        for lc, rc in zip(tcache["layers"], tc["layers"]):
            lc["mixer"].k[:, :12] = rc["mixer"].k
            lc["mixer"].v[:, :12] = rc["mixer"].v
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jd, _ = JM.decode_step(jp, jcfg, jcache, jnp.asarray(tok), 12,
                               plan=jplan.resolve_plan(jcfg, backend="reference"))
        td, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 12, plan=tplan_)
        assert _rel(td.numpy(), jd) <= BUDGET
        # per-slot positions: a (B,) vector gives what the scalar gave
        # (rewriting position 12 with the same K/V)
        tv, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                               torch.tensor([12, 12]), plan=tplan_)
        torch.testing.assert_close(tv, td, rtol=0, atol=0)


def test_prefill_logit_index_and_prefix_continuation(carried):
    jcfg, tcfg, jp, tp, prompt = carried
    plan = jplan.resolve_plan(jcfg, backend="reference")
    idx = np.array([5, 11], np.int32)
    jl, _ = JM.prefill(jp, jcfg, jnp.asarray(prompt), logit_index=jnp.asarray(idx), plan=plan)
    with torch.inference_mode():
        tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompt), logit_index=torch.from_numpy(idx))
        assert _rel(tl.numpy(), jl) <= BUDGET
        # a continuation prefill over the first 8 positions' cache gives the
        # same last-position logits as the full prefill
        full, _ = TM.prefill(tp, tcfg, torch.from_numpy(prompt[:1]))
        _, head = TM.prefill(tp, tcfg, torch.from_numpy(prompt[:1, :8]))
        cont, _ = TM.prefill(tp, tcfg, torch.from_numpy(prompt[:1, 8:]), prefix_cache=head,
                             pos_offset=8)
        torch.testing.assert_close(cont, full, rtol=1e-5, atol=1e-5)


def test_greedy_tokens_equal_reference(carried):
    jcfg, tcfg, jp, tp, prompt = carried
    jt = jgreedy(jp, jcfg, jnp.asarray(prompt), n_steps=8, ctx=20,
                 plan=jplan.resolve_plan(jcfg, backend="reference"))
    with torch.inference_mode():
        for backend in ("reference", "kernel"):
            tt = tgreedy(tp, tcfg, torch.from_numpy(prompt), 8, 20,
                         plan=tplan.resolve_plan(tcfg, backend=backend))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
