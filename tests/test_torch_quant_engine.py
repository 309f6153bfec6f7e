"""The port's engine under the mixed-precision plans on the smoke arch:
decode linears from the NF4 twin, decode KV in int8 or NF4 (paged pools
for the engine, a dense cache for ``greedy_generate``).  Served tokens
equal ``greedy_generate``'s under the same plan; prefix sharing is off;
quantized caches insert, clear and refuse a prefix gather as they
should."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import execplan
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import model as M


def _mixed(cfg, kv: str):
    return cfg.with_(decode_kv_cache=kv,
                     salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4"))


@pytest.fixture(scope="module")
def smoke():
    """Smoke params compressed with the NF4 twin (``dual_repr``)."""
    cfg = configs.get("smollm_135m", smoke=True)
    cfg = cfg.with_(salr=dataclasses.replace(cfg.salr, dual_repr=True))
    return cfg, M.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_engine_tokens_equal_greedy_quantized(smoke, kv, kv_layout):
    cfg, params = smoke
    qcfg = _mixed(cfg, kv)
    prompts = serve.request_prompts(cfg, 6, 16, seed=1, shared_prefix=8)
    plan = execplan.resolve_plan(qcfg, overrides={"decode": {"kv": kv_layout}})
    native = execplan.resolve_plan(cfg)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(qcfg, params, prompts, 8, 6, plan)
        ops.reset_launches()
        eng, results, metrics = serve.run_continuous(qcfg, params, prompts, 8, 4, plan=plan)
        native_greedy, _ = serve.run_batch(cfg, params, prompts, 8, 6, native)
    assert not eng.sharable and metrics["prefix_hit_rate"] == 0.0
    assert metrics["precision"]["decode"] == {"repr": "bitmap_nf4", "kv_dtype": kv}
    assert metrics["precision"]["prefill"] == {"repr": "native", "kv_dtype": "native"}
    for i in range(6):
        assert results[i].tokens == greedy[i].tolist(), i
    # prefill is native, so the first token is the native plan's
    np.testing.assert_array_equal(greedy[:, 0], native_greedy[:, 0])
    assert not np.array_equal(greedy, native_greedy)        # decode did change
    # on the CPU the wrappers run their plain versions: nothing launched
    assert not any(ops.LAUNCHES.values())
    cache = eng.cache["layers"][0]["mixer"]
    want = {("paged", "int8"): attn.PagedQuantKVCache, ("paged", "nf4"): attn.PagedNF4KVCache,
            ("dense", "int8"): attn.QuantKVCache, ("dense", "nf4"): attn.NF4KVCache}
    assert type(cache) is want[kv_layout, kv]


def test_engine_with_int8_kv_in_both_phases(smoke):
    """``kv_cache="int8"``: prefill builds the int8 cache itself, which the
    engine inserts as it is; tokens still equal greedy_generate's."""
    cfg, params = smoke
    qcfg = cfg.with_(kv_cache="int8")
    prompts = serve.request_prompts(cfg, 4, 16, seed=2)
    plan = execplan.resolve_plan(qcfg)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(qcfg, params, prompts, 6, 4, plan)
        eng, results, metrics = serve.run_continuous(qcfg, params, prompts, 6, 2, plan=plan)
    assert not eng.sharable
    assert metrics["precision"]["prefill"] == {"repr": "native", "kv_dtype": "int8"}
    assert [results[i].tokens for i in range(4)] == greedy.tolist()


def test_quantized_slot_insert_and_clear(smoke):
    cfg, params = smoke
    prompt = torch.from_numpy(serve.request_prompts(cfg, 1, 8, seed=5))
    with torch.inference_mode():
        _, rc = M.prefill(params, cfg, prompt)
    cache = M.init_slot_cache(cfg, 3, 16, "cpu", kv_dtype="nf4")
    M.insert_cache_slot(cache, rc, 1)
    lc, req = cache["layers"][0]["mixer"], rc["layers"][0]["mixer"]
    want = attn.quantize_kv(req.k, req.v, "nf4")
    assert torch.equal(lc.k[1, :8], want.k[0]) and torch.equal(lc.v_scale[1, :8], want.v_scale[0])
    assert not lc.k[0].any() and not lc.k_scale[1, 8:].any()
    M.clear_cache_slot(cache, 1)
    assert not lc.k[1].any() and not lc.k_scale[1].any()
    with pytest.raises(TypeError, match="cannot insert"):
        M.quantize_request(attn.init_gqa_cache(cfg, 1, 8, torch.float32, "cpu", "int8"), want)


def test_paged_insert_quantizes_and_gather_refuses(smoke):
    cfg, params = smoke
    prompt = torch.from_numpy(serve.request_prompts(cfg, 1, 8, seed=6))
    with torch.inference_mode():
        _, rc = M.prefill(params, cfg, prompt)
    cache = M.init_paged_slot_cache(cfg, 2, 16, page_size=4, n_pages=5, device="cpu",
                                    kv_dtype="int8")
    cache["page_table"][0, :2] = torch.tensor([3, 1], dtype=torch.int32)
    M.insert_paged_cache_slot(cache, rc, 0, 0)
    pool, req = cache["layers"][1]["mixer"], rc["layers"][1]["mixer"]
    want = attn.quantize_kv(req.k, req.v, "int8")
    assert torch.equal(pool.k[3], want.k[0, :4]) and torch.equal(pool.k_scale[1], want.k_scale[0, 4:])
    assert not pool.k[2].any()
    with pytest.raises(TypeError, match="native pools"):
        M.gather_prefix_cache(cache, torch.tensor([3]))


def test_route_line_names_each_phase_op(smoke):
    cfg, _ = smoke
    line = serve.route_line(_mixed(cfg, "int8"), execplan.resolve_plan(_mixed(cfg, "int8")))
    assert "route[prefill]=ops.salr_matmul" in line and "kv_dtype=native" in line
    assert "route[decode]=ops.qsalr_matmul" in line
    assert "attention=ops.paged_quant_gqa_attention" in line
    dense = serve.route_line(_mixed(cfg, "nf4"), execplan.resolve_plan(
        _mixed(cfg, "nf4"), overrides={"decode": {"kv": "dense"}}))
    assert "attention=ops.ring_nf4_gqa_attention" in dense
    native = serve.route_line(cfg, execplan.resolve_plan(cfg, backend="reference"))
    assert native.count("dense decode + GEMM") == 2


@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_replay_logits_reproduce_greedy_and_parity_reads_them(smoke, kv):
    """``replay_logits`` fed greedy's tokens gives the logits greedy chose
    them from; under a mixed plan ``parity_report`` reads a divergence's
    top-2 gap from that decode replay, not from a native prefill."""
    from repro_torch.train.step import replay_logits
    cfg, params = smoke
    qcfg = _mixed(cfg, kv)
    prompts = serve.request_prompts(cfg, 3, 12, seed=3)
    plan = execplan.resolve_plan(qcfg)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(qcfg, params, prompts, 8, 3, plan)
        lg = replay_logits(params, qcfg, torch.from_numpy(prompts), torch.from_numpy(greedy),
                           plan=plan)
        assert lg.shape == (3, 8, cfg.vocab_size)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), greedy)

        class Result:
            def __init__(self, tokens):
                self.tokens = tokens
        results = {i: Result(greedy[i].tolist()) for i in range(3)}
        toks = greedy[1].tolist()
        toks[5] = (toks[5] + 1) % cfg.vocab_size
        results[1] = Result(toks)
        report = serve.parity_report(qcfg, params, prompts, greedy, results, plan)
        prefill_lg = M.prefill(params, qcfg, torch.from_numpy(
            np.concatenate([prompts[1], greedy[1, :5]])[None]), plan=plan)[0][0, -1].float()
    assert [r[:2] for r in report] == [(1, 5)]
    # the replay at batch 1 and at batch 3 differ only by summation order
    top2 = lg[1, 5].topk(2).values
    assert report[0][2] == pytest.approx(float(top2[0] - top2[1]), rel=1e-4)
    top2_prefill = prefill_lg.topk(2).values
    assert report[0][2] != pytest.approx(float(top2_prefill[0] - top2_prefill[1]), rel=1e-2)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_reference_route_reads_quantized_kv_through_plain_attention(smoke, layout,
                                                                      monkeypatch):
    """On the reference route decode attention runs the kernels' plain
    versions (``ref``), never the ``ops`` wrappers: the route a
    kernel-route run is held against shares no kernel with it."""
    cfg, params = smoke
    qcfg = _mixed(cfg, "int8")
    name = ("paged" if layout == "paged" else "ring") + "_quant_gqa_attention"

    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} wrapper called")
    monkeypatch.setattr(ops, name, refuse)
    prompts = serve.request_prompts(cfg, 2, 8, seed=4)
    ov = {"decode": {"kv": layout}}
    with torch.inference_mode():
        ref_plan = execplan.resolve_plan(qcfg, backend="reference", overrides=ov)
        if layout == "paged":
            serve.run_continuous(qcfg, params, prompts, 4, 2, plan=ref_plan)
        else:
            serve.run_batch(qcfg, params, prompts, 4, 2, ref_plan)
        with pytest.raises(AssertionError, match="wrapper called"):
            kplan = execplan.resolve_plan(qcfg, overrides=ov)
            if layout == "paged":
                serve.run_continuous(qcfg, params, prompts, 4, 2, plan=kplan)
            else:
                serve.run_batch(qcfg, params, prompts, 4, 2, kplan)
