"""The port's continuous-batching engine on the smoke arch: scheduler
units, and served tokens equal to the port's ``greedy_generate`` exactly
(paged KV with prefix sharing, and the dense slot cache)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import execplan
from repro_torch.launch import serve
from repro_torch.launch.engine import (ContinuousBatchingEngine, EngineConfig, PagePool,
                                       RadixCache, Request, default_buckets, pick_bucket)
from repro_torch.models import model as M

_FROZEN = lambda: 0.0  # noqa: E731  (deterministic scheduling clock)


@pytest.fixture(scope="module")
def smoke():
    cfg = configs.get("smollm_135m", smoke=True)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def test_buckets():
    assert default_buckets(64) == (8, 16, 32, 64)
    assert default_buckets(48) == (8, 16, 32, 48)
    assert pick_bucket(9, (8, 16, 32)) == 16
    with pytest.raises(ValueError):
        pick_bucket(33, (8, 16, 32))


def test_page_pool_and_radix_refcounts():
    pool = PagePool(6)                       # page 0 reserved
    assert pool.n_free == 5
    a = pool.alloc(2)
    assert a == [1, 2] and pool.alloc(4) is None
    radix = RadixCache(pool)
    radix.insert([(1, 2), (3, 4)], a)        # the tree's own references
    assert radix.match([(1, 2), (3, 4), (5, 6)]) == a
    pool.decref(a)                           # the request finishes
    assert pool.n_free == 3                  # tree still holds both pages
    assert radix.evict(5) == 2 and pool.n_free == 5
    with pytest.raises(RuntimeError):
        pool.decref([1])


def test_submit_rejects_oversized(smoke):
    cfg, params = smoke
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(n_slots=2, max_ctx=16),
                                   time_fn=_FROZEN)
    eng.submit(Request(rid=0, prompt=tuple(range(8)), max_new_tokens=8))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=tuple(range(8)), max_new_tokens=10))


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_engine_tokens_equal_greedy(smoke, kv):
    cfg, params = smoke
    prompts = serve.request_prompts(cfg, 6, 16, seed=1, shared_prefix=8)
    plan = execplan.resolve_plan(cfg, overrides={"decode": {"kv": kv}})
    with torch.inference_mode():
        greedy, _ = serve.run_batch(cfg, params, prompts, 8, 6, plan)
        eng, results, metrics = serve.run_continuous(cfg, params, prompts, 8, 4, plan=plan)
    assert metrics["kv_layout"] == kv and metrics["requests"] == 6
    for i in range(6):
        assert results[i].tokens == greedy[i].tolist(), i
    assert serve.parity_report(cfg, params, prompts, greedy, results, plan) == []
    if kv == "paged":
        # the shared 8-token prefix is one full page, reused by requests 1..5
        assert metrics["prefix_hit_rate"] == pytest.approx(5 * 8 / (6 * 16))
        # the tree keeps the shared page and each prompt's own second page
        assert metrics["pages_free"] == eng.n_pages - 1 - (1 + 6)


def test_parity_report_limits_a_divergence_by_route_noise(smoke):
    """A planted divergence is reported at its step, with a near-tie limit
    from the kernel route's spread around the reference route: in f32 the
    two agree within ``method:*``, so the limit is tiny."""
    cfg, params = smoke
    prompts = serve.request_prompts(cfg, 2, 8, seed=3)
    plan = execplan.resolve_plan(cfg)
    with torch.inference_mode():
        greedy, _ = serve.run_batch(cfg, params, prompts, 4, 2, plan)
        toks = greedy.tolist()
        toks[1][2] = (toks[1][2] + 1) % cfg.vocab_size
        results = {i: SimpleNamespace(tokens=t) for i, t in enumerate(toks)}
        report = serve.parity_report(cfg, params, prompts, greedy, results, plan)
    [(rid, step, gap, limit, tie, _, _)] = report
    assert (rid, step) == (1, 2) and gap >= 0
    assert 0 <= limit < 1e-3 * gap and tie is False


def test_engine_reset_and_slot_reuse(smoke):
    cfg, params = smoke
    prompts = serve.request_prompts(cfg, 5, 12, seed=2)
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(n_slots=2, max_ctx=24),
                                   time_fn=_FROZEN)
    reqs = [Request(rid=i, prompt=tuple(int(t) for t in p), max_new_tokens=4 + i)
            for i, p in enumerate(prompts)]
    # built and driven outside inference mode: the engine enters it itself
    first, _ = eng.run(reqs)
    eng.reset()
    second, m = eng.run(reqs)
    assert m["n_prefills"] == 5 and m["slot_occupancy_mean"] <= 2
    assert {r: v.tokens for r, v in first.items()} == {r: v.tokens for r, v in second.items()}
    assert all(len(second[i].tokens) == 4 + i for i in range(5))


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--engine", "both", "--requests", "2",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "parity OK: 4/4" in out and "engine=continuous" in out


def test_clear_cache_slot_zeroes_one_row(smoke):
    cfg, _ = smoke
    cache = M.init_slot_cache(cfg, 3, 8, "cpu")
    for lc in cache["layers"]:
        lc["mixer"].k.fill_(1.0)
    M.clear_cache_slot(cache, 1)
    k = cache["layers"][0]["mixer"].k
    assert not k[1].any() and bool((k[0] == 1).all()) and bool((k[2] == 1).all())
    assert np.isfinite(k.numpy()).all()
