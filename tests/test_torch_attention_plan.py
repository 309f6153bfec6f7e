"""The chunk plan of the quantized decode-attention kernels, on the CPU:
the chunks are whole pages that cover [0, ctx) exactly once, a ring cache
and a paged one whose pages divide the unit take the same plan, and the
plan the wrappers pass depends on the context, the page size, KH and the
card alone, never on B.  The launch is intercepted; no kernel runs here."""
import inspect

import pytest
import torch

from repro_torch.kernels import ops

H100_SMS = 132          # an H100 SXM's streaming multiprocessors
# 160: the main path's engine context; 2048: SmolLM-135M's published
# max_position_embeddings; 8192 at one KV head: the GPU tests' long context
CONTEXTS = (0, 1, 7, 8, 32, 63, 64, 65, 160, 300, 2048, 8192, 100_000)


@pytest.mark.parametrize("sms", [H100_SMS, 1, 1000])
@pytest.mark.parametrize("page_size", [1, 8, 16, 48, 128])
def test_attention_chunks_are_whole_pages_covering_the_context(page_size, sms):
    for kh in (1, 3, 8):
        for ctx in CONTEXTS:
            chunks, chunk = ops.attention_plan(ctx, page_size, kh, sms)
            assert chunk % page_size == 0 and chunk >= ops.ATTN_UNIT
            # chunk c holds [c * chunk, (c + 1) * chunk): each position in
            # exactly one, the last chunk starting before ctx
            assert chunks >= 1 and (chunks - 1) * chunk < max(ctx, 1) <= chunks * chunk
            assert chunk <= ops.ATTN_MAX_UNITS * (ops.ATTN_UNIT + page_size)


def test_ring_and_paged_take_one_plan():
    """The ring == paged bitwise property rests on it."""
    for ps in (2, 4, 8, 16, 32, 64):
        for kh in (1, 3, 8):
            for ctx in CONTEXTS:
                assert (ops.attention_plan(ctx, ps, kh, H100_SMS)
                        == ops.attention_plan(ctx, 1, kh, H100_SMS))


def test_attention_plan_takes_no_batch():
    assert list(inspect.signature(ops.attention_plan).parameters) == [
        "ctx", "page_size", "kh", "sms"]


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_wrappers_pass_a_plan_independent_of_b(monkeypatch, kv, paged):
    """smollm_135m's engine shape (9 heads, 3 KV heads, d 64, 20 pages of
    8): the (chunk, chunks) of every launch at B = 1, 4 and 8 is the plan
    of the context, and a workspace goes with a plan of several chunks."""
    seen = []
    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(ops, "_launch", lambda name, device, *args: seen.append(
        (args[8 if paged else 7], args[-3], args[-2])))
    name = f"{'paged' if paged else 'ring'}_{'quant' if kv == 'int8' else 'nf4'}_gqa_attention"
    dc, code = (64, torch.int8) if kv == "int8" else (32, torch.uint8)
    h, kh, ps, pages = 9, 3, 8, 20
    for b in (1, 4, 8):
        q = torch.zeros((b, 1, h, 64), dtype=torch.bfloat16)
        lead = (b * pages + 1, ps) if paged else (b, pages * ps)
        kvc = torch.zeros(lead + (kh, dc), dtype=code)
        scales = torch.zeros(lead + (kh,))
        pos = torch.full((b,), 100, dtype=torch.int32)
        table = (torch.arange(b * pages, dtype=torch.int32).reshape(b, pages) + 1,) if paged \
            else ()
        getattr(ops, name)(q, kvc, kvc, scales, scales, *table, pos)
    chunks, chunk = ops.attention_plan(pages * ps, ps if paged else 1, kh, H100_SMS)
    assert [(c, n) for _, c, n in seen] == [(chunk, chunks)] * 3
    assert all((ws is None) == (chunks == 1) for ws, _, _ in seen)
