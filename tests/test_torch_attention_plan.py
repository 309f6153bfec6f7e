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


H100_SMEM_OPTIN = 227 * 1024    # an H100's opt-in shared memory a block


@pytest.mark.parametrize("heads,cap", [((32, 8, 128), 14272), ((9, 3, 64), 19178)],
                         ids=["llama3_8b_proxy", "smollm_135m"])
def test_paged_gqa_context_cap(monkeypatch, heads, cap):
    """paged_gqa_attention's block keeps a G x ctx f32 score row in shared
    memory, which caps the page table's width: at an H100's 227 KB, 14272
    positions at llama3_8b_proxy's heads (G 4, d 128) and 19178 at
    smollm_135m's (G 3, d 64).  The wrapper launches a table up to the cap
    and raises a ValueError naming it for one page wider, before any launch."""
    h, kh, d = heads
    g = h // kh
    assert ops.paged_gqa_max_ctx(g, d, H100_SMEM_OPTIN) == cap
    assert (ops.paged_gqa_smem_bytes(g, d, cap) <= H100_SMEM_OPTIN
            < ops.paged_gqa_smem_bytes(g, d, cap + 1))
    seen = []
    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_smem_optin", lambda device: H100_SMEM_OPTIN)
    monkeypatch.setattr(ops, "_launch", lambda name, device, *args: seen.append(args[-2]))
    ps = 8
    q = torch.zeros((1, 1, h, d), dtype=torch.bfloat16)
    pool = torch.zeros((2, ps, kh, d), dtype=torch.bfloat16)
    pos = torch.zeros(1, dtype=torch.int32)
    ops.paged_gqa_attention(q, pool, pool, torch.zeros((1, cap // ps), dtype=torch.int32), pos)
    assert seen == [cap // ps]
    with pytest.raises(ValueError, match=f"take at most {cap} positions"):
        ops.paged_gqa_attention(q, pool, pool,
                                torch.zeros((1, cap // ps + 1), dtype=torch.int32), pos)
    assert seen == [cap // ps]
