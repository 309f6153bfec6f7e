"""The split plan of the bf16 ``nm_spmm``, ``nf4_spmm``, ``fused_lora``,
``salr_spmm``, ``qsalr_spmm`` and ``bitmap_spmm`` kernels, on the CPU: the
slices cover [0, K) in order at every shape the GPU tests and
``chip_smoke.py`` give the kernels, and the plan the wrappers pass to the kernel depends on (K, N)
and the card (``fused_lora``: on K) alone, never on M (a row's bits at M =
1 and M = 1024 rest on it); the expert kernels take no plan at all.  The
launch is intercepted; no kernel runs here."""
import pytest
import torch

from repro_torch.core import bitmap as tbm
from repro_torch.kernels import build, ops

H100_SMS = 132          # an H100 SXM's streaming multiprocessors

# (K, N) of every nm_spmm / nf4_spmm call in tests/test_torch_cuda.py and
# chip_smoke.py phase 2: smollm's wo and down, granite's wo, the ragged ones
SHAPES = [(576, 576), (1536, 576), (1024, 1024), (100, 200), (64, 136), (48, 128),
          (96, 128), (100, 192)]
ROWS = (1, 4, 8, 33, 100, 1024)


@pytest.mark.parametrize("sms", [H100_SMS, 1, 1000])
@pytest.mark.parametrize("k,n", SHAPES)
def test_slices_cover_k_in_order(k, n, sms):
    slices, slice_k = ops.splitk_plan(k, n, sms)
    assert slice_k % build.SPLITK_BK == 0
    bounds = [(s * slice_k, min(k, (s + 1) * slice_k)) for s in range(slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_decode_fills_a_wave():
    """The (column tile x slice) blocks at decode on an H100: 144 at down
    against the column GEMM's 5, at least one block per SM at each
    main-path shape."""
    def blocks(k, n):
        return ops.splitk_plan(k, n, H100_SMS)[0] * -(-n // build.SPLITK_BN)
    assert blocks(1536, 576) == 144
    for k, n in [(576, 576), (1536, 576), (1024, 1024)]:
        assert blocks(k, n) >= H100_SMS


def _plan_args(args) -> tuple:
    """(workspace, slices, slice_k) of an nm_spmm / nf4_spmm launch: x, two
    weight tensors and y come before the workspace; the plan comes last but
    for the dtype code."""
    return args[4], args[-3], args[-2]


def _launches(monkeypatch, call, rows, k):
    """The (workspace, slices, slice_k) arguments ``call`` passes per M."""
    seen = []

    def record(name, device, *args):
        seen.append(_plan_args(args))

    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(ops, "_launch", record)
    gen = torch.Generator().manual_seed(k)
    for m in rows:
        call(torch.randn((m, k), generator=gen).to(torch.bfloat16))
    return seen


@pytest.mark.parametrize("kernel", ["nm_spmm", "nf4_spmm"])
@pytest.mark.parametrize("k,n", [(1536, 576), (100, 192)])
def test_wrappers_pass_a_plan_of_k_and_n_alone(monkeypatch, kernel, k, n):
    gen = torch.Generator().manual_seed(n)
    w = torch.randn((k, n), generator=gen) / k ** 0.5
    if kernel == "nm_spmm":
        nmw, _ = tbm.nm_encode(w.to(torch.bfloat16))
        seen = _launches(monkeypatch, lambda x: ops.nm_matmul(x, nmw), ROWS, k)
    else:
        codes, scales = ops.nf4_encode_2d(w)
        seen = _launches(monkeypatch, lambda x: ops.nf4_matmul(x, codes, scales), ROWS, k)
    assert len(seen) == len(ROWS)
    assert ({(slices, slice_k) for _, slices, slice_k in seen}
            == {ops.splitk_plan(k, n, H100_SMS)})
    # the rows dispatch (null workspace) at M = 1024 alone: there the
    # slices' partials would pass the bytes a pipeline step of K is worth
    slices, _ = ops.splitk_plan(k, n, H100_SMS)
    steps = -(-k // build.SPLITK_BK)
    for m, (ws, _, _) in zip(ROWS, seen):
        walks_rows = slices * m * n * 4 >= steps * ops.SPLITK_ROWS_BYTES_PER_STEP
        assert (ws is None) == walks_rows == (m == 1024)


def test_f32_takes_no_plan(monkeypatch):
    """f32 stays on the column GEMM: no workspace and no slices."""
    nmw, _ = tbm.nm_encode(torch.randn((64, 64)))
    seen = []
    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_launch", lambda name, device, *args: seen.append(_plan_args(args)))
    ops.nm_matmul(torch.randn((4, 64)), nmw)
    assert seen == [(None, 0, 0)]


# (K, R, N) of every fused_lora call in tests/test_torch_cuda.py and
# chip_smoke.py phase 2: smollm's wo and down at R = 128, the ragged ones
LORA_SHAPES = [(576, 128, 576), (1536, 128, 576), (100, 24, 200), (64, 256, 72)]


def _lora_launches(monkeypatch, k, r, n, dtype=torch.bfloat16):
    """(workspace shape, slices, slice_k) of each fused_lora launch at the
    M of ``ROWS``: x, A_cat, B_cat, y and the workspace come before M, K, R
    and N."""
    seen, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        if kw.get("dtype") == torch.float32:
            shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    def record(name, device, *args):
        assert name == "fused_lora" and args[5:9] == (m, k, r, n)
        seen.append((shapes.pop() if args[4] is not None else None, *args[9:11]))

    monkeypatch.setattr(ops.torch, "empty", empty)
    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_launch", record)
    gen = torch.Generator().manual_seed(k + r)
    a = torch.randn((k, r), generator=gen).to(dtype)
    b = torch.randn((r, n), generator=gen).to(dtype)
    for m in ROWS:
        ops.lora_matmul(torch.randn((m, k), generator=gen).to(dtype), a, b)
    return seen


@pytest.mark.parametrize("k", [576, 1536, 1024, 100, 64, 32, 7168])
def test_lora_plan_covers_k_in_order(k):
    """At most LORA_SLICES slices of whole pipeline steps cover [0, K) in
    order, none empty."""
    slices, slice_k = ops.lora_plan(k)
    assert 1 <= slices <= ops.LORA_SLICES and slice_k % build.SPLITK_BK == 0
    bounds = [(s * slice_k, min(k, (s + 1) * slice_k)) for s in range(slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)


@pytest.mark.parametrize("k,r,n", LORA_SHAPES)
def test_lora_passes_a_plan_of_k_alone(monkeypatch, k, r, n):
    """u = x @ A_cat is cut by the plan of K at every M, its partials in a
    (slices, M, R) workspace: no M moves the plan or the dispatch."""
    seen = _lora_launches(monkeypatch, k, r, n)
    slices, slice_k = ops.lora_plan(k)
    assert seen == [((slices, m, r), slices, slice_k) for m in ROWS]


def test_lora_f32_takes_no_plan(monkeypatch):
    """f32 stays on the column GEMM: no workspace and no slices."""
    assert set(_lora_launches(monkeypatch, 64, 8, 64, torch.float32)) == {(None, 0, 0)}


# the NF4 cases keep their earlier ids; the plain and 2:4 families' run
# beside them
@pytest.mark.parametrize("kind,route", [
    pytest.param("qsalr", "grouped", id="grouped"),
    pytest.param("qsalr", "decode", id="decode"),
    pytest.param("salr", "grouped", id="plain-grouped"),
    pytest.param("salr", "decode", id="plain-decode"),
    pytest.param("nm", "grouped", id="nm-grouped"),
    pytest.param("nm", "decode", id="nm-decode"),
    pytest.param("dense", "grouped", id="dense-grouped"),
    pytest.param("dense", "decode", id="dense-decode")])
def test_qsalr_expert_wrappers_pass_no_plan(monkeypatch, kind, route):
    """The expert kernels on the tensor-core body, tiled bitmap plain
    (grouped_ and decode_salr_spmm) and NF4 (grouped_ and
    decode_qsalr_spmm), 2:4 (grouped_ and decode_nm_spmm) and masked dense
    (grouped_ and decode_dense_spmm), launch with the stack's layout ints
    after M (K, R, E, then n_tiles, words per tile and cap_t; N, n and m;
    or N; grouped: block_m) and nothing else: no split of K that M, the
    tile count or an expert's rows could move."""
    from repro_torch.models import moe
    n_exp, k, n, r, topk = 4, 64, 512, 16, 2
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((n_exp * k, n), generator=gen)
    mask = w.abs() > 0.7
    tbw, _ = tbm.tile_encode((w * mask).to(torch.bfloat16), mask, 256, 160)
    tbw = tbm.TiledBitmapWeight(words=tbw.words.reshape(n_exp, k, 2, 8),
                                values=tbw.values.reshape(n_exp, k, 2, 160),
                                cols=n, tile=256, cap_t=160)
    w3 = w.reshape(n_exp, k, n)
    stack = {"salr": lambda: tbw, "qsalr": lambda: tbm.tile_quantize_nf4(tbw)[0],
             "nm": lambda: tbm.nm_encode(w3.to(torch.bfloat16))[0],
             "dense": lambda: (w3 * mask.reshape(n_exp, k, n)).to(torch.bfloat16)}[kind]()
    layout = {"nm": (n, 2, 4), "dense": (n,)}.get(kind, (2, 8, 160))
    a = torch.randn((n_exp, k, r), generator=gen).to(torch.bfloat16)
    b = torch.randn((n_exp, r, n), generator=gen).to(torch.bfloat16)
    seen = []
    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_launch", lambda name, device, *args: seen.append(args))
    # x, the stack's leaves (words + values, words + codes + scales, group
    # bytes + values, or the dense weight), A_cat, B_cat, u, y and the row
    # map come before M
    skip = 7 + {"qsalr": 3, "dense": 1}.get(kind, 2)
    for n_tok in (1, 4, 8, 33, 128):
        x = torch.randn((n_tok, k), generator=gen).to(torch.bfloat16)
        top_i = torch.rand((n_tok, n_exp), generator=gen).argsort(dim=1)[:, :topk]
        if route == "decode":
            xd = x.repeat_interleave(topk, dim=0)
            getattr(ops, f"decode_{kind}_matmul")(xd, top_i.reshape(-1).to(torch.int32),
                                                  stack, a, b)
            want = (k, r, n_exp, *layout, 1)
        else:
            g = moe.group_assignments(top_i, n_exp, moe._group_block_m(n_tok * topk, n_exp))
            xs = x.new_zeros((g.m_pad, k))
            getattr(ops, f"grouped_{kind}_matmul")(xs, g.tile_expert, stack, a, b,
                                                   block_m=g.block_m)
            want = (k, r, n_exp, *layout, g.block_m, 1)
        assert seen[-1][skip:] == want


# (K, N) of the salr_spmm / qsalr_spmm calls in tests/test_torch_cuda.py
# and chip_smoke.py phase 2: smollm's four projection shapes, deepseek's wo,
# shared expert and gate/up, llama3_8b_proxy's four, and the ragged ones
SALR_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576), (16384, 7168), (7168, 2048),
               (2048, 7168), (7168, 18432), (4096, 4096), (4096, 1024), (4096, 14336),
               (14336, 4096), (100, 64), (100, 192), (100, 384), (100, 512)]


@pytest.mark.parametrize("sms", [H100_SMS, 1, 1000])
@pytest.mark.parametrize("k,n", SALR_SHAPES)
def test_salr_plan_chunks_cover_k(k, n, sms):
    """salr_plan's slices cover [0, K) in order, none empty, and a slice
    longer than SALR_CHUNK_K rows is a whole number of chunks, so the rows
    dispatch's chunks are the slices dispatch's; it departs from
    splitk_plan only there."""
    slices, slice_k = ops.salr_plan(k, n, sms)
    assert slice_k % build.SPLITK_BK == 0
    assert slice_k <= ops.SALR_CHUNK_K or slice_k % ops.SALR_CHUNK_K == 0
    bounds = [(s * slice_k, min(k, (s + 1) * slice_k)) for s in range(slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    if ops.splitk_plan(k, n, sms)[1] <= ops.SALR_CHUNK_K:
        assert (slices, slice_k) == ops.splitk_plan(k, n, sms)


def _salr_weight(kind, k, n, tile, cap_t):
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn((k, n), generator=gen)
    mask = w.abs() > 0.7
    tbw, _ = tbm.tile_encode((w * mask).to(torch.bfloat16), mask, tile, cap_t)
    return tbm.tile_quantize_nf4(tbw)[0] if kind == "qsalr_spmm" else tbw


def _salr_launches(monkeypatch, kind, k, n, r, tile, cap_t, dtype=torch.bfloat16):
    """(workspace pointer, the plan ints) of each salr_spmm / qsalr_spmm /
    bitmap_spmm launch at the M of ``ROWS``: after the workspace come M, K,
    R (bitmap_spmm: none), the three layout ints, the base's plan, u's plan
    (bitmap_spmm: none) and the dtype code."""
    seen = []
    bitmap = kind == "bitmap_spmm"
    n_plan = 2 if bitmap else 4

    def record(name, device, *args):
        want = ((m, k) if bitmap else (m, k, r)) + (n // tile, tile // 32, cap_t)
        plan_at = len(args) - 1 - n_plan
        assert name == kind and args[plan_at - len(want):plan_at] == want
        seen.append((args[plan_at - len(want) - 1], *args[plan_at:-1]))

    monkeypatch.setattr(ops, "_placement", lambda *a: "cuda")
    monkeypatch.setattr(ops, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(ops, "_launch", record)
    tw = _salr_weight(kind, k, n, tile, cap_t)
    if dtype != torch.bfloat16 and kind != "qsalr_spmm":
        tw = tbm.TiledBitmapWeight(words=tw.words, values=tw.values.to(dtype), cols=tw.cols,
                                   tile=tw.tile, cap_t=tw.cap_t)
    gen = torch.Generator().manual_seed(r)
    a = torch.randn((k, r), generator=gen).to(dtype)
    b = torch.randn((r, n), generator=gen).to(dtype)
    op = {"salr_spmm": ops.salr_matmul, "qsalr_spmm": ops.qsalr_matmul,
          "bitmap_spmm": lambda x, tw, a, b: ops.bitmap_matmul(x, tw)}[kind]
    for m in ROWS:
        op(torch.randn((m, k), generator=gen).to(dtype), tw, a, b)
    return seen


@pytest.mark.parametrize("kind", ["salr_spmm", "qsalr_spmm", "bitmap_spmm"])
@pytest.mark.parametrize("k,n,r,tile,cap_t", [(576, 1536, 128, 256, 160),
                                              (100, 192, 24, 96, 72)])
def test_salr_wrappers_pass_a_plan_of_k_and_n_alone(monkeypatch, kind, k, n, r, tile, cap_t):
    """bf16: the base's plan is salr_plan(K, N, SMs) and u's lora_plan(K)
    (bitmap_spmm: no u plan) at every M; the workspace pointer is null (the
    rows dispatch) at M = 1024 alone, where the base's partials would pass
    the bytes a pipeline step of K is worth."""
    seen = _salr_launches(monkeypatch, kind, k, n, r, tile, cap_t)
    plan = (*ops.salr_plan(k, n, H100_SMS),
            *(() if kind == "bitmap_spmm" else ops.lora_plan(k)))
    assert [p for _, *p in seen] == [list(plan)] * len(ROWS)
    for m, (ws, *_) in zip(ROWS, seen):
        walks_rows = ops._walks_rows(m, k, n, plan[0], ops.SALR_ROWS_BYTES_PER_STEP)
        assert (ws is None) == walks_rows == (m == 1024)


@pytest.mark.parametrize("kind", ["salr_spmm", "qsalr_spmm", "bitmap_spmm"])
def test_salr_f32_takes_no_plan(monkeypatch, kind):
    """f32 stays on the scalar body: no workspace and no slices."""
    seen = _salr_launches(monkeypatch, kind, 64, 64, 8, 32, 16, torch.float32)
    assert set(seen) == {(None,) + (0,) * (2 if kind == "bitmap_spmm" else 4)}
