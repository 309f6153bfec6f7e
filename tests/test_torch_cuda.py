"""The port's CUDA kernels against their plain PyTorch versions.

Marked ``cuda``: they need an NVIDIA GPU (a CUDA kernel has no CPU mode)
and skip elsewhere.  This file imports neither JAX nor the reference
package, so it runs on a GPU machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import bitmap as tbm
from repro_torch.core import prune
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import moe

# kernel and plain version both sum in f32 and round once: only the
# summation order differs (in bf16 it flips the rounding of a few
# outputs; a u = x @ A_cat left unrounded reads ~2e-3)
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(y, y_ref, dtype) -> bool:
    return bool((y.float() - y_ref.float()).norm() <= TOL[dtype] * y_ref.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,cap_t", [(32, 32), (96, 72), (192, 128), (256, 160)])
def test_spmm_kernels_match_plain(cuda, tile, cap_t, dtype):
    gen = torch.Generator(device=cuda).manual_seed(tile)
    k, n = 100, 2 * tile
    w = (torch.randn((k, n), generator=gen, device=cuda) / 10).to(dtype)
    mask = prune.magnitude_mask(w, 0.5)
    tbw, _ = tbm.tile_encode(prune.apply_mask(w, mask), mask, tile, cap_t)
    for m in (1, 5, 33, 100):
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        a = torch.randn((k, 24), generator=gen, device=cuda).to(dtype)
        b = torch.randn((24, n), generator=gen, device=cuda).to(dtype)
        y = ops.salr_matmul(x, tbw, a, b)
        assert _close(y, ref.salr_spmm_ref(x, tbw, a, b), dtype)
        assert _close(ops.bitmap_matmul(x, tbw), ref.bitmap_spmm_ref(x, tbw), dtype)
        # row independence: a row's result does not depend on the batch
        torch.testing.assert_close(ops.salr_matmul(x[:1], tbw, a, b), y[:1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_and_skips_dead_pages(cuda, dtype):
    rng = np.random.default_rng(2)
    b, h, kh, d, ps, max_pages = 3, 9, 3, 64, 8, 4
    n_pages = b * max_pages + 1
    kp = torch.from_numpy(rng.standard_normal((n_pages, ps, kh, d))).to(cuda, dtype)
    vp = torch.from_numpy(rng.standard_normal((n_pages, ps, kh, d))).to(cuda, dtype)
    table = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    pos = np.array([max_pages * ps - 1, 6, 0], np.int32)
    for i in range(b):
        table[i, pos[i] // ps + 1:] = 0
    table, pos = torch.from_numpy(table).to(cuda), torch.from_numpy(pos).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d))).to(cuda, dtype)
    y = ops.paged_gqa_attention(q, kp, vp, table, pos)
    assert _close(y, ref.paged_gqa_attention_ref(q, kp, vp, table, pos), dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    torch.testing.assert_close(ops.paged_gqa_attention(q, kp, vp, table, pos), y,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,cap_t", [(32, 32), (96, 72), (192, 128), (256, 160)])
def test_qsalr_kernel_matches_plain_and_rows_are_independent(cuda, tile, cap_t, dtype):
    gen = torch.Generator(device=cuda).manual_seed(tile + 1)
    k, n = 100, 2 * tile
    w = (torch.randn((k, n), generator=gen, device=cuda) / 10).to(dtype)
    mask = prune.magnitude_mask(w, 0.5)
    tbw, _ = tbm.tile_encode(prune.apply_mask(w, mask), mask, tile, cap_t)
    q, _ = tbm.tile_quantize_nf4(tbw)
    for m in (1, 4, 8, 33, 100):              # 4 and 8: the main path's decode batches
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        a = torch.randn((k, 24), generator=gen, device=cuda).to(dtype)
        b = torch.randn((24, n), generator=gen, device=cuda).to(dtype)
        y = ops.qsalr_matmul(x, q, a, b)
        assert _close(y, ref.qsalr_spmm_ref(x, q, a, b), dtype)
        a0 = torch.zeros((k, 0), device=cuda, dtype=dtype)
        b0 = torch.zeros((0, n), device=cuda, dtype=dtype)
        assert _close(ops.qsalr_matmul(x, q, a0, b0), ref.qsalr_spmm_ref(x, q, a0, b0), dtype)
        # row independence: a row's result does not depend on the batch
        torch.testing.assert_close(ops.qsalr_matmul(x[:1], q, a, b), y[:1], rtol=0, atol=0)
        if dtype == torch.bfloat16 and m == 100:
            # the limit rejects stored values left unrounded (f32 into the
            # product); taken on the base term, which the adapter term of
            # these unscaled factors would swamp
            unrounded = (x.float() @ tbm.qtile_decode(q).float()).to(dtype)
            assert not _close(unrounded, ref.qsalr_spmm_ref(x, q, a0, b0), dtype)


def _quant_pools(kv, rng, cuda, dtype, paged, b=3, h=9, kh=3, d=64, ps=8, max_pages=4):
    quant = attn.q8 if kv == "int8" else attn.qnf4
    lead = (b * max_pages + 1, ps) if paged else (b, max_pages * ps)
    k, ks = quant(torch.from_numpy(rng.standard_normal(lead + (kh, d))).to(cuda, dtype))
    v, vs = quant(torch.from_numpy(rng.standard_normal(lead + (kh, d))).to(cuda, dtype))
    pos = torch.tensor([max_pages * ps - 1, 6, 0][:b], dtype=torch.int32, device=cuda)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d))).to(cuda, dtype)
    if not paged:
        return (q, k, v, ks, vs, pos), None
    table = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    dead = [0]
    for i in range(b):
        dead += table[i, int(pos[i]) // ps + 1:].tolist()
        table[i, int(pos[i]) // ps + 1:] = 0 if i % 2 else table[i, int(pos[i]) // ps + 1:]
    return (q, k, v, ks, vs, torch.from_numpy(table).to(cuda), pos), dead


_QUANT_ATTENTION = {("int8", False): (ops.ring_quant_gqa_attention,
                                      ref.ring_quant_gqa_attention_ref),
                    ("nf4", False): (ops.ring_nf4_gqa_attention, ref.ring_nf4_gqa_attention_ref),
                    ("int8", True): (ops.paged_quant_gqa_attention,
                                     ref.paged_quant_gqa_attention_ref),
                    ("nf4", True): (ops.paged_nf4_gqa_attention,
                                    ref.paged_nf4_gqa_attention_ref)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("kv", ["int8", "nf4"])
def test_quant_attention_kernels_match_plain_and_skip_dead_data(cuda, kv, paged, dtype):
    rng = np.random.default_rng(3)
    args, dead = _quant_pools(kv, rng, cuda, dtype, paged)
    kern, plain = _QUANT_ATTENTION[kv, paged]
    y = kern(*args)
    assert _close(y, plain(*args), dtype)
    q, k, v, ks, vs, *rest = args
    pos = rest[-1]
    if paged:           # NaN scales and junk codes in the dead pages
        for t in (ks, vs):
            t[dead] = float("nan")
        k[dead] = 3
    else:               # NaN scales and junk codes past each row's pos
        for i, p in enumerate(pos.tolist()):
            ks[i, p + 1:] = float("nan")
            vs[i, p + 1:] = float("nan")
            v[i, p + 1:] = 5
    torch.testing.assert_close(kern(*args), y, rtol=0, atol=0)
    # the ring and paged kernels share their per-position code: the same
    # rows read through a page table give the same bits
    if not paged:
        b, w = k.shape[:2]
        table = torch.arange(b * w // 8, dtype=torch.int32, device=cuda).reshape(b, w // 8)
        pools = [t.reshape(b * w // 8, 8, *t.shape[2:]) for t in (k, v, ks, vs)]
        other = _QUANT_ATTENTION[kv, True][0](q, *pools, table, pos)
        torch.testing.assert_close(other, y, rtol=0, atol=0)


_ROWS = (1, 4, 8, 33, 100)       # 4 and 8: the main path's decode batches


def _rows_independent(fn, x, y) -> None:
    """Bitwise: the first and last rows computed alone equal the batch's."""
    torch.testing.assert_close(fn(x[:1]), y[:1], rtol=0, atol=0)
    torch.testing.assert_close(fn(x[-1:]), y[-1:], rtol=0, atol=0)


# nm_spmm / nf4_spmm: on an H100, M = 1024 takes the bf16 kernels' rows
# dispatch at every shape here, M <= 100 their slices dispatch
# (ops._splitk_args)
_SPLITK_ROWS = _ROWS + (1024,)


def _deterministic(fn, x, y) -> None:
    """Bitwise: a second call on the same inputs gives the same output."""
    torch.testing.assert_close(fn(x), y, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,nm", [(576, 576, (2, 4)), (100, 200, (2, 4)), (64, 136, (1, 4)),
                                    (48, 128, (4, 8)), (1024, 1024, (2, 4))])
def test_nm_kernel_matches_plain_and_rows_are_independent(cuda, k, n, nm, dtype):
    """(1024, 1024): granite's wo."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    w = (torch.randn((k, n), generator=gen, device=cuda) / 10).to(dtype)
    nmw, _ = tbm.nm_encode(w, *nm)
    for m in _SPLITK_ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        y = ops.nm_matmul(x, nmw)
        assert _close(y, ref.nm_spmm_ref(x, nmw), dtype)
        _rows_independent(lambda xs: ops.nm_matmul(xs, nmw), x, y)
        _deterministic(lambda xs: ops.nm_matmul(xs, nmw), x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,r,n", [(576, 128, 576), (1536, 128, 576), (100, 24, 200),
                                   (64, 256, 72)])
def test_fused_lora_kernel_matches_plain_and_rows_are_independent(cuda, k, r, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k + r)
    a = (torch.randn((k, r), generator=gen, device=cuda) / k ** 0.5).to(dtype)
    b = (torch.randn((r, n), generator=gen, device=cuda) / r ** 0.5).to(dtype)
    for m in _ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        y = ops.lora_matmul(x, a, b)
        y_ref = ref.fused_lora_ref(x, a, b)
        assert _close(y, y_ref, dtype)
        _rows_independent(lambda xs: ops.lora_matmul(xs, a, b), x, y)
        if dtype == torch.bfloat16 and m == 100:
            # the limit rejects u = x @ A_cat left unrounded
            unrounded = ((x.float() @ a.float()) @ b.float()).to(dtype)
            assert not _close(unrounded, y_ref, dtype)
    with pytest.raises(ValueError, match="rank"):
        ops.lora_matmul(x, torch.zeros((k, 300), device=cuda, dtype=dtype),
                        torch.zeros((300, n), device=cuda, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(576, 576), (1536, 576), (96, 96), (100, 192)])
def test_nf4_kernel_matches_plain_and_rows_are_independent(cuda, k, n, dtype):
    """N = 96 pads to 128 (the smoke width's twin), as attach_qbase pads."""
    gen = torch.Generator(device=cuda).manual_seed(k * n)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    codes, scales = ops.nf4_encode_2d(torch.nn.functional.pad(w, (0, (-n) % 64)))
    for m in _SPLITK_ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        y = ops.nf4_matmul(x, codes, scales)
        y_ref = ref.nf4_spmm_ref(x, codes, scales)
        assert _close(y, y_ref, dtype)
        assert not y[:, n:].any()                 # padded columns quantize to zeros
        _rows_independent(lambda xs: ops.nf4_matmul(xs, codes, scales), x, y)
        _deterministic(lambda xs: ops.nf4_matmul(xs, codes, scales), x, y)
        if dtype == torch.bfloat16 and m == 100:
            # the limit rejects the dequantized weight left unrounded
            from repro_torch.core.quant import nf4_dequant_2d
            unrounded = (x.float() @ nf4_dequant_2d(codes, scales)).to(dtype)
            assert not _close(unrounded, y_ref, dtype)


@pytest.mark.parametrize("k,n", [(100, 200), (1536, 576)])
def test_splitk_dispatches_give_the_same_bits(cuda, k, n, monkeypatch):
    """nm_spmm and nf4_spmm in bf16 with every call forced through the rows
    dispatch, then through the slices dispatch: bitwise equal at every M,
    ragged K and N included."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    nmw, _ = tbm.nm_encode(w.to(torch.bfloat16))
    codes, scales = ops.nf4_encode_2d(torch.nn.functional.pad(w, (0, (-n) % 64)))
    plan = ops._splitk_args

    def forced(walk_rows):
        def args(x2, k, n):
            _, slices, slice_k = plan(x2, k, n)
            ws = None if walk_rows else torch.empty((slices, x2.shape[0], n),
                                                    dtype=torch.float32, device=x2.device)
            return ws, slices, slice_k
        return args

    for m in _SPLITK_ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        out = []
        for walk_rows in (True, False):
            monkeypatch.setattr(ops, "_splitk_args", forced(walk_rows))
            out.append((ops.nm_matmul(x, nmw), ops.nf4_matmul(x, codes, scales)))
        for a, b in zip(*out):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("sms", [1, 1000])
@pytest.mark.parametrize("k,n", [(100, 200), (1536, 576)])
def test_splitk_kernels_hold_under_any_plan(cuda, k, n, sms, monkeypatch):
    """nm_spmm and nf4_spmm in bf16 under the plans of other cards: one
    slice for all of K (1 SM) and one pipeline step a slice (1000 SMs),
    each M under the dispatch it picks.  Each matches its plain version
    with its rows independent of M, ragged K and N included."""
    gen = torch.Generator(device=cuda).manual_seed(k + sms)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    nmw, _ = tbm.nm_encode(w.to(torch.bfloat16))
    codes, scales = ops.nf4_encode_2d(torch.nn.functional.pad(w, (0, (-n) % 64)))
    monkeypatch.setattr(ops, "_sm_count", lambda device: sms)
    for m in _SPLITK_ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        for fn, plain in ((lambda xs: ops.nm_matmul(xs, nmw), lambda: ref.nm_spmm_ref(x, nmw)),
                          (lambda xs: ops.nf4_matmul(xs, codes, scales),
                           lambda: ref.nf4_spmm_ref(x, codes, scales))):
            y = fn(x)
            assert _close(y, plain(), torch.bfloat16)
            _rows_independent(fn, x, y)


def test_wrappers_launch_and_count(cuda):
    w = torch.randn((64, 64), device=cuda)
    mask = prune.magnitude_mask(w, 0.5)
    tbw, _ = tbm.tile_encode(prune.apply_mask(w, mask), mask, 64, 48)
    before = dict(ops.LAUNCHES)
    ops.bitmap_matmul(torch.randn((3, 64), device=cuda), tbw)
    assert ops.LAUNCHES["bitmap_spmm"] == before["bitmap_spmm"] + 1
    with pytest.raises(TypeError):
        ops.bitmap_matmul(torch.randn((3, 64), device=cuda, dtype=torch.float16),
                          tbw)
    x = torch.randn((3, 64), device=cuda)
    nmw, _ = tbm.nm_encode(w)
    codes, scales = ops.nf4_encode_2d(w)
    before = dict(ops.LAUNCHES)
    ops.nm_matmul(x, nmw)
    ops.lora_matmul(x, w[:, :8].contiguous(), w[:8].contiguous())
    ops.nf4_matmul(x, codes, scales)
    for name in ("nm_spmm", "fused_lora", "nf4_spmm"):
        assert ops.LAUNCHES[name] == before[name] + 1
    with pytest.raises(TypeError):
        ops.nm_matmul(x.to(torch.bfloat16), nmw)


def _expert_stacks(cuda, gen, dtype, n_exp, k, n, r):
    """An expert stack in each base family the expert kernels take: a
    tiled bitmap (p = 0.5) and its NF4 twin, a masked dense stack and a
    2:4 stack (groups along N); adapters A_cat (E, K, R), B_cat (E, R,
    N)."""
    from repro_torch.core import salr
    w = torch.randn((n_exp * k, n), generator=gen, device=cuda) / k ** 0.5
    flat, _ = salr._tiled_encode(w.to(dtype), salr.SALRConfig())
    tbw = tbm.TiledBitmapWeight(words=flat.words.reshape(n_exp, k, *flat.words.shape[1:]),
                                values=flat.values.reshape(n_exp, k, *flat.values.shape[1:]),
                                cols=flat.cols, tile=flat.tile, cap_t=flat.cap_t)
    q, _ = tbm.tile_quantize_nf4(tbw)
    w3 = w.reshape(n_exp, k, n)
    dense = prune.apply_mask(w3, prune.magnitude_mask(w3, 0.5, batch_dims=1)).to(dtype)
    nmw, _ = tbm.nm_encode(w3.to(dtype))
    a = (torch.randn((n_exp, k, r), generator=gen, device=cuda) / k ** 0.5).to(dtype)
    b = (torch.randn((n_exp, r, n), generator=gen, device=cuda) / r ** 0.5).to(dtype)
    return {"salr": tbw, "qsalr": q, "dense": dense, "nm": nmw}, a, b


def _width(st) -> int:
    """The encoded output width of an expert stack."""
    return st.shape[-1] if isinstance(st, torch.Tensor) else st.cols


def _expert_rows(gen, cuda, x, n_exp, topk):
    """(top_i, grouped assignments, grouped rows, decode rows, row map)
    for the tokens x."""
    n_tok = x.shape[0]
    top_i = torch.rand((n_tok, n_exp), generator=gen, device=cuda).argsort(dim=1)[:, :topk]
    g = moe.group_assignments(top_i, n_exp, moe._group_block_m(n_tok * topk, n_exp))
    xs = x.new_zeros((g.m_pad, x.shape[1]))
    xs.index_copy_(0, g.dst, x.index_select(0, g.tok))
    return top_i, g, xs, x.repeat_interleave(topk, dim=0), top_i.reshape(-1).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,r", [(1024, 512, 128), (512, 1024, 128), (100, 200, 24)])
def test_expert_kernels_match_plain_bitwise_across_routes(cuda, k, n, r, dtype):
    """grouped_/decode_{salr,qsalr,dense,nm}_spmm vs their plain versions
    (E 32, top-8);
    the grouped and decode outputs bitwise equal per assignment row; a
    row bitwise the same at 1, 4, 8 and 33 tokens as in a 64-token call."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    stacks, a, b = _expert_stacks(cuda, gen, dtype, 32, k, n, r)
    x = (torch.randn((64, k), generator=gen, device=cuda) / 4).to(dtype)
    top_i, g, xs, xd, row_e = _expert_rows(gen, cuda, x, 32, 8)
    for kind, st in stacks.items():
        grouped = getattr(ops, f"grouped_{kind}_matmul")
        decode = getattr(ops, f"decode_{kind}_matmul")
        yg = grouped(xs, g.tile_expert, st, a, b, block_m=g.block_m)
        yd = decode(xd, row_e, st, a, b)
        # the plain versions take B_cat at the encoded width
        bp = torch.nn.functional.pad(b, (0, _width(st) - n))
        assert _close(yg, getattr(ref, f"grouped_{kind}_spmm_ref")(
            xs, g.tile_expert, st, a, bp, g.block_m), dtype)
        assert _close(yd, getattr(ref, f"decode_{kind}_spmm_ref")(xd, row_e, st, a, bp), dtype)
        assert torch.equal(yg[g.dst[g.inv]], yd)
        for n_sub in (1, 4, 8, 33):
            rows = n_sub * 8
            assert torch.equal(decode(xd[:rows], row_e[:rows], st, a, b), yd[:rows])
            gs = moe.group_assignments(top_i[:n_sub], 32, moe._group_block_m(rows, 32))
            xsub = x.new_zeros((gs.m_pad, k))
            xsub.index_copy_(0, gs.dst, x[:n_sub].index_select(0, gs.tok))
            ys = grouped(xsub, gs.tile_expert, st, a, b, block_m=gs.block_m)
            assert torch.equal(ys[gs.dst[gs.inv]], yd[:rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernels_pad_rows_and_planted_faults(cuda, dtype):
    """Decode pad rows (-1, and rows past the map) come out exactly zero
    with NaN in their x rows; grouped pad and slack rows exactly zero from
    zero x, and NaN there changes no real row.  In bf16 the limit rejects
    u left unrounded, a tile reading its neighbour expert's weights and
    (N:M) values read at the inclusive popcount."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    stacks, a, b = _expert_stacks(cuda, gen, dtype, 32, 512, 512, 128)
    x = (torch.randn((8, 512), generator=gen, device=cuda) / 4).to(dtype)
    _, g, xs, xd, row_e = _expert_rows(gen, cuda, x, 32, 8)
    pad = torch.ones(xs.shape[0], dtype=torch.bool, device=cuda)
    pad[g.dst] = False
    for kind, st in stacks.items():
        grouped = getattr(ops, f"grouped_{kind}_matmul")
        decode = getattr(ops, f"decode_{kind}_matmul")
        yd = decode(xd, row_e, st, a, b)
        junk_rows = torch.full((8, 512), float("nan"), dtype=dtype, device=cuda)
        row_e_pad = torch.cat([row_e[:-1], torch.tensor([-1], dtype=torch.int32, device=cuda)])
        xj = torch.cat([xd, junk_rows])
        xj[row_e.shape[0] - 1] = float("nan")
        yj = decode(xj, row_e_pad, st, a, b)
        assert not yj[row_e.shape[0] - 1:].any()
        assert torch.equal(yj[:row_e.shape[0] - 1], yd[:-1])
        yg = grouped(xs, g.tile_expert, st, a, b, block_m=g.block_m)
        assert not yg[pad].any()
        junk = xs.clone()
        junk[pad] = float("nan")
        assert torch.equal(grouped(junk, g.tile_expert, st, a, b, block_m=g.block_m)[~pad],
                           yg[~pad])
        if dtype == torch.bfloat16:
            plain = getattr(ref, f"grouped_{kind}_spmm_ref")
            y_ref = plain(xs, g.tile_expert, st, a, b, g.block_m)
            assert _close(yg, y_ref, dtype)
            assert not _close(plain(xs, g.tile_expert, st, a, b.float(), g.block_m).to(dtype),
                              y_ref, dtype)
            moved = g.tile_expert.clone()
            moved[0] = (moved[0] + 1) % 32
            assert not _close(plain(xs, moved, st, a, b, g.block_m), y_ref, dtype)
            if kind == "nm":
                late = torch.stack([_nm_inclusive(st, e) for e in range(32)])
                assert not _close(ref.grouped_dense_spmm_ref(xs, g.tile_expert, late, a, b,
                                                             g.block_m), y_ref, dtype)


def _nm_inclusive(nmw, e: int) -> torch.Tensor:
    """Expert e of an N:M stack decoded with each set bit's value read at
    the inclusive popcount of its group byte (one slot late, clamped)."""
    bits = nmw.group_bits[e]
    shifts = torch.arange(nmw.m, dtype=torch.uint8, device=bits.device)
    set_ = ((bits[..., None] >> shifts) & 1).bool()
    slot = torch.cumsum(set_.long(), dim=-1).clamp(max=nmw.n - 1)
    vals = torch.gather(nmw.values[e].reshape(*bits.shape, nmw.n), -1, slot)
    return torch.where(set_, vals, 0).reshape(bits.shape[0], nmw.cols)


def test_route_tokens_rows_invariant_on_card(cuda):
    """A token's experts and weights are bitwise the same routed alone or
    among 4, 8, 33 or 1024 tokens (granite's router shape, E 32, top-8)."""
    cfg = configs.get("granite_moe_1b_a400m")
    gen = torch.Generator(device=cuda).manual_seed(3)
    router = torch.randn((1024, 32), generator=gen, device=cuda) / 32
    for dtype in (torch.float32, torch.bfloat16):
        tokens = torch.randn((1024, 1024), generator=gen, device=cuda).to(dtype)
        ti, w, _ = moe.route_tokens(router, tokens, cfg)
        for m in (1, 4, 8, 33, 1024):
            for start in {0, 1024 - m, 517 % (1025 - m)}:
                ts, ws, _ = moe.route_tokens(router, tokens[start:start + m], cfg)
                assert torch.equal(ts, ti[start:start + m]) and torch.equal(ws, w[start:start + m])


def test_expert_wrappers_launch_and_count(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    stacks, a, b = _expert_stacks(cuda, gen, torch.float32, 4, 64, 64, 8)
    x = torch.randn((16, 64), generator=gen, device=cuda)
    te = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    re_ = torch.tensor([0, 3, -1, 2] * 4, dtype=torch.int32, device=cuda)
    before = dict(ops.LAUNCHES)
    for kind, st in stacks.items():
        getattr(ops, f"grouped_{kind}_matmul")(x, te, st, a, b, block_m=8)
        getattr(ops, f"decode_{kind}_matmul")(x, re_, st, a, b)
        # a rank-0 stack: no adapter term
        y0 = getattr(ops, f"decode_{kind}_matmul")(x, re_, st, a[..., :0], b[:, :0])
        y0_ref = getattr(ref, f"decode_{kind}_spmm_ref")(x, re_, st, None, None)
        assert _close(y0, y0_ref, torch.float32)
    for kind in stacks:
        assert ops.LAUNCHES[f"grouped_{kind}_spmm"] == before[f"grouped_{kind}_spmm"] + 1
        assert ops.LAUNCHES[f"decode_{kind}_spmm"] == before[f"decode_{kind}_spmm"] + 2
    with pytest.raises(TypeError):
        ops.decode_salr_matmul(x.to(torch.bfloat16), re_, stacks["salr"], a, b)


def _mla_case(cuda, dtype, b: int, h: int, r: int, rd: int, seed: int):
    """Paged latent pools (page size 8) with a shuffled page table; entries
    past each slot's last live page point at the null page or a freed page;
    per-slot positions cycling through a few lengths up to 159."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ps, max_pages = 8, 20
    n_pages = b * max_pages + 2
    ckv = torch.randn((n_pages, ps, r), generator=gen, device=cuda).to(dtype)
    kr = torch.randn((n_pages, ps, rd), generator=gen, device=cuda).to(dtype)
    table = (torch.randperm(b * max_pages, generator=gen, device=cuda) + 1).reshape(
        b, max_pages).to(torch.int32)
    pos = torch.tensor(([159, 100, 37, 0, 7, 8, 63, 150] * 5)[:b], dtype=torch.int32,
                       device=cuda)
    for i in range(b):
        table[i, int(pos[i]) // ps + 1:] = 0 if i % 2 == 0 else n_pages - 1
    q_lat = torch.randn((b, h, r), generator=gen, device=cuda) / 4
    q_rope = torch.randn((b, h, rd), generator=gen, device=cuda) / 4
    return q_lat, q_rope, ckv, kr, table, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("h,r,rd,qk", [(4, 32, 16, 48), (128, 512, 64, 192)],
                         ids=["smoke", "published"])
def test_mla_kernel_matches_plain_and_skips_dead_data(cuda, h, r, rd, qk, b, dtype):
    """The kernel computes in f32 on bf16 or f32 pools, so the f32 limit
    holds for both; NaN in the null page, a freed page and past each
    slot's position in its last page leaves the output bitwise equal."""
    q_lat, q_rope, ckv, kr, table, pos = _mla_case(cuda, dtype, b, h, r, rd, seed=b + h)
    before = ops.LAUNCHES["paged_mla_attention"]
    y = ops.paged_mla_attention(q_lat, q_rope, ckv, kr, table, pos, qk_dim=qk)
    assert ops.LAUNCHES["paged_mla_attention"] == before + 1
    assert y.shape == (b, h, r) and y.dtype == torch.float32
    assert _close(y, ref.paged_mla_attention_ref(q_lat, q_rope, ckv, kr, table, pos, qk),
                  torch.float32)
    ps = ckv.shape[1]
    live = torch.zeros(ckv.shape[:2], dtype=torch.bool, device=cuda)
    for i in range(b):
        p = torch.arange(int(pos[i]) + 1, device=cuda)
        live[table[i, p // ps].long(), p % ps] = True
    ckv[~live] = float("nan")
    kr[~live] = float("nan")
    torch.testing.assert_close(
        ops.paged_mla_attention(q_lat, q_rope, ckv, kr, table, pos, qk_dim=qk), y,
        rtol=0, atol=0)


def test_mla_wrapper_refuses_shapes_the_kernel_does_not_take(cuda):
    q_lat, q_rope, ckv, kr, table, pos = _mla_case(cuda, torch.float32, 2, 12, 48, 16, 0)
    with pytest.raises(ValueError, match="kernel takes"):
        ops.paged_mla_attention(q_lat, q_rope, ckv, kr, table, pos, qk_dim=64)
    with pytest.raises(TypeError, match="float32"):
        ops.paged_mla_attention(q_lat.bfloat16(), q_rope, ckv, kr, table, pos, qk_dim=64)


@pytest.mark.parametrize("shape", [(7168, 2048), (32, 1024, 512)], ids=["deepseek_expert",
                                                                         "granite_stack"])
def test_gesvda_adapter_matches_the_default_driver(cuda, shape):
    """At one deepseek_v3_671b expert (7168 x 2048) and at granite's gate
    stack (32 x 1024 x 512) the residual adapter's product A.B under the
    package's driver (``residual.CUDA_SVD_DRIVER``, gesvda) against
    PyTorch's default one (gesvdj): within 1e-2 rel-L2 (the residual's
    singular values crowd around rank 64, so even the exact drivers gesvd
    and gesvdj differ by 4.4e-3 to 6.6e-3 at deepseek's shapes), and the
    same share of the residual captured to 1e-4."""
    from repro_torch.core import residual, salr

    gen = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(shape, generator=gen, device=cuda) / shape[-2] ** 0.5).bfloat16()
    _, e = salr._tiled_encode(w.reshape(-1, shape[-1]), salr.SALRConfig(dtype="bfloat16"))
    e = e.reshape(shape)
    assert residual.CUDA_SVD_DRIVER == "gesvda"
    products = []
    for driver in ("gesvdj", None):
        ad = residual.truncated_svd_adapter(e, 64, dtype=torch.float32, driver=driver)
        products.append(ad.a @ ad.b)
    default, package = products
    assert (package - default).norm() <= 1e-2 * default.norm()
    e = e.float()
    captured = [1 - (e - p).norm() / e.norm() for p in (default, package)]
    assert abs(captured[0] - captured[1]) <= 1e-4
