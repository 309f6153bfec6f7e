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

from repro_torch.core import bitmap as tbm
from repro_torch.core import prune
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,nm", [(576, 576, (2, 4)), (100, 200, (2, 4)), (64, 136, (1, 4)),
                                    (48, 128, (4, 8))])
def test_nm_kernel_matches_plain_and_rows_are_independent(cuda, k, n, nm, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    w = (torch.randn((k, n), generator=gen, device=cuda) / 10).to(dtype)
    nmw, _ = tbm.nm_encode(w, *nm)
    for m in _ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        y = ops.nm_matmul(x, nmw)
        assert _close(y, ref.nm_spmm_ref(x, nmw), dtype)
        _rows_independent(lambda xs: ops.nm_matmul(xs, nmw), x, y)


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
    for m in _ROWS:
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        y = ops.nf4_matmul(x, codes, scales)
        y_ref = ref.nf4_spmm_ref(x, codes, scales)
        assert _close(y, y_ref, dtype)
        assert not y[:, n:].any()                 # padded columns quantize to zeros
        _rows_independent(lambda xs: ops.nf4_matmul(xs, codes, scales), x, y)
        if dtype == torch.bfloat16 and m == 100:
            # the limit rejects the dequantized weight left unrounded
            from repro_torch.core.quant import nf4_dequant_2d
            unrounded = (x.float() @ nf4_dequant_2d(codes, scales)).to(dtype)
            assert not _close(unrounded, y_ref, dtype)


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
