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
