"""The port's kernel wrappers (``repro_torch.kernels.ops``).

On the CPU each wrapper runs its plain PyTorch version; those are held
to the reference's wrappers (``repro.kernels.ops``, Pallas in interpret
mode) on identical numpy inputs within ``method:*``.  The CUDA kernels
themselves are held to the plain versions in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpaged
from repro_torch.bridge import to_tensor
from repro_torch.core import bitmap as tbm
from repro_torch.core.quant import ERROR_BUDGETS
from repro_torch.kernels import ops

BUDGET = ERROR_BUDGETS["method:bitmap"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _encoded(k, n, tile, seed):
    """The reference's tiled encoding of a pruned random (k, n) weight and
    the same encoding carried over to the port."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jt, _ = jbm.tile_encode_from_dense(jnp.asarray(w), 0.5, tile=tile)
    tt = tbm.TiledBitmapWeight(words=to_tensor(np.asarray(jt.words), "cpu"),
                               values=to_tensor(np.asarray(jt.values), "cpu"),
                               cols=jt.cols, tile=jt.tile, cap_t=jt.cap_t)
    return jt, tt, rng


@pytest.mark.parametrize("tile", [32, 96, 192])
@pytest.mark.parametrize("m", [1, 7, 13])
def test_plain_spmm_matches_reference(m, tile):
    k, n, r = 96, 2 * tile, 8
    jt, tt, rng = _encoded(k, n, tile, m * 1000 + tile)
    x = (rng.standard_normal((m, k)) / 4).astype(np.float32)
    a = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((r, n - 5)) / np.sqrt(r)).astype(np.float32)  # padded by the op
    y = ops.salr_matmul(torch.from_numpy(x), tt, torch.from_numpy(a), torch.from_numpy(b))
    yj = jops.salr_matmul(jnp.asarray(x), jt, jnp.asarray(a), jnp.asarray(b))
    assert y.shape == (m, n)
    assert _rel(y.numpy(), yj) <= BUDGET
    y0 = ops.bitmap_matmul(torch.from_numpy(x), tt)
    assert _rel(y0.numpy(), jops.bitmap_matmul(jnp.asarray(x), jt)) <= BUDGET


def test_wrappers_flatten_leading_dims():
    jt, tt, rng = _encoded(64, 96, 96, 5)
    x = torch.from_numpy((rng.standard_normal((2, 3, 64)) / 4).astype(np.float32))
    a, b = torch.randn(64, 8), torch.randn(8, 96)
    y = ops.salr_matmul(x, tt, a, b)
    assert y.shape == (2, 3, 96)
    torch.testing.assert_close(y.reshape(6, 96), ops.salr_matmul(x.reshape(6, 64), tt, a, b))


def test_wrappers_are_forward_only_and_checked():
    jt, tt, _ = _encoded(64, 96, 96, 6)
    x = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.bitmap_matmul(x, tt)
    with torch.no_grad():
        assert ops.bitmap_matmul(x, tt).shape == (4, 96)
        with pytest.raises(ValueError, match="K=32"):
            ops.bitmap_matmul(torch.randn(4, 32), tt)
        with pytest.raises(ValueError, match="adapter shapes"):
            ops.salr_matmul(torch.randn(4, 64), tt, torch.randn(64, 0), torch.randn(0, 96))


def _paged_case(seed, b=3, h=6, kh=2, d=32, ps=4, max_pages=5):
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    kp = rng.standard_normal((n_pages, ps, kh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, kh, d)).astype(np.float32)
    table = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    pos = np.array([max_pages * ps - 1, 6, 0][:b], np.int32)
    for i in range(b):
        table[i, pos[i] // ps + 1:] = 0          # dead entries -> null page
    kp[0] = 1e3 * rng.standard_normal(kp[0].shape)   # junk in the null page
    vp[0] = 1e3 * rng.standard_normal(vp[0].shape)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    return q, kp, vp, table, pos


def test_plain_paged_attention_matches_reference():
    q, kp, vp, table, pos = _paged_case(0)
    y = ops.paged_gqa_attention(*(torch.from_numpy(a) for a in (q, kp, vp, table, pos)))
    yj = jpaged.paged_gqa_attention(*(jnp.asarray(a) for a in (q, kp, vp, table, pos)),
                                    interpret=True)
    assert y.shape == q.shape
    assert _rel(y.numpy(), yj) <= BUDGET


def test_plain_paged_attention_ignores_dead_pages():
    q, kp, vp, table, pos = _paged_case(1)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    clean = ops.paged_gqa_attention(*args)
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    dirty = ops.paged_gqa_attention(*args)
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)
