"""The port's N:M, masked-dense and dense SALR methods against the
reference: the N:M mask and encoding and the NF4 2-D weight layout bit
for bit (ties and padding included), ``compress_linear`` for each method
and orientation, the ``QDenseWeight`` twin, the plain versions of
``nm_spmm``, ``fused_lora`` and ``nf4_spmm`` within ``method:*`` of the
reference's kernels (Pallas in interpret mode), and the bridge's flat
bases.  The model and engine under the two serving plans are in
``test_torch_methods_model.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import prune as jprune
from repro.core import quant as jquant
from repro.core import salr as jsalr
from repro.kernels import ops as jops
from repro_torch import configs as tconfigs
from repro_torch.bridge import _linear, to_tensor
from repro_torch.core import bitmap as tbm
from repro_torch.core import prune as tprune
from repro_torch.core import quant as tquant
from repro_torch.core import salr as tsalr
from repro_torch.kernels import ops

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
BUDGET = tquant.ERROR_BUDGETS["method:nm"]        # = method:mask = method:dense
# the residual adapter's factors: the SVD runs in f32 on each side (LAPACKs
# that differ in the last bits); bf16 factors then round apart, so the
# budget in bf16 is bf16's, as tests/test_torch_bitmap.py holds it
RES_TOL = {"float32": BUDGET, "bfloat16": 2e-2}
# two bf16 outputs summed in f32 in other orders and rounded once: a few
# outputs round the other way (the port's kernel-vs-plain limit)
OUT_TOL = {"float32": BUDGET, "bfloat16": 5e-4}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _tied(shape, seed: int) -> np.ndarray:
    """Weights from a few levels of both signs and zeros: most N:M groups
    hold ties in magnitude."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, shape) / 4).astype(np.float32)


def _equal(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32 if t.is_floating_point()
                                                     else None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (4, 8)])
@pytest.mark.parametrize("tied", [False, True], ids=["gauss", "ties"])
def test_nm_mask_encode_decode_bit_exact(nm, dtype, tied):
    n, m = nm
    w = (_tied((24, 64), n * m) if tied else
         np.random.default_rng(n + m).standard_normal((24, 64)).astype(np.float32))
    wj = jnp.asarray(w).astype(DTYPES[dtype])
    wt = _t(wj)
    np.testing.assert_array_equal(tprune.nm_mask(wt, n, m).numpy(),
                                  np.asarray(jprune.nm_mask(wj, n, m)))
    jw, je = jbm.nm_encode(wj, n=n, m=m)
    tw, te = tbm.nm_encode(wt, n=n, m=m)
    assert (tw.cols, tw.n, tw.m) == (jw.cols, jw.n, jw.m)
    assert tw.group_bits.dtype == torch.uint8 and tw.values.dtype == wt.dtype
    np.testing.assert_array_equal(tw.group_bits.numpy(), np.asarray(jw.group_bits))
    _equal(tw.values, jw.values)
    _equal(te, je)
    _equal(tbm.nm_decode(tw), jbm.nm_decode(jw))
    # the encoding is exact: W_hat + E == W
    assert torch.equal(tbm.nm_decode(tw) + te, wt)


@pytest.mark.parametrize("shape,block", [((16, 128), 64), ((7, 9), 64), ((3, 64), 16)])
def test_quantize_nf4_and_2d_layout_bit_exact(shape, block):
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32)
    x[0, :5] = 0.0                                  # an all-small block start
    jq, tq = jquant.quantize_nf4(jnp.asarray(x), block=block), tquant.quantize_nf4(
        torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert (tq.shape, tq.block) == (jq.shape, jq.block)
    for dt in ("float32", "bfloat16"):
        _equal(tquant.dequantize_nf4(tq, getattr(torch, dt)),
               jquant.dequantize_nf4(jq, jnp.dtype(DTYPES[dt])))
    if shape[1] % tquant.QBLOCK == 0:
        jc, js = jops.nf4_encode_2d(jnp.asarray(x))
        tc, ts = ops.nf4_encode_2d(torch.from_numpy(x))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        with pytest.raises(ValueError, match="multiple"):
            ops.nf4_encode_2d(torch.from_numpy(x))


def _layers(method: str, k: int, n: int, transposed: bool, dtype: str, seed: int,
            dual: bool = False):
    """The reference's and the port's compress_linear of one random (k, n)
    weight."""
    w = (np.random.default_rng(seed).standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    kw = dict(method=method, lora_rank=4, res_rank=4, dtype=dtype, dual_repr=dual)
    jl = jsalr.compress_linear(jax.random.PRNGKey(seed), jnp.asarray(w),
                               jsalr.SALRConfig(**kw), transposed=transposed)
    tl = tsalr.compress_linear(torch.Generator().manual_seed(seed), torch.from_numpy(w),
                               tsalr.SALRConfig(**kw), transposed=transposed)
    return jl, tl


def _res_delta(layer) -> np.ndarray:
    """A_res @ B_res in f32 (the SVD factors' signs are free)."""
    return (layer.res.a.float() @ layer.res.b.float()).numpy() if isinstance(
        layer.res.a, torch.Tensor) else np.asarray(
        layer.res.a.astype(jnp.float32) @ layer.res.b.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["stored", "transposed"])
def test_compress_linear_nm_matches_reference(transposed, dtype):
    """Untransposed: an NMWeight.  Transposed: the N:M mask along d_in,
    re-encoded as a tiled bitmap (kernel-ready storage)."""
    jl, tl = _layers("nm", 96, 160, transposed, dtype, seed=3 + transposed)
    assert tl.transposed is jl.transposed is False
    assert (tl.d_in, tl.d_out) == (jl.d_in, jl.d_out)
    if transposed:
        assert isinstance(tl.base, tbm.TiledBitmapWeight)
        assert (tl.base.cols, tl.base.tile, tl.base.cap_t) == (
            jl.base.cols, jl.base.tile, jl.base.cap_t)
        np.testing.assert_array_equal(tl.base.words.numpy(),
                                      np.asarray(jl.base.words).view(np.int32))
    else:
        assert isinstance(tl.base, tbm.NMWeight)
        np.testing.assert_array_equal(tl.base.group_bits.numpy(),
                                      np.asarray(jl.base.group_bits))
    _equal(tl.base.values, jl.base.values)
    _equal(tsalr.materialize_base(tl.base), jsalr.materialize_base(jl.base))
    assert _rel(_res_delta(tl), _res_delta(jl)) <= RES_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["stored", "transposed"])
@pytest.mark.parametrize("method", ["mask", "dense"])
def test_compress_linear_flat_bases_match_reference(method, transposed, dtype):
    """A flat base is stored as the reference stores it (W^T for a
    transposed layer), bit for bit; the mask's residual adapter agrees."""
    jl, tl = _layers(method, 96, 64, transposed, dtype, seed=5 + transposed)
    assert tl.transposed is jl.transposed is transposed
    assert tuple(tl.base.shape) == tuple(jl.base.shape) == ((64, 96) if transposed
                                                            else (96, 64))
    _equal(tl.base, jl.base)
    if method == "dense":
        assert tl.res is None and jl.res is None
    else:
        assert _rel(_res_delta(tl), _res_delta(jl)) <= RES_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [96, 128, 160])
def test_qdense_twin_bit_exact(n, dtype):
    """The NF4 twin of an untransposed masked base: codes and scales as
    the reference's, columns padded up to a QBLOCK multiple (96 -> 128);
    a transposed layer and an N:M layer get none."""
    jl, tl = _layers("mask", 64, n, False, dtype, seed=n, dual=True)
    tq, jq = tl.qbase, jl.qbase
    assert isinstance(tq, tsalr.QDenseWeight)
    assert tq.codes.shape == (64, -(-n // 64) * 32) and tq.scales.shape == (64, -(-n // 64))
    assert tuple(tq.shape) == tuple(jq.shape) and jq.block == tquant.QBLOCK
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    _equal(tsalr.materialize_base(tq), jsalr.materialize_base(jq))
    assert _layers("mask", 64, n, True, dtype, seed=n, dual=True)[1].qbase is None
    assert _layers("nm", 64, n, False, dtype, seed=n, dual=True)[1].qbase is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 7, 16])
def test_plain_kernels_match_reference(m, dtype):
    """ops.nm_matmul / lora_matmul / nf4_matmul (their plain versions on
    the CPU) within method:* of the reference's Pallas kernels."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(m)
    k, n, r = 64, 96, 24
    budget = OUT_TOL[dtype]
    x = jnp.asarray(rng.standard_normal((m, k)) / 4).astype(dt)
    w = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k)).astype(dt)
    a = jnp.asarray(rng.standard_normal((k, r)) / np.sqrt(k)).astype(dt)
    b = jnp.asarray(rng.standard_normal((r, n)) / np.sqrt(r)).astype(dt)
    jw, _ = jbm.nm_encode(w)
    tw = tbm.NMWeight(group_bits=_t(jw.group_bits), values=_t(jw.values), cols=n, n=2, m=4)
    xt = _t(x)
    assert _rel(_np(ops.nm_matmul(xt, tw)), np.asarray(jops.nm_matmul(x, jw), np.float32)) \
        <= budget
    assert _rel(_np(ops.lora_matmul(xt, _t(a), _t(b))),
                np.asarray(jops.lora_matmul(x, a, b), np.float32)) <= budget
    wp = jnp.pad(w.astype(jnp.float32), ((0, 0), (0, 32)))      # 96 -> 128 columns
    jc, js = jops.nf4_encode_2d(wp)
    y = ops.nf4_matmul(xt, _t(jc), _t(js))
    assert y.shape == (m, 128) and not y[:, n:].any()
    assert _rel(_np(y), np.asarray(jops.nf4_matmul(x, jc, js), np.float32)) <= budget


def test_plain_kernels_round_as_the_reference():
    """The roundings each plain version follows, on bf16: fused_lora's u
    is rounded to B's dtype, nf4_spmm's weight to x's dtype."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)).bfloat16()
    a = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)).bfloat16()
    u = (x.float() @ a.float()).bfloat16()
    assert torch.equal(ops.lora_matmul(x, a, b), (u.float() @ b.float()).bfloat16())
    codes, scales = ops.nf4_encode_2d(a.float().T.contiguous())
    w = tquant.nf4_dequant_2d(codes, scales).bfloat16()
    xs = x[:, :16]
    assert torch.equal(ops.nf4_matmul(xs, codes, scales), (xs.float() @ w.float()).bfloat16())


def test_new_wrapper_checks():
    nmw, _ = tbm.nm_encode(torch.randn(64, 96))
    codes, scales = ops.nf4_encode_2d(torch.randn(64, 128))
    x = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.nm_matmul(x, nmw)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.lora_matmul(x, torch.randn(64, 8), torch.randn(8, 96))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.nf4_matmul(x, codes, scales)
    with torch.no_grad():
        with pytest.raises(ValueError, match="K=32"):
            ops.nm_matmul(torch.randn(4, 32), nmw)
        with pytest.raises(TypeError, match="uint8"):
            ops.nm_matmul(torch.randn(4, 64), dataclasses.replace(
                nmw, group_bits=nmw.group_bits.to(torch.int32)))
        with pytest.raises(ValueError, match="R>0"):       # no rank-0 adapter
            ops.lora_matmul(torch.randn(4, 64), torch.zeros(64, 0), torch.zeros(0, 96))
        with pytest.raises(ValueError, match="codes"):
            ops.nf4_matmul(torch.randn(4, 64), codes, scales[:, :1])
        with pytest.raises(TypeError, match="float32"):
            ops.nf4_matmul(torch.randn(4, 64), codes, scales.double())
        assert ops.nm_matmul(torch.randn(2, 3, 64), nmw).shape == (2, 3, 96)
        assert ops.lora_matmul(torch.randn(2, 3, 64), torch.randn(64, 8),
                               torch.randn(8, 40)).shape == (2, 3, 40)
        assert ops.nf4_matmul(torch.randn(2, 3, 64), codes, scales).shape == (2, 3, 128)


def _carried_layer(jl, name: str, d_out: int):
    """One reference layer through the bridge, under ``name``."""
    key = f"['groups'][0][0]['mixer']['{name}']"
    flat = {key + jax.tree_util.keystr(p): np.asarray(leaf)[None]
            for p, leaf in jax.tree_util.tree_flatten_with_path(jl)[0]}
    return _linear(flat, key, 0, d_out, tconfigs.get("smollm_135m", smoke=True), "cpu",
                   name in ("wq", "wk", "wv", "gate", "up"))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("method,name,transposed", [
    ("mask", "wq", True), ("mask", "wo", False), ("dense", "wq", True),
    ("nm", "wo", False), ("nm", "down", False)])
def test_bridge_carries_flat_bases(method, name, transposed, backend):
    """A square wq masked base arrives as the W^T it stores (the shape
    cannot tell), an N:M base and a QDenseWeight twin as they were
    emitted; each carried layer computes what the reference's does."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((96, 96)) / np.sqrt(96)).astype(np.float32)
    jl = jsalr.compress_linear(jax.random.PRNGKey(2), jnp.asarray(w), jsalr.SALRConfig(
        method=method, lora_rank=4, res_rank=4, dual_repr=True), transposed=transposed)
    jl = dataclasses.replace(jl, lora=dataclasses.replace(
        jl.lora, b=jnp.asarray(rng.standard_normal(jl.lora.b.shape) / 8, jnp.float32)))
    tl = _carried_layer(jl, name, 96)
    assert tl.transposed is jl.transposed
    _equal(tsalr.materialize_base(tl.base), jsalr.materialize_base(jl.base))
    assert (tl.qbase is None) == (jl.qbase is None)
    x = (rng.standard_normal((5, 96)) / 4).astype(np.float32)
    for repr_ in ("native", "nf4"):
        y = tsalr.apply_salr(torch.from_numpy(x), tl, backend=backend, base_repr=repr_)
        yj = jsalr.apply_salr(jnp.asarray(x), jl, backend="reference", base_repr=repr_)
        assert _rel(y.numpy(), yj) <= BUDGET
    if transposed:      # read the other way round, the layer is wrong
        wrong = dataclasses.replace(tl, transposed=False)
        y = tsalr.apply_salr(torch.from_numpy(x), wrong, backend=backend)
        assert _rel(y.numpy(), jsalr.apply_salr(jnp.asarray(x), jl)) > 0.1


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_apply_salr_routes_by_base(backend, monkeypatch):
    """The kernel route runs nm_matmul + lora_matmul for an untransposed
    N:M layer and nf4_matmul + lora_matmul for its dense twin; a dense or
    transposed base takes the dense GEMM whatever the route."""
    calls = []
    for name in ("nm_matmul", "lora_matmul", "nf4_matmul", "salr_matmul", "qsalr_matmul"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    x = torch.randn(3, 96)
    _, nm = _layers("nm", 96, 64, False, "float32", seed=1)
    _, nmt = _layers("nm", 96, 64, True, "float32", seed=1)
    _, mask = _layers("mask", 96, 64, False, "float32", seed=1, dual=True)
    _, maskt = _layers("mask", 96, 64, True, "float32", seed=1, dual=True)
    for layer, repr_, want in ((nm, "native", ["nm_matmul", "lora_matmul"]),
                               (nmt, "native", ["salr_matmul"]),
                               (mask, "native", []), (maskt, "nf4", []),
                               (mask, "nf4", ["nf4_matmul", "lora_matmul"])):
        calls.clear()
        y = tsalr.apply_salr(x, layer, backend=backend, base_repr=repr_)
        ref = tsalr._apply_reference(x, layer, base=layer.qbase if want[:1] == ["nf4_matmul"]
                                     else None)
        assert calls == (want if backend == "kernel" else [])
        assert _rel(y.numpy(), ref.numpy()) <= 1e-5
