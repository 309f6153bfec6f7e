"""The split plan of the bf16 ``nm_spmm`` and ``nf4_spmm`` kernels, on the
CPU: the slices cover [0, K) in order at every shape the GPU tests and
``chip_smoke.py`` give the kernels, and the plan the wrappers pass to the
kernel depends on (K, N) and the card alone, never on M (a row's bits at M
= 1 and M = 1024 rest on it).  The launch is intercepted; no kernel runs
here."""
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
