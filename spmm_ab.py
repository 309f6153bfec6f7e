#!/usr/bin/env python3
"""Device time per call of the SpMM kernels of one checkout, for A/B runs.

    python3 spmm_ab.py TREE LABEL [--plan-sms N] [--dispatch rows|slices]

Imports ``repro_torch`` and ``chip_smoke.Timer`` from the checkout at
TREE (building its kernels there), times ``salr_spmm``, ``qsalr_spmm``
and ``bitmap_spmm`` in bf16 at smollm_135m's four projection shapes at
M = 4 and 8, ``nm_spmm`` and ``nf4_spmm`` at smollm_135m's wo and down
at M = 4, 8 and 256 to 1024 and ``nm_spmm`` at granite_moe_1b_a400m's
wo at M = 8 and 256 to 1024 (profiler device time, L2 flushed, median of
3 traces), and prints one JSON line tagged LABEL, with each ``nm_spmm``
/ ``nf4_spmm`` call's device time also split by the kernels it
launches.  ``--plan-sms N`` cuts K for the split-K kernels as on a card
of N SMs (``ops.splitk_plan``) instead of this card's count;
``--dispatch`` takes their rows or their slices dispatch at every M
instead of the one ``ops._splitk_args`` picks.  To compare two
versions, unpack each into its own directory (``git archive``) and
alternate their runs, one process each, back to back on one GPU.
"""
import json
import math
import re
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root), str(root / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import bitmap as bm  # noqa: E402
from repro_torch.core import salr  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

assert Path(ops.__file__).resolve().is_relative_to(root)
if "--plan-sms" in sys.argv:
    plan_sms = int(sys.argv[sys.argv.index("--plan-sms") + 1])
    ops._sm_count = lambda device: plan_sms
if "--dispatch" in sys.argv:
    walk_rows = sys.argv[sys.argv.index("--dispatch") + 1] == "rows"
    picked = ops._splitk_args

    def forced(x2, k, n):
        ws, slices, slice_k = picked(x2, k, n)
        if walk_rows:
            return None, slices, slice_k
        return (torch.empty((slices, x2.shape[0], n), dtype=torch.float32, device=x2.device),
                slices, slice_k)
    ops._splitk_args = forced
build.build_all()
timer = cs.Timer(torch)


def ms_by_kernel(fn) -> dict:
    """fn's device ms per call by kernel name (one trace, L2 flushed)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(timer.iters):
            timer.flush_buf.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    cs.device_us(torch, prof, by_name)
    return {(re.search(r"\w*_kernel\w*", k) or [k])[0]: us / timer.iters / 1e3
            for k, us in by_name.items() if timer.FLUSH not in k}


gen = torch.Generator(device="cuda").manual_seed(0)
out = {}
with torch.inference_mode():
    for lname, (k, n) in {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/up": (576, 1536),
                          "down": (1536, 576)}.items():
        w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
        tbw, _ = salr._tiled_encode(w, salr.SALRConfig(dtype="bfloat16"))
        q, _ = bm.tile_quantize_nf4(tbw)
        a = (torch.randn((k, 128), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
        b = ops._pad_bcat((torch.randn((128, n), generator=gen, device="cuda") / 12).bfloat16(),
                          tbw.cols)
        for m in (4, 8):
            x = (torch.randn((m, k), generator=gen, device="cuda") / 4).bfloat16()
            out[f"{lname} M={m}"] = {
                "salr": timer.ms(lambda: ops.salr_matmul(x, tbw, a, b)),
                "qsalr": timer.ms(lambda: ops.qsalr_matmul(x, q, a, b)),
                "bitmap": timer.ms(lambda: ops.bitmap_matmul(x, tbw))}
    # up to 1024 around the M where the row tiles x column tiles reach 132
    # (960 at N = 576, 576 at N = 1024)
    big = (256, 384, 512, 576, 640, 768, 896, 960, 1024)
    for lname, (k, n), kernels, rows in (("wo", (576, 576), ("nm", "nf4"), (4, 8, *big)),
                                         ("down", (1536, 576), ("nm", "nf4"), (4, 8, *big)),
                                         ("granite wo", (1024, 1024), ("nm",), (8, *big))):
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        nmw, _ = bm.nm_encode(w.bfloat16())
        codes, scales = ops.nf4_encode_2d(w)
        for m in rows:
            x = (torch.randn((m, k), generator=gen, device="cuda") / 4).bfloat16()
            fns = {"nm": lambda: ops.nm_matmul(x, nmw),
                   "nf4": lambda: ops.nf4_matmul(x, codes, scales)}
            out[f"{lname} M={m}"] = {kk: timer.ms(fns[kk]) for kk in kernels}
            for kk in kernels:
                out[f"{lname} M={m} {kk} by kernel"] = ms_by_kernel(fns[kk])
print(json.dumps({"tree": sys.argv[2], **out}))
