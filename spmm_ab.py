#!/usr/bin/env python3
"""Device time per call of the SpMM kernels of one checkout, for A/B runs.

    python3 spmm_ab.py TREE LABEL

Imports ``repro_torch`` and ``chip_smoke.Timer`` from the checkout at
TREE (building its kernels there), times ``salr_spmm``, ``qsalr_spmm``
and ``bitmap_spmm`` in bf16 at smollm_135m's four projection shapes at
M = 4 and 8 (profiler device time, L2 flushed, median of 3 traces), and
prints one JSON line tagged LABEL.  To compare two versions, unpack each
into its own directory (``git archive``) and alternate their runs, one
process each, on one GPU in one session.
"""
import json
import math
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
build.build_all()
timer = cs.Timer(torch)
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
print(json.dumps({"tree": sys.argv[2], **out}))
