"""Time the compress step on the GPU at the shapes of four ported models
(smollm_135m, granite_moe_1b_a400m, deepseek_v3_671b, llama3_8b_proxy),
and its residual SVD under each cuSOLVER driver.

    PYTHONPATH=src python -m repro_torch.launch.compress_timing \\
        [--drivers gesvd,gesvda,gesvdj] [--shapes smollm_gate,...] [--out t.json]

Shapes (bitmap method, p = 0.5, LoRA 64 + residual 64, bf16): each
model's projections and expert stacks as ``init_params`` compresses them,
``stack`` shapes through ``compress_stack`` (deepseek_v3_671b's in its
chunks of 18 experts), the others through ``compress_linear``.  Per
shape: ``compress_s``, one whole compress under the package's driver
(``residual.CUDA_SVD_DRIVER``), then per driver ``svd_s``, the median of
three truncated SVDs of the magnitude-pruning residual, and the rank-64
adapter product A.B against the first driver's as rel-L2 (the drivers
compute the same thin SVD, so only rounding separates them).  Times are
host-clock seconds around work ending in a synchronize, each driver
warmed up first on a small matrix.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from repro_torch.core import prune, residual, salr
from repro_torch.device import resolve_device

# name: (experts or None, d_in, d_out, transposed)
SHAPES = {
    "smollm_q": (None, 576, 576, True), "smollm_gate": (None, 576, 1536, True),
    "smollm_down": (None, 1536, 576, False),
    "granite_q": (None, 1024, 1024, True), "granite_stack_gate": (32, 1024, 512, False),
    "granite_stack_down": (32, 512, 1024, False),
    "deepseek_stack_gate": (18, 7168, 2048, False), "deepseek_wo": (None, 16384, 7168, False),
    "deepseek_gate": (None, 7168, 18432, True),
    "llama_q": (None, 4096, 4096, True), "llama_kv": (None, 4096, 1024, True),
    "llama_gate": (None, 4096, 14336, True), "llama_down": (None, 14336, 4096, False),
}


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--drivers", default="gesvd,gesvda,gesvdj")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = salr.SALRConfig(dtype="bfloat16")
    drivers = args.drivers.split(",")
    for driver in drivers:
        residual.truncated_svd_adapter(torch.randn((64, 48), device=dev), 8, driver=driver)
    rows = []
    for shape in args.shapes.split(","):
        e, k, n, transposed = SHAPES[shape]
        gen = torch.Generator(dev).manual_seed(0)
        lead = () if e is None else (e,)
        w = torch.randn((*lead, k, n), generator=gen, device=dev) / math.sqrt(k)
        cgen = torch.Generator().manual_seed(1)
        compress_s, _ = _timed(
            (lambda: salr.compress_stack(cgen, w, cfg)) if e is not None else
            (lambda: salr.compress_linear(cgen, w, cfg, transposed=transposed)), dev)
        wd = w.bfloat16()
        res = prune.residual(wd, prune.magnitude_mask(wd, cfg.sparsity, batch_dims=len(lead)))
        row = {"shape": shape, "dims": [e, k, n], "compress_s": compress_s,
               "package_driver": residual.CUDA_SVD_DRIVER, "svd_s": {}, "rel_l2_vs_first": {}}
        first = None
        for driver in drivers:
            secs = []
            for _ in range(3):
                s, ad = _timed(lambda: residual.truncated_svd_adapter(
                    res, cfg.res_rank, dtype=torch.float32, driver=driver), dev)
                secs.append(s)
            ab = ad.a @ ad.b
            first = ab if first is None else first
            row["svd_s"][driver] = statistics.median(secs)
            row["rel_l2_vs_first"][driver] = ((ab - first).norm() / first.norm()).item()
            del ad, ab
        rows.append(row)
        print(json.dumps(row), flush=True)
        del w, wd, res, first
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
