#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0] [--out details.json]

Phases (any failure exits non-zero before the result line):

1. Card and build: the card's name and power limit, then the nine CUDA
   sources of ``src/repro_torch/csrc`` (twenty kernels) built with nvcc,
   one process per source, in parallel.
2. Kernel vs plain version, in bf16 and in f32 with TF32 off, held to
   the plain PyTorch version: rel-L2 <= 5e-4 in bf16, <= 1e-5 in f32
   (both sum in f32 and round once, so only the f32 summation order
   differs; in bf16 that flips the rounding of a few outputs).
   ``salr_spmm`` and ``bitmap_spmm`` at every (K, N_pad, tile, cap_t)
   of smollm_135m's projections at the decode batch and at prefill
   size; the bf16 limit must reject a planted fault, ``u = x @ A_cat``
   left unrounded.  ``qsalr_spmm`` on the NF4 twin of the same
   projections at the main path's decode batches, M = 4 (the engine's
   slots) and 8 (greedy_generate's batch), and at M = 1024, which the
   main path never gives it (prefill is native), to hold its grid over
   many row blocks too; the bf16 limit must reject the NF4 values left
   unrounded (f32 into the product).  ``paged_gqa_attention``
   and the four quantized decode-attention kernels (ring and paged, int8
   and NF4) at 4 and 8 slots with 300 / 532 live positions: with NaN or
   junk in the null page and a freed page (data and scales), or past
   each ring row's position, the output must be finite and equal to the
   clean one.  ``paged_mla_attention`` at deepseek_v3_671b's published
   MLA widths (H 128, kv_lora_rank 512, rope 64, qk_dim 192), page size
   8, at 4 and 8 slots with 300 / 532 live positions, pools in bf16 and
   in f32, held to the f32 limit in both (it computes in f32 whatever
   the pool type); NaN in dead pages and past each slot's position must
   leave the output bitwise equal, and the limit must reject three
   planted faults (the rope score term dropped, the scale taken as
   sqrt(R + rd), the live range one position short).  ``nm_spmm``,
   ``fused_lora`` and ``nf4_spmm`` at the wo
   and down shapes (K = 576 / 1536, N = 576, R = 128) at M = 4, 8 and
   1024, ``nm_spmm`` at granite_moe_1b_a400m's wo (K = N = 1024) at M = 8
   and 1024, and ``nf4_spmm`` at the smoke width's padded shape (96
   columns -> 128); the bf16 limit must reject one planted fault each:
   values read at the inclusive popcount, u left unrounded, the
   dequantized weight left unrounded.  At down, ``nm_spmm``'s and
   ``nf4_spmm``'s rows computed at M = 1, 4, 8, 33 and 100 must equal
   the same rows at M = 1024 bit for bit (their split-K kernels' two
   dispatches, slices and rows), and two calls must give equal bits.  The eight expert-stack kernels, grouped and
   decode grid over a tiled bitmap (``grouped_salr_spmm``,
   ``decode_salr_spmm``), its NF4 twin (``*_qsalr_spmm``), a masked
   dense stack (``*_dense_spmm``) and a 2:4 stack (``*_nm_spmm``), at
   granite_moe_1b_a400m's gate/up and down stacks (E 32, top-8, R 128) at
   the rows the main path gives them (grouped: 64 and 8192 assignment
   rows; decode: 64 and 1024), the dense and 2:4 ones also with no
   adapter at 64 rows, with two planted faults each (u unrounded; a tile
   reading its neighbour expert's weights) and a third for 2:4 (values
   read at the inclusive popcount), grouped and decode bitwise equal per
   row, rows bitwise independent of the token count (1, 4, 8, 33, 128),
   decode pad rows exactly zero with NaN in their x rows.
   ``grouped_salr_spmm`` and ``decode_salr_spmm`` again at
   deepseek_v3_671b's expert stacks (E 256, top-8, gate/up 7168 -> 2048,
   down 2048 -> 7168, R 128) at 64 assignment rows, grouped and decode
   bitwise equal per row, and ``salr_spmm`` at its shared expert's
   projections at 8 rows.  Each is timed (profiler device time, L2
   flushed before every launch; CUDA events for a function whose every
   trace comes back empty) beside the plain version and, where one
   exists, one library call as a yardstick.
3. Main path: smollm_135m at full width, compressed once on the GPU from
   seeded dense weights with the NF4 twin (``dual_repr``); 8 requests
   (prompt 128 sharing a 64-token prefix, 32 new tokens) served by the
   batch engine (greedy_generate) and by the continuous engine (4 slots,
   paged KV), three times: the native plan (prefix sharing on, plus one
   rank-0 SALR layer through ``apply_salr``), then decode linears from
   the NF4 twin with decode KV in int8, then in NF4 (prefill native).
   Every request must return 32 in-vocab tokens and engine tokens must
   equal greedy tokens up to near-ties (``serve.parity_report``: a top-2
   logit gap, or in an MoE model the router's k-th and (k+1)-th experts,
   within the route noise at the diverging step); under the quantized
   plans every
   first token must equal the native run's and prefix sharing must be
   off.  Native prefill logits of the kernel route must lie within
   ``ROUTE_TOL`` of the reference route's, and each planted fault (a
   projection family's adapter term dropped) beyond it.  Under each
   quantized plan, the decode logits of greedy's steps (replayed) on the
   kernel route must lie within ``QROUTE_TOL`` of the reference route's
   (the dequantized twin, the plain quantized attention), and planted
   wiring faults beyond it (two layers' twins swapped; under int8 KV
   also ``down`` served from its native base).  Then the model
   compressed anew under two more SALR methods, served the same way:
   (A) ``method="nm"`` (2:4) at ``NM_LAYERS`` = 10 of its 30 layers,
   whose prefill logits of the kernel route must lie within
   ``ROUTE_TOL`` of the reference route and wo/down's adapter term
   dropped beyond it; (B) ``method="mask"`` with
   ``decode_repr="nf4"``, whose replayed decode logits must lie within
   ``TWIN_ROUTE_TOL`` of the reference route and ``down`` served from
   its native base beyond it.  Then granite_moe_1b_a400m at full width
   (24 layers, 32 experts, top-8), compressed once with the NF4 twin of
   every projection and expert stack, the same 8 requests served by
   greedy_generate (its own plan: the grouped expert kernels) and by the
   continuous engine at 8 slots (its plan from the slots and its largest
   bucket: the decode-grid kernels), under the native plan (prefill
   logits within ``ROUTE_TOL`` of the reference route, the dense masked
   experts) and under the NF4 twin with int8 decode KV (replayed decode
   logits within ``QROUTE_TOL``), each with two planted faults beyond the
   limit (the down experts' adapter term dropped; one layer routing to
   top_i + 1); then granite compressed anew under (C) ``method="nm"``
   (2:4 expert stacks: ``grouped_nm_spmm`` / ``decode_nm_spmm``) and (D)
   ``method="mask"`` (masked dense expert stacks: ``grouped_dense_spmm``
   / ``decode_dense_spmm``), each under the native plan, served and held
   the same way (prefill logits within ``ROUTE_TOL`` of the reference
   route, the same two planted faults beyond it).  Then (E)
   deepseek_v3_671b at its published widths (d_model 7168, 128 heads,
   MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128, d_ff
   18432, 256 experts top-8 + 1 shared of moe_d_ff 2048, vocab 129280,
   bf16, p = 0.5, R = 128) cut to ``DEEPSEEK_LAYERS`` = 2 of its 61
   layers (the first of each LayerGroup: a dense MLA + SwiGLU layer and
   an MLA + MoE layer; 6.7e11 weights fit no card), compressed on the
   GPU (the expert stacks drawn and compressed 18 experts at a time,
   every SVD through cuSOLVER's gesvda), served by greedy_generate (a
   dense slot latent cache: MLA's plain attention; grouped experts) and
   the engine at 8 slots (paged latent pools with prefix sharing:
   ``paged_mla_attention``; decode-grid experts), tokens and parity as
   above, prefill logits within ``ROUTE_TOL`` of the reference route and
   wo's adapter term dropped beyond it.
4. Launch counts, set to 0 before each of the ten runs and read after
   it: the native run 210 ``salr_spmm`` per forward (7 projections x 30
   layers); a quantized run 210 ``qsalr_spmm`` and 30 quantized
   attention launches per decode step and ``salr_spmm`` at prefill
   only; (A) 50 ``salr_spmm``, 20 ``nm_spmm`` and 20 ``fused_lora``
   per forward (10 layers); (B) 60 ``nf4_spmm`` and 60 ``fused_lora`` per decode
   step and no linear kernel at prefill; granite 96 ``salr_spmm`` and
   72 expert-stack launches per forward (grouped in greedy_generate,
   decode grid in the engine), 24 decode attention launches per step,
   the twin's ``qsalr_spmm`` / ``*_qsalr_spmm`` at its decode; (C) 72
   ``salr_spmm`` (wq/wk/wv), 24 ``nm_spmm`` and 24 ``fused_lora`` (wo)
   per forward, 72 ``grouped_nm_spmm`` per greedy forward or 72
   ``decode_nm_spmm`` per engine prefill or tick; (D) no attention
   linear kernel and 72 ``grouped_dense_spmm`` / ``decode_dense_spmm``;
   both 24 ``paged_gqa_attention`` per engine tick; (E) per layer and
   forward ``salr_spmm`` for dq, uq, dkv and wo, for uk and uv too at
   prefill (twice over a shared prefix) but not at decode (absorbed),
   and for the dense MLP or the shared expert; 3
   ``grouped_salr_spmm`` per greedy forward and 3 ``decode_salr_spmm``
   per engine prefill or tick for the MoE layer; one
   ``paged_mla_attention`` per layer and engine tick, no
   ``paged_gqa_attention``; every kernel launched at least once.

The last lines are the card (nvidia-smi), a JSON object describing each
kernel (its launches summed over the ten main-path runs, its times at
one decode-size call), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12                       # HBM3, SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, tensor core / CUDA core
# kernel vs plain version, rel-L2: both sum in f32 and round once, so
# only the summation order differs (bf16: a few outputs round the other
# way; sound readings <= 1.2e-4 over seeds 0-2, an unrounded u reads
# 1.9e-3 to 2.3e-3)
TOL = {"bfloat16": 5e-4, "float32": 1e-5}
# paged_mla_attention computes in f32 on bf16 and f32 pools alike, so it
# is held to the f32 limit in both: sound readings 5.0e-8 to 7.6e-8 over
# seeds 0-2, planted faults (the rope score term dropped, the scale taken
# as sqrt(R + rd), the live range one position short) 2.97e-2 to 1.81e-1
# kernel route vs reference route, prefill logits at full width (bf16
# rounding at other places through 30 layers): sound readings 1.9e-2 to
# 2.4e-2 over seeds 0-2, a projection shape's adapter term dropped reads
# 0.23 to 0.71; under method="nm" sound 2.0e-2 to 2.2e-2, wo/down's
# adapter term dropped 0.70 to 0.78; granite_moe_1b_a400m (24 layers of
# top-8 experts) sound 2.2e-2 to 4.1e-2, the down experts' adapter term
# dropped 0.10 to 0.11, one layer routing to top_i + 1 0.37 to 0.46.  A
# guard against gross divergence only: subtle faults (an unrounded u)
# are phase 2's to catch
ROUTE_TOL = 7e-2
# the same under a mixed-precision plan, per decode KV precision, on the
# decode logits of 16 replayed greedy steps of 4 requests: kernel route
# (qsalr_spmm, the quantized ring attention kernel) vs reference route
# (the dequantized NF4 twin, the plain quantized attention).  Sound
# readings over seeds 0-2: int8 2.1e-2 to 2.3e-2, NF4 3.9e-2 to 5.1e-2
# (a rounding difference that moves a K/V entry across an NF4 decision
# boundary moves it by a whole level).  Planted faults: two layers' twins
# swapped 0.60 to 0.68 (checked under both); down served from its native
# base 8.8e-2 to 1.1e-1 (checked under int8, too close to NF4's sound
# readings there); wk/wv from their native base 3.8e-2 to 8.8e-2
# (reported only).  granite_moe_1b_a400m under its twin with int8 KV:
# sound 2.7e-2 to 3.1e-2; the down experts' adapter term dropped 0.10 to
# 0.11, one layer routing to top_i + 1 0.37 to 0.45
QROUTE_TOL = {"int8": 5e-2, "nf4": 1e-1}
# the same check for the masked-dense plan whose decode serves wo/down
# from their NF4 twins (nf4_spmm + fused_lora; native KV, so both routes
# read the same cache values).  Sound readings over seeds 0-2: 1.46e-2 to
# 1.53e-2; down served from its native base 8.4e-2 to 9.6e-2 (checked)
TWIN_ROUTE_TOL = 4e-2
QROUTE_STEPS = 16
R_CAT = 128                                      # LoRA 64 + residual 64
# the main path's requests: prompts sharing a 64-token prefix, new tokens
# per request, the continuous engine's slots
N_REQ, PROMPT_LEN, GEN_LEN, N_SLOTS = 8, 128, 32, 4
# the continuous engine's slots on granite_moe_1b_a400m: at 8 its decode
# tick runs the decode-grid expert kernels (the crossover's 8-256 band)
MOE_SLOTS = 8
# smollm_135m's depth under method="nm" (run (A)): its 30 layers cut to
# 10, so the whole smoke stays near 10 minutes on the H100 with granite's
# nm and mask runs beside it (full width; the kernels and their shapes
# per layer are those of the full model)
NM_LAYERS = 10
# deepseek_v3_671b's depth in run (E): the first layer of each LayerGroup
# (61 layers, 6.7e11 weights, fit no card); every width is the published one
DEEPSEEK_LAYERS = 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time per call: the summed durations of the GPU work one call
    launches, read from torch.profiler (CUPTI) traces of ``iters`` calls.
    The L2 cache is flushed before each call (the main path reads every
    weight cold: the model's compressed weights exceed the 50 MB L2) by a
    bitwise_not over 64 MB, whose kernels are left out of the sum.  A trace
    can miss device records, so each function is traced three times and
    the median is taken over the traces that hold the most records.  A
    trace can also come back with no device record at all: the function
    is then traced again, up to ``RETRIES`` times, and if every trace
    stays empty it is timed with CUDA events instead (``events_ms``), and
    the run says so on a line of its own."""

    FLUSH = "bitwise_not"
    RETRIES = 3
    by_events = 0                 # calls of ms(), over every Timer, timed by events

    def __init__(self, torch, iters: int = 20, traces: int = 3):
        self.torch = torch
        self.iters = iters
        self.traces = traces
        self.flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")

    def _trace(self, fn) -> tuple:
        """(device us of fn's work, fn's device records)."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(self.iters):
                self.flush_buf.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        counts: dict = {}
        device_us(torch, prof, by_name, counts)
        work = [k for k in by_name if self.FLUSH not in k]
        return sum(by_name[k] for k in work), sum(counts[k] for k in work)

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        self.torch.cuda.synchronize()
        traces = [self._trace(fn) for _ in range(self.traces)]
        for _ in range(self.RETRIES):
            if max(n for _, n in traces):
                break
            traces.append(self._trace(fn))
        most = max(n for _, n in traces)
        if most == 0:
            Timer.by_events += 1
            ms = self.events_ms(fn)
            code = getattr(fn, "__code__", None)
            where = f"line {code.co_firstlineno}" if code else repr(fn)
            print(f"timer: {len(traces)} profiler traces of the function at {where} held "
                  f"no device record; timed with CUDA events: {ms:.5f} ms")
            return ms
        full = sorted(us for us, n in traces if n == most)
        return full[len(full) // 2] / self.iters / 1e3

    def events_ms(self, fn) -> float:
        """Device time per call from a pair of CUDA events around each call,
        the L2 flush outside them, median over ``traces`` runs of ``iters``
        calls.  The span also holds the gaps between fn's kernels, so it
        reads at or above the profiler's sum of kernel durations."""
        torch = self.torch
        runs = []
        for _ in range(self.traces):
            pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                     for _ in range(self.iters)]
            for start, end in pairs:
                self.flush_buf.bitwise_not_()
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize()
            runs.append(sum(start.elapsed_time(end) for start, end in pairs) / self.iters)
        return sorted(runs)[len(runs) // 2]


def device_us(torch, prof, by_name: dict = None, counts: dict = None) -> float:
    """Summed duration (us) of the device activities in a profiler trace;
    ``by_name`` / ``counts`` collect their time / number per kernel name."""
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            if by_name is not None:
                by_name[e.name] = by_name.get(e.name, 0.0) + us
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return total


def _row_line(row: dict) -> str:
    shape = " ".join(f"{k}={row[k]}" for k in ("layer", "tokens", "M", "K", "N_pad", "tile",
                                                "cap_t", "E",
                                                "B", "H", "R", "live_positions") if k in row)
    fault = "".join(f" ({what}: {row[key]:.2e})"
                    for what, key in (("unrounded u", "unrounded_u_rel_l2"),
                                      ("unrounded values", "unrounded_values_rel_l2"),
                                      ("unrounded weight", "unrounded_weight_rel_l2"),
                                      ("inclusive popcount", "inclusive_popcount_rel_l2"),
                                      ("neighbour expert", "neighbour_expert_rel_l2"),
                                      ("no adapter, vs its plain version", "no_adapter_rel_l2"))
                    if key in row)
    times = " ".join(f"{k} {row[k]:.5f}" for k in ("ms", "plain_ms", "library_ms",
                                                     "bound_ms") if k in row)
    return (f"phase 2: {row['kernel']} {row['dtype']} {shape}: rel-L2 {row['rel_l2']:.2e}"
            f"{fault} max-abs {row['max_abs_err']:.2e} {times}")


def rel_l2(torch, y, ref) -> float:
    d = (y.float() - ref.float()).norm().item()
    return d / max(ref.float().norm().item(), 1e-30)


def _bound(nbytes: float, flops: float, dtype_name: str) -> tuple:
    """(least ms, what binds it) for ``nbytes`` moved and ``flops`` done."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def spmm_checks(torch, timer, gen, rows: list) -> dict:
    """salr_spmm / bitmap_spmm vs their plain versions at the main path's
    projection shapes.  Returns per-kernel summaries."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import salr
    from repro_torch.kernels import ops, ref

    shapes = {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/up": (576, 1536),
              "down": (1536, 576)}
    summary = {"salr_spmm": {"max_abs_err": 0.0}, "bitmap_spmm": {"max_abs_err": 0.0}}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for lname, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
            tbw, _ = salr._tiled_encode(w.to(dt), salr.SALRConfig(dtype=dtype_name))
            a = (torch.randn((k, R_CAT), generator=gen, device="cuda") / math.sqrt(k)).to(dt)
            b = (torch.randn((R_CAT, n), generator=gen, device="cuda") / math.sqrt(R_CAT)).to(dt)
            b_pad = ops._pad_bcat(b, tbw.cols)
            nnz = int(bm.unpack_bits(tbw.words.reshape(-1, tbw.tile // 32), tbw.tile).sum())
            w_dense = salr.materialize_base(tbw)
            for m in (4, 8, 128, 1024):
                x = (torch.randn((m, k), generator=gen, device="cuda") / 4).to(dt)
                cases = {
                    "salr_spmm": (lambda: ops.salr_matmul(x, tbw, a, b_pad),
                                  lambda: ref.salr_spmm_ref(x, tbw, a, b_pad),
                                  lambda: x @ w_dense + (x @ a) @ b_pad, R_CAT),
                    "bitmap_spmm": (lambda: ops.bitmap_matmul(x, tbw),
                                    lambda: ref.bitmap_spmm_ref(x, tbw),
                                    lambda: x @ w_dense, 0),
                }
                for name, (kern, plain, lib, r) in cases.items():
                    y, y_ref = kern(), plain()
                    torch.cuda.synchronize()
                    err = rel_l2(torch, y, y_ref)
                    abs_err = (y.float() - y_ref.float()).abs().max().item()
                    if not (err <= TOL[dtype_name]) or not torch.isfinite(y).all():
                        fail(f"{name} {dtype_name} {lname} M={m}: rel-L2 {err:.3e} "
                             f"> {TOL[dtype_name]:.0e}")
                    s = summary[name]
                    s["max_abs_err"] = max(s["max_abs_err"], abs_err)
                    es = y.element_size()
                    # what the function needs: x, the words, the nnz stored
                    # values, A and B at the logical width n, y at width n
                    nbytes = (m * k * es + tbw.words.numel() * 4 + nnz * es
                              + (k * r + r * n) * es + m * n * es)
                    flops = 2 * m * nnz + 2 * m * k * r + 2 * m * r * n
                    bound, by = _bound(nbytes, flops, dtype_name)
                    row = {"kernel": name, "dtype": dtype_name, "layer": lname, "M": m,
                           "K": k, "N_pad": tbw.cols, "tile": tbw.tile, "cap_t": tbw.cap_t,
                           "rel_l2": err, "max_abs_err": abs_err, "bytes": nbytes,
                           "flops": flops, "bound_ms": bound, "bound_by": by}
                    if dtype_name == "bfloat16" and r:
                        # planted fault: the plain version with u unrounded
                        unrounded = (x.float() @ w_dense.float() + (x.float() @ a.float())
                                     @ b_pad.float()).to(dt)
                        fault = rel_l2(torch, unrounded, y_ref)
                        row["unrounded_u_rel_l2"] = fault
                        if not fault > TOL[dtype_name]:
                            fail(f"bf16 limit {TOL[dtype_name]:.0e} does not reject an "
                                 f"unrounded u at {lname} M={m} (rel-L2 {fault:.3e})")
                    if dtype_name == "bfloat16":
                        row.update(ms=timer.ms(kern), plain_ms=timer.ms(plain),
                                   library_ms=timer.ms(lib))
                        # the yardstick shape in the kernels line: one decode
                        # step of the widest projection
                        if lname == "gate/up" and m == 4:
                            s.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                             "bound_ms", "bound_by")})
                            s["shape"] = "bf16 M=4 K=576 N_pad=1536 tile=256 cap_t=160"
                    rows.append(row)
                    print(_row_line(row))
    return summary


def paged_checks(torch, timer, gen, rows: list) -> dict:
    """paged_gqa_attention vs its plain version at smollm_135m's decode
    shape, with NaN planted in the null page and a freed page."""
    from repro_torch.kernels import ops, ref

    h, kh, d, ps, max_pages = 9, 3, 64, 8, 20       # max_ctx 160
    summary = {"max_abs_err": 0.0}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for b in (4, 8):
            n_pages = b * max_pages + 2               # + null page + one freed page
            freed = n_pages - 1
            kp = torch.randn((n_pages, ps, kh, d), generator=gen, device="cuda").to(dt)
            vp = torch.randn((n_pages, ps, kh, d), generator=gen, device="cuda").to(dt)
            perm = torch.randperm(b * max_pages, generator=gen, device="cuda") + 1
            table = perm.reshape(b, max_pages).to(torch.int32)
            pos = torch.tensor([159, 100, 37, 0, 7, 8, 63, 150][:b], dtype=torch.int32,
                               device="cuda")
            # entries past each slot's last live page: the null page on even
            # slots, a freed page on odd ones
            for i in range(b):
                last = int(pos[i]) // ps
                table[i, last + 1:] = 0 if i % 2 == 0 else freed
            q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
            clean = ops.paged_gqa_attention(q, kp, vp, table, pos)
            plain = ref.paged_gqa_attention_ref(q, kp, vp, table, pos)
            live = torch.zeros(n_pages, dtype=torch.bool, device="cuda")
            live[table.long().flatten()] = True
            for i in range(b):
                live[table[i, int(pos[i]) // ps + 1:].long()] = False
            dead = ~live
            kp_nan, vp_nan = kp.clone(), vp.clone()
            kp_nan[dead] = float("nan")
            vp_nan[dead] = float("nan")
            y = ops.paged_gqa_attention(q, kp_nan, vp_nan, table, pos)
            plain_nan = ref.paged_gqa_attention_ref(q, kp_nan, vp_nan, table, pos)
            torch.cuda.synchronize()
            if not torch.isfinite(y).all() or not torch.equal(y, clean):
                fail(f"paged_gqa_attention {dtype_name} B={b}: dead-page NaN reached "
                     "the output")
            if not torch.isfinite(plain_nan).all():
                fail("plain paged attention let dead-page NaN through")
            err = rel_l2(torch, y, plain)
            abs_err = (y.float() - plain.float()).abs().max().item()
            if not (err <= TOL[dtype_name]):
                fail(f"paged_gqa_attention {dtype_name} B={b}: rel-L2 {err:.3e}")
            summary["max_abs_err"] = max(summary["max_abs_err"], abs_err)
            es = q.element_size()
            live_pos = int((pos.long() + 1).sum())
            live_pages = int((pos.long() // ps + 1).sum())
            nbytes = (2 * b * h * d * es + 2 * live_pos * kh * d * es
                      + live_pages * 4 + b * 4)
            flops = 4 * live_pos * h * d
            bound, by = _bound(nbytes, flops, dtype_name)
            row = {"kernel": "paged_gqa_attention", "dtype": dtype_name, "B": b, "H": h,
                   "KH": kh, "d": d, "page_size": ps, "max_pages": max_pages,
                   "live_positions": live_pos, "rel_l2": err, "max_abs_err": abs_err,
                   "bytes": nbytes, "flops": flops, "bound_ms": bound, "bound_by": by}
            if dtype_name == "bfloat16":
                w = max_pages * ps
                # the yardstick attends over pre-gathered, head-expanded K/V
                kg = kp[table.long()].reshape(b, w, kh, d).transpose(1, 2)
                vg = vp[table.long()].reshape(b, w, kh, d).transpose(1, 2)
                kg = kg.repeat_interleave(h // kh, dim=1).contiguous()
                vg = vg.repeat_interleave(h // kh, dim=1).contiguous()
                mask = (torch.arange(w, device="cuda")[None] <= pos[:, None])[:, None, None]
                qs = q.transpose(1, 2)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                row.update(
                    ms=timer.ms(lambda: ops.paged_gqa_attention(q, kp, vp, table, pos)),
                    plain_ms=timer.ms(lambda: ref.paged_gqa_attention_ref(q, kp, vp, table,
                                                                          pos)),
                    library_ms=timer.ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)))
                if b == 4:
                    summary.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")})
                    summary["shape"] = (f"bf16 B=4 H=9 KH=3 d=64 page_size=8 "
                                        f"live positions {live_pos}")
            rows.append(row)
            print(_row_line(row))
    return summary


# deepseek_v3_671b's published MLA widths: heads, kv_lora_rank (the latent),
# rope width, nope + rope query width
MLA_H, MLA_R, MLA_RD, MLA_QK = 128, 512, 64, 192


def _mla_faults(torch, ref, args, qk: int, pos) -> dict:
    """The plain version under the planted faults the limit must reject."""
    ql, qr, ckv, kr, table = args
    return {"rope score term dropped": ref.paged_mla_attention_ref(
                ql, torch.zeros_like(qr), ckv, kr, table, pos, qk),
            "scale sqrt(R + rd)": ref.paged_mla_attention_ref(
                ql, qr, ckv, kr, table, pos, MLA_R + MLA_RD),
            "live range one short": ref.paged_mla_attention_ref(
                ql, qr, ckv, kr, table, (pos - 1).clamp(min=0), qk)}


def mla_checks(torch, timer, gen, rows: list) -> dict:
    """paged_mla_attention vs its plain version at deepseek_v3_671b's
    published MLA widths (H 128, R 512, rope 64, qk_dim 192), the engine's
    page size (8), at 4 and 8 slots with 300 / 532 live positions, pools in
    bf16 and in f32 (the arithmetic is f32 either way: the f32 limit holds
    for both).  NaN in the null page, a freed page and past each slot's
    position inside its last page must leave the output bitwise equal; the
    limit must reject three planted faults (the rope score term dropped,
    the scale taken as sqrt(R + rd), the live range one position short).
    Timed beside the plain version and SDPA over pre-gathered f32 pages
    (the heads as the query axis of one MQA head)."""
    from repro_torch.kernels import ops, ref

    ps, max_pages = 8, 20                          # max_ctx 160, as the engine's
    summary = {"max_abs_err": 0.0}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for b in (4, 8):
            n_pages = b * max_pages + 2               # + null page + one freed page
            freed = n_pages - 1
            ckv = torch.randn((n_pages, ps, MLA_R), generator=gen, device="cuda").to(dt)
            kr = torch.randn((n_pages, ps, MLA_RD), generator=gen, device="cuda").to(dt)
            perm = torch.randperm(b * max_pages, generator=gen, device="cuda") + 1
            table = perm.reshape(b, max_pages).to(torch.int32)
            pos = torch.tensor([159, 100, 37, 0, 7, 8, 63, 150][:b], dtype=torch.int32,
                               device="cuda")
            for i in range(b):
                table[i, int(pos[i]) // ps + 1:] = 0 if i % 2 == 0 else freed
            ql = torch.randn((b, MLA_H, MLA_R), generator=gen, device="cuda") / 4
            qr = torch.randn((b, MLA_H, MLA_RD), generator=gen, device="cuda") / 4
            args = (ql, qr, ckv, kr, table)
            clean = ops.paged_mla_attention(*args, pos, qk_dim=MLA_QK)
            plain = ref.paged_mla_attention_ref(*args, pos, MLA_QK)
            # NaN wherever no slot reads: dead pages and past pos in the last page
            live = torch.zeros((n_pages, ps), dtype=torch.bool, device="cuda")
            for i in range(b):
                p = torch.arange(int(pos[i]) + 1, device="cuda")
                live[table[i, p // ps].long(), p % ps] = True
            ckv_nan, kr_nan = ckv.clone(), kr.clone()
            ckv_nan[~live] = float("nan")
            kr_nan[~live] = float("nan")
            y = ops.paged_mla_attention(ql, qr, ckv_nan, kr_nan, table, pos, qk_dim=MLA_QK)
            plain_nan = ref.paged_mla_attention_ref(ql, qr, ckv_nan, kr_nan, table, pos,
                                                    MLA_QK)
            torch.cuda.synchronize()
            if not torch.isfinite(y).all() or not torch.equal(y, clean):
                fail(f"paged_mla_attention {dtype_name} B={b}: dead data reached the output")
            if not torch.isfinite(plain_nan).all():
                fail("plain MLA attention let dead-page NaN through")
            err = rel_l2(torch, clean, plain)
            abs_err = (clean - plain).abs().max().item()
            if not (err <= TOL["float32"]):
                fail(f"paged_mla_attention {dtype_name} B={b}: rel-L2 {err:.3e} > "
                     f"{TOL['float32']:.0e}")
            faults = {k: rel_l2(torch, f, plain)
                      for k, f in _mla_faults(torch, ref, args, MLA_QK, pos).items()}
            if not min(faults.values()) > TOL["float32"]:
                fail(f"MLA limit {TOL['float32']:.0e} does not reject every planted fault: "
                     f"{faults}")
            summary["max_abs_err"] = max(summary["max_abs_err"], abs_err)
            live_pos = int((pos.long() + 1).sum())
            live_pages = int((pos.long() // ps + 1).sum())
            es = ckv.element_size()
            # what the function needs: the live latents and rope keys, q,
            # o_lat, the live page-table entries and pos; per (slot, head,
            # live position) 2 (R + rd) score and 2 R output operations
            nbytes = (live_pos * (MLA_R + MLA_RD) * es + b * MLA_H * (2 * MLA_R + MLA_RD) * 4
                      + live_pages * 4 + b * 4)
            flops = live_pos * MLA_H * (2 * (MLA_R + MLA_RD) + 2 * MLA_R)
            bound, by = _bound(nbytes, flops, "float32")
            row = {"kernel": "paged_mla_attention", "dtype": dtype_name, "B": b, "H": MLA_H,
                   "R": MLA_R, "rope": MLA_RD, "qk_dim": MLA_QK, "page_size": ps,
                   "max_pages": max_pages, "live_positions": live_pos, "rel_l2": err,
                   "max_abs_err": abs_err, "planted_faults_rel_l2": faults, "bytes": nbytes,
                   "flops": flops, "bound_ms": bound, "bound_by": by}
            w = max_pages * ps
            # the yardstick: SDPA over pre-gathered f32 latents, the 128
            # heads as the query axis of one head sharing one K/V
            kg = torch.cat([ckv[table.long()], kr[table.long()]], dim=-1).reshape(
                b, 1, w, MLA_R + MLA_RD).float()
            vg = kg[..., :MLA_R].contiguous()
            qs = torch.cat([ql, qr], dim=-1)[:, None]
            mask = (torch.arange(w, device="cuda")[None] <= pos[:, None])[:, None, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            y_lib = sdpa(qs, kg, vg, attn_mask=mask, scale=1 / math.sqrt(MLA_QK))[:, 0]
            row["library_rel_l2"] = rel_l2(torch, y_lib, plain)
            row.update(
                ms=timer.ms(lambda: ops.paged_mla_attention(*args, pos, qk_dim=MLA_QK)),
                plain_ms=timer.ms(lambda: ref.paged_mla_attention_ref(*args, pos, MLA_QK)),
                library_ms=timer.ms(lambda: sdpa(qs, kg, vg, attn_mask=mask,
                                                 scale=1 / math.sqrt(MLA_QK))))
            if dtype_name == "bfloat16" and b == 8:
                summary.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "bound_by")})
                summary["shape"] = (f"bf16 pools B=8 H=128 R=512 rope=64 page_size=8 "
                                    f"live positions {live_pos}")
            rows.append(row)
            print(_row_line(row) + "; planted faults: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in faults.items()))
    return summary


def qsalr_checks(torch, timer, gen, rows: list) -> dict:
    """qsalr_spmm vs its plain version at the main path's projection
    shapes on the NF4 twin of each projection's tiled bitmap: at the
    decode batches it is given (M = 4 in the engine, 8 in greedy_generate)
    and at M = 1024 (many row blocks).  The bf16 limit must reject a
    planted fault: the stored values left unrounded (f32 into the
    product)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import salr
    from repro_torch.kernels import ops, ref

    shapes = {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/up": (576, 1536),
              "down": (1536, 576)}
    summary = {"max_abs_err": 0.0}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for lname, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
            tbw, _ = salr._tiled_encode(w.to(dt), salr.SALRConfig(dtype=dtype_name))
            q, _ = bm.tile_quantize_nf4(tbw)
            a = (torch.randn((k, R_CAT), generator=gen, device="cuda") / math.sqrt(k)).to(dt)
            b = (torch.randn((R_CAT, n), generator=gen, device="cuda") / math.sqrt(R_CAT)).to(dt)
            b_pad = ops._pad_bcat(b, q.cols)
            nnz = int(bm.unpack_bits(q.words.reshape(-1, q.tile // 32), q.tile).sum())
            w_deq = bm.qtile_decode(q, dt)          # the yardstick's weight, decoded ahead
            for m in (4, 8, 1024):
                x = (torch.randn((m, k), generator=gen, device="cuda") / 4).to(dt)
                y = ops.qsalr_matmul(x, q, a, b_pad)
                y_ref = ref.qsalr_spmm_ref(x, q, a, b_pad)
                torch.cuda.synchronize()
                err = rel_l2(torch, y, y_ref)
                abs_err = (y.float() - y_ref.float()).abs().max().item()
                if not (err <= TOL[dtype_name]) or not torch.isfinite(y).all():
                    fail(f"qsalr_spmm {dtype_name} {lname} M={m}: rel-L2 {err:.3e} "
                         f"> {TOL[dtype_name]:.0e}")
                summary["max_abs_err"] = max(summary["max_abs_err"], abs_err)
                es = y.element_size()
                # x, the words, nnz/2 code bytes, one f32 scale per cell,
                # A and B at the logical width n, y at width n
                nbytes = (m * k * es + q.words.numel() * 4 + nnz / 2 + q.scales.numel() * 4
                          + (k * R_CAT + R_CAT * n) * es + m * n * es)
                flops = 2 * m * nnz + 2 * m * k * R_CAT + 2 * m * R_CAT * n
                bound, by = _bound(nbytes, flops, dtype_name)
                row = {"kernel": "qsalr_spmm", "dtype": dtype_name, "layer": lname, "M": m,
                       "K": k, "N_pad": q.cols, "tile": q.tile, "cap_t": q.cap_t,
                       "rel_l2": err, "max_abs_err": abs_err, "bytes": nbytes,
                       "flops": flops, "bound_ms": bound, "bound_by": by}
                if dtype_name == "bfloat16":
                    u = (x.float() @ a.float()).to(dt)
                    unrounded = (x.float() @ bm.qtile_decode(q).float()
                                 + u.float() @ b_pad.float()).to(dt)
                    fault = rel_l2(torch, unrounded, y_ref)
                    row["unrounded_values_rel_l2"] = fault
                    if not fault > TOL[dtype_name]:
                        fail(f"bf16 limit {TOL[dtype_name]:.0e} does not reject unrounded "
                             f"NF4 values at {lname} M={m} (rel-L2 {fault:.3e})")
                    row.update(ms=timer.ms(lambda: ops.qsalr_matmul(x, q, a, b_pad)),
                               plain_ms=timer.ms(lambda: ref.qsalr_spmm_ref(x, q, a, b_pad)),
                               library_ms=timer.ms(lambda: x @ w_deq + (x @ a) @ b_pad))
                    if lname == "gate/up" and m == 4:
                        summary.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                               "bound_ms", "bound_by")})
                        summary["shape"] = (f"bf16 M=4 K=576 N_pad=1536 tile=256 "
                                            f"cap_t={q.cap_t}")
                rows.append(row)
                print(_row_line(row))
    return summary


def _nm_decode_inclusive(torch, nmw):
    """A planted nm_spmm / grouped_ and decode_nm_spmm fault: each set
    bit's value read at the inclusive popcount of its group byte (one slot
    late), clamped to the row; an expert stack decodes expert by expert
    into a dense (E, K, N) stack."""
    n, m = nmw.n, nmw.m
    lead = nmw.group_bits.shape[:-1]
    shifts = torch.arange(m, dtype=torch.uint8, device=nmw.group_bits.device)
    bits = ((nmw.group_bits[..., None] >> shifts) & 1).bool()
    slot = torch.cumsum(bits.long(), dim=-1)
    groups = torch.arange(bits.shape[-2], device=bits.device)[:, None]
    idx = (groups * n + slot).clamp(max=nmw.values.shape[-1] - 1).reshape(*lead, -1)
    vals = torch.gather(nmw.values, -1, idx).reshape(bits.shape)
    return torch.where(bits, vals, 0).reshape(*lead, nmw.cols)


def method_checks(torch, timer, gen, rows: list) -> dict:
    """nm_spmm, fused_lora and nf4_spmm vs their plain versions at the
    shapes the N:M and masked-dense paths give them: wo (K = 576) and
    down (K = 1536), N = 576, R = 128, at the decode batches M = 4
    (engine slots) and 8 (greedy_generate) and at prefill size M = 1024
    (which the main path gives nm_spmm and fused_lora; nf4_spmm only
    decodes, and is held at the split-K kernels' rows dispatch there
    too), nm_spmm at granite's wo (K = N = 1024) at M = 8 and 1024, and
    nf4_spmm at the smoke width's padded shape (96 columns -> 128).  The
    bf16 limit must reject one planted fault per kernel: nm_spmm's values
    read at the inclusive popcount, fused_lora's u left unrounded,
    nf4_spmm's dequantized weight left unrounded (f32 into the
    product).  At down, nm_spmm's and nf4_spmm's rows must be bitwise
    independent of M (1, 4, 8, 33, 100 against 1024) and two calls
    bitwise equal (``_rows_bitwise``)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core.quant import nf4_dequant_2d
    from repro_torch.kernels import ops, ref

    shapes = {"wo": (576, 576), "down": (1536, 576), "wo (smoke width, padded)": (96, 96),
              "granite wo": (1024, 1024)}
    # the shapes that only some kernels take here, and at which M
    only = {"wo (smoke width, padded)": ("nf4_spmm",), "granite wo": ("nm_spmm",)}
    rows_at = {"granite wo": (8, 1024)}
    names = ("nm_spmm", "fused_lora", "nf4_spmm")
    summary = {name: {"max_abs_err": 0.0} for name in names}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for lname, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
            nmw, _ = bm.nm_encode(w.to(dt))
            w_nm = bm.nm_decode(nmw)                      # yardstick weights, decoded ahead
            a = (torch.randn((k, R_CAT), generator=gen, device="cuda") / math.sqrt(k)).to(dt)
            b = (torch.randn((R_CAT, n), generator=gen, device="cuda") / math.sqrt(R_CAT)).to(dt)
            codes, scales = ops.nf4_encode_2d(torch.nn.functional.pad(w, (0, (-n) % 64)))
            w_nf4 = nf4_dequant_2d(codes, scales)
            w_nf4_dt = w_nf4.to(dt)
            n_pad = w_nf4.shape[1]
            nnz = int(w_nm.ne(0).sum())
            splitk = {"nm_spmm": lambda xs: ops.nm_matmul(xs, nmw),
                      "nf4_spmm": lambda xs: ops.nf4_matmul(xs, codes, scales)}
            for m in rows_at.get(lname, (4, 8, 1024)):
                x = (torch.randn((m, k), generator=gen, device="cuda") / 4).to(dt)
                es = x.element_size()
                cases = {   # kernel, plain, library call, planted fault, bytes, flops
                    "nm_spmm": (
                        lambda: ops.nm_matmul(x, nmw), lambda: ref.nm_spmm_ref(x, nmw),
                        lambda: x @ w_nm,
                        ("inclusive_popcount_rel_l2",
                         lambda: (x.float() @ _nm_decode_inclusive(torch, nmw).float()).to(dt)),
                        # x, the group bytes, the n/m stored values, y
                        m * k * es + nmw.group_bits.numel() + nmw.values.numel() * es
                        + m * n * es, 2 * m * nnz),
                    "fused_lora": (
                        lambda: ops.lora_matmul(x, a, b), lambda: ref.fused_lora_ref(x, a, b),
                        lambda: torch.linalg.multi_dot([x, a, b]),
                        ("unrounded_u_rel_l2",
                         lambda: ((x.float() @ a.float()) @ b.float()).to(dt)),
                        (m * k + k * R_CAT + R_CAT * n + m * n) * es,
                        2 * m * R_CAT * (k + n)),
                    "nf4_spmm": (
                        lambda: ops.nf4_matmul(x, codes, scales),
                        lambda: ref.nf4_spmm_ref(x, codes, scales),
                        lambda: x @ w_nf4_dt,
                        ("unrounded_weight_rel_l2", lambda: (x.float() @ w_nf4).to(dt)),
                        # x, the code bytes, one f32 scale per 64 columns, y
                        m * k * es + codes.numel() + scales.numel() * 4 + m * n_pad * es,
                        2 * m * k * n_pad),
                }
                for name, (kern, plain, lib, (fault_key, fault_fn), nbytes, flops) in \
                        cases.items():
                    if name not in only.get(lname, names):
                        continue
                    y, y_ref = kern(), plain()
                    torch.cuda.synchronize()
                    err = rel_l2(torch, y, y_ref)
                    abs_err = (y.float() - y_ref.float()).abs().max().item()
                    if not (err <= TOL[dtype_name]) or not torch.isfinite(y).all():
                        fail(f"{name} {dtype_name} {lname} M={m}: rel-L2 {err:.3e} "
                             f"> {TOL[dtype_name]:.0e}")
                    if lname == "down" and m == 1024 and name in splitk:
                        _rows_bitwise(torch, f"{name} {dtype_name} {lname}", splitk[name], x, y)
                    s = summary[name]
                    s["max_abs_err"] = max(s["max_abs_err"], abs_err)
                    bound, by = _bound(nbytes, flops, dtype_name)
                    row = {"kernel": name, "dtype": dtype_name, "layer": lname, "M": m, "K": k,
                           "N_pad": n_pad if name == "nf4_spmm" else n, "rel_l2": err,
                           "max_abs_err": abs_err, "bytes": nbytes, "flops": flops,
                           "bound_ms": bound, "bound_by": by}
                    if dtype_name == "bfloat16":
                        fault = rel_l2(torch, fault_fn(), y_ref)
                        row[fault_key] = fault
                        if not fault > TOL[dtype_name]:
                            fail(f"bf16 limit {TOL[dtype_name]:.0e} does not reject the "
                                 f"planted {name} fault at {lname} M={m} (rel-L2 {fault:.3e})")
                        row.update(ms=timer.ms(kern), plain_ms=timer.ms(plain),
                                   library_ms=timer.ms(lib))
                        # the yardstick shape in the kernels line: one engine
                        # decode step of the deepest projection
                        if lname == "down" and m == 4:
                            s.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                             "bound_ms", "bound_by")})
                            s["shape"] = (f"bf16 M=4 K={k} N={n}"
                                          + (f" R={R_CAT}" if name == "fused_lora" else ""))
                    rows.append(row)
                    print(_row_line(row))
    return summary


def _same_bits(torch, a, b) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.shape == b.shape and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _rows_bitwise(torch, what: str, fn, x, y) -> None:
    """A row's bits do not depend on M: fn's first 1, 4, 8, 33 and 100 rows
    computed alone equal the same rows of ``y = fn(x)`` at x's M (1024: the
    split-K kernels' rows dispatch, the smaller M their slices dispatch),
    and a second call on x gives y's bits."""
    for mm in (1, 4, 8, 33, 100):
        if not _same_bits(torch, fn(x[:mm]), y[:mm]):
            fail(f"{what}: rows computed at M={mm} differ from the same rows at "
                 f"M={x.shape[0]}")
    if not _same_bits(torch, fn(x), y):
        fail(f"{what}: two calls on the same inputs differ")
    print(f"phase 2: {what}: rows at M = 1, 4, 8, 33, 100 bitwise equal to the same rows "
          f"at M = {x.shape[0]}; two calls bitwise equal")


# granite_moe_1b_a400m's expert stacks: (K, N) of gate/up and of down
MOE_SHAPES = {"gate/up": (1024, 512), "down": (512, 1024)}
MOE_EXPERTS, MOE_TOPK = 32, 8
# the expert-stack kernels by base family: tiled bitmap, its NF4 twin, a
# masked (or dense) stack, a 2:4 stack
MOE_KINDS = ("salr", "qsalr", "dense", "nm")
MOE_KERNELS = tuple(f"{route}_{kind}_spmm" for route in ("grouped", "decode")
                    for kind in MOE_KINDS)


def _popcount(words):
    """Set bits of each int32 word (SWAR in int64, a word at a time: the
    bits of a 256-expert stack unpacked would not fit the card)."""
    w = words.long() & 0xFFFFFFFF
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & 0xFFFFFFFF) >> 24


def _moe_cost(torch, stack, row_e, k: int, n: int, r: int, es: int) -> tuple:
    """(bytes, flops) the expert-stack op needs for these rows: x and y
    rows, and for each expert a row uses, its base as stored and its
    A_cat / B_cat at the logical width; flops 2 per weight the product
    needs per row of its expert (a tiled or N:M expert's stored nonzeros,
    a dense expert's K x N), plus the adapter products.  Stored bases: a
    tiled bitmap's words and nonzeros (NF4: half a byte each plus an f32
    scale per cell), an N:M expert's group bytes and n/m values, a dense
    expert in full."""
    from repro_torch.core import bitmap as bm

    n_exp = stack.shape[0] if isinstance(stack, torch.Tensor) else (
        stack.group_bits.shape[0] if isinstance(stack, bm.NMWeight) else stack.words.shape[0])
    rows_of = torch.bincount(row_e[row_e >= 0].long(), minlength=n_exp)
    used = rows_of > 0
    a = int(rows_of.sum())
    adapters = (k * r + r * n) * es
    if isinstance(stack, torch.Tensor):
        nnz = torch.full((n_exp,), k * n, dtype=torch.float64, device=rows_of.device)
        base = torch.full_like(nnz, k * n * es)
    elif isinstance(stack, bm.NMWeight):
        nnz = torch.full((n_exp,), k * n * stack.n / stack.m, dtype=torch.float64,
                         device=rows_of.device)
        base = torch.full_like(nnz, stack.group_bits[0].numel() + stack.values[0].numel() * es)
    else:
        nnz = _popcount(stack.words).reshape(n_exp, -1).sum(1).double()
        quant = hasattr(stack, "codes")
        base = (stack.words[0].numel() * 4 + (stack.scales[0].numel() * 4 if quant else 0)
                + (nnz / 2 if quant else nnz * es))
    nbytes = a * (k + n) * es + int(used.sum()) * adapters + float(base[used].sum())
    flops = 2 * float((rows_of.double() * nnz).sum()) + 2 * a * r * (k + n)
    return nbytes, flops


def _moe_stacks(torch, gen, dt, dtype_name: str, k: int, n: int) -> tuple:
    """Expert stacks of each base family from one seeded (E, K, N) weight:
    the tiled bitmap (p = 0.5) and its NF4 twin, the masked stack (p =
    0.5) and the 2:4 stack, each as ``compress_stack`` encodes it; and
    each expert decoded dense in the operand type (the yardstick's base)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import prune, salr
    from repro_torch.kernels import ref

    n_exp = MOE_EXPERTS
    w = torch.randn((n_exp, k, n), generator=gen, device="cuda") / math.sqrt(k)
    flat, _ = salr._tiled_encode(w.reshape(n_exp * k, n).to(dt),
                                 salr.SALRConfig(dtype=dtype_name))
    tbw = bm.TiledBitmapWeight(
        words=flat.words.reshape(n_exp, k, *flat.words.shape[1:]),
        values=flat.values.reshape(n_exp, k, *flat.values.shape[1:]),
        cols=flat.cols, tile=flat.tile, cap_t=flat.cap_t)
    q, _ = bm.tile_quantize_nf4(tbw)
    masked = prune.apply_mask(w, prune.magnitude_mask(w, 0.5, batch_dims=1)).to(dt)
    nmw, _ = bm.nm_encode(w.to(dt))
    stacks = {"salr": tbw, "qsalr": q, "dense": masked, "nm": nmw}
    decoded = {"salr": bm.tile_decode(tbw)[..., :n],
               "qsalr": torch.stack([bm.qtile_decode(ref._expert(q, e), dtype=dt)
                                     for e in range(n_exp)])[..., :n],
               "dense": masked, "nm": bm.nm_decode(nmw)}
    return stacks, {kind: d.to(dt) for kind, d in decoded.items()}


def moe_checks(torch, timer, gen, rows: list) -> dict:
    """The eight expert-stack kernels (tiled bitmap, its NF4 twin, masked
    dense, 2:4; grouped and decode grid) vs their plain versions at
    granite_moe_1b_a400m's expert shapes (E 32, top-8, R 128), at the rows
    the main path gives them: grouped at 64 assignment rows (8 tokens,
    block_m 8, 288 grouped rows) and 8192 (greedy_generate's prefill of
    8 x 128 tokens, block_m 128, 12288 rows); decode at 64 rows (the
    engine's 8 slots) and 1024 (an engine prefill bucket of 128); the
    dense and 2:4 kernels also with no adapter at 64 rows.  The bf16
    limit must reject the planted faults: u left unrounded, one tile
    (decode: one expert's rows) reading its neighbour expert's weights,
    and (2:4) values read at the inclusive popcount.  Exact checks:
    grouped and decode bitwise equal per row on the same assignments; a
    row bitwise the same among 1, 4, 8, 33 and 128 tokens; decode pad rows
    (-1) exactly zero with NaN in their x rows, grouped pad rows exactly
    zero from zero x, NaN there leaving every real row unchanged.  Each is
    timed beside its plain version and ``torch.nn.functional.grouped_mm``
    over the merged weights W + A_cat B_cat (decoded beforehand; rows
    sorted by expert beforehand).  The plain versions loop over the
    experts with a host sync each; their traces are so long that they are
    timed over 3 calls in one trace."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe

    n_exp, topk = MOE_EXPERTS, MOE_TOPK
    plain_timer = Timer(torch, iters=3, traces=1)
    summary = {name: {"max_abs_err": 0.0} for name in MOE_KERNELS}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for lname, (k, n) in MOE_SHAPES.items():
            stacks, decoded = _moe_stacks(torch, gen, dt, dtype_name, k, n)
            a = (torch.randn((n_exp, k, R_CAT), generator=gen, device="cuda")
                 / math.sqrt(k)).to(dt)
            b = (torch.randn((n_exp, R_CAT, n), generator=gen, device="cuda")
                 / math.sqrt(R_CAT)).to(dt)
            # the yardstick's weights, merged and decoded ahead: (E, K, N),
            # column-major as grouped_mm takes them
            merged = {}
            if dtype_name == "bfloat16":
                for kind in stacks:
                    dense = (decoded[kind].float()
                             + torch.bmm(a.float(), b.float())).to(dt)
                    merged[kind] = dense.transpose(1, 2).contiguous().transpose(1, 2)
            for n_tok in (8, 128, 1024):
                x = (torch.randn((n_tok, k), generator=gen, device="cuda") / 4).to(dt)
                top_i = torch.rand((n_tok, n_exp), generator=gen,
                                   device="cuda").argsort(dim=1)[:, :topk]
                n_as = n_tok * topk
                row_e = top_i.reshape(-1).to(torch.int32)
                g = moe.group_assignments(top_i, n_exp, moe._group_block_m(n_as, n_exp))
                xs = x.new_zeros((g.m_pad, k))
                xs.index_copy_(0, g.dst, x.index_select(0, g.tok))
                xd = x.repeat_interleave(topk, dim=0)
                back = g.dst[g.inv]                       # grouped row of each assignment
                for kind, st in stacks.items():
                    routes = {"grouped": (xs, g.tile_expert), "decode": (xd, row_e)}
                    outs = {}
                    for route, (xr, emap) in routes.items():
                        name = f"{route}_{kind}_spmm"
                        op = getattr(ops, f"{route}_{kind}_matmul")
                        plain_fn = getattr(ref, f"{name}_ref")
                        kw = {"block_m": g.block_m} if route == "grouped" else {}

                        def kern(op=op, xr=xr, emap=emap, st=st, kw=kw):
                            return op(xr, emap, st, a, b, **kw)

                        def plain(plain_fn=plain_fn, xr=xr, emap=emap, st=st, kw=kw):
                            return plain_fn(xr, emap, st, a, b, **kw)
                        outs[route] = y = kern()
                        if not ((route == "grouped" and n_tok in (8, 1024))
                                or (route == "decode" and n_tok in (8, 128))):
                            continue                # a shape the main path does not give
                        y_ref = plain()
                        torch.cuda.synchronize()
                        err = rel_l2(torch, y, y_ref)
                        abs_err = (y.float() - y_ref.float()).abs().max().item()
                        if not (err <= TOL[dtype_name]) or not torch.isfinite(y).all():
                            fail(f"{name} {dtype_name} {lname} rows={xr.shape[0]}: rel-L2 "
                                 f"{err:.3e} > {TOL[dtype_name]:.0e}")
                        s = summary[name]
                        s["max_abs_err"] = max(s["max_abs_err"], abs_err)
                        nbytes, flops = _moe_cost(torch, st, row_e, k, n, R_CAT,
                                                  y.element_size())
                        bound, by = _bound(nbytes, flops, dtype_name)
                        tiled = kind in ("salr", "qsalr")
                        row = {"kernel": name, "dtype": dtype_name, "layer": lname,
                               "tokens": n_tok, "M": xr.shape[0], "K": k,
                               "N_pad": st.cols if tiled else n,
                               **({"tile": st.tile, "cap_t": st.cap_t} if tiled else {}),
                               "rel_l2": err, "max_abs_err": abs_err, "bytes": nbytes,
                               "flops": flops, "bound_ms": bound, "bound_by": by}
                        if kind in ("dense", "nm") and n_tok == 8:
                            _moe_no_adapter(torch, row, name, op, plain_fn, xr, emap, st, kw,
                                            dtype_name)
                        if dtype_name == "bfloat16":
                            _moe_faults(torch, row, name, route, plain_fn, xr, emap, st, a, b,
                                        kw, y_ref, n_exp)
                            order = row_e.long().argsort(stable=True)
                            xsort = xd.index_select(0, order)
                            offs = torch.cumsum(torch.bincount(row_e.long(), minlength=n_exp),
                                                0).to(torch.int32)
                            library = _grouped_mm_call(torch, xsort, merged[kind], offs)
                            row.update(ms=timer.ms(kern), plain_ms=plain_timer.ms(plain),
                                       library_ms=(timer.ms(library) if library else None))
                            if lname == "gate/up" and n_tok == 8:
                                s.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                                 "bound_ms", "bound_by")})
                                s["shape"] = ("bf16 8 tokens x top-8 = 64 rows, E=32 K=1024 "
                                              "N=512 R=128"
                                              + (f" tile=256 cap_t={st.cap_t}" if tiled else ""))
                        rows.append(row)
                        print(_row_line(row))
                    # grouped == decode, bitwise, per assignment row
                    if not torch.equal(outs["grouped"][back], outs["decode"]):
                        fail(f"{kind} {dtype_name} {lname} {n_tok} tokens: grouped and decode "
                             "rows differ")
                    if n_tok == 128:
                        _moe_row_invariance(torch, moe, ops, kind, st, a, b, x, top_i,
                                            outs["decode"], f"{dtype_name} {lname}")
                    if n_tok == 8:
                        _moe_pad_rows(torch, ops, kind, st, a, b, xs, g, xd, row_e, outs,
                                      f"{dtype_name} {lname}")
    print("phase 2: expert-stack kernels: grouped == decode bitwise per row, rows "
          "independent of the token count, pad rows exactly zero")
    return summary


# deepseek_v3_671b's MoE: 256 routed experts, top-8, moe_d_ff 2048, and one
# shared expert of the same width
DS_MOE_SHAPES = {"gate/up": (7168, 2048), "down": (2048, 7168)}
DS_EXPERTS, DS_TOPK, DS_CHUNK = 256, 8, 16


def _ds_stack(torch, gen, k: int, n: int):
    """A tiled-bitmap stack of ``DS_EXPERTS`` bf16 experts (p = 0.5) from
    seeded weights, encoded ``DS_CHUNK`` experts at a time."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import salr

    parts = []
    for _ in range(DS_EXPERTS // DS_CHUNK):
        w = torch.randn((DS_CHUNK, k, n), generator=gen, device="cuda") / math.sqrt(k)
        flat, _ = salr._tiled_encode(w.reshape(DS_CHUNK * k, n).to(torch.bfloat16),
                                     salr.SALRConfig(dtype="bfloat16"))
        parts.append(bm.TiledBitmapWeight(
            words=flat.words.reshape(DS_CHUNK, k, *flat.words.shape[1:]),
            values=flat.values.reshape(DS_CHUNK, k, *flat.values.shape[1:]),
            cols=flat.cols, tile=flat.tile, cap_t=flat.cap_t))
        del w, flat
    return salr.cat_stacks(parts)


def deepseek_moe_checks(torch, timer, gen, rows: list) -> None:
    """``grouped_salr_spmm`` and ``decode_salr_spmm`` vs their plain
    versions at deepseek_v3_671b's expert stacks (E 256, top-8, gate/up
    7168 -> 2048, down 2048 -> 7168, R 128, bf16) at 64 assignment rows
    (8 tokens: the engine's tick at 8 slots, greedy_generate's decode
    step), grouped and decode bitwise equal per row; and ``salr_spmm`` at
    the shared expert's projections (7168 <-> 2048) at the 8-token decode
    batch.  The stacks are tiled bitmaps encoded from seeded weights, the
    adapters drawn from the seed (no SVD).  Each is timed beside its plain
    version (bytes bound)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import salr
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe

    dt, n_tok = torch.bfloat16, 8
    plain_timer = Timer(torch, iters=3, traces=1)
    for lname, (k, n) in DS_MOE_SHAPES.items():
        st = _ds_stack(torch, gen, k, n)
        a = (torch.randn((DS_EXPERTS, k, R_CAT), generator=gen, device="cuda")
             / math.sqrt(k)).to(dt)
        b = (torch.randn((DS_EXPERTS, R_CAT, n), generator=gen, device="cuda")
             / math.sqrt(R_CAT)).to(dt)
        x = (torch.randn((n_tok, k), generator=gen, device="cuda") / 4).to(dt)
        top_i = torch.rand((n_tok, DS_EXPERTS), generator=gen,
                           device="cuda").argsort(dim=1)[:, :DS_TOPK]
        row_e = top_i.reshape(-1).to(torch.int32)
        g = moe.group_assignments(top_i, DS_EXPERTS,
                                  moe._group_block_m(n_tok * DS_TOPK, DS_EXPERTS))
        xs = x.new_zeros((g.m_pad, k))
        xs.index_copy_(0, g.dst, x.index_select(0, g.tok))
        xd = x.repeat_interleave(DS_TOPK, dim=0)
        outs = {}
        for route, (xr, emap, kw) in {"grouped": (xs, g.tile_expert, {"block_m": g.block_m}),
                                      "decode": (xd, row_e, {})}.items():
            name = f"{route}_salr_spmm"
            op, plain_fn = getattr(ops, f"{route}_salr_matmul"), getattr(ref, f"{name}_ref")

            def kern(op=op, xr=xr, emap=emap, kw=kw):
                return op(xr, emap, st, a, b, **kw)

            def plain(plain_fn=plain_fn, xr=xr, emap=emap, kw=kw):
                return plain_fn(xr, emap, st, a, b, **kw)
            outs[route] = y = kern()
            y_ref = plain()
            torch.cuda.synchronize()
            err = rel_l2(torch, y, y_ref)
            if not (err <= TOL["bfloat16"]) or not torch.isfinite(y).all():
                fail(f"{name} deepseek {lname} rows={xr.shape[0]}: rel-L2 {err:.3e}")
            nbytes, flops = _moe_cost(torch, st, row_e, k, n, R_CAT, y.element_size())
            bound, by = _bound(nbytes, flops, "bfloat16")
            row = {"kernel": name, "dtype": "bfloat16", "layer": f"deepseek {lname}",
                   "tokens": n_tok, "M": xr.shape[0], "K": k, "N_pad": st.cols, "E": DS_EXPERTS,
                   "tile": st.tile, "cap_t": st.cap_t, "rel_l2": err,
                   "max_abs_err": (y.float() - y_ref.float()).abs().max().item(),
                   "bytes": nbytes, "flops": flops, "bound_ms": bound, "bound_by": by,
                   "ms": timer.ms(kern), "plain_ms": plain_timer.ms(plain)}
            rows.append(row)
            print(_row_line(row))
        if not torch.equal(outs["grouped"][g.dst[g.inv]], outs["decode"]):
            fail(f"deepseek {lname}: grouped and decode rows differ")
        del st, a, b
        # the shared expert's projection of the same shape: one SALR linear
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        tbw, _ = salr._tiled_encode(w.to(dt), salr.SALRConfig(dtype="bfloat16"))
        a1 = (torch.randn((k, R_CAT), generator=gen, device="cuda") / math.sqrt(k)).to(dt)
        b1 = ops._pad_bcat((torch.randn((R_CAT, n), generator=gen, device="cuda")
                            / math.sqrt(R_CAT)).to(dt), tbw.cols)
        y, y_ref = ops.salr_matmul(x, tbw, a1, b1), ref.salr_spmm_ref(x, tbw, a1, b1)
        torch.cuda.synchronize()
        err = rel_l2(torch, y, y_ref)
        if not (err <= TOL["bfloat16"]) or not torch.isfinite(y).all():
            fail(f"salr_spmm deepseek shared {lname} M={n_tok}: rel-L2 {err:.3e}")
        nnz = int(bm.unpack_bits(tbw.words.reshape(-1, tbw.tile // 32), tbw.tile).sum())
        nbytes = (n_tok * k * 2 + tbw.words.numel() * 4 + nnz * 2 + (k + n) * R_CAT * 2
                  + n_tok * n * 2)
        bound, by = _bound(nbytes, 2 * n_tok * (nnz + R_CAT * (k + n)), "bfloat16")
        row = {"kernel": "salr_spmm", "dtype": "bfloat16", "layer": f"deepseek shared {lname}",
               "M": n_tok, "K": k, "N_pad": tbw.cols, "tile": tbw.tile, "cap_t": tbw.cap_t,
               "rel_l2": err, "max_abs_err": (y.float() - y_ref.float()).abs().max().item(),
               "bound_ms": bound, "bound_by": by,
               "ms": timer.ms(lambda: ops.salr_matmul(x, tbw, a1, b1)),
               "plain_ms": timer.ms(lambda: ref.salr_spmm_ref(x, tbw, a1, b1))}
        rows.append(row)
        print(_row_line(row))
    print("phase 2: deepseek_v3_671b expert stacks (E 256): grouped == decode bitwise per row")


def _moe_no_adapter(torch, row, name, op, plain_fn, xr, emap, st, kw, dtype_name):
    """The kernel with no adapter (a plain ``{"w"}`` stack, ``method="dense"``
    with rank 0) vs its plain version."""
    y0, y0_ref = op(xr, emap, st, None, None, **kw), plain_fn(xr, emap, st, None, None, **kw)
    torch.cuda.synchronize()
    err = rel_l2(torch, y0, y0_ref)
    row["no_adapter_rel_l2"] = err
    if not (err <= TOL[dtype_name]) or not torch.isfinite(y0).all():
        fail(f"{name} {dtype_name} without adapter rows={xr.shape[0]}: rel-L2 {err:.3e} > "
             f"{TOL[dtype_name]:.0e}")


def _grouped_mm_call(torch, xsort, w_merged, offs):
    """One grouped_mm call over expert-sorted rows, or None (printed) where
    this torch has none or refuses the shapes."""
    fn = getattr(torch.nn.functional, "grouped_mm", None)
    if fn is None:
        print("phase 2: torch.nn.functional.grouped_mm is missing: no library time")
        return None
    try:
        fn(xsort, w_merged, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as exc:
        print(f"phase 2: grouped_mm refused the call ({exc}): no library time")
        return None
    return lambda: fn(xsort, w_merged, offs=offs)


def _moe_faults(torch, row, name, route, plain_fn, xr, emap, st, a, b, kw, y_ref, n_exp):
    """The planted faults the bf16 limit must reject: u left unrounded
    (B_cat handed over in f32), one tile (decode: the rows of one expert)
    reading its neighbour expert's weights, and for a 2:4 stack the values
    read at the inclusive popcount (the dense plain version over the
    misdecoded stack)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.kernels import ref

    faults = {"unrounded_u_rel_l2": plain_fn(xr, emap, st, a, b.float(), **kw).to(y_ref.dtype)}
    moved = emap.clone()
    if route == "grouped":
        moved[0] = (moved[0] + 1) % n_exp           # the first tile holds real rows
    else:
        moved[emap == emap[0]] = (emap[0] + 1) % n_exp
    faults["neighbour_expert_rel_l2"] = plain_fn(xr, moved, st, a, b, **kw)
    if isinstance(st, bm.NMWeight):
        dense_fn = getattr(ref, f"{route}_dense_spmm_ref")
        faults["inclusive_popcount_rel_l2"] = dense_fn(xr, emap, _nm_decode_inclusive(torch, st),
                                                       a, b, **kw)
    for key, fault in faults.items():
        err = rel_l2(torch, fault, y_ref)
        row[key] = err
        if not err > TOL["bfloat16"]:
            fail(f"bf16 limit {TOL['bfloat16']:.0e} does not reject the planted {name} "
                 f"fault {key} at rows={xr.shape[0]} (rel-L2 {err:.3e})")


def _moe_row_invariance(torch, moe, ops, kind, st, a, b, x, top_i, full, label):
    """Each token's rows from its first-n-token subset equal the
    128-token call's, bitwise, on both routes, for n in 1, 4, 8, 33."""
    n_exp, topk = MOE_EXPERTS, MOE_TOPK
    for n_sub in (1, 4, 8, 33):
        xsub, tsub = x[:n_sub], top_i[:n_sub]
        n_as = n_sub * topk
        dec = getattr(ops, f"decode_{kind}_matmul")(
            xsub.repeat_interleave(topk, dim=0), tsub.reshape(-1).to(torch.int32), st, a, b)
        g = moe.group_assignments(tsub, n_exp, moe._group_block_m(n_as, n_exp))
        xs = xsub.new_zeros((g.m_pad, xsub.shape[1]))
        xs.index_copy_(0, g.dst, xsub.index_select(0, g.tok))
        grp = getattr(ops, f"grouped_{kind}_matmul")(xs, g.tile_expert, st, a, b,
                                                     block_m=g.block_m)[g.dst[g.inv]]
        if not (torch.equal(dec, full[:n_as]) and torch.equal(grp, full[:n_as])):
            fail(f"{kind} {label}: rows at {n_sub} tokens differ from the 128-token call")


def _moe_pad_rows(torch, ops, kind, st, a, b, xs, g, xd, row_e, outs, label):
    """Decode: 8 pad rows past the map hold NaN, come out exactly zero, and
    the real rows do not change.  Grouped: pad rows (zero x) come out
    exactly zero; NaN put there leaves every real row unchanged."""
    nan_rows = torch.full((8, xd.shape[1]), float("nan"), dtype=xd.dtype, device=xd.device)
    dec = getattr(ops, f"decode_{kind}_matmul")(torch.cat([xd, nan_rows]), row_e, st, a, b)
    if dec[xd.shape[0]:].count_nonzero() or not torch.equal(dec[:xd.shape[0]], outs["decode"]):
        fail(f"decode_{kind}_spmm {label}: NaN pad rows not exactly zero or leaked")
    pad = torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    pad[g.dst] = False
    if outs["grouped"][pad].count_nonzero():
        fail(f"grouped_{kind}_spmm {label}: zero pad rows not exactly zero")
    junk = xs.clone()
    junk[pad] = float("nan")
    grp = getattr(ops, f"grouped_{kind}_matmul")(junk, g.tile_expert, st, a, b,
                                                 block_m=g.block_m)
    if not torch.equal(grp[~pad], outs["grouped"][~pad]):
        fail(f"grouped_{kind}_spmm {label}: NaN in pad rows changed a real row")


QUANT_ATTENTION = ("ring_quant_gqa_attention", "paged_quant_gqa_attention",
                   "ring_nf4_gqa_attention", "paged_nf4_gqa_attention")


def quant_attention_checks(torch, timer, gen, rows: list) -> dict:
    """The four quantized decode-attention kernels vs their plain versions
    at smollm_135m's decode shape (9 query heads, 3 KV heads, head dim 64,
    page size 8, 160 positions), 4 and 8 slots.  Paged: junk codes and
    NaN scales in the null page and in a freed page.  Ring: junk codes
    and NaN scales past each row's position.  The output must be finite
    and equal to the clean one."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn

    h, kh, d, ps, max_pages = 9, 3, 64, 8, 20       # max_ctx 160
    w = ps * max_pages
    summary = {name: {"max_abs_err": 0.0} for name in QUANT_ATTENTION}
    for name in QUANT_ATTENTION:
        kv = "int8" if "quant" in name else "nf4"
        paged = name.startswith("paged")
        quant = attn.q8 if kv == "int8" else attn.qnf4
        kern, plain = getattr(ops, name), getattr(ref, name + "_ref")
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            for b in (4, 8):
                pos = torch.tensor([159, 100, 37, 0, 7, 8, 63, 150][:b], dtype=torch.int32,
                                   device="cuda")
                lead = (b * max_pages + 2, ps) if paged else (b, w)  # + null + a freed page
                kq, ks = quant(torch.randn(lead + (kh, d), generator=gen, device="cuda").to(dt))
                vq, vs = quant(torch.randn(lead + (kh, d), generator=gen, device="cuda").to(dt))
                q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
                if paged:
                    freed = lead[0] - 1
                    perm = torch.randperm(b * max_pages, generator=gen, device="cuda") + 1
                    table = perm.reshape(b, max_pages).to(torch.int32)
                    for i in range(b):   # past the last live page: null or freed
                        table[i, int(pos[i]) // ps + 1:] = 0 if i % 2 == 0 else freed
                    args = (q, kq, vq, ks, vs, table, pos)
                    live = torch.zeros(lead[0], dtype=torch.bool, device="cuda")
                    for i in range(b):
                        live[table[i, :int(pos[i]) // ps + 1].long()] = True
                    dead = ~live
                else:
                    args = (q, kq, vq, ks, vs, pos)
                    dead = torch.arange(w, device="cuda")[None, :] > pos[:, None]
                clean = kern(*args)
                y_ref = plain(*args)
                dirty = [t.clone() for t in args]
                for t, junk in zip(dirty[1:5], (-99 if kv == "int8" else 0xAB,) * 2
                                   + (float("nan"),) * 2):
                    t[dead] = junk
                y = kern(*dirty)
                plain_dirty = plain(*dirty)
                torch.cuda.synchronize()
                if not torch.isfinite(y).all() or not torch.equal(y, clean):
                    fail(f"{name} {dtype_name} B={b}: dead data reached the output")
                if not torch.isfinite(plain_dirty).all():
                    fail(f"plain {name} let dead data through")
                err = rel_l2(torch, y, y_ref)
                abs_err = (y.float() - y_ref.float()).abs().max().item()
                if not (err <= TOL[dtype_name]):
                    fail(f"{name} {dtype_name} B={b}: rel-L2 {err:.3e} > {TOL[dtype_name]:.0e}")
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], abs_err)
                es = q.element_size()
                live_pos = int((pos.long() + 1).sum())
                row_bytes = d if kv == "int8" else d // 2
                # q and the output; each live position's K and V codes and
                # their two scales; the live page-table entries; pos
                nbytes = (2 * b * h * d * es + 2 * live_pos * kh * (row_bytes + 4) + b * 4
                          + (int((pos.long() // ps + 1).sum()) * 4 if paged else 0))
                flops = 4 * live_pos * h * d
                bound, by = _bound(nbytes, flops, dtype_name)
                row = {"kernel": name, "dtype": dtype_name, "B": b, "H": h, "KH": kh, "d": d,
                       "page_size": ps if paged else None, "ctx": w,
                       "live_positions": live_pos, "rel_l2": err, "max_abs_err": abs_err,
                       "bytes": nbytes, "flops": flops, "bound_ms": bound, "bound_by": by}
                if dtype_name == "bfloat16":
                    # the yardstick: SDPA over K/V dequantized, gathered and
                    # head-expanded beforehand
                    deq = attn.dq8 if kv == "int8" else attn.dqnf4
                    kd, vd = deq(kq, ks, dt), deq(vq, vs, dt)
                    if paged:
                        kd = kd[table.long()].reshape(b, w, kh, d)
                        vd = vd[table.long()].reshape(b, w, kh, d)
                    kg = kd.transpose(1, 2).repeat_interleave(h // kh, dim=1).contiguous()
                    vg = vd.transpose(1, 2).repeat_interleave(h // kh, dim=1).contiguous()
                    mask = (torch.arange(w, device="cuda")[None] <= pos[:, None])[:, None, None]
                    qs = q.transpose(1, 2)
                    sdpa = torch.nn.functional.scaled_dot_product_attention
                    row.update(ms=timer.ms(lambda: kern(*args)),
                               plain_ms=timer.ms(lambda: plain(*args)),
                               library_ms=timer.ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)))
                    if b == 4:
                        s.update({kk: row[kk] for kk in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by")})
                        s["shape"] = (f"bf16 B=4 H=9 KH=3 d=64 {kv} "
                                      f"{'page_size=8 ' if paged else ''}"
                                      f"live positions {live_pos}")
                rows.append(row)
                print(_row_line(row))
    return summary


def main_path(torch, dev, seed: int, rows: list) -> list:
    """Serve smollm_135m at full width through both engines on ``dev``:
    compressed once with the NF4 twin (``dual_repr``, which leaves the
    native base as it is), served under the native plan, then under the
    two mixed-precision plans.  Returns (path, launch counts, launches
    expected) for each of the three runs, the counts set to 0 before
    each run and read right after it (and, for the quantized runs, the
    launches of one decode step)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import execplan, salr
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = configs.get("smollm_135m")
    cfg = cfg.with_(salr=dataclasses.replace(cfg.salr, dual_repr=True))
    params, init_s = serve.build_params(cfg, seed, dev)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    twin = sum(t.numel() * t.element_size() for lp in params["layers"]
               for part in ("mixer", "mlp") for lin in lp[part].values()
               if isinstance(lin, salr.SALRLinear) for t in (lin.qbase.codes, lin.qbase.scales))
    print(f"phase 3: compressed {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) with the NF4 twin on {dev} in {init_s:.2f}s; parameter bytes "
          f"{nbytes}, of which NF4 codes and scales {twin}")
    gen = torch.Generator().manual_seed(seed + 1)
    d = cfg.d_model
    rank0 = salr.compress_linear(gen, (torch.randn((d, d), generator=gen)
                                       / math.sqrt(d)).to(dev),
                                 salr.SALRConfig(lora_rank=0, res_rank=0, dtype=cfg.dtype))
    n_req, gen_len, n_slots = N_REQ, GEN_LEN, N_SLOTS
    prompts = serve.request_prompts(cfg, n_req, PROMPT_LEN, seed, shared_prefix=64)
    plan = execplan.resolve_plan(cfg)
    x_rank0 = params["embed"]["table"][torch.from_numpy(prompts).to(dev).long()]

    on_gpu = dev.type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    ops.reset_launches()
    with torch.inference_mode():
        greedy, batch_s = serve.run_batch(cfg, params, prompts, gen_len, n_req, plan)
        eng, results, metrics = serve.run_continuous(cfg, params, prompts, gen_len,
                                                     n_slots, plan=plan)
        y0 = salr.apply_salr(x_rank0, rank0, backend="kernel")
        if on_gpu:
            torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    forwards = gen_len + metrics["n_prefills"] + metrics["n_decode_ticks"]
    # 7 SALR projections per layer per forward (210 at 30 layers)
    expected = dict.fromkeys(counts, 0)
    expected.update({"salr_spmm": 7 * cfg.n_layers * forwards, "bitmap_spmm": 1,
                     "paged_gqa_attention": cfg.n_layers * metrics["n_decode_ticks"]})
    print(f"phase 3: native plan: {serve.route_line(cfg, plan)}")
    print(f"phase 3: batch engine: {greedy.size} tokens in {batch_s:.3f}s "
          f"({greedy.size / batch_s:.1f} tok/s)")
    print(f"phase 3: continuous engine: {metrics['total_tokens']} tokens in "
          f"{metrics['wall_s']:.3f}s ({metrics['tok_s']:.1f} tok/s), ttft mean "
          f"{metrics['ttft_mean_s']:.4f}s p50 {metrics['ttft_p50_s']:.4f}s, prefix hit rate "
          f"{metrics['prefix_hit_rate']:.4f}, prefills {metrics['n_prefills']}, decode ticks "
          f"{metrics['n_decode_ticks']}, pages/request {metrics['pages_per_request_mean']}")
    print(f"phase 3: peak device memory {peak} bytes")
    rows.append({"main_path": "native", "batch_tokens": int(greedy.size), "batch_s": batch_s,
                 "engine": {k: v for k, v in metrics.items() if k != "plan"},
                 "peak_bytes": peak, "param_bytes": nbytes, "nf4_twin_bytes": twin,
                 "compress_s": init_s, "launches": counts})

    # outputs: shape, vocabulary, finiteness, engine vs greedy
    check_tokens("native", cfg, greedy, results, n_req, gen_len)
    if not torch.isfinite(y0).all():
        fail("rank-0 layer output not finite")
    with torch.inference_mode():
        pt = torch.from_numpy(prompts[:2]).to(dev)
        lk, _ = M.prefill(params, cfg, pt, plan=plan)
        lr, _ = M.prefill(params, cfg, pt, plan=execplan.resolve_plan(cfg, backend="reference"))
        report = serve.parity_report(cfg, params, prompts, greedy, results, plan)
        # planted faults, one per projection shape: a kernel that drops
        # the adapter term at that shape, in every layer
        faults = {f"{'/'.join(names)} adapter term dropped": rel_l2(
            torch, M.prefill(drop_adapters(torch, params, names), cfg, pt, plan=plan)[0], lr)
            for names in (("wk", "wv"), ("down",))}
    if not torch.isfinite(lk).all() or not torch.isfinite(lr).all():
        fail("prefill logits not finite")
    ref_err = rel_l2(torch, lk, lr)
    print(f"phase 3: prefill logits, kernel route vs reference route: rel-L2 {ref_err:.4e} "
          f"(limit {ROUTE_TOL:.0e}); planted faults: "
          + ", ".join(f"{k} {v:.4e}" for k, v in faults.items()))
    if not ref_err <= ROUTE_TOL:
        fail(f"kernel route strays from the reference formulation: rel-L2 {ref_err:.3e}")
    if not min(faults.values()) > ROUTE_TOL:
        fail(f"route limit {ROUTE_TOL:.0e} does not reject every planted fault")
    check_parity("native", report, n_req)
    rows[-1].update(kernel_vs_reference_rel_l2=ref_err, planted_faults_rel_l2=faults,
                    divergences=report)
    if on_gpu:
        rows[-1]["decode_tick"] = tick_profile(torch, eng, prompts)
    paths = [("native", counts, expected, None)]
    for kv in ("int8", "nf4"):
        paths.append(quant_path(torch, dev, cfg, params, prompts, gen_len, n_slots, kv,
                                greedy, results, rows))
    return paths


def method_paths(torch, dev, seed: int, rows: list) -> list:
    """The same requests served by the model compressed anew under
    method="nm" and under method="mask" with its NF4 twin (run after the
    bitmap model is freed, so each run's peak memory is its own)."""
    from repro_torch.launch import serve

    prompts = serve.request_prompts(method_cfg(), N_REQ, PROMPT_LEN, seed, shared_prefix=64)
    return [nm_path(torch, dev, seed, prompts, rows),
            mask_nf4_path(torch, dev, seed, prompts, rows)]


def check_tokens(label: str, cfg, greedy, results, n_req: int, gen_len: int) -> None:
    """Every request returned ``gen_len`` in-vocabulary tokens from both
    engines."""
    if greedy.shape != (n_req, gen_len) or not ((greedy >= 0) & (greedy < cfg.vocab_size)).all():
        fail(f"{label}: batch engine tokens: shape {greedy.shape} or out of vocabulary")
    for i in range(n_req):
        toks = results[i].tokens
        if len(toks) != gen_len or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label}: engine request {i}: {len(toks)} tokens or out of vocabulary")


def check_parity(label: str, report: list, n_req: int) -> None:
    """Engine tokens equal greedy tokens up to near-ties
    (``serve.parity_report``)."""
    for d in report:
        router = (f", router margin {d.router_margin:.5g}, limit {d.router_limit:.5g}"
                  if math.isfinite(d.router_margin) else "")
        print(f"phase 3: {label}: request {d.rid} diverges from greedy_generate at step "
              f"{d.step}: top-2 gap {d.gap:.5g}, near-tie limit {d.limit:.5g}{router} -> "
              f"{f'near-tie ({d.near_tie}), accepted' if d.near_tie else 'NOT a near-tie'}")
    if not all(d.near_tie for d in report):
        fail(f"{label}: engine tokens diverge from greedy_generate away from a near-tie")
    print(f"phase 3: {label}: parity: {n_req - len(report)}/{n_req} requests equal "
          f"greedy_generate exactly, {len(report)} diverge at near-ties")


def serve_both(torch, cfg, params, prompts, gen_len: int, n_slots: int, plan,
               engine_plan="same") -> tuple:
    """Both engines over ``prompts``, greedy_generate under ``plan`` and the
    continuous engine under ``engine_plan`` (``"same"``: ``plan``; None: the
    engine resolves its own), the launch counts set to 0 just before and
    read just after.  Returns (greedy tokens, batch seconds, engine,
    results, metrics, launch counts, peak device bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.inference_mode():
        greedy, batch_s = serve.run_batch(cfg, params, prompts, gen_len, len(prompts), plan)
        eng, results, metrics = serve.run_continuous(
            cfg, params, prompts, gen_len, n_slots,
            plan=plan if engine_plan == "same" else engine_plan)
        torch.cuda.synchronize()
    return (greedy, batch_s, eng, results, metrics, dict(ops.LAUNCHES),
            torch.cuda.max_memory_allocated())


def method_cfg(**salr_fields):
    """smollm_135m at full width under other SALR config fields."""
    import dataclasses

    from repro_torch import configs
    cfg = configs.get("smollm_135m")
    return cfg.with_(salr=dataclasses.replace(cfg.salr, **salr_fields))


def _engine_line(label: str, greedy, batch_s: float, metrics: dict, peak: int) -> str:
    return (f"phase 3: {label}: batch engine {greedy.size} tokens in {batch_s:.3f}s "
            f"({greedy.size / batch_s:.1f} tok/s); continuous engine {metrics['total_tokens']} "
            f"tokens in {metrics['wall_s']:.3f}s ({metrics['tok_s']:.1f} tok/s), ttft mean "
            f"{metrics['ttft_mean_s']:.4f}s p50 {metrics['ttft_p50_s']:.4f}s, prefix hit rate "
            f"{metrics['prefix_hit_rate']:.4f}; peak device memory {peak} bytes")


def nm_path(torch, dev, seed: int, prompts, rows: list) -> tuple:
    """(A) method="nm" (2:4), native plan, at ``NM_LAYERS`` layers: the
    model compressed anew from the same seed; wq/wk/wv/gate/up take their N:M masks along d_in and
    run salr_spmm on tiled bitmaps, wo/down keep N:M bases and run
    nm_spmm + fused_lora.  Checks: tokens, engine vs greedy up to
    near-ties, prefill logits of the kernel route within ``ROUTE_TOL`` of
    the reference route and wo/down's adapter term dropped beyond it.
    Returns (path, launch counts, launches expected, None)."""
    from repro_torch.core import execplan
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    from repro_torch.configs.base import LayerGroup

    cfg = method_cfg(method="nm").with_(layer_groups=(LayerGroup(("attn",), NM_LAYERS),))
    label = f"nm (2:4), {NM_LAYERS} layers"
    params, init_s = serve.build_params(cfg, seed, dev)
    plan = execplan.resolve_plan(cfg)
    n_req, n_layers = len(prompts), cfg.n_layers
    greedy, batch_s, eng, results, metrics, counts, peak = serve_both(
        torch, cfg, params, prompts, GEN_LEN, N_SLOTS, plan)
    forwards = GEN_LEN + metrics["n_prefills"] + metrics["n_decode_ticks"]
    # per layer per forward: 5 salr_spmm (wq/wk/wv/gate/up), and wo/down's
    # nm_spmm + fused_lora
    expected = dict.fromkeys(counts, 0)
    expected.update({"salr_spmm": 5 * n_layers * forwards, "nm_spmm": 2 * n_layers * forwards,
                     "fused_lora": 2 * n_layers * forwards,
                     "paged_gqa_attention": n_layers * metrics["n_decode_ticks"]})
    print(f"phase 3: {label}: compressed in {init_s:.2f}s; {serve.route_line(cfg, plan)}")
    print(_engine_line(label, greedy, batch_s, metrics, peak))
    check_tokens(label, cfg, greedy, results, n_req, GEN_LEN)
    with torch.inference_mode():
        pt = torch.from_numpy(prompts[:2]).to(dev)
        lk, _ = M.prefill(params, cfg, pt, plan=plan)
        lr, _ = M.prefill(params, cfg, pt, plan=execplan.resolve_plan(cfg, backend="reference"))
        report = serve.parity_report(cfg, params, prompts, greedy, results, plan)
        fault = rel_l2(torch, M.prefill(drop_adapters(torch, params, ("wo", "down")), cfg, pt,
                                        plan=plan)[0], lr)
    if not torch.isfinite(lk).all() or not torch.isfinite(lr).all():
        fail(f"{label}: prefill logits not finite")
    err = rel_l2(torch, lk, lr)
    print(f"phase 3: {label}: prefill logits, kernel route vs reference route: rel-L2 "
          f"{err:.4e} (limit {ROUTE_TOL:.0e}); planted fault: wo/down adapter term dropped "
          f"{fault:.4e}")
    if not err <= ROUTE_TOL:
        fail(f"{label}: kernel route strays from the reference formulation: rel-L2 {err:.3e}")
    if not fault > ROUTE_TOL:
        fail(f"{label}: route limit {ROUTE_TOL:.0e} does not reject the planted fault")
    check_parity(label, report, n_req)
    rows.append({"main_path": label, "batch_tokens": int(greedy.size), "batch_s": batch_s,
                 "engine": {k: v for k, v in metrics.items() if k != "plan"},
                 "peak_bytes": peak, "compress_s": init_s, "launches": counts,
                 "divergences": report, "kernel_vs_reference_rel_l2": err,
                 "planted_faults_rel_l2": {"wo/down adapter term dropped": fault},
                 "decode_tick": tick_profile(torch, eng, prompts)})
    return label, counts, expected, None


def mask_nf4_path(torch, dev, seed: int, prompts, rows: list) -> tuple:
    """(B) method="mask", decode_repr="nf4", decode KV native: the model
    compressed anew from the same seed with masked dense bases; prefill
    runs every linear as a dense GEMM on them (no kernel), decode serves
    wo/down from their NF4 twins (QDenseWeight) through nf4_spmm +
    fused_lora, and wq/wk/wv/gate/up (no twin) as dense GEMMs.  Checks:
    tokens, engine vs greedy up to near-ties, greedy's decode logits
    replayed on the kernel route within ``TWIN_ROUTE_TOL`` of the
    reference route (the dequantized twin) and down served from its
    native base beyond it.  Returns (path, launch counts, launches
    expected, launches per decode step)."""
    from repro_torch.core import execplan
    from repro_torch.launch import serve

    cfg = method_cfg(method="mask", decode_repr="nf4")
    label = "mask + NF4 twin"
    params, init_s = serve.build_params(cfg, seed, dev)
    twin = sum(t.numel() * t.element_size() for lp in params["layers"]
               for part in ("mixer", "mlp") for lin in lp[part].values()
               if getattr(lin, "qbase", None) is not None
               for t in (lin.qbase.codes, lin.qbase.scales))
    plan = execplan.resolve_plan(cfg)
    n_req, n_layers = len(prompts), cfg.n_layers
    greedy, batch_s, eng, results, metrics, counts, peak = serve_both(
        torch, cfg, params, prompts, GEN_LEN, N_SLOTS, plan)
    steps, ticks = GEN_LEN - 1, metrics["n_decode_ticks"]
    # prefill runs no linear kernel; every decode step runs wo/down's
    # nf4_spmm + fused_lora in each layer
    expected = dict.fromkeys(counts, 0)
    expected.update({"nf4_spmm": 2 * n_layers * (steps + ticks),
                     "fused_lora": 2 * n_layers * (steps + ticks),
                     "paged_gqa_attention": n_layers * ticks})
    print(f"phase 3: {label}: compressed in {init_s:.2f}s, NF4 twin bytes {twin}; "
          f"{serve.route_line(cfg, plan)}")
    print(_engine_line(label, greedy, batch_s, metrics, peak))
    check_tokens(label, cfg, greedy, results, n_req, GEN_LEN)
    if metrics["precision"]["decode"]["repr"] != "nf4":
        fail(f"{label}: the engine ran decode at {metrics['precision']['decode']}")
    with torch.inference_mode():
        report = serve.parity_report(cfg, params, prompts, greedy, results, plan)
    check_parity(label, report, n_req)
    faults = {"down from the native base": (edit_linears(
        params, ("down",), range(cfg.n_layers), lambda lin, _: {"qbase": None}), True)}
    route_err, fault_errs = decode_route_check(torch, cfg, params, prompts, greedy, plan, label,
                                               TWIN_ROUTE_TOL, faults)
    rows.append({"main_path": label, "batch_tokens": int(greedy.size), "batch_s": batch_s,
                 "engine": {k: v for k, v in metrics.items() if k != "plan"},
                 "peak_bytes": peak, "compress_s": init_s, "nf4_twin_bytes": twin,
                 "launches": counts, "divergences": report,
                 "decode_kernel_vs_reference_rel_l2": route_err,
                 "decode_planted_faults_rel_l2": fault_errs,
                 "decode_tick": tick_profile(torch, eng, prompts)})
    per_step = {"nf4_spmm": counts["nf4_spmm"] / (steps + ticks),
                "fused_lora": counts["fused_lora"] / (steps + ticks),
                "paged_gqa_attention per engine tick": counts["paged_gqa_attention"] / ticks,
                "salr_spmm + qsalr_spmm": counts["salr_spmm"] + counts["qsalr_spmm"]}
    return label, counts, expected, per_step


def granite_paths(torch, dev, seed: int, rows: list) -> list:
    """Serve granite_moe_1b_a400m at full width (24 layers, 32 experts,
    top-8) with the same 8 requests as the smollm runs: compressed once on
    the GPU from seeded weights with the NF4 twin of every projection and
    expert stack, under the native plan, then decode from the NF4 twin
    with int8 decode KV (prefill native); then compressed anew under (C)
    ``method="nm"`` and (D) ``method="mask"``, each under the native
    plan, each model freed before the next is built.  greedy_generate
    keeps its own plan (prefill at 4096 tokens and decode at 1: the
    grouped kernels); the continuous engine resolves its own at 8 slots
    and its largest bucket (160: the decode-grid kernels), so engine vs
    greedy crosses the two MoE routes.  Returns (path, launch counts,
    launches expected, launches per decode step) for each run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve

    base = configs.get("granite_moe_1b_a400m")
    prompts = serve.request_prompts(base, N_REQ, PROMPT_LEN, seed, shared_prefix=64)
    cfg = base.with_(salr=dataclasses.replace(base.salr, dual_repr=True))
    out = _granite_bitmap(torch, dev, seed, cfg, prompts, rows)
    gc.collect()
    for label, method in (("granite (C) nm (2:4)", "nm"), ("granite (D) mask", "mask")):
        mcfg = base.with_(salr=dataclasses.replace(base.salr, method=method))
        out.append(_granite_method(torch, dev, seed, label, mcfg, prompts, rows))
        gc.collect()
    return out


def _granite_build(torch, dev, seed: int, cfg, label: str) -> tuple:
    """Compress granite under ``cfg`` on ``dev``; print its sizes.  Returns
    (params, compress seconds, parameter bytes, NF4 twin bytes)."""
    from repro_torch.launch import serve

    params, init_s = serve.build_params(cfg, seed, dev)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    twin = sum(t.numel() * t.element_size() for lp in params["layers"]
               for part in ("mixer", "moe") for lin in lp[part].values()
               if getattr(lin, "qbase", None) is not None
               for t in (lin.qbase.codes, lin.qbase.scales))
    print(f"phase 3: {label}: compressed {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts, top-{cfg.experts_per_token}, method "
          f"{cfg.salr.method}) on {dev} in {init_s:.2f}s; parameter bytes {nbytes}, of which "
          f"NF4 codes and scales {twin}")
    return params, init_s, nbytes, twin


def _granite_faults(torch, params) -> dict:
    """Planted faults: the adapter term of every down expert dropped; one
    layer's router picking (top_i + 1) % E."""
    return {"down experts' adapter term dropped": drop_adapters(torch, params, ("down",),
                                                                part="moe"),
            "layer 0 routes to top_i + 1": roll_router(torch, params, 0)}


def _moe_serve(torch, label: str, cfg, params, prompts, rows: list, expected_of,
               faults: dict, quant: bool, row_extra: dict) -> tuple:
    """One MoE-arch run (granite, deepseek): both engines (greedy_generate
    on the grouped route, the engine at ``MOE_SLOTS`` slots on the decode
    grid), tokens, parity, the route check (prefill; under a quantized
    plan the replayed decode) with its planted faults, and the decode
    tick's profile.  ``expected_of(steps, ticks, prefills, hits)`` gives
    the nonzero launch counts the run must show (``hits``: the engine's
    prefills that continued a shared prefix).  Returns (launch counts,
    launches expected)."""
    from repro_torch.core import execplan
    from repro_torch.launch import serve

    plan = execplan.resolve_plan(cfg)
    greedy, batch_s, eng, results, metrics, counts, peak = serve_both(
        torch, cfg, params, prompts, GEN_LEN, MOE_SLOTS, plan, engine_plan=None)
    steps, ticks, prefills = GEN_LEN - 1, metrics["n_decode_ticks"], metrics["n_prefills"]
    routes = {ph: (plan.moe_route(ph), eng.plan.moe_route(ph)) for ph in ("prefill", "decode")}
    if routes != {"prefill": ("grouped", "decode_grid"), "decode": ("grouped", "decode_grid")}:
        fail(f"{label}: MoE routes (greedy, engine) {routes}")
    expected = dict.fromkeys(counts, 0)
    expected.update(expected_of(steps, ticks, prefills, metrics["n_prefix_hits"]))
    print(f"phase 3: {label}: greedy_generate {serve.route_line(cfg, plan)}")
    print(f"phase 3: {label}: continuous engine ({MOE_SLOTS} slots) "
          f"{serve.route_line(cfg, eng.plan)}")
    print(_engine_line(label, greedy, batch_s, metrics, peak))
    check_tokens(label, cfg, greedy, results, N_REQ, GEN_LEN)
    with torch.inference_mode():
        report = serve.parity_report(cfg, params, prompts, greedy, results, plan)
    check_parity(label, report, N_REQ)
    row = {"main_path": label, "batch_tokens": int(greedy.size), "batch_s": batch_s,
           "engine": {k: v for k, v in metrics.items() if k != "plan"},
           "engine_plan": eng.plan.describe(), "peak_bytes": peak, "launches": counts,
           "divergences": report, **row_extra}
    if quant:
        err, errs = decode_route_check(torch, cfg, params, prompts, greedy, plan, label,
                                       QROUTE_TOL["int8"],
                                       {k: (fp, True) for k, fp in faults.items()})
        row.update(decode_kernel_vs_reference_rel_l2=err, decode_planted_faults_rel_l2=errs)
    else:
        err, errs = prefill_route_check(torch, cfg, params, prompts, plan, label, faults)
        row.update(kernel_vs_reference_rel_l2=err, planted_faults_rel_l2=errs)
    row["decode_tick"] = tick_profile(torch, eng, prompts)
    rows.append(row)
    return counts, expected


def _granite_bitmap(torch, dev, seed: int, cfg, prompts, rows: list) -> list:
    """The bitmap model with its NF4 twins: the native run and the twin
    run with int8 decode KV."""
    import dataclasses

    params, init_s, nbytes, twin = _granite_build(torch, dev, seed, cfg, "granite bitmap")
    faults = _granite_faults(torch, params)
    n_layers = cfg.n_layers
    out = []
    for label, qcfg in (("granite native", cfg),
                        ("granite bitmap_nf4 + int8 KV", cfg.with_(
                            decode_kv_cache="int8",
                            salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4")))):
        quant = qcfg is not cfg
        q = "q" if quant else ""

        # per forward: 4 attention projections (salr_spmm, the twin's
        # qsalr_spmm at a quantized decode) and 3 expert stacks per layer
        # (greedy: grouped; the engine: decode grid); one decode attention
        # per layer and decode step (greedy: the int8 ring under the twin
        # plan, plain attention under the native one; the engine: paged)
        def expected_of(steps, ticks, prefills, _hits, q=q, quant=quant):
            e = collections.Counter({"salr_spmm": 4 * n_layers * (1 + prefills),
                                     "grouped_salr_spmm": 3 * n_layers,
                                     "decode_salr_spmm": 3 * n_layers * prefills})
            e[q + "salr_spmm"] += 4 * n_layers * (steps + ticks)
            e[f"grouped_{q}salr_spmm"] += 3 * n_layers * steps
            e[f"decode_{q}salr_spmm"] += 3 * n_layers * ticks
            if quant:
                e.update({"ring_quant_gqa_attention": n_layers * steps,
                          "paged_quant_gqa_attention": n_layers * ticks})
            else:
                e["paged_gqa_attention"] = n_layers * ticks
            return e
        counts, expected = _moe_serve(
            torch, label, qcfg, params, prompts, rows, expected_of, faults, quant,
            {"param_bytes": nbytes, "nf4_twin_bytes": twin, "compress_s": init_s})
        per_step = {f"grouped_{q}salr_spmm per greedy step": 3 * n_layers,
                    f"decode_{q}salr_spmm per engine tick": 3 * n_layers,
                    f"{q}salr_spmm per decode step": 4 * n_layers}
        out.append((label, counts, expected, per_step))
    return out


def _granite_method(torch, dev, seed: int, label: str, cfg, prompts, rows: list) -> tuple:
    """(C) ``method="nm"``: wq/wk/wv take their 2:4 masks along d_in and run
    salr_spmm on tiled bitmaps, wo keeps its 2:4 base (nm_spmm +
    fused_lora), the expert stacks their 2:4 bases (grouped_nm_spmm /
    decode_nm_spmm).  (D) ``method="mask"``: the attention projections run
    dense GEMMs on their masked bases (no kernel), the expert stacks
    grouped_dense_spmm / decode_dense_spmm.  Native plan; prefill logits
    of the kernel route within ``ROUTE_TOL`` of the reference route (the
    dense masked experts, plain attention), both planted faults beyond."""
    params, init_s, nbytes, _ = _granite_build(torch, dev, seed, cfg, label)
    n_layers = cfg.n_layers
    nm = cfg.salr.method == "nm"
    family = "nm" if nm else "dense"

    # per forward: the 3 expert stacks of each layer (greedy: grouped; the
    # engine: decode grid) and, under nm, wq/wk/wv's salr_spmm and wo's
    # nm_spmm + fused_lora; one paged attention per layer and engine tick
    def expected_of(steps, ticks, prefills, _hits):
        forwards = 1 + steps + prefills + ticks
        e = {f"grouped_{family}_spmm": 3 * n_layers * (1 + steps),
             f"decode_{family}_spmm": 3 * n_layers * (prefills + ticks),
             "paged_gqa_attention": n_layers * ticks}
        if nm:
            e.update({"salr_spmm": 3 * n_layers * forwards, "nm_spmm": n_layers * forwards,
                      "fused_lora": n_layers * forwards})
        return e
    counts, expected = _moe_serve(torch, label, cfg, params, prompts, rows, expected_of,
                                      _granite_faults(torch, params), False,
                                      {"param_bytes": nbytes, "compress_s": init_s})
    per_step = {f"grouped_{family}_spmm per greedy step": 3 * n_layers,
                f"decode_{family}_spmm per engine tick": 3 * n_layers}
    if nm:
        per_step.update({"salr_spmm per decode step": 3 * n_layers,
                         "nm_spmm + fused_lora per decode step": 2 * n_layers})
    return label, counts, expected, per_step


def deepseek_cfg():
    """deepseek_v3_671b at its published widths, cut to ``DEEPSEEK_LAYERS``
    layers: the first layer of each of its LayerGroups (a dense MLA +
    SwiGLU layer, then an MLA + MoE layer with 256 routed experts, top-8,
    and the shared expert)."""
    import dataclasses

    from repro_torch import configs

    base = configs.get("deepseek_v3_671b")
    groups = tuple(dataclasses.replace(g, repeats=1)
                   for g in base.layer_groups[:DEEPSEEK_LAYERS])
    return base.with_(layer_groups=groups, first_dense_layers=1)


def deepseek_path(torch, dev, seed: int, rows: list) -> tuple:
    """(E) deepseek_v3_671b at published width, ``DEEPSEEK_LAYERS`` layers,
    compressed on the GPU from seeded weights (bitmap, p = 0.5, R = 128,
    the expert stacks drawn and compressed in chunks along E), served by
    greedy_generate (a dense slot latent cache: MLA's plain attention
    branch; the grouped expert kernels) and by the continuous engine at
    ``MOE_SLOTS`` slots (paged latent pools with prefix sharing:
    ``paged_mla_attention``; the decode-grid expert kernels).  Prefill
    logits of the kernel route within ``ROUTE_TOL`` of the reference
    route, wo's adapter term dropped beyond it."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = deepseek_cfg()
    prompts = serve.request_prompts(cfg, N_REQ, PROMPT_LEN, seed, shared_prefix=64)
    params, init_s = serve.build_params(cfg, seed, dev)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    kinds = M.layer_kinds(cfg)
    n_layers = len(kinds)
    n_moe = sum(mlp == "moe" for _, mlp in kinds)
    label = "deepseek (E)"
    print(f"phase 3: {label}: compressed {cfg.name} at {n_layers} of its 61 layers "
          f"({kinds}; d_model {cfg.d_model}, {cfg.n_heads} heads, MLA q_lora "
          f"{cfg.mla.q_lora_rank} kv_lora {cfg.mla.kv_lora_rank}, {cfg.n_experts} experts "
          f"top-{cfg.experts_per_token} + {cfg.n_shared_experts} shared) on {dev} in "
          f"{init_s:.2f}s; parameter bytes {nbytes}")

    # per forward and MLA layer: dq, uq, dkv and wo through salr_spmm, uk and
    # uv too at prefill (twice over a shared prefix, which is decompressed
    # again) but not at decode (absorbed); the dense MLP's or the shared
    # expert's 3; an MoE layer's 3 expert stacks (greedy: grouped; the
    # engine: decode grid); one paged_mla_attention per layer and tick
    def expected_of(steps, ticks, prefills, hits):
        ffn = 3 * n_layers
        e = {"salr_spmm": ((6 * n_layers + ffn) * (1 + prefills) + 2 * n_layers * hits
                           + (4 * n_layers + ffn) * (steps + ticks)),
             "paged_mla_attention": n_layers * ticks}
        if n_moe:
            e.update(grouped_salr_spmm=3 * n_moe * (1 + steps),
                     decode_salr_spmm=3 * n_moe * (prefills + ticks))
        return e
    faults = {"wo's adapter term dropped": drop_adapters(torch, params, ("wo",),
                                                         part="mixer")}
    counts, expected = _moe_serve(torch, label, cfg, params, prompts, rows, expected_of,
                                  faults, False, {"param_bytes": nbytes, "compress_s": init_s,
                                                  "layers": n_layers})
    per_step = {"salr_spmm per decode step": 4 * n_layers + 3 * n_layers,
                "paged_mla_attention per engine tick": n_layers}
    if n_moe:
        per_step.update({"grouped_salr_spmm per greedy step": 3 * n_moe,
                         "decode_salr_spmm per engine tick": 3 * n_moe})
    return label, counts, expected, per_step


def prefill_route_check(torch, cfg, params, prompts, plan, label: str, faults: dict) -> tuple:
    """Prefill logits of 2 prompts, kernel route vs reference route, within
    ``ROUTE_TOL``; every planted fault (params) on the kernel route beyond
    it.  Returns (rel-L2, {fault: rel-L2})."""
    from repro_torch.core import execplan
    from repro_torch.models import model as M

    pt = torch.from_numpy(prompts[:2]).to(M.params_device(params))
    with torch.inference_mode():
        lk, _ = M.prefill(params, cfg, pt, plan=plan)
        lr, _ = M.prefill(params, cfg, pt, plan=execplan.resolve_plan(cfg, backend="reference"))
        errs = {k: rel_l2(torch, M.prefill(fp, cfg, pt, plan=plan)[0], lr)
                for k, fp in faults.items()}
    if not torch.isfinite(lk).all() or not torch.isfinite(lr).all():
        fail(f"{label}: prefill logits not finite")
    err = rel_l2(torch, lk, lr)
    print(f"phase 3: {label}: prefill logits, kernel route vs reference route: rel-L2 {err:.4e} "
          f"(limit {ROUTE_TOL:.0e}); planted faults: "
          + ", ".join(f"{k} {v:.4e}" for k, v in errs.items()))
    if not err <= ROUTE_TOL:
        fail(f"{label}: kernel route strays from the reference formulation: rel-L2 {err:.3e}")
    if not min(errs.values()) > ROUTE_TOL:
        fail(f"{label}: route limit {ROUTE_TOL:.0e} does not reject every planted fault")
    return err, errs


def roll_router(torch, params, layer: int):
    """A copy of ``params`` whose MoE router in ``layer`` has its expert
    columns rolled by one, so every token there routes to (top_i + 1) % E
    with the same weights."""
    layers = list(params["layers"])
    lp = dict(layers[layer])
    lp["moe"] = {**lp["moe"], "router": {"w": torch.roll(lp["moe"]["router"]["w"], 1, dims=1)}}
    layers[layer] = lp
    return {**params, "layers": layers}


def quant_path(torch, dev, cfg, params, prompts, gen_len: int, n_slots: int, kv: str,
               native_greedy, native_results, rows: list) -> tuple:
    """Serve the same requests under a mixed-precision plan: decode
    linears from the NF4 twin (``qsalr_spmm``), decode KV in ``kv``
    (int8 or NF4: quantized paged pools for the engine, a quantized dense
    cache for greedy_generate), prefill native.  Checks: in-vocabulary
    tokens, no prefix sharing, every request's first token equal to the
    native run's (prefill is native), engine tokens equal to
    greedy_generate's under the same plan up to near-ties.  Returns
    (path, launch counts, launches expected, launches per decode step)."""
    import dataclasses

    from repro_torch.core import execplan
    from repro_torch.launch import serve

    qcfg = cfg.with_(decode_kv_cache=kv,
                     salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4"))
    plan = execplan.resolve_plan(qcfg)
    n_req, n_layers = len(prompts), cfg.n_layers
    label = f"bitmap_nf4 + {kv} KV"
    greedy, batch_s, eng, results, metrics, counts, peak = serve_both(
        torch, qcfg, params, prompts, gen_len, n_slots, plan)
    steps, ticks = gen_len - 1, metrics["n_decode_ticks"]
    ring, paged = (("ring_quant_gqa_attention", "paged_quant_gqa_attention") if kv == "int8"
                   else ("ring_nf4_gqa_attention", "paged_nf4_gqa_attention"))
    # prefill (one batch prefill, one per admission) stays on salr_spmm;
    # every decode step runs 7 qsalr_spmm and one quantized attention per
    # layer: ring in greedy_generate, paged in the engine
    expected = dict.fromkeys(counts, 0)
    expected.update({"salr_spmm": 7 * n_layers * (1 + metrics["n_prefills"]),
                     "qsalr_spmm": 7 * n_layers * (steps + ticks),
                     ring: n_layers * steps, paged: n_layers * ticks})
    print(f"phase 3: {label}: {serve.route_line(qcfg, plan)}")
    print(_engine_line(label, greedy, batch_s, metrics, peak))
    check_tokens(label, cfg, greedy, results, n_req, gen_len)
    if eng.sharable or metrics["prefix_hit_rate"] != 0.0:
        fail(f"{label}: prefix sharing must be off with quantized decode KV")
    if metrics["precision"]["decode"] != {"repr": "bitmap_nf4", "kv_dtype": kv}:
        fail(f"{label}: the engine ran decode at {metrics['precision']['decode']}")
    first_native = [native_results[i].tokens[0] for i in range(n_req)]
    if ([results[i].tokens[0] for i in range(n_req)] != first_native
            or greedy[:, 0].tolist() != native_greedy[:, 0].tolist()):
        fail(f"{label}: a first token differs from the native run's (prefill is native)")
    eng_toks = [results[i].tokens for i in range(n_req)]
    nat_toks = [native_results[i].tokens for i in range(n_req)]
    agree_eng = sum(a == b for r, n in zip(eng_toks, nat_toks) for a, b in zip(r, n))
    agree_batch = int((greedy == native_greedy).sum())
    total = n_req * gen_len
    print(f"phase 3: {label}: tokens agreeing with the native run: engine "
          f"{agree_eng}/{total} ({agree_eng / total:.4f}), batch {agree_batch}/{total} "
          f"({agree_batch / total:.4f}); first tokens all equal")
    with torch.inference_mode():
        report = serve.parity_report(qcfg, params, prompts, greedy, results, plan)
    check_parity(label, report, n_req)
    n = len(params["layers"])
    faults = {   # (params with the fault, whether the limit must reject it)
        "down from the native base": (edit_linears(
            params, ("down",), range(n), lambda lin, _: {"qbase": None}), kv == "int8"),
        "layers 0 and 1 twins swapped": (edit_linears(
            params, PROJECTIONS, (0, 1), lambda lin, other: {"qbase": other.qbase}), True),
        "wk/wv from the native base": (edit_linears(
            params, ("wk", "wv"), range(n), lambda lin, _: {"qbase": None}), False),
    }
    route_err, faults = decode_route_check(torch, qcfg, params, prompts, greedy, plan, label,
                                           QROUTE_TOL[kv], faults)
    rows.append({"main_path": label, "batch_tokens": int(greedy.size), "batch_s": batch_s,
                 "engine": {k: v for k, v in metrics.items() if k != "plan"},
                 "peak_bytes": peak, "launches": counts, "divergences": report,
                 "decode_kernel_vs_reference_rel_l2": route_err,
                 "decode_planted_faults_rel_l2": faults,
                 "agree_with_native": {"engine": agree_eng / total,
                                       "batch": agree_batch / total},
                 "decode_tick": tick_profile(torch, eng, prompts)})
    # the quantized decode tick as counted: per engine tick, per
    # greedy_generate step, and the salr_spmm launches left after prefill
    per_step = {"qsalr_spmm": counts["qsalr_spmm"] / (steps + ticks),
                paged + " per engine tick": counts[paged] / ticks,
                ring + " per greedy_generate step": counts[ring] / steps,
                "salr_spmm at decode": counts["salr_spmm"]
                - 7 * n_layers * (1 + metrics["n_prefills"])}
    return label, counts, expected, per_step


def decode_route_check(torch, cfg, params, prompts, greedy, plan, label: str, tol: float,
                       faults: dict) -> tuple:
    """Decode logits of a mixed-precision plan, kernel route vs reference
    route: greedy's first ``QROUTE_STEPS`` decode steps of 4 requests
    replayed on each route (``replay_logits``), rel-L2 within ``tol``.
    The kernel route runs the plan's decode kernels, the reference route
    the dequantized twin and the plain attention, each on its own KV
    cache.  ``faults``: {name: (params with a planted wiring fault, whether
    the limit must reject it)}, each replayed on the kernel route.
    Returns (rel-L2, {fault: rel-L2})."""
    from repro_torch.core import execplan
    from repro_torch.models import model as M
    from repro_torch.train.step import replay_logits

    dev = M.params_device(params)
    pt = torch.from_numpy(prompts[:4]).to(dev)
    toks = torch.from_numpy(greedy[:4, :QROUTE_STEPS + 1]).to(dev)
    ref_plan = execplan.resolve_plan(cfg, backend="reference")

    def decode_logits(p, pl):                     # step 0 is the native prefill's
        return replay_logits(p, cfg, pt, toks, plan=pl)[:, 1:]
    with torch.inference_mode():
        lr = decode_logits(params, ref_plan)
        lk = decode_logits(params, plan)
        faults = {k: (rel_l2(torch, decode_logits(fp, plan), lr), checked)
                  for k, (fp, checked) in faults.items()}
    if not torch.isfinite(lk).all() or not torch.isfinite(lr).all():
        fail(f"{label}: decode logits not finite")
    err = rel_l2(torch, lk, lr)
    print(f"phase 3: {label}: decode logits ({QROUTE_STEPS} steps), kernel route vs "
          f"reference route: rel-L2 {err:.4e} (limit {tol:.0e}); planted faults: "
          + ", ".join(f"{k} {v:.4e}{'' if c else ' (reported only)'}"
                      for k, (v, c) in faults.items()))
    if not err <= tol:
        fail(f"{label}: kernel route strays from the reference formulation at decode: "
             f"rel-L2 {err:.3e}")
    if not all(v > tol for v, c in faults.values() if c):
        fail(f"{label}: decode route limit {tol:.0e} does not reject every checked "
             "planted fault")
    return err, {k: v for k, (v, _) in faults.items()}


PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def edit_linears(params, names: tuple, layers, edit, parts=("mixer", "mlp")):
    """A copy of ``params`` in which each projection ``names`` (under the
    layer keys ``parts``) of each layer in ``layers`` gets the fields
    ``edit(lin, other)`` returns (a dict): ``lin`` is the projection,
    ``other`` the same projection of the layer ``layers`` lists next
    (cyclically)."""
    import dataclasses

    layers = list(layers)
    src = params["layers"]
    out = [{k: dict(v) if isinstance(v, dict) else v for k, v in lp.items()} for lp in src]
    for i, l in enumerate(layers):
        o = layers[(i + 1) % len(layers)]
        for part in parts:
            for name in set(names) & set(src[l][part]):
                lin = src[l][part][name]
                out[l][part][name] = dataclasses.replace(lin, **edit(lin, src[o][part][name]))
    return {**params, "layers": out}


def drop_adapters(torch, params, names: tuple, part=None):
    """A copy of ``params`` in which projections ``names`` (expert stacks
    with ``part="moe"``) of every layer lose their adapter term (LoRA and
    residual B set to zero)."""
    import dataclasses

    def drop(ad):
        return None if ad is None else dataclasses.replace(ad, b=torch.zeros_like(ad.b))
    return edit_linears(params, names, range(len(params["layers"])),
                        lambda lin, _: {"lora": drop(lin.lora), "res": drop(lin.res)},
                        **({"parts": (part,)} if part else {}))


def tick_profile(torch, eng, prompts) -> dict:
    """Where a decode tick's time goes: the continuous engine with all
    slots busy, ``n`` ticks timed on the host clock, then three more
    windows of ``n`` ticks traced by the profiler (device activity only;
    the trace holding the most device records is kept, as a trace can
    miss some) for the device-busy share and the device time per kernel
    family."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.engine import Request

    n_slots, windows = eng.ecfg.n_slots, 3
    # ticks per window: 6, or what the context leaves beside the admissions
    n = min(6, (eng.ecfg.max_ctx - len(prompts[0]) - n_slots - 1) // (windows + 1))
    eng.reset()
    for i in range(n_slots):
        eng.submit(Request(rid=i, prompt=tuple(int(t) for t in prompts[i]),
                           max_new_tokens=(windows + 1) * n + n_slots + 1))
    with torch.inference_mode():
        for _ in range(n_slots):                 # admissions, one per tick
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        best: tuple = (-1, {})
        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    eng.step()
                torch.cuda.synchronize()
            by_name: dict = {}
            counts: dict = {}
            device_us(torch, prof, by_name, counts)
            if sum(counts.values()) > best[0]:
                best = (sum(counts.values()), by_name)
    if best[0] == 0:
        print(f"phase 3: decode tick: the profiler recorded no device activity in "
              f"{windows} windows; the device split is not measured")
    by_name = best[1]
    busy_ms = sum(by_name.values()) / n / 1e3
    # salr_spmm.cu's two ops share kernel names; the NF4 loader in the
    # template arguments marks qsalr_spmm's, so it is matched first (after
    # the expert kernels, whose row map names them).  The nm_spmm_kernel
    # and nf4_spmm_kernel prefixes cover each op's split-K kernels
    # (*_splitk, *_rows), its own reduce pass (*_reduce) and its f32 column
    # GEMM
    families = {"grouped expert kernels": ("TileMap",),
                "decode-grid expert kernels": ("RowMap",),
                "qsalr_spmm": ("NF4Values",),
                "salr_spmm": ("salr_spmm_kernel", "adapter_u_kernel"),
                "nm_spmm": ("nm_spmm_kernel",),
                "fused_lora": ("fused_lora_kernel",),
                "nf4_spmm": ("nf4_spmm_kernel",),
                "paged_gqa_attention": ("paged_gqa_kernel",),
                "paged_mla_attention": ("paged_mla_kernel",),
                "quantized attention": ("quant_gqa_kernel",)}
    split = {f: 0.0 for f in (*families, "other")}
    for name, us in by_name.items():
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "other")
        split[fam] += us / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"slots_active": n_slots, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_records": best[0],
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "device_ms_by_family": split,
           "top_kernels_ms": {k: v / n / 1e3 for k, v in top}}
    print(f"phase 3: decode tick ({n_slots} slots): {wall_ms:.3f} ms wall, device busy "
          f"{busy_ms:.3f} ms, by family "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    return out


def _tensors(obj):
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = build.build_all()
    for name in build.KERNELS:
        build.load(name)
    print(f"phase 1: built {', '.join(build.KERNELS)} in {build_s:.2f}s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(torch)
    rows: list = []
    with torch.inference_mode():
        spmm = spmm_checks(torch, timer, gen, rows)
        paged = paged_checks(torch, timer, gen, rows)
        qsalr = qsalr_checks(torch, timer, gen, rows)
        mla = mla_checks(torch, timer, gen, rows)
        quant_att = quant_attention_checks(torch, timer, gen, rows)
        methods = method_checks(torch, timer, gen, rows)
        moe_k = moe_checks(torch, timer, gen, rows)
        deepseek_moe_checks(torch, timer, gen, rows)
    print(f"phase 2: every kernel agrees with its plain version "
          f"({time.perf_counter() - t_start:.1f}s); {Timer.by_events} timed functions "
          f"fell back to CUDA events")

    paths = main_path(torch, torch.device("cuda"), args.seed, rows)
    gc.collect()                  # the bitmap model goes before the next two
    paths += method_paths(torch, torch.device("cuda"), args.seed, rows)
    gc.collect()
    print(f"phase 3: smollm_135m runs done ({time.perf_counter() - t_start:.1f}s)")
    paths += granite_paths(torch, torch.device("cuda"), args.seed, rows)
    gc.collect()
    print(f"phase 3: granite_moe_1b_a400m runs done ({time.perf_counter() - t_start:.1f}s)")
    paths.append(deepseek_path(torch, torch.device("cuda"), args.seed, rows))
    gc.collect()
    print(f"phase 3: deepseek_v3_671b run done ({time.perf_counter() - t_start:.1f}s)")
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for path, counts, expected, per_step in paths:
        for name, n in counts.items():
            if n != expected[name]:
                fail(f"{path} path launched {name} {n} times, expected {expected[name]}")
            launches[name] += n
        print(f"phase 4: {path} path launches {({k: v for k, v in counts.items() if v})}")
        if per_step:
            print(f"phase 4: {path}: per decode step {per_step}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was launched no time on the main path")

    sources = {"salr_spmm": ("src/repro_torch/csrc/salr_spmm.cu",
                             "src/repro/kernels/salr_spmm.py:74", spmm["salr_spmm"]),
               "bitmap_spmm": ("src/repro_torch/csrc/bitmap_spmm.cu",
                               "src/repro/kernels/bitmap_spmm.py:68", spmm["bitmap_spmm"]),
               "paged_gqa_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                       "src/repro/kernels/paged_attention.py:98", paged),
               "paged_mla_attention": ("src/repro_torch/csrc/mla_attention.cu",
                                       "src/repro/kernels/paged_attention.py:331", mla),
               "qsalr_spmm": ("src/repro_torch/csrc/salr_spmm.cu",
                              "src/repro/kernels/qsalr_spmm.py:89", qsalr),
               **{name: ("src/repro_torch/csrc/quant_attention.cu",
                         f"src/repro/kernels/{rep}", quant_att[name])
                  for name, rep in (("ring_quant_gqa_attention", "ring_attention.py:77"),
                                    ("paged_quant_gqa_attention", "paged_attention.py:175"),
                                    ("ring_nf4_gqa_attention", "ring_attention.py:142"),
                                    ("paged_nf4_gqa_attention", "paged_attention.py:259"))},
               **{name: (f"src/repro_torch/csrc/{name}.cu", f"src/repro/kernels/{rep}",
                         methods[name])
                  for name, rep in (("nm_spmm", "nm_spmm.py:59"),
                                    ("fused_lora", "fused_lora.py:43"),
                                    ("nf4_spmm", "nf4_spmm.py:49"))},
               **{name: ("src/repro_torch/csrc/grouped_spmm.cu",
                         f"src/repro/kernels/grouped_spmm.py:{line}", moe_k[name])
                  for name, line in (("grouped_salr_spmm", 281), ("grouped_qsalr_spmm", 313),
                                     ("decode_salr_spmm", 578), ("decode_qsalr_spmm", 605),
                                     ("grouped_dense_spmm", 256), ("grouped_nm_spmm", 344),
                                     ("decode_dense_spmm", 554), ("decode_nm_spmm", 633))}}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                "shape": s["shape"]}
               for name, (src, rep, s) in sources.items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "build_s": build_s,
                                              "rows": rows,
                                              "timed_by_events": Timer.by_events,
                                              "kernels": kernels}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
