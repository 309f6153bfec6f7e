#!/usr/bin/env python3
"""Device time per call of the SpMM kernels of one checkout, for A/B runs.

    python3 spmm_ab.py TREE LABEL [--only GROUP,...] [--plan-sms N]
                                  [--dispatch rows|slices]

Imports ``repro_torch`` and ``chip_smoke.Timer`` from the checkout at
TREE (building its kernels there), times in bf16 (profiler device time,
L2 flushed, median of 3 traces) the groups of kernels ``--only`` names
(default: all), and prints one JSON line tagged LABEL:

- ``tiled``: ``salr_spmm``, ``qsalr_spmm`` and ``bitmap_spmm`` at
  smollm_135m's four projection shapes at M = 4, 8 and 1024 (with
  ``--dispatch``: 4, 8 and 256 to 1024), and
  ``salr_spmm`` and ``qsalr_spmm`` at deepseek_v3_671b's wo (16384 ->
  7168) and gate/up (7168 -> 18432) at M = 8 (R = 128);
- ``splitk``: ``nm_spmm`` and ``nf4_spmm`` at smollm_135m's wo and down
  at M = 4, 8 and 256 to 1024, ``nm_spmm`` at granite_moe_1b_a400m's wo
  at M = 8 and 256 to 1024;
- ``lora``: ``fused_lora`` (R = 128) at smollm_135m's wo and down and
  granite_moe_1b_a400m's wo at M = 4 to 1024;
- ``experts``: the eight expert kernels, tiled bitmap plain and NF4, 2:4
  and masked dense (``grouped_salr_spmm``, ``decode_salr_spmm``,
  ``grouped_qsalr_spmm``, ``decode_qsalr_spmm``, ``grouped_nm_spmm``,
  ``decode_nm_spmm``, ``grouped_dense_spmm``, ``decode_dense_spmm``), at
  granite_moe_1b_a400m's gate/up and down stacks (E 32, top-8, R = 128)
  at 8 tokens (64 rows) and 128 tokens (decode: 1024 rows) or 1024
  tokens (grouped: 8192 rows);
- ``deepseek``: ``grouped_salr_spmm`` and ``decode_salr_spmm`` at
  deepseek_v3_671b's gate/up and down stacks (E 256, top-8, R = 128,
  ``chip_smoke._ds_stack``) at 8 tokens (64 rows);
- ``attention``: the four quantized decode-attention kernels
  (``ring_quant_gqa_attention``, ``paged_quant_gqa_attention``,
  ``ring_nf4_gqa_attention``, ``paged_nf4_gqa_attention``) and, as an
  untouched control, ``paged_gqa_attention`` over bf16 pools, at
  ``chip_smoke.py`` phase 2's shape (smollm_135m's heads, page size 8, 4
  slots in a 160-position context, 300 live positions) and at its long
  context (8 slots, 2048 positions, all live), on the inputs this
  checkout's ``chip_smoke.qa_inputs`` makes;
- ``llama``: llama3_8b_proxy's four projection shapes (wq/wo 4096 ->
  4096, wk/wv 4096 -> 1024, gate/up 4096 -> 14336, down 14336 -> 4096)
  at M = 8 (Table 4's decode batch) under three ops: the bitmap SALR op
  (``salr_spmm``, R = 128), the 2:4 SALR op (``nm_spmm`` + ``fused_lora``
  and their sum, as the model runs it) and the dense ``x @ W``, each with
  its byte bound and its rel-L2 against its plain version and, beside
  the plain version's own, against the op's roundings on f64 sums; and
  ``paged_gqa_attention`` beside SDPA (over K/V gathered and
  head-expanded beforehand) at 8 slots x 2048 live positions, page size
  8, at smollm_135m's heads (9 query, 3 KV, d 64) and llama3_8b_proxy's
  (32, 8, 128);
- ``host``: the host's microseconds per call (host clock over 300 calls,
  one synchronize, best of 5) of ``salr_matmul``, ``qsalr_matmul`` and,
  as a control, ``nm_matmul`` at smollm_135m's gate/up (down for
  ``nm_matmul``) at M = 4, where the device finishes each call before
  the host has issued the next: the wrapper's cost, which sets a
  host-bound decode tick.

Each call is also split by the kernels it launches;
an expert call also gives its rel-L2 against its plain version.
``--plan-sms N`` cuts K for ``nm_spmm``, ``nf4_spmm``, ``salr_spmm``,
``qsalr_spmm`` and ``bitmap_spmm`` (``ops.splitk_plan``; a tree whose
``bitmap_spmm`` takes a plan), and a quantized attention call's
context (``ops.attention_plan``, a tree that has it), as on a card of N
SMs instead of this card's count; ``--dispatch`` takes their rows or their slices
dispatch at every M instead of the one ``ops._walks_rows`` picks (a
tree that has it).  To compare two
versions, unpack each into its own directory (``git archive``) and
alternate their runs, one process each, back to back on one GPU.
"""
import importlib.util
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
from repro_torch.kernels import build, ops, ref  # noqa: E402

assert Path(ops.__file__).resolve().is_relative_to(root)
GROUPS = ("tiled", "splitk", "lora", "experts", "deepseek", "attention", "llama", "host")
only = (sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv
        else GROUPS)
assert set(only) <= set(GROUPS), only
if "--plan-sms" in sys.argv:
    plan_sms = int(sys.argv[sys.argv.index("--plan-sms") + 1])
    ops._sm_count = lambda device: plan_sms
if "--dispatch" in sys.argv:
    walk_rows = sys.argv[sys.argv.index("--dispatch") + 1] == "rows"
    ops._walks_rows = lambda *args: walk_rows
# the kernels each group calls: only their sources are built
NEEDS = {"tiled": ("salr_spmm", "bitmap_spmm"), "splitk": ("nm_spmm", "nf4_spmm"),
         "lora": ("fused_lora",), "experts": ("grouped_salr_spmm",),
         "deepseek": ("grouped_salr_spmm",),
         "attention": ("paged_quant_gqa_attention", "paged_gqa_attention"),
         "llama": ("salr_spmm", "nm_spmm", "fused_lora", "paged_gqa_attention"),
         "host": ("salr_spmm", "nm_spmm")}
build.build_all(tuple({n for g in only for n in NEEDS[g]}))
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
# up to 1024 around where the split-K dispatches cross (PERF.md)
BIG = (256, 384, 512, 576, 640, 768, 896, 960, 1024)
# the tiled group's M at smollm's shapes: swept with a dispatch forced
tiled_rows = (4, 8, *BIG) if "--dispatch" in sys.argv else (4, 8, 1024)
with torch.inference_mode():
    if "tiled" in only:
        shapes = {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/up": (576, 1536),
                  "down": (1536, 576), "deepseek wo": (16384, 7168),
                  "deepseek gate/up": (7168, 18432)}
        for lname, (k, n) in shapes.items():
            w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            tbw, _ = salr._tiled_encode(w, salr.SALRConfig(dtype="bfloat16"))
            del w
            q, _ = bm.tile_quantize_nf4(tbw)
            a = (torch.randn((k, 128), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            b = ops._pad_bcat((torch.randn((128, n), generator=gen, device="cuda")
                               / 12).bfloat16(), tbw.cols)
            deepseek = lname.startswith("deepseek")
            for m in (8,) if deepseek else tiled_rows:
                x = (torch.randn((m, k), generator=gen, device="cuda") / 4).bfloat16()
                fns = {"salr": lambda: ops.salr_matmul(x, tbw, a, b),
                       "qsalr": lambda: ops.qsalr_matmul(x, q, a, b)}
                if not deepseek:
                    fns["bitmap"] = lambda: ops.bitmap_matmul(x, tbw)
                out[f"tiled {lname} M={m}"] = {kk: timer.ms(fn) for kk, fn in fns.items()}
                for kk in fns:
                    out[f"tiled {lname} M={m} {kk} by kernel"] = ms_by_kernel(fns[kk])
            del tbw, q
    # fused_lora's plan is taken at every M: timed from decode up
    lora_rows = (4, 8, 16, 32, 48, 64, 96, 128, 256, 512, 1024)
    shapes = (("wo", (576, 576), ("nm", "nf4", "lora")),
              ("down", (1536, 576), ("nm", "nf4", "lora")),
              ("granite wo", (1024, 1024), ("nm", "lora")))
    for lname, (k, n), kernels in shapes:
        kernels = [kk for kk in kernels if ("lora" if kk == "lora" else "splitk") in only]
        if not kernels:
            continue
        rows = sorted({*((4, 8, *BIG) if lname != "granite wo" else (8, *BIG)),
                       *(lora_rows if "lora" in kernels else ())})
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        nmw, _ = bm.nm_encode(w.bfloat16())
        codes, scales = ops.nf4_encode_2d(w)
        a = (torch.randn((k, 128), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
        b = (torch.randn((128, n), generator=gen, device="cuda") / math.sqrt(128)).bfloat16()
        for m in rows:
            x = (torch.randn((m, k), generator=gen, device="cuda") / 4).bfloat16()
            fns = {"nm": lambda: ops.nm_matmul(x, nmw),
                   "nf4": lambda: ops.nf4_matmul(x, codes, scales),
                   "lora": lambda: ops.lora_matmul(x, a, b)}
            timed = [kk for kk in kernels
                     if m in (lora_rows if kk == "lora" else (4, 8, *BIG))]
            out[f"{lname} M={m}"] = {kk: timer.ms(fns[kk]) for kk in timed}
            for kk in timed:
                out[f"{lname} M={m} {kk} by kernel"] = ms_by_kernel(fns[kk])
    if "experts" in only:
        from repro_torch.models import moe
        n_exp, topk = cs.MOE_EXPERTS, cs.MOE_TOPK
        for lname, (k, n) in cs.MOE_SHAPES.items():
            stacks, _ = cs._moe_stacks(torch, gen, torch.bfloat16, "bfloat16", k, n)
            a = (torch.randn((n_exp, k, 128), generator=gen, device="cuda")
                 / math.sqrt(k)).bfloat16()
            b = (torch.randn((n_exp, 128, n), generator=gen, device="cuda")
                 / math.sqrt(128)).bfloat16()
            for n_tok, routes in ((8, ("grouped", "decode")), (128, ("decode",)),
                                  (1024, ("grouped",))):
                x = (torch.randn((n_tok, k), generator=gen, device="cuda") / 4).bfloat16()
                top_i = torch.rand((n_tok, n_exp), generator=gen,
                                   device="cuda").argsort(dim=1)[:, :topk]
                g = moe.group_assignments(top_i, n_exp,
                                          moe._group_block_m(n_tok * topk, n_exp))
                xs = x.new_zeros((g.m_pad, k))
                xs.index_copy_(0, g.dst, x.index_select(0, g.tok))
                xd = x.repeat_interleave(topk, dim=0)
                row_e = top_i.reshape(-1).to(torch.int32)
                for kind, st in stacks.items():
                    fns = {"grouped": lambda: getattr(ops, f"grouped_{kind}_matmul")(
                               xs, g.tile_expert, st, a, b, block_m=g.block_m),
                           "decode": lambda: getattr(ops, f"decode_{kind}_matmul")(
                               xd, row_e, st, a, b)}
                    plain = {"grouped": lambda: getattr(ref, f"grouped_{kind}_spmm_ref")(
                                 xs, g.tile_expert, st, a, b, g.block_m),
                             "decode": lambda: getattr(ref, f"decode_{kind}_spmm_ref")(
                                 xd, row_e, st, a, b)}
                    for route in routes:
                        rows = xs.shape[0] if route == "grouped" else xd.shape[0]
                        key = f"{route}_{kind}_spmm {lname} tokens={n_tok} rows={rows}"
                        out[key] = timer.ms(fns[route])
                        out[f"{key} by kernel"] = ms_by_kernel(fns[route])
                        out[f"{key} rel_l2"] = cs.rel_l2(torch, fns[route](), plain[route]())
            del stacks, a, b
    if "deepseek" in only:
        from repro_torch.models import moe
        n_exp, topk, n_tok = cs.DS_EXPERTS, cs.DS_TOPK, 8
        for lname, (k, n) in cs.DS_MOE_SHAPES.items():
            st = cs._ds_stack(torch, gen, k, n)
            a = (torch.randn((n_exp, k, 128), generator=gen, device="cuda")
                 / math.sqrt(k)).bfloat16()
            b = (torch.randn((n_exp, 128, n), generator=gen, device="cuda")
                 / math.sqrt(128)).bfloat16()
            x = (torch.randn((n_tok, k), generator=gen, device="cuda") / 4).bfloat16()
            top_i = torch.rand((n_tok, n_exp), generator=gen,
                               device="cuda").argsort(dim=1)[:, :topk]
            g = moe.group_assignments(top_i, n_exp, moe._group_block_m(n_tok * topk, n_exp))
            xs = x.new_zeros((g.m_pad, k))
            xs.index_copy_(0, g.dst, x.index_select(0, g.tok))
            xd = x.repeat_interleave(topk, dim=0)
            row_e = top_i.reshape(-1).to(torch.int32)
            fns = {"grouped": lambda: ops.grouped_salr_matmul(xs, g.tile_expert, st, a, b,
                                                              block_m=g.block_m),
                   "decode": lambda: ops.decode_salr_matmul(xd, row_e, st, a, b)}
            plain = {"grouped": lambda: ref.grouped_salr_spmm_ref(xs, g.tile_expert, st, a, b,
                                                                  g.block_m),
                     "decode": lambda: ref.decode_salr_spmm_ref(xd, row_e, st, a, b)}
            for route, fn in fns.items():
                key = f"{route}_salr_spmm deepseek {lname} tokens={n_tok}"
                out[key] = timer.ms(fn)
                out[f"{key} by kernel"] = ms_by_kernel(fn)
                out[f"{key} rel_l2"] = cs.rel_l2(torch, fn(), plain[route]())
            del st, a, b
    if "attention" in only:
        # the inputs of this script's own chip_smoke.py, whatever TREE holds
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
        here = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(here)
        for ctx, pos in ((160, here.QA_POS[:4]),
                         (here.QA_LONG_CTX, (here.QA_LONG_CTX - 1,) * here.QA_LONG_SLOTS)):
            for name in (*here.QUANT_ATTENTION, "paged_gqa_attention"):
                native = name == "paged_gqa_attention"
                args, _ = here.qa_inputs(torch, gen, "paged_quant_gqa_attention" if native
                                         else name, torch.bfloat16, list(pos), ctx)
                if native:      # bf16 pools of the same pages, the same table
                    q, kq, *_, table, pos_t = args
                    pools = [torch.randn(kq.shape, generator=gen, device="cuda").bfloat16()
                             for _ in range(2)]
                    args = (q, *pools, table, pos_t)
                fn = (lambda f=getattr(ops, name), a=args: f(*a))
                key = f"attention {name} B={len(pos)} ctx={ctx}"
                out[key] = timer.ms(fn)
                out[f"{key} by kernel"] = ms_by_kernel(fn)
                if not native:
                    out[f"{key} rel_l2"] = cs.rel_l2(torch, fn(),
                                                     getattr(ref, name + "_ref")(*args))
    if "llama" in only:
        m, r, es = 8, cs.R_CAT, 2
        shapes = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 14336),
                  "down": (14336, 4096)}
        for lname, (k, n) in shapes.items():
            w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            tbw, _ = salr._tiled_encode(w, salr.SALRConfig(dtype="bfloat16"))
            nmw, _ = bm.nm_encode(w)
            a = (torch.randn((k, r), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            b = (torch.randn((r, n), generator=gen, device="cuda") / math.sqrt(r)).bfloat16()
            b_pad = ops._pad_bcat(b, tbw.cols)
            x = (torch.randn((m, k), generator=gen, device="cuda") / 4).bfloat16()
            nnz = int(bm.unpack_bits(tbw.words.reshape(-1, tbw.tile // 32), tbw.tile).sum())
            fns = {"bitmap": lambda: ops.salr_matmul(x, tbw, a, b_pad),
                   "2:4": lambda: ops.nm_matmul(x, nmw) + ops.lora_matmul(x, a, b),
                   "dense": lambda: x @ w}
            plain = {"bitmap": lambda: ref.salr_spmm_ref(x, tbw, a, b_pad),
                     "2:4": lambda: ref.nm_spmm_ref(x, nmw) + ref.fused_lora_ref(x, a, b),
                     "dense": lambda: (x.float() @ w.float()).bfloat16()}
            # each op's roundings (u, each product's output) on sums taken in
            # f64, against which the kernel and its plain version are both
            # read: at K = 4096 and 14336 an f32 sum can round the other way
            xd = x.double()
            u = (xd @ a.double()).bfloat16().double()
            exact = {"bitmap": (xd @ salr.materialize_base(tbw).double()
                                + u @ b_pad.double()).bfloat16(),
                     "2:4": (xd @ bm.nm_decode(nmw).double()).bfloat16()
                     + (u @ b.double()).bfloat16(),
                     "dense": (xd @ w.double()).bfloat16()}
            # what each function needs: x and y; the words and the nnz
            # stored values, the 2:4 group bits and the k x n / 2 values, or
            # the dense weight; A and B of the SALR ops
            io, adapters = (m * k + m * n) * es, (k * r + r * n) * es
            cost = {"bitmap": (io + tbw.words.numel() * 4 + nnz * es + adapters,
                               2 * m * (nnz + k * r + r * n)),
                    "2:4": (io + nmw.group_bits.numel() + nmw.values.numel() * es + adapters,
                            2 * m * (nmw.values.numel() + k * r + r * n)),
                    "dense": (io + k * n * es, 2 * m * k * n)}
            for kk, fn in fns.items():
                key = f"llama {lname} M={m} {kk}"
                out[key] = timer.ms(fn)
                out[f"{key} by kernel"] = ms_by_kernel(fn)
                y, y_plain = fn(), plain[kk]()
                out[f"{key} rel_l2"] = cs.rel_l2(torch, y, y_plain)
                out[f"{key} rel_l2 vs f64"] = cs.rel_l2(torch, y, exact[kk])
                out[f"{key} plain rel_l2 vs f64"] = cs.rel_l2(torch, y_plain, exact[kk])
                nbytes, flops = cost[kk]
                if kk == "2:4":     # its two launches apart, and u's roundings
                    out[f"{key} nm_spmm rel_l2 vs f64"] = cs.rel_l2(
                        torch, ops.nm_matmul(x, nmw),
                        (xd @ bm.nm_decode(nmw).double()).bfloat16())
                    out[f"{key} fused_lora rel_l2 vs f64"] = cs.rel_l2(
                        torch, ops.lora_matmul(x, a, b), (u @ b.double()).bfloat16())
                    # u itself, read through B = I (u rounded, times 1)
                    eye = torch.eye(r, device="cuda").bfloat16()
                    out[f"{key} u entries off the f64 sum's rounding"] = {
                        "kernel": int((ops.lora_matmul(x, a, eye).double() != u).sum()),
                        "plain": int(((x.float() @ a.float()).bfloat16().double() != u).sum())}
                out[f"{key} bytes"], out[f"{key} flops"] = nbytes, flops
                out[f"{key} bound_ms"], out[f"{key} bound_by"] = cs._bound(nbytes, flops,
                                                                           "bfloat16")
            del w, tbw, nmw, a, b, b_pad, exact, u
        ctx, ps, b = 2048, 8, 8
        for arch, (h, kh, d) in (("smollm", (9, 3, 64)), ("llama", (32, 8, 128))):
            pages = ctx // ps
            kp, vp = (torch.randn((b * pages + 1, ps, kh, d), generator=gen,
                                  device="cuda").bfloat16() for _ in range(2))
            table = (torch.randperm(b * pages, generator=gen, device="cuda") + 1).reshape(
                b, pages).to(torch.int32)
            pos = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
            q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
            kg, vg = (pool[table.long()].reshape(b, ctx, kh, d).transpose(1, 2)
                      .repeat_interleave(h // kh, dim=1).contiguous() for pool in (kp, vp))
            qs = q.transpose(1, 2)
            fns = {"kernel": lambda: ops.paged_gqa_attention(q, kp, vp, table, pos),
                   "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                       qs, kg, vg)}
            key = f"llama attention paged_gqa_attention {arch} H={h} KH={kh} d={d} B={b} ctx={ctx}"
            for kk, fn in fns.items():
                out[f"{key} {kk}"] = timer.ms(fn)
                out[f"{key} {kk} by kernel"] = ms_by_kernel(fn)
            out[f"{key} rel_l2"] = cs.rel_l2(torch, fns["kernel"](),
                                             ref.paged_gqa_attention_ref(q, kp, vp, table, pos))
            # q and the output, each live position's K and V rows, the page
            # table, pos
            nbytes = 2 * b * h * d * es + 2 * b * ctx * kh * d * es + b * pages * 4 + b * 4
            flops = 4 * b * ctx * h * d
            out[f"{key} bound_ms"], out[f"{key} bound_by"] = cs._bound(nbytes, flops,
                                                                       "bfloat16")
            del kp, vp, kg, vg
    if "host" in only:
        import time
        w = (torch.randn((576, 1536), generator=gen, device="cuda") / 24).bfloat16()
        tbw, _ = salr._tiled_encode(w, salr.SALRConfig(dtype="bfloat16"))
        q, _ = bm.tile_quantize_nf4(tbw)
        nmw, _ = bm.nm_encode((torch.randn((1536, 576), generator=gen, device="cuda")
                               / 40).bfloat16())
        a = (torch.randn((576, 128), generator=gen, device="cuda") / 24).bfloat16()
        b = (torch.randn((128, 1536), generator=gen, device="cuda") / 12).bfloat16()
        x = (torch.randn((4, 576), generator=gen, device="cuda") / 4).bfloat16()
        xd = (torch.randn((4, 1536), generator=gen, device="cuda") / 4).bfloat16()
        fns = {"salr": lambda: ops.salr_matmul(x, tbw, a, b),
               "qsalr": lambda: ops.qsalr_matmul(x, q, a, b),
               "nm": lambda: ops.nm_matmul(xd, nmw)}
        for kk, fn in fns.items():
            best = float("inf")
            for _ in range(5):
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(300):
                    fn()
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) / 300 * 1e6)
            out[f"host us per call {kk}"] = best
print(json.dumps({"tree": sys.argv[2], **out}))
