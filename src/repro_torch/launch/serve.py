"""Serving driver: a SALR-compressed model behind two engines.

``--engine batch`` runs prefill + greedy decode over fixed request
batches (``greedy_generate``); ``--engine continuous`` serves the same
prompts through the continuous-batching engine (paged KV, radix prefix
sharing); ``--engine both`` runs the two and checks that every request's
engine tokens equal its ``greedy_generate`` tokens.  A divergence is
accepted only at a near-tie: where greedy's two top logits at the first
diverging step differ by no more than the noise that bf16 rounding at
other places puts on such a gap, or, in an MoE model, where the step's
router puts its k-th and (k+1)-th experts that close (see
``parity_report``): either can flip the step.

The continuous engine resolves its own plan from its slot count and
largest prefill bucket (for an MoE arch its MoE route may then differ
from the batch engine's; the two kernel routes are bitwise equal per
row).  Runs on ``cuda`` unless ``--device cpu``.  Prompts are drawn from
``--seed`` with numpy.  Examples (full width, on the GPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m --engine both
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \
      --engine both --requests 1 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b_proxy --engine both \
      --requests 1 --batch 8 --slots 4 --prompt-len 128 --shared-prefix 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_v3_671b --smoke \
      --device cpu --engine both
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import execplan
from repro_torch.device import resolve_device
from repro_torch.launch.engine import ContinuousBatchingEngine, EngineConfig, Request
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.train.step import greedy_generate, replay_logits

# a near-tie is a top-2 gap within this many standard deviations of the
# rounding noise on a logit gap
NEAR_TIE_SIGMAS = 3.0

# the ops the linears of a kernel route run, by SALR method (the base the
# layers store), on the native base and on its NF4 twin
_KERNEL_ROUTES = {
    "bitmap": "ops.salr_matmul (fused bitmap decode+GEMM+adapters)",
    "nm": "ops.salr_matmul (wq/wk/wv/gate/up, N:M masks re-encoded as tiled bitmaps) "
          "+ ops.nm_matmul + ops.lora_matmul (wo/down, 2:4 base)",
    "dense": "dense GEMM (a dense base has no fused kernel)",
    "mask": "dense GEMM on the masked base (a dense base has no fused kernel)",
}
_DENSE_TWIN = ("ops.nf4_matmul + ops.lora_matmul (wo/down: the NF4 twin; "
               "wq/wk/wv/gate/up have none: dense GEMM)")
_TWIN_ROUTES = {
    "bitmap": "ops.qsalr_matmul (NF4 dequant-in-kernel)",
    "nm": "ops.qsalr_matmul (wq/wk/wv/gate/up: the NF4 twin) + ops.nm_matmul "
          "+ ops.lora_matmul (wo/down: no twin)",
    "dense": _DENSE_TWIN,
    "mask": _DENSE_TWIN,
}
_ATTENTION_ROUTES = {
    ("paged", "native"): "ops.paged_gqa_attention",
    ("paged", "int8"): "ops.paged_quant_gqa_attention",
    ("paged", "nf4"): "ops.paged_nf4_gqa_attention",
    ("dense", "native"): "plain decode attention",
    ("dense", "int8"): "ops.ring_quant_gqa_attention",
    ("dense", "nf4"): "ops.ring_nf4_gqa_attention",
}

_MLA_ROUTES = {"paged": "ops.paged_mla_attention",
               "dense": "plain MLA latent attention"}


# the expert-stack op family of a kernel route, by SALR method (a masked
# stack's NF4 twin is not read there, as in the reference: no kernel)
_MOE_FAMILIES = {"bitmap": "salr", "nm": "nm", "dense": "dense", "mask": "dense"}


def moe_op(r: execplan.PhaseRoute, method: str, quant: bool) -> str:
    """The op an MoE layer's expert stacks run under phase route ``r``."""
    if r.moe == "dense_masked":
        return "dense decode + GEMM over every expert, masked combine"
    family = "qsalr" if quant and method == "bitmap" else _MOE_FAMILIES[method]
    return f"ops.{'grouped' if r.moe == 'grouped' else 'decode'}_{family}_matmul"


def route_line(cfg, plan: execplan.ExecutionPlan) -> str:
    """Per-phase route line: which op every SALR linear runs, for an MoE
    arch which op its expert stacks run, and, for decode, which attention
    op reads the cache in the plan's decode layout.  A quantized decode
    repr reads the NF4 twin, which ``compress_linear`` (and
    ``compress_stack``) emit whenever the config asks for one; the op that
    reads it follows the base it was made from (a tiled bitmap's twin:
    qsalr_matmul; a dense or masked base's: nf4_matmul)."""
    parts = []
    for phase in ("prefill", "decode"):
        r = plan.route(phase)
        quant = r.repr != "native" and (cfg.salr.dual_repr or cfg.salr.decode_repr)
        if r.linear != "kernel":
            desc = "dense decode + GEMM"
        else:
            desc = (_TWIN_ROUTES if quant else _KERNEL_ROUTES)[cfg.salr.method]
        if cfg.n_experts:   # gate/up/down are expert stacks: the moe= op
            desc = desc.replace("wq/wk/wv/gate/up", "wq/wk/wv").replace("wo/down", "wo")
            desc += f", moe={moe_op(r, cfg.salr.method, bool(quant))}"
        if cfg.mla is not None:   # latents stay in the model dtype
            desc += ", kv_dtype=native (MLA latents)"
            if phase == "decode":
                desc += f", attention={_MLA_ROUTES[r.kv]} (W_uk/W_uv absorbed)"
        else:
            desc += f", kv_dtype={r.kv_dtype}"
            if phase == "decode":
                desc += f", attention={_ATTENTION_ROUTES[r.kv, r.kv_dtype]}"
        parts.append(f"route[{phase}]={desc}")
    return "  ".join(parts)


def request_prompts(cfg, n: int, prompt_len: int, seed: int,
                    shared_prefix: int = 0) -> np.ndarray:
    """(n, prompt_len) int32 prompts drawn from ``seed``; the first
    ``shared_prefix`` tokens are the same in every prompt."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (n, prompt_len), dtype=np.int32)
    prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    return prompts


def run_batch(cfg, params, prompts: np.ndarray, gen: int, batch: int,
              plan: execplan.ExecutionPlan):
    """Batch engine: ``greedy_generate`` over consecutive ``batch``-row
    groups of ``prompts``.  Returns ((n, gen) tokens, seconds)."""
    dev = M.params_device(params)
    ctx = prompts.shape[1] + gen
    out = []
    t0 = time.perf_counter()
    for r in range(0, len(prompts), batch):
        toks = greedy_generate(params, cfg, torch.from_numpy(prompts[r:r + batch]).to(dev),
                               n_steps=gen, ctx=ctx, plan=plan)
        out.append(toks.cpu().numpy())
    return np.concatenate(out), time.perf_counter() - t0


def run_continuous(cfg, params, prompts: np.ndarray, gen: int, n_slots: int,
                   backend: str = "kernel", plan=None):
    """Continuous engine over ``prompts``.  Returns (engine, results,
    metrics)."""
    max_ctx = prompts.shape[1] + gen
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(
        n_slots=n_slots, max_ctx=max_ctx, backend=backend, plan=plan))
    reqs = [Request(rid=i, prompt=tuple(int(t) for t in p), max_new_tokens=gen)
            for i, p in enumerate(prompts)]
    results, metrics = eng.run(reqs)
    return eng, results, metrics


def _rms(x: torch.Tensor) -> float:
    return float(x.square().mean().sqrt())


def _topk_margin(router_logits: torch.Tensor, k: int) -> float:
    """How far apart a token's k-th and (k+1)-th router logits lie."""
    v = router_logits.topk(k + 1).values
    return float(v[k - 1] - v[k])


class Divergence(NamedTuple):
    """A request's first step where the engine's token is not greedy's."""
    rid: int
    step: int
    gap: float             # greedy's top-2 logit gap at the step
    limit: float           # the gap's near-tie limit
    near_tie: object       # "top-2", "router" or False
    router_margin: float   # the MoE layer nearest a top-k tie: its margin
    router_limit: float    # and the margin's near-tie limit (inf, 0: no MoE)


def parity_report(cfg, params, prompts: np.ndarray, greedy: np.ndarray,
                  results: dict, plan) -> list:
    """A ``Divergence`` per diverging request.  The logits are greedy's at
    the first diverging step, recomputed on ``plan`` and on the reference
    route (the same base repr and KV precision, with plain linears and
    attention).  The rms difference of the two routes' logits at that
    step measures the noise bf16 rounding at other places puts on one
    logit; a gap carries sqrt(2) times it, and the limit is
    ``NEAR_TIE_SIGMAS`` of that.

    An MoE layer makes a second discrete choice per token, its top-k
    experts, and one expert more or less moves the logits far beyond that
    noise.  So a step is also a near-tie where, at some MoE layer, the
    step's router logits put the k-th and (k+1)-th experts no further
    apart than ``NEAR_TIE_SIGMAS`` times sqrt(2) times the rms difference
    of the two routes' router logits there, and the step recomputed with
    those two experts swapped puts the engine's token within the top-2
    limit of its top logit: the other side of the tie gives the engine's
    token.

    Where decode reads another base repr or KV precision than prefill (a
    mixed-precision plan), a step after the first is recomputed by
    replaying greedy's decode up to it (``replay_logits``); otherwise by
    prefilling the prompt and greedy's tokens before the step."""
    dev = M.params_device(params)
    ref_plan = execplan.resolve_plan(cfg, backend="reference")
    mixed = any(getattr(plan.route("decode"), f) != getattr(plan.route("prefill"), f)
                for f in ("repr", "kv_dtype"))
    n_moe = sum(mlp == "moe" for _, mlp in M.layer_kinds(cfg))
    k = cfg.experts_per_token
    out = []
    for i, p in enumerate(prompts):
        eng_toks = np.asarray(results[i].tokens)
        diff = np.nonzero(eng_toks != greedy[i])[0]
        if not len(diff):
            continue
        step = int(diff[0])

        def run(pl):
            if mixed and step > 0:
                prompt = torch.from_numpy(p[None].astype(np.int32)).to(dev)
                toks = torch.from_numpy(greedy[i:i + 1, :step + 1].astype(np.int32)).to(dev)
                return replay_logits(params, cfg, prompt, toks, plan=pl)[0, -1]
            seq = np.concatenate([p, greedy[i, :step]])[None].astype(np.int32)
            return M.prefill(params, cfg, torch.from_numpy(seq).to(dev), plan=pl)[0][0, -1].float()

        routed = []
        for pl in (plan, ref_plan):
            with moe.router_logits_tap() as calls:   # the step's token, per MoE layer
                routed.append((run(pl), len(calls) - n_moe,
                               [c[-1] for c in calls[len(calls) - n_moe:]]))
        (logits, first_moe, routers), (ref_logits, _, ref_routers) = routed
        top2 = logits.topk(2).values.cpu().numpy()
        gap = float(top2[0] - top2[1])
        limit = NEAR_TIE_SIGMAS * math.sqrt(2) * _rms(logits - ref_logits)
        margins = [(_topk_margin(r, k), NEAR_TIE_SIGMAS * math.sqrt(2) * _rms(r - rr))
                   for r, rr in zip(routers, ref_routers)]
        tie = "top-2" if gap <= limit else False
        for j, (margin, r_limit) in enumerate(margins):
            if not tie and margin <= r_limit:
                with moe.router_logits_tap(swap_at=first_moe + j):
                    swapped = run(plan)
                if float(swapped.max() - swapped[int(eng_toks[step])]) <= limit:
                    tie = "router"
        margin, r_limit = min(margins, key=lambda m: m[0] - m[1], default=(math.inf, 0.0))
        out.append(Divergence(i, step, gap, limit, tie, margin, r_limit))
    return out


def build_params(cfg, seed: int, device):
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m", choices=configs.PORTED)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", default="kernel",
                    choices=["kernel", "reference", "both"])
    ap.add_argument("--engine", default="batch",
                    choices=["batch", "continuous", "both"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="leading prompt tokens every request shares")
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--slots", type=int, help="continuous engine slots (default: --batch, "
                    "at least 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    print(f"initializing {cfg.name} on {dev} (SALR {cfg.salr.method}, "
          f"p={cfg.salr.sparsity})")
    params, init_s = build_params(cfg, args.seed, dev)
    print(f"compressed in {init_s:.2f}s")
    prompts = request_prompts(cfg, args.requests * args.batch, args.prompt_len,
                              args.seed, shared_prefix=args.shared_prefix)
    backends = ["kernel", "reference"] if args.backend == "both" else [args.backend]
    failed = False
    with torch.inference_mode():
        for b in backends:
            plan = execplan.resolve_plan(cfg, backend=b)
            print(f"backend={b}: {route_line(cfg, plan)}")
            greedy = None
            if args.engine in ("batch", "both"):
                greedy, dt = run_batch(cfg, params, prompts, args.gen, args.batch, plan)
                print(f"engine=batch backend={b}: {greedy.size} tokens in {dt:.2f}s "
                      f"({greedy.size / dt:.1f} tok/s); sample {greedy[0, :8].tolist()}")
            if args.engine in ("continuous", "both"):
                eng, results, m = run_continuous(cfg, params, prompts, args.gen,
                                                 args.slots or max(2, args.batch), backend=b)
                print(f"engine=continuous backend={b}: {route_line(cfg, eng.plan)}")
                print(f"engine=continuous backend={b}: {m['requests']} requests, "
                      f"{m['total_tokens']} tokens in {m['wall_s']:.2f}s "
                      f"({m['tok_s']:.1f} tok/s); ttft mean {m['ttft_mean_s']:.3f}s, "
                      f"kv={m['kv_layout']}, prefix hit rate {m['prefix_hit_rate']:.2f}")
            if greedy is not None and args.engine == "both":
                report = parity_report(cfg, params, prompts, greedy, results, plan)
                for d in report:
                    verdict = f"near-tie ({d.near_tie}), accepted" if d.near_tie else \
                        "NOT a near-tie"
                    print(f"request {d.rid}: diverges at step {d.step}, top-2 gap "
                          f"{d.gap:.4g} (near-tie limit {d.limit:.4g}), router margin "
                          f"{d.router_margin:.4g} (limit {d.router_limit:.4g}) -> {verdict}")
                if all(d.near_tie for d in report):
                    print(f"parity OK: {len(prompts) - len(report)}/{len(prompts)} "
                          "requests match greedy_generate exactly, the rest "
                          "diverge only at near-ties")
                else:
                    print("PARITY FAIL", file=sys.stderr)
                    failed = True
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
