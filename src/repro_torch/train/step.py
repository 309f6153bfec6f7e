"""Batched greedy decoding (the batch serving engine)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import execplan
from repro_torch.models import model as M


@torch.inference_mode()
def greedy_generate(params, cfg, prompt: torch.Tensor, n_steps: int, ctx: int,
                    plan: Optional[execplan.ExecutionPlan] = None) -> torch.Tensor:
    """Prefill ``prompt`` (B, S), then decode greedily over a dense
    (B, ctx) cache.  Returns the (B, n_steps) generated tokens, the first
    of them read from the prefill logits.  ``plan`` pins the per-phase
    routes: pass the engine's plan when comparing the two."""
    b, s = prompt.shape
    logits, pcache = M.prefill(params, cfg, prompt, plan=plan)
    cache = M.init_cache(cfg, b, ctx, prompt.device)
    for lc, rc in zip(cache["layers"], pcache["layers"]):
        lc["mixer"].k[:, :s] = rc["mixer"].k
        lc["mixer"].v[:, :s] = rc["mixer"].v
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n_steps - 1):
        lg, cache = M.decode_step(params, cfg, cache, tok, s + i, plan=plan)
        tok = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
