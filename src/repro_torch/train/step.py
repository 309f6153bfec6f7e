"""Batched greedy decoding (the batch serving engine)."""
from __future__ import annotations

import itertools
from typing import Optional

import torch

from repro_torch.core import execplan
from repro_torch.models import model as M


def _step_logits(params, cfg, prompt: torch.Tensor, ctx: int,
                 plan: Optional[execplan.ExecutionPlan], forced=None):
    """Yield greedy decoding's (B, V) logits step by step: the prefill's,
    then each decode step's.  The token fed after step i is
    ``forced[:, i]`` when given, else that step's argmax.  A step decodes
    only when its logits are asked for, so a consumer that stops after n
    yields has run n - 1 decode steps."""
    b, s = prompt.shape
    logits, pcache = M.prefill(params, cfg, prompt, plan=plan)
    resolved = plan or execplan.current_override() or execplan.resolve_plan(cfg)
    # the decode cache is at the decode route's KV precision; a native
    # prefill cache is quantized on its way in, as the engine's insert does
    cache = M.init_cache(cfg, b, ctx, prompt.device, kv_dtype=resolved.kv_dtype("decode"))
    for lc, rc in zip(cache["layers"], pcache["layers"]):
        req = M.quantize_request(lc["mixer"], rc["mixer"])
        for name, t in M.cache_fields(lc["mixer"]):
            t[:, :s] = getattr(req, name).to(t.dtype)
    lg = logits[:, -1]
    for i in itertools.count():
        yield lg
        tok = (forced[:, i:i + 1] if forced is not None
               else lg.argmax(dim=-1).to(torch.int32)[:, None])
        lg, cache = M.decode_step(params, cfg, cache, tok, s + i, plan=plan)
        lg = lg[:, -1]


@torch.inference_mode()
def greedy_generate(params, cfg, prompt: torch.Tensor, n_steps: int, ctx: int,
                    plan: Optional[execplan.ExecutionPlan] = None) -> torch.Tensor:
    """Prefill ``prompt`` (B, S), then decode greedily over a dense
    (B, ctx) cache at the decode route's KV precision.  Returns the
    (B, n_steps) generated tokens, the first of them read from the
    prefill logits.  ``plan`` pins the per-phase
    routes: pass the engine's plan when comparing the two."""
    steps = _step_logits(params, cfg, prompt, ctx, plan)
    return torch.cat([lg.argmax(dim=-1).to(torch.int32)[:, None]
                      for _, lg in zip(range(n_steps), steps)], dim=1)


@torch.inference_mode()
def replay_logits(params, cfg, prompt: torch.Tensor, tokens: torch.Tensor,
                  plan: Optional[execplan.ExecutionPlan] = None) -> torch.Tensor:
    """The logits greedy decoding computes at every step when ``tokens``
    (B, T) are the tokens it generated: prefill ``prompt`` (B, S), then
    decode ``tokens[:, :-1]`` on a dense cache at the decode route's KV
    precision.  Returns (B, T, V) f32; the logits of step i are those
    token i was chosen from, under ``plan``'s prefill route for i = 0 and
    its decode route after."""
    n = tokens.shape[1]
    steps = _step_logits(params, cfg, prompt, prompt.shape[1] + n, plan,
                         forced=tokens.to(torch.int32))
    return torch.stack([lg.float() for _, lg in zip(range(n), steps)], dim=1)
