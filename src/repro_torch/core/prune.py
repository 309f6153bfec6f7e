"""Magnitude pruning: a static mask on the frozen base weights (global or
N:M), mask application and residual extraction E = W - W_hat."""
from __future__ import annotations

import torch


def magnitude_mask(w: torch.Tensor, p: float, batch_dims: int = 0) -> torch.Tensor:
    """Static magnitude mask keeping the largest (1-p) fraction of |w|.

    Exactly ``round(p * size)`` entries are pruned, ties broken by index
    (a stable argsort), so downstream capacity planning is deterministic.
    The leading ``batch_dims`` axes index independent matrices (an expert
    stack), each masked on its own.
    """
    lead = w.shape[:batch_dims]
    flat = w.abs().reshape(*lead, -1)
    n = flat.shape[-1]
    k_prune = int(round(float(p) * n))
    if k_prune <= 0:
        return torch.ones_like(w, dtype=torch.bool)
    if k_prune >= n:
        return torch.zeros_like(w, dtype=torch.bool)
    order = torch.argsort(flat, dim=-1, stable=True)
    keep = torch.ones_like(flat, dtype=torch.bool)
    keep.scatter_(-1, order[..., :k_prune], False)
    return keep.reshape(w.shape)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """W_hat = W * mask."""
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype, device=w.device))


def residual(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """E = W - W_hat = the pruned-away entries."""
    return torch.where(mask, torch.zeros((), dtype=w.dtype, device=w.device), w)


def nm_mask(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """N:M semi-structured mask: keep the n largest |w| of every m
    consecutive entries along the last axis (ties to the lower index, a
    stable argsort of -|w|, as the reference breaks them).  The last dim
    must be divisible by m."""
    *lead, cols = w.shape
    if cols % m:
        raise ValueError(f"cols={cols} not divisible by m={m}")
    # f32 holds every bf16 magnitude exactly, so the order is unchanged
    mag = w.float().abs().reshape(*lead, cols // m, m)
    order = torch.argsort(-mag, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < n).reshape(w.shape)
