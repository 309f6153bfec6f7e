"""Sparsity-preservation residual: truncated-SVD low-rank recovery of the
pruned-away entries (paper, Theorem 3)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.adapters import LoRAAdapter

# cuSOLVER driver of every residual SVD on the GPU (``torch.linalg.svd``'s
# ``driver``): gesvda, the batched driver for tall or wide matrices.  It
# computes the same thin SVD as gesvd and gesvdj (PyTorch's own choice),
# several times faster at every shape the port compresses, from smollm's
# 576-wide projections to deepseek_v3_671b's expert stacks, and its rank-64
# adapter product sits as close to gesvd's as gesvdj's does
# (``launch/compress_timing.py``; the times are in PERF.md)
CUDA_SVD_DRIVER = "gesvda"


def truncated_svd_adapter(e: torch.Tensor, rank: int, dtype=None,
                          driver: Optional[str] = None) -> LoRAAdapter:
    """Best rank-r approximation of the residual E as a LoRA pair,
    balanced: E ~= (U_r sqrt(S_r)) (sqrt(S_r) V_r^T).  The SVD runs in f32;
    leading axes of E (an expert stack) are decomposed as one batch.  On
    the GPU it takes the cuSOLVER ``driver`` (``CUDA_SVD_DRIVER`` unless
    one is named); on the CPU, LAPACK's."""
    if dtype is None:
        dtype = e.dtype
    u, s, vt = torch.linalg.svd(e.to(torch.float32), full_matrices=False,
                                driver=(driver or CUDA_SVD_DRIVER) if e.is_cuda else None)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., :r])
    a = (u[..., :, :r] * sq[..., None, :]).to(dtype)
    b = (sq[..., :, None] * vt[..., :r, :]).to(dtype)
    if r < rank:  # pad to the requested static rank with zeros
        a = torch.nn.functional.pad(a, (0, rank - r))
        b = torch.nn.functional.pad(b, (0, 0, 0, rank - r))
    return LoRAAdapter(a=a, b=b, scale=1.0)
