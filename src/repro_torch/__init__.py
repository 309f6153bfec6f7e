"""PyTorch/CUDA port of the SALR reproduction (the JAX package ``repro``
is the reference).

The port serves SALR-compressed dense decoders on one NVIDIA Hopper GPU:
tiled-bitmap sparse bases with fused concat adapters run through
hand-written CUDA kernels (``repro_torch/csrc``), decode reads a paged KV
pool through a hand-written paged-attention kernel.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version instead.
"""
