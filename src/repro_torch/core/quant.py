"""Error budgets for parity against the reference.

A copy of ``repro.core.quant.ERROR_BUDGETS`` (a CPU test pins the two
equal): relative-L2 ceilings, ``method:*`` for a native route against
its reference formulation, ``repr:*`` / ``kv:*`` for quantized routes.
NF4 quantization itself waits for its own slice of the port.
"""
ERROR_BUDGETS = {
    "method:dense": 1e-4,
    "method:mask": 1e-4,
    "method:bitmap": 1e-4,
    "method:nm": 1e-4,
    "method:bitmap_nf4": 1e-4,
    "repr:nf4": 0.15,
    "repr:bitmap_nf4": 0.15,
    "kv:int8": 0.05,
    "kv:nf4": 0.15,
}
