"""Build ``repro_torch/csrc/*.cu`` at first use and load them with ctypes.

Each source compiles on its own (``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``) into a shared library with
a plain C interface under ``build/repro_torch_kernels/`` at the root of
the checkout; one source may hold several kernels' entry points
(``salr_spmm.cu`` holds two, ``quant_attention.cu`` four and
``grouped_spmm.cu`` eight).  A library's file name carries a hash
of its sources and flags, so an edit rebuilds it.  A failed build
raises; nothing falls back to the plain PyTorch versions.  Pointers and the stream cross the
boundary as ``c_void_p``; every entry returns the CUDA error code of its
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# The split-K kernels' tile (csrc/splitk_gemm.cuh, also under fused_lora,
# the bf16 salr_spmm / qsalr_spmm / bitmap_spmm and the expert body): columns per block
# and K rows per pipeline step, the unit of a slice.  The kernels are
# compiled with them; ops.splitk_plan, ops.salr_plan, ops._walks_rows and
# ops.lora_plan cut K by them.
SPLITK_BN, SPLITK_BK = 64, 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DSALR_SPLITK_BN={SPLITK_BN}", f"-DSALR_SPLITK_BK={SPLITK_BK}")

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (source, C argument types); the entry has the kernel's name
KERNELS = {
    "salr_spmm": ("salr_spmm.cu", [_P] * 8 + [_I] * 12 + [_P]),
    "bitmap_spmm": ("bitmap_spmm.cu", [_P] * 5 + [_I] * 9 + [_P]),
    "paged_gqa_attention": ("paged_attention.cu", [_P] * 6 + [_I] * 8 + [_P]),
    "qsalr_spmm": ("salr_spmm.cu", [_P] * 9 + [_I] * 12 + [_P]),
    "ring_quant_gqa_attention": ("quant_attention.cu", [_P] * 8 + [_I] * 9 + [_P]),
    "ring_nf4_gqa_attention": ("quant_attention.cu", [_P] * 8 + [_I] * 9 + [_P]),
    "paged_quant_gqa_attention": ("quant_attention.cu", [_P] * 9 + [_I] * 10 + [_P]),
    "paged_nf4_gqa_attention": ("quant_attention.cu", [_P] * 9 + [_I] * 10 + [_P]),
    "nm_spmm": ("nm_spmm.cu", [_P] * 5 + [_I] * 9 + [_P]),
    "fused_lora": ("fused_lora.cu", [_P] * 5 + [_I] * 8 + [_P]),
    "nf4_spmm": ("nf4_spmm.cu", [_P] * 5 + [_I] * 7 + [_P]),
    "grouped_salr_spmm": ("grouped_spmm.cu", [_P] * 8 + [_I] * 10 + [_P]),
    "grouped_qsalr_spmm": ("grouped_spmm.cu", [_P] * 9 + [_I] * 10 + [_P]),
    "decode_salr_spmm": ("grouped_spmm.cu", [_P] * 8 + [_I] * 9 + [_P]),
    "decode_qsalr_spmm": ("grouped_spmm.cu", [_P] * 9 + [_I] * 9 + [_P]),
    "grouped_dense_spmm": ("grouped_spmm.cu", [_P] * 7 + [_I] * 8 + [_P]),
    "grouped_nm_spmm": ("grouped_spmm.cu", [_P] * 8 + [_I] * 10 + [_P]),
    "decode_dense_spmm": ("grouped_spmm.cu", [_P] * 7 + [_I] * 7 + [_P]),
    "decode_nm_spmm": ("grouped_spmm.cu", [_P] * 8 + [_I] * 9 + [_P]),
    "paged_mla_attention": ("mla_attention.cu", [_P] * 7 + [_I] * 9 + [_P]),
}

_LIBS: dict = {}                  # kernel name -> its loaded library


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the GPU")


def library_path(name: str) -> Path:
    """The library built from kernel ``name``'s source."""
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=tuple(KERNELS)) -> float:
    """Compile the libraries of ``names`` that are not built yet, one nvcc
    per source, all started together.  Returns the wall seconds spent."""
    by_source = {KERNELS[n][0]: n for n in names}
    todo = [n for n in by_source.values() if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    log, tmp, out)
    failed = []
    for n, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{KERNELS[n][0]} (nvcc exit {rc}):\n"
                          f"{out.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        # a handle per kernel (kernels of one source share the file)
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = KERNELS[name][1]
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
