"""Checked wrappers around the CUDA kernels.

Each wrapper flattens leading dims, checks device, dtype, shape and
contiguity, and then launches its kernel for CUDA tensors or runs the
plain PyTorch version (``ref``) for CPU tensors; any other device
raises.  Nothing on the GPU falls back to the plain version.  The
wrappers are forward-only in this slice: called on inputs that require
grad they raise (the autograd Functions come with the fine-tuning slice).

``LAUNCHES`` counts kernel launches per wrapper (one per call that
reached the GPU), so a run can show its main path went through the
kernels; ``reset_launches`` zeroes it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.quant import QBLOCK, quantize_nf4
from repro_torch.kernels import build, ref

LAUNCHES = {"salr_spmm": 0, "bitmap_spmm": 0, "paged_gqa_attention": 0,
            "qsalr_spmm": 0, "ring_quant_gqa_attention": 0,
            "paged_quant_gqa_attention": 0, "ring_nf4_gqa_attention": 0,
            "paged_nf4_gqa_attention": 0, "nm_spmm": 0, "fused_lora": 0,
            "nf4_spmm": 0, "grouped_salr_spmm": 0, "grouped_qsalr_spmm": 0,
            "decode_salr_spmm": 0, "decode_qsalr_spmm": 0, "grouped_dense_spmm": 0,
            "grouped_nm_spmm": 0, "decode_dense_spmm": 0, "decode_nm_spmm": 0,
            "paged_mla_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _forward_only(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} is forward-only in this slice; run it "
                           "under torch.inference_mode() or no_grad()")


def _placement(name: str, x: torch.Tensor, *ts) -> str:
    """'cpu' or 'cuda' for a call whose tensors all share x's device."""
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _check_cuda(name: str, dtype, *ts) -> int:
    """Contiguity and operand dtype of a launch; returns the dtype code."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _DTYPE_CODES[dtype]


def _launch(name: str, device: torch.device, *args) -> None:
    lib = build.load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, name)(*args, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    LAUNCHES[name] += 1


def _flatten(x: torch.Tensor) -> tuple:
    return x.reshape(-1, x.shape[-1]).contiguous(), x.shape[:-1]


def _check_tiled(name: str, x2: torch.Tensor, tbw, n_lead: int = 0) -> None:
    """The tiled layout a SpMM kernel takes (native or NF4 payload); an
    expert stack (``n_lead`` = 1) carries a leading E axis on every leaf."""
    lead = tuple(tbw.words.shape[:-3])
    if tbw.words.ndim != 3 + n_lead:
        raise ValueError(f"{name}: words {tuple(tbw.words.shape)} must have "
                         f"{3 + n_lead} dims")
    if tbw.rows != x2.shape[1]:
        raise ValueError(f"{name}: x has K={x2.shape[1]}, weight {tbw.rows} rows")
    if tbw.tile % 32 or tbw.tile > 256 or tbw.n_tiles * tbw.tile != tbw.cols:
        raise ValueError(f"{name}: tile {tbw.tile} must be a multiple of 32 "
                         f"up to 256 covering cols={tbw.cols}")
    if tbw.cap_t % 8 or not 0 < tbw.cap_t <= tbw.tile:
        raise ValueError(f"{name}: cap_t {tbw.cap_t} must be a multiple of 8 "
                         f"up to the tile")
    if tbw.words.dtype != torch.int32:
        raise TypeError(f"{name}: words must be int32")
    cells = (*lead, tbw.rows, tbw.n_tiles)
    if tbw.words.shape[-1] != tbw.tile // 32:
        raise ValueError(f"{name}: words {tuple(tbw.words.shape)} do not fit tile {tbw.tile}")
    if isinstance(tbw, bm.QTiledBitmapWeight):
        if tbw.codes.shape != (*cells, tbw.cap_t // 2) or tbw.scales.shape != (*cells, 1):
            raise ValueError(f"{name}: codes {tuple(tbw.codes.shape)} / scales "
                             f"{tuple(tbw.scales.shape)} do not fit cells {cells}, "
                             f"cap_t {tbw.cap_t}")
        if tbw.codes.dtype != torch.uint8 or tbw.scales.dtype != torch.float32:
            raise TypeError(f"{name}: codes must be uint8 and scales float32")
    else:
        if tbw.values.shape != (*cells, tbw.cap_t):
            raise ValueError(f"{name}: values {tuple(tbw.values.shape)} do not fit cells "
                             f"{cells}, cap_t {tbw.cap_t}")
        if tbw.values.dtype != x2.dtype:
            raise TypeError(f"{name}: values must be {x2.dtype}")


def _check_adapters(name: str, tbw, a_cat: torch.Tensor, b_cat: torch.Tensor,
                    allow_rank0: bool) -> int:
    r = a_cat.shape[1]
    if (a_cat.shape[0] != tbw.rows or b_cat.shape != (r, tbw.cols)
            or (r == 0 and not allow_rank0)):
        raise ValueError(f"{name}: adapter shapes {tuple(a_cat.shape)} / "
                         f"{tuple(b_cat.shape)} do not fit ({tbw.rows}, R"
                         f"{'' if allow_rank0 else '>0'}) / (R, {tbw.cols})")
    return r


def _pad_bcat(b_cat: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad B_cat's output dim up to the (tile-padded) encoded width;
    padded columns produce zeros the caller slices off."""
    if b_cat.shape[1] < cols:
        b_cat = torch.nn.functional.pad(b_cat, (0, cols - b_cat.shape[1]))
    return b_cat


def bitmap_matmul(x: torch.Tensor, tbw: bm.TiledBitmapWeight) -> torch.Tensor:
    """y = x @ W_hat with the fused bitmap-decode GEMM.  x: (..., K);
    returns (..., tbw.cols).  bf16 runs salr_spmm's split-K walk at rank
    0: the same plan (:func:`salr_plan`) and dispatch, with a (slices, M,
    N) f32 workspace in the slices dispatch; f32 (the scalar body) takes
    no plan."""
    name = "bitmap_spmm"
    _forward_only(name, x, tbw.values)
    x2, lead = _flatten(x)
    _check_tiled(name, x2, tbw)
    if _placement(name, x2, tbw.words, tbw.values) == "cpu":
        y = ref.bitmap_spmm_ref(x2, tbw)
    else:
        code = _check_cuda(name, x2.dtype, tbw.words, tbw.values)
        m, k = x2.shape
        n = tbw.cols
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        if m:
            ws, plan = None, (0, 0)
            if x2.dtype == torch.bfloat16:
                plan, rows = _salr_base_plan(x2, k, n)
                if not rows:
                    ws = torch.empty((plan[0], m, n), dtype=torch.float32, device=x2.device)
            _launch(name, x2.device, x2.data_ptr(), tbw.words.data_ptr(),
                    tbw.values.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(),
                    m, k, tbw.n_tiles, tbw.tile // 32, tbw.cap_t, *plan, code)
    return y.reshape(*lead, tbw.cols)


def salr_matmul(x: torch.Tensor, tbw: bm.TiledBitmapWeight,
                a_cat: torch.Tensor, b_cat: torch.Tensor) -> torch.Tensor:
    """y = x @ W_hat + (x @ A_cat) @ B_cat, the full SALR op.  x: (..., K);
    a_cat (K, R), b_cat (R, <= cols); returns (..., tbw.cols)."""
    name = "salr_spmm"
    _forward_only(name, x, tbw.values, a_cat, b_cat)
    x2, lead = _flatten(x)
    _check_tiled(name, x2, tbw)
    b_cat = _pad_bcat(b_cat, tbw.cols)
    r = _check_adapters(name, tbw, a_cat, b_cat, allow_rank0=False)
    if _placement(name, x2, tbw.words, tbw.values, a_cat, b_cat) == "cpu":
        y = ref.salr_spmm_ref(x2, tbw, a_cat, b_cat)
    else:
        y = _launch_salr(name, x2, tbw, (tbw.words, tbw.values), a_cat, b_cat, r)
    return y.reshape(*lead, tbw.cols)


def splitk_plan(k: int, n: int, sms: int) -> tuple:
    """(slices, slice_k) of the bf16 nm_spmm and nf4_spmm kernels
    (csrc/splitk_gemm.cuh) for a (K, N) weight on a card of ``sms`` SMs: K
    cut into ``slices`` slices of ``slice_k`` rows (whole pipeline steps of
    build.SPLITK_BK rows, the last ending at K), enough that the (column
    tile x slice) blocks fill a wave of one block per SM at decode.  Never
    a function of M: a row's products meet the same slices, summed in the
    same order, at every M."""
    steps = max(1, -(-k // build.SPLITK_BK))
    per = max(1, steps // -(-sms // -(-n // build.SPLITK_BN)))
    return -(-steps // per), per * build.SPLITK_BK


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The rows dispatch once the slices' f32 partials would exceed this many
# bytes per pipeline step of K: on an H100 a block's step takes about 0.55
# us, and partials cost about 1.4 us per MB written and summed (the
# spmm_ab.py sweep of M, PERF.md)
SPLITK_ROWS_BYTES_PER_STEP = 400_000


# The same switch for the bf16 salr_spmm / qsalr_spmm / bitmap_spmm: a
# bitmap step takes about twice a 2:4 step, so the partials pay for longer
# (the spmm_ab.py --dispatch sweep of M = 4 to 1024 at smollm's four
# shapes: the least summed time of the 88 calls, PERF.md)
SALR_ROWS_BYTES_PER_STEP = 750_000


def _walks_rows(m: int, k: int, n: int, slices: int,
                bytes_per_step: int = SPLITK_ROWS_BYTES_PER_STEP) -> bool:
    """Whether a bf16 split-K launch at M = ``m`` takes the rows dispatch
    (a block per (column tile, row tile) walks every slice in order) over
    the slices one (a block per slice writes its f32 partial, a second pass
    sums them in slice order): once the (slices, M, N) partials pass
    ``bytes_per_step`` per pipeline step of K.  Both give the same bits."""
    return slices * m * n * 4 >= -(-k // build.SPLITK_BK) * bytes_per_step


def _splitk_args(x2: torch.Tensor, k: int, n: int) -> tuple:
    """(workspace, slices, slice_k) of a bf16 nm_spmm / nf4_spmm launch:
    the (slices, M, N) f32 workspace of the slices dispatch, or None (a null
    pointer) for the rows dispatch (:func:`_walks_rows`)."""
    slices, slice_k = splitk_plan(k, n, _sm_count(x2.device))
    m = x2.shape[0]
    if _walks_rows(m, k, n, slices):
        return None, slices, slice_k
    ws = torch.empty((slices, m, n), dtype=torch.float32, device=x2.device)
    return ws, slices, slice_k


def _launch_splitk(name: str, x2: torch.Tensor, y: torch.Tensor, weights: tuple, k: int,
                   n: int, shape_args: tuple, code: int) -> None:
    """Launch nm_spmm / nf4_spmm: bf16 with its split plan and workspace,
    f32 (the column GEMM) with none."""
    ws, slices, slice_k = (_splitk_args(x2, k, n) if x2.dtype == torch.bfloat16
                           else (None, 0, 0))
    _launch(name, x2.device, x2.data_ptr(), *(t.data_ptr() for t in weights), y.data_ptr(),
            None if ws is None else ws.data_ptr(), *shape_args, slices, slice_k, code)


def nm_matmul(x: torch.Tensor, nmw: bm.NMWeight) -> torch.Tensor:
    """y = x @ W_hat with W_hat in N:M form, decoded inside the GEMM.
    x: (..., K); returns (..., nmw.cols)."""
    name = "nm_spmm"
    _forward_only(name, x, nmw.values)
    x2, lead = _flatten(x)
    k, groups = nmw.group_bits.shape
    if (k != x2.shape[1] or groups * nmw.m != nmw.cols
            or nmw.values.shape != (k, groups * nmw.n) or not 0 < nmw.n <= nmw.m <= 8):
        raise ValueError(f"{name}: x has K={x2.shape[1]}; group bits "
                         f"{tuple(nmw.group_bits.shape)}, values {tuple(nmw.values.shape)} "
                         f"do not fit a {nmw.n}:{nmw.m} weight of {nmw.cols} columns "
                         "(m <= 8)")
    if nmw.group_bits.dtype != torch.uint8:
        raise TypeError(f"{name}: group bits must be uint8")
    if _placement(name, x2, nmw.group_bits, nmw.values) == "cpu":
        y = ref.nm_spmm_ref(x2, nmw)
    else:
        if nmw.values.dtype != x2.dtype:
            raise TypeError(f"{name}: values must be {x2.dtype}")
        if nmw.n not in (1, 2, 4):
            raise ValueError(f"{name}: the kernel is built for n = 1, 2, 4 (got {nmw.n})")
        code = _check_cuda(name, x2.dtype, nmw.group_bits, nmw.values)
        m = x2.shape[0]
        y = torch.empty((m, nmw.cols), dtype=x2.dtype, device=x2.device)
        if m:
            _launch_splitk(name, x2, y, (nmw.group_bits, nmw.values), k, nmw.cols,
                           (m, k, nmw.cols, nmw.n, nmw.m), code)
    return y.reshape(*lead, nmw.cols)


# the largest adapter rank the fused_lora kernel keeps on chip
LORA_MAX_RANK = 256
# the most slices fused_lora cuts u = x @ A_cat's K into: each of its
# output blocks sums every slice of its rows, so more slices cost more
# there than they save in the u pass (the spmm_ab.py sweep of M = 4 to 1024
# on an H100, PERF.md)
LORA_SLICES = 8


def lora_plan(k: int) -> tuple:
    """(slices, slice_k) of the bf16 fused_lora kernel: K cut into at most
    ``LORA_SLICES`` slices of whole pipeline steps (build.SPLITK_BK rows,
    the last ending at K).  A function of K alone, never of M."""
    steps = max(1, -(-k // build.SPLITK_BK))
    per = -(-steps // LORA_SLICES)
    return -(-steps // per), per * build.SPLITK_BK


# K rows an f32 accumulator of the bf16 salr_spmm / qsalr_spmm kernels runs
# over at most, 8 pipeline steps (csrc/salr_walk.cuh CHUNK_K): one
# tensor-core accumulator over deepseek's K = 7168 drifts to 4.5e-4 of the
# 5e-4 limit (PERF.md)
SALR_CHUNK_K = 8 * build.SPLITK_BK
# blocks of the bf16 salr_spmm / qsalr_spmm base kernels resident on an SM
# (csrc/splitk_gemm.cuh MIN_BLOCKS: 97 KB of shared memory and <= 128
# registers a thread each)
SALR_BLOCKS_PER_SM = 2


def salr_plan(k: int, n: int, sms: int) -> tuple:
    """(slices, slice_k) of the bf16 salr_spmm / qsalr_spmm / bitmap_spmm
    base product: :func:`splitk_plan`'s where its slices are at most
    ``SALR_CHUNK_K`` rows.  Longer slices are made whole ``SALR_CHUNK_K``-row chunks (the
    kernel flushes its accumulator every chunk, on one grid in both
    dispatches), as many to a slice as keep the card's waves of
    ``SALR_BLOCKS_PER_SM`` blocks an SM full: splitk_plan fills one wave at
    least, but deepseek's gate/up (288 column blocks) gets one slice of all
    224 steps, 1.09 waves, so its last 24 blocks walk a second wave alone.
    The fewest slices whose waves x steps come within 5% of the least.  A
    function of (K, N) and the card alone, never of M."""
    slices, slice_k = splitk_plan(k, n, sms)
    if slice_k <= SALR_CHUNK_K:
        return slices, slice_k
    bk, chunk = build.SPLITK_BK, SALR_CHUNK_K // build.SPLITK_BK
    steps, cols = -(-k // bk), -(-n // build.SPLITK_BN)
    slots = SALR_BLOCKS_PER_SM * sms

    def cost(per: int) -> int:             # waves x steps a block
        return -(-cols * -(-steps // per) // slots) * per

    pers = range(chunk, -(-steps // chunk) * chunk + 1, chunk)
    least = min(cost(per) for per in pers)
    per = max(per for per in pers if cost(per) <= 1.05 * least)
    return -(-steps // per), per * bk


def _salr_base_plan(x2: torch.Tensor, k: int, n: int) -> tuple:
    """((slices, slice_k), rows) of the bf16 salr_spmm / qsalr_spmm /
    bitmap_spmm base over a (K, N) weight: :func:`salr_plan` on x's card,
    and whether the launch takes the rows dispatch (:func:`_walks_rows`
    at ``SALR_ROWS_BYTES_PER_STEP``)."""
    plan = salr_plan(k, n, _sm_count(x2.device))
    return plan, _walks_rows(x2.shape[0], k, n, plan[0], SALR_ROWS_BYTES_PER_STEP)


def _launch_salr(name: str, x2: torch.Tensor, tbw, leaves: tuple, a_cat: torch.Tensor,
                 b_cat: torch.Tensor, r: int) -> torch.Tensor:
    """Launch salr_spmm / qsalr_spmm on CUDA tensors; returns y (M, cols).
    bf16: the base's K cut by :func:`salr_plan`, u's by :func:`lora_plan`,
    one f32 scratch holding u's (u_slices, M, R) partials and, in the
    slices dispatch, the base's (slices, M, N) ones.  f32 (the scalar
    body): an (M, R) u scratch and no plan."""
    if a_cat.dtype != x2.dtype or b_cat.dtype != x2.dtype:
        raise TypeError(f"{name}: adapters must be {x2.dtype}")
    code = _check_cuda(name, x2.dtype, *leaves, a_cat, b_cat)
    m, k = x2.shape
    n = tbw.cols
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if not m:
        return y
    ws = None
    plans = (0, 0, 0, 0)
    if x2.dtype == torch.bfloat16:
        (slices, slice_k), rows = _salr_base_plan(x2, k, n)
        u_slices, u_slice_k = lora_plan(k)
        plans = (slices, slice_k, u_slices, u_slice_k)
        u_len = -(-u_slices * m * r // 4) * 4          # the base's partials 16-byte aligned
        scratch = torch.empty(u_len + (0 if rows else slices * m * n), dtype=torch.float32,
                              device=x2.device)
        u = scratch.data_ptr()
        if not rows:
            ws = u + 4 * u_len
    else:
        u = torch.empty((m, r), dtype=x2.dtype, device=x2.device).data_ptr()
    _launch(name, x2.device, x2.data_ptr(), *(t.data_ptr() for t in leaves), a_cat.data_ptr(),
            b_cat.data_ptr(), u, y.data_ptr(), ws, m, k, r, tbw.n_tiles, tbw.tile // 32,
            tbw.cap_t, *plans, code)
    return y


def lora_matmul(x: torch.Tensor, a_cat: torch.Tensor, b_cat: torch.Tensor) -> torch.Tensor:
    """y = (x @ A_cat) @ B_cat, u = x @ A_cat rounded to B_cat's dtype.
    x: (..., K); a_cat (K, R), b_cat (R, N) with R > 0; returns (..., N).
    bf16 splits u's K by :func:`lora_plan`, the slices' f32 partials in a
    (slices, M, R) workspace that the output pass sums in slice order; f32
    takes the column GEMM, with no plan."""
    name = "fused_lora"
    _forward_only(name, x, a_cat, b_cat)
    x2, lead = _flatten(x)
    k, r = a_cat.shape
    n = b_cat.shape[1]
    if k != x2.shape[1] or b_cat.shape[0] != r or r == 0:
        raise ValueError(f"{name}: x has K={x2.shape[1]}; adapter shapes "
                         f"{tuple(a_cat.shape)} / {tuple(b_cat.shape)} do not fit "
                         f"(K, R>0) / (R, N)")
    if _placement(name, x2, a_cat, b_cat) == "cpu":
        y = ref.fused_lora_ref(x2, a_cat, b_cat)
    else:
        if a_cat.dtype != x2.dtype or b_cat.dtype != x2.dtype:
            raise TypeError(f"{name}: adapters must be {x2.dtype}")
        if r > LORA_MAX_RANK:
            raise ValueError(f"{name}: the kernel keeps u on chip up to rank "
                             f"{LORA_MAX_RANK} (got {r})")
        code = _check_cuda(name, x2.dtype, a_cat, b_cat)
        m = x2.shape[0]
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        if m:
            ws, slices, slice_k = None, 0, 0
            if x2.dtype == torch.bfloat16:
                slices, slice_k = lora_plan(k)
                ws = torch.empty((slices, m, r), dtype=torch.float32, device=x2.device)
            _launch(name, x2.device, x2.data_ptr(), a_cat.data_ptr(), b_cat.data_ptr(),
                    y.data_ptr(), None if ws is None else ws.data_ptr(), m, k, r, n,
                    slices, slice_k, code)
    return y.reshape(*lead, n)


def nf4_encode_2d(w: torch.Tensor) -> tuple:
    """Quantize a ([E,] K, N) weight into the 2-D NF4 layout: codes ([E,]
    K, N/2) uint8, interleaved, and scales ([E,] K, N/QBLOCK) f32 (an
    expert stack's experts each as one 2-D weight).  N % QBLOCK == 0."""
    *lead, n = w.shape
    if n % QBLOCK:
        raise ValueError(f"N={n} must be a multiple of {QBLOCK}")
    q = quantize_nf4(w, block=QBLOCK)
    return q.codes.reshape(*lead, n // 2), q.scales.reshape(*lead, n // QBLOCK)


def nf4_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(codes, scales) with the NF4 dequantization inside
    the GEMM.  x: (..., K); codes (K, N/2) uint8 (interleaved); scales
    (K, N/QBLOCK) f32; returns (..., N)."""
    name = "nf4_spmm"
    _forward_only(name, x)
    x2, lead = _flatten(x)
    k, half = codes.shape
    n = 2 * half
    if k != x2.shape[1] or n % QBLOCK or scales.shape != (k, n // QBLOCK):
        raise ValueError(f"{name}: x has K={x2.shape[1]}; codes {tuple(codes.shape)} / "
                         f"scales {tuple(scales.shape)} do not fit (K, N/2) / "
                         f"(K, N/{QBLOCK}) with N % {QBLOCK} == 0")
    if codes.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: codes must be uint8 and scales float32")
    if _placement(name, x2, codes, scales) == "cpu":
        y = ref.nf4_spmm_ref(x2, codes, scales)
    else:
        code = _check_cuda(name, x2.dtype, codes, scales)
        m = x2.shape[0]
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        if m:
            _launch_splitk(name, x2, y, (codes, scales), k, n, (m, k, n), code)
    return y.reshape(*lead, n)


# paged_gqa_attention's block (csrc/paged_attention.cu:27, THREADS)
PAGED_GQA_THREADS = 128


def paged_gqa_smem_bytes(g: int, d: int, ctx: int) -> int:
    """Shared memory of one paged_gqa_attention block, as its launch sizes
    it: the G query heads' q (G x d f32), their score rows over the page
    table's whole width of ``ctx`` positions (G x ctx f32) and the PV
    stripes' partial sums ((THREADS / d) x G x d f32).  A copy of the
    launch's own sizing, csrc/paged_attention.cu:128-129: the two must
    change together."""
    return 4 * (g * d + g * ctx + (PAGED_GQA_THREADS // d) * g * d)


def paged_gqa_max_ctx(g: int, d: int, smem_bytes: int) -> int:
    """The widest page table, in positions, whose block fits in
    ``smem_bytes`` of shared memory (:func:`paged_gqa_smem_bytes`)."""
    return (smem_bytes // 4 - g * d - (PAGED_GQA_THREADS // d) * g * d) // g


@functools.cache
def _smem_optin(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def paged_gqa_attention(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over paged K/V pools.

    q: (B, 1, H, d); pools: (P, page_size, KH, d); page_table:
    (B, max_pages) int32, entry j = pool page of positions
    [j*page_size, (j+1)*page_size), page 0 the null page; pos: (B,) int32,
    last live position per slot (inclusive).  Returns (B, 1, H, d)."""
    name = "paged_gqa_attention"
    _forward_only(name, q, k_pool, v_pool)
    b, one, h, d = q.shape
    p_total, ps, kh, dk = k_pool.shape
    if (one != 1 or dk != d or v_pool.shape != k_pool.shape or h % kh
            or page_table.shape[0] != b or pos.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, page "
                         f"table {tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and pos must be int32")
    if _placement(name, q, k_pool, v_pool, page_table, pos) == "cpu":
        return ref.paged_gqa_attention_ref(q, k_pool, v_pool, page_table, pos)
    if h // kh > 8 or d not in (32, 64, 128):
        raise ValueError(f"{name}: kernel takes up to 8 query heads per KV "
                         f"head and head dim 32/64/128 (got {h // kh}, {d})")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: pools must be {q.dtype}")
    g, ctx, limit = h // kh, page_table.shape[1] * ps, _smem_optin(q.device)
    if paged_gqa_smem_bytes(g, d, ctx) > limit:
        cap = paged_gqa_max_ctx(g, d, limit)
        raise ValueError(f"{name}: a page table of {page_table.shape[1]} pages of {ps} "
                         f"({ctx} positions) needs {paged_gqa_smem_bytes(g, d, ctx)} bytes "
                         f"of shared memory a block; at {g} query heads per KV head and "
                         f"head dim {d} the card's {limit} take at most {cap} positions "
                         f"({cap // ps} pages)")
    code = _check_cuda(name, q.dtype, q, k_pool, v_pool, page_table, pos)
    out = torch.empty_like(q)
    if b:
        _launch(name, q.device, q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
                out.data_ptr(), b, h, kh, d, ps, page_table.shape[1], code)
    return out


def paged_mla_attention(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv_pool: torch.Tensor,
                        krope_pool: torch.Tensor, page_table: torch.Tensor, pos: torch.Tensor,
                        *, qk_dim: int) -> torch.Tensor:
    """MLA absorbed decode over paged latent pools.

    q_lat: (B, H, R) f32, already absorbed through W_uk; q_rope: (B, H,
    rd) f32; ckv_pool: (P, page_size, R) and krope_pool (P, page_size,
    rd), float32 or bfloat16 alike; page_table: (B, max_pages) int32, page
    0 the null page; pos: (B,) int32, last live position per slot
    (inclusive); ``qk_dim`` is the nope + rope query width the scores are
    divided by the root of.  Returns o_lat (B, H, R) f32 (the caller
    applies W_uv and wo)."""
    name = "paged_mla_attention"
    _forward_only(name, q_lat, q_rope, ckv_pool, krope_pool)
    b, h, r = q_lat.shape
    rd = q_rope.shape[-1]
    p_total, ps, rc = ckv_pool.shape
    if (q_rope.shape != (b, h, rd) or rc != r or krope_pool.shape != (p_total, ps, rd)
            or page_table.ndim != 2 or page_table.shape[0] != b or pos.shape != (b,)):
        raise ValueError(f"{name}: shapes q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, pools {tuple(ckv_pool.shape)}/"
                         f"{tuple(krope_pool.shape)}, page table {tuple(page_table.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if q_lat.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise TypeError(f"{name}: q_lat and q_rope must be float32")
    if krope_pool.dtype != ckv_pool.dtype:
        raise TypeError(f"{name}: pools of {ckv_pool.dtype} and {krope_pool.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and pos must be int32")
    tensors = (q_lat, q_rope, ckv_pool, krope_pool, page_table, pos)
    if _placement(name, *tensors) == "cpu":
        return ref.paged_mla_attention_ref(*tensors, qk_dim=qk_dim)
    if (h > 8 and h % 8) or r % 32 or not 0 < r <= 512 or rd % 8 or not 0 < rd <= 128:
        raise ValueError(f"{name}: kernel takes up to 8 heads or a multiple of 8, a latent "
                         f"width R a multiple of 32 up to 512 and a rope width a multiple "
                         f"of 8 up to 128 (got H={h}, R={r}, rope {rd})")
    code = _check_cuda(name, ckv_pool.dtype, *tensors)
    if ckv_pool.data_ptr() % 16 or krope_pool.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start 16-byte aligned")
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_lat.device)
    if b:
        _launch(name, q_lat.device, *(t.data_ptr() for t in tensors), out.data_ptr(),
                b, h, r, rd, ps, page_table.shape[1], qk_dim, code)
    return out


def qsalr_matmul(x: torch.Tensor, q: bm.QTiledBitmapWeight,
                 a_cat: torch.Tensor, b_cat: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(W_hat) + (x @ A_cat) @ B_cat with W_hat an
    NF4-quantized tiled bitmap, dequantized and decoded inside the GEMM.
    x: (..., K); a_cat (K, R), b_cat (R, <= cols), R >= 0; returns
    (..., q.cols)."""
    name = "qsalr_spmm"
    _forward_only(name, x, a_cat, b_cat)
    x2, lead = _flatten(x)
    _check_tiled(name, x2, q)
    b_cat = _pad_bcat(b_cat, q.cols)
    r = _check_adapters(name, q, a_cat, b_cat, allow_rank0=True)
    if _placement(name, x2, q.words, q.codes, q.scales, a_cat, b_cat) == "cpu":
        y = ref.qsalr_spmm_ref(x2, q, a_cat, b_cat)
    else:
        y = _launch_salr(name, x2, q, (q.words, q.codes, q.scales), a_cat, b_cat, r)
    return y.reshape(*lead, q.cols)


_KV_CODES = {"int8": torch.int8, "nf4": torch.uint8}
# The quantized decode-attention kernels' chunk (csrc/quant_attention.cu):
# at least this many positions, whole pages, and at most ATTN_MAX_UNITS
# such units, so a chunk's page-table entries fit shared memory
ATTN_UNIT, ATTN_MAX_UNITS = 64, 64
# the decode batch a plan fills the card for (the engine's 4 to 8 slots)
ATTN_SLOTS = 4


def attention_plan(ctx: int, page_size: int, kh: int, sms: int) -> tuple:
    """(chunks, chunk) of the quantized decode-attention kernels for a
    context of ``ctx`` positions in pages of ``page_size`` (1 for a ring
    cache) over ``kh`` KV heads on a card of ``sms`` SMs: ``chunks`` chunks
    of ``chunk`` positions, whole pages and whole units of ATTN_UNIT
    positions or more, the last ending at or past ``ctx``, enough that the
    (chunk, KV head) blocks of ATTN_SLOTS slots fill a wave.  Never a
    function of B or of the slots' positions: a slot's output has the same
    bits at every batch, and a ring and a paged cache whose pages divide
    ATTN_UNIT take the same plan (the same bits from the same rows)."""
    unit = page_size * -(-ATTN_UNIT // page_size)
    units = max(1, -(-ctx // unit))
    want = max(1, sms // (ATTN_SLOTS * kh))
    chunk = min(ATTN_MAX_UNITS, -(-units // want)) * unit
    return max(1, -(-ctx // chunk)), chunk


def _quant_attention(name: str, kv: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor,
                     pos: torch.Tensor, page_table=None) -> torch.Tensor:
    """Check and run one of the four quantized decode-attention kernels.
    Ring (``page_table`` None): k/v (B, W, KH, dc), scales (B, W, KH).
    Paged: k/v (P, page_size, KH, dc), scales (P, page_size, KH),
    page_table (B, max_pages).  dc = d for int8, d/2 for NF4."""
    tensors = (q, k, v, k_scale, v_scale, pos) + (() if page_table is None else (page_table,))
    _forward_only(name, q)
    b, one, h, d = q.shape
    n0, n1, kh, dc = k.shape
    want_dc = d if kv == "int8" else d // 2
    paged = page_table is not None
    if (one != 1 or dc != want_dc or v.shape != k.shape or h % kh
            or k_scale.shape != (n0, n1, kh) or v_scale.shape != k_scale.shape
            or pos.shape != (b,) or (paged and page_table.shape[0] != b)
            or (not paged and n0 != b)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)}, scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)}, pos {tuple(pos.shape)}"
                         + (f", page table {tuple(page_table.shape)}" if paged else ""))
    if k.dtype != _KV_CODES[kv] or v.dtype != _KV_CODES[kv]:
        raise TypeError(f"{name}: K/V codes must be {_KV_CODES[kv]}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32")
    if pos.dtype != torch.int32 or (paged and page_table.dtype != torch.int32):
        raise TypeError(f"{name}: pos and page_table must be int32")
    if _placement(name, *tensors) == "cpu":
        fn = getattr(ref, name + "_ref")
        return fn(q, k, v, k_scale, v_scale, page_table, pos) if paged else \
            fn(q, k, v, k_scale, v_scale, pos)
    g = h // kh
    ctx = page_table.shape[1] * n1 if paged else n1
    if g > 8 or d not in (32, 64, 128):
        raise ValueError(f"{name}: kernel takes up to 8 query heads per KV head and "
                         f"head dim 32/64/128 (got {g}, {d})")
    code = _check_cuda(name, q.dtype, *tensors)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: the K/V codes must start 16-byte aligned")
    chunks, chunk = attention_plan(ctx, n1 if paged else 1, kh, _sm_count(q.device))
    out = torch.empty_like(q)
    if b:
        # the chunks' f32 partials: acc (B, H, chunks, d), then (max, sum)
        ws = (torch.empty(b * h * chunks * (d + 2), dtype=torch.float32, device=q.device)
              if chunks > 1 else None)
        tail = (page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), b, h, kh, d, n1,
                page_table.shape[1]) if paged else \
            (pos.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
             b, h, kh, d, n1)
        _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), *tail, chunk, chunks, code)
    return out


def ring_quant_gqa_attention(q, k, v, k_scale, v_scale, pos) -> torch.Tensor:
    """One-token GQA attention over a dense int8 cache.  q: (B, 1, H, d);
    k/v: (B, W, KH, d) int8; scales: (B, W, KH) f32; pos: (B,) int32,
    last live position per row (inclusive).  Returns (B, 1, H, d)."""
    return _quant_attention("ring_quant_gqa_attention", "int8", q, k, v, k_scale,
                            v_scale, pos)


def ring_nf4_gqa_attention(q, k_codes, v_codes, k_scale, v_scale, pos) -> torch.Tensor:
    """One-token GQA attention over a dense NF4 cache: codes (B, W, KH,
    d/2) uint8, split-packed (byte i = element i low, i + d/2 high)."""
    return _quant_attention("ring_nf4_gqa_attention", "nf4", q, k_codes, v_codes,
                            k_scale, v_scale, pos)


def paged_quant_gqa_attention(q, k_pool, v_pool, ks_pool, vs_pool, page_table,
                              pos) -> torch.Tensor:
    """One-token GQA attention over paged int8 pools (P, page_size, KH, d)
    with scales (P, page_size, KH); page_table (B, max_pages) int32, page
    0 the null page."""
    return _quant_attention("paged_quant_gqa_attention", "int8", q, k_pool, v_pool,
                            ks_pool, vs_pool, pos, page_table)


def paged_nf4_gqa_attention(q, k_pool, v_pool, ks_pool, vs_pool, page_table,
                            pos) -> torch.Tensor:
    """One-token GQA attention over paged NF4 code pools (P, page_size, KH,
    d/2) uint8, split-packed, with scales (P, page_size, KH)."""
    return _quant_attention("paged_nf4_gqa_attention", "nf4", q, k_pool, v_pool,
                            ks_pool, vs_pool, pos, page_table)


# ---------------------------------------------------------------------------
# MoE expert stacks: the SALR op with each row on its own expert
# ---------------------------------------------------------------------------

def _stack_layout(name: str, x2: torch.Tensor, stack) -> tuple:
    """Check an expert stack against x (M, K) by its base family; returns
    (leaves the kernel reads, E, the output width, the family's launch
    ints).  Tiled bitmap (plain or NF4): words (E, K, n_tiles, tile/32)
    with values or codes/scales.  N:M: group bits (E, K, N/m) uint8,
    values (E, K, N/m*n).  Dense: a tensor (E, K, N)."""
    if isinstance(stack, (bm.TiledBitmapWeight, bm.QTiledBitmapWeight)):
        _check_tiled(name, x2, stack, n_lead=1)
        leaves = ((stack.words, stack.codes, stack.scales)
                  if isinstance(stack, bm.QTiledBitmapWeight) else (stack.words, stack.values))
        return (leaves, stack.words.shape[0], stack.cols,
                (stack.n_tiles, stack.tile // 32, stack.cap_t))
    if isinstance(stack, bm.NMWeight):
        bits, vals = stack.group_bits, stack.values
        n, m = stack.n, stack.m
        if (bits.ndim != 3 or bits.shape[1] != x2.shape[1] or bits.shape[2] * m != stack.cols
                or vals.shape != (*bits.shape[:2], bits.shape[2] * n) or not 0 < n <= m <= 8):
            raise ValueError(f"{name}: x has K={x2.shape[1]}; group bits {tuple(bits.shape)}, "
                             f"values {tuple(vals.shape)} do not fit a stacked {n}:{m} "
                             f"weight (E, K, {stack.cols}) (m <= 8)")
        if bits.dtype != torch.uint8:
            raise TypeError(f"{name}: group bits must be uint8")
        if vals.dtype != x2.dtype:
            raise TypeError(f"{name}: values must be {x2.dtype}")
        return (bits, vals), bits.shape[0], stack.cols, (stack.cols, n, m)
    if isinstance(stack, torch.Tensor):
        if stack.ndim != 3 or stack.shape[1] != x2.shape[1]:
            raise ValueError(f"{name}: x has K={x2.shape[1]}; the dense stack "
                             f"{tuple(stack.shape)} must be (E, K, N)")
        if stack.dtype != x2.dtype:
            raise TypeError(f"{name}: the dense stack must be {x2.dtype}")
        return (stack,), stack.shape[0], stack.shape[2], (stack.shape[2],)
    raise TypeError(f"{name}: no expert-stack kernel for {type(stack).__name__}")


def _moe_matmul(name: str, x: torch.Tensor, emap: torch.Tensor, stack, a_cat, b_cat,
                block_m: int, grouped: bool) -> torch.Tensor:
    """Check and run one of the eight expert-stack kernels.  x (..., K)
    rows are padded with zeros to a ``block_m`` multiple; grouped: emap is
    ``tile_expert`` (M_pad / block_m,) int32; decode: ``row_expert``
    (<= M_pad,) int32, padded with -1.  A rank-0 (or absent) adapter
    means no adapter term; B_cat is zero-padded to the encoded width."""
    x2, lead = _flatten(x)
    leaves, n_exp, cols, base_ints = _stack_layout(name, x2, stack)
    adapters = tuple(t for t in (a_cat, b_cat) if t is not None)
    _forward_only(name, x, *leaves, *adapters)
    m, kdim = x2.shape
    if block_m <= 0:
        raise ValueError(f"{name}: block_m {block_m} must be positive")
    if m % block_m:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, block_m - m % block_m))
    mp = x2.shape[0]
    if emap.dtype != torch.int32:
        raise TypeError(f"{name}: the row map must be int32")
    if grouped and emap.shape != (mp // block_m,):
        raise ValueError(f"{name}: tile_expert {tuple(emap.shape)} must map every "
                         f"{block_m}-row tile of {mp} rows")
    if not grouped:
        if emap.ndim != 1 or emap.shape[0] > mp:
            raise ValueError(f"{name}: row_expert {tuple(emap.shape)} has more rows "
                             f"than x ({mp})")
        if emap.shape[0] < mp:
            emap = torch.nn.functional.pad(emap, (0, mp - emap.shape[0]), value=-1)
    emap = emap.contiguous()
    if a_cat is None or a_cat.shape[-1] == 0:
        a_cat = b_cat = None
    else:
        # padded (a copy) only where the encoded width exceeds B_cat's
        b_cat = (torch.nn.functional.pad(b_cat, (0, cols - b_cat.shape[-1]))
                 if b_cat.shape[-1] < cols else b_cat.contiguous())
        if (a_cat.shape[:2] != (n_exp, kdim)
                or b_cat.shape != (n_exp, a_cat.shape[-1], cols)):
            raise ValueError(f"{name}: adapter shapes {tuple(a_cat.shape)} / "
                             f"{tuple(b_cat.shape)} do not fit ({n_exp}, {kdim}, R) / "
                             f"({n_exp}, R, {cols})")
    adapters = tuple(t for t in (a_cat, b_cat) if t is not None)
    if _placement(name, x2, emap, *leaves, *adapters) == "cpu":
        plain = getattr(ref, name + "_ref")
        y = (plain(x2, emap, stack, a_cat, b_cat, block_m) if grouped
             else plain(x2, emap, stack, a_cat, b_cat))
    else:
        if any(t.dtype != x2.dtype for t in adapters):
            raise TypeError(f"{name}: adapters must be {x2.dtype}")
        if isinstance(stack, bm.NMWeight) and stack.n not in (1, 2, 4):
            raise ValueError(f"{name}: the kernel is built for n = 1, 2, 4 (got {stack.n})")
        if (mp // block_m if grouped else n_exp + 1) > 65535:
            raise ValueError(f"{name}: {mp} rows in {block_m}-row tiles exceed the grid")
        code = _check_cuda(name, x2.dtype, emap, *leaves, *adapters)
        r = a_cat.shape[-1] if a_cat is not None else 0
        u = torch.empty((mp, r), dtype=x2.dtype, device=x2.device)
        y = torch.empty((mp, cols), dtype=x2.dtype, device=x2.device)
        if mp:
            ptr = [t.data_ptr() for t in leaves]
            ab = [t.data_ptr() if t is not None else None for t in (a_cat, b_cat)]
            tail = (block_m,) if grouped else ()
            _launch(name, x2.device, x2.data_ptr(), *ptr, *ab, u.data_ptr(), y.data_ptr(),
                    emap.data_ptr(), mp, kdim, r, n_exp, *base_ints, *tail, code)
    return y[:m].reshape(*lead, cols)


def grouped_salr_matmul(x: torch.Tensor, tile_expert: torch.Tensor,
                        tbw: bm.TiledBitmapWeight, a_cat, b_cat, *,
                        block_m: int = 128) -> torch.Tensor:
    """Expert-grouped SALR op: row r of x (..., K) uses expert
    ``tile_expert[r // block_m]``'s tiled bitmap (words (E, K, n_tiles,
    tile/32), values (E, K, n_tiles, cap_t)) and adapters a_cat (E, K, R),
    b_cat (E, R, <= cols); returns (..., tbw.cols)."""
    return _moe_matmul("grouped_salr_spmm", x, tile_expert, tbw, a_cat, b_cat, block_m,
                       grouped=True)


def grouped_qsalr_matmul(x: torch.Tensor, tile_expert: torch.Tensor,
                         q: bm.QTiledBitmapWeight, a_cat, b_cat, *,
                         block_m: int = 128) -> torch.Tensor:
    """:func:`grouped_salr_matmul` over an expert stack's NF4 twin (codes
    (E, K, n_tiles, cap_t/2) uint8, scales (E, K, n_tiles, 1) f32),
    dequantized inside the GEMM."""
    return _moe_matmul("grouped_qsalr_spmm", x, tile_expert, q, a_cat, b_cat, block_m,
                       grouped=True)


def decode_salr_matmul(x: torch.Tensor, row_expert: torch.Tensor,
                       tbw: bm.TiledBitmapWeight, a_cat, b_cat, *,
                       block_m: int = 8) -> torch.Tensor:
    """Decode-grid SALR op: row r of x (..., K), in assignment order, uses
    expert ``row_expert[r]`` (int32; -1, and every row past the map, is a
    pad row whose output is exactly zero)."""
    return _moe_matmul("decode_salr_spmm", x, row_expert, tbw, a_cat, b_cat, block_m,
                       grouped=False)


def decode_qsalr_matmul(x: torch.Tensor, row_expert: torch.Tensor,
                        q: bm.QTiledBitmapWeight, a_cat, b_cat, *,
                        block_m: int = 8) -> torch.Tensor:
    """:func:`decode_salr_matmul` over an expert stack's NF4 twin."""
    return _moe_matmul("decode_qsalr_spmm", x, row_expert, q, a_cat, b_cat, block_m,
                       grouped=False)


def grouped_dense_matmul(x: torch.Tensor, tile_expert: torch.Tensor, w: torch.Tensor,
                         a_cat=None, b_cat=None, *, block_m: int = 128) -> torch.Tensor:
    """:func:`grouped_salr_matmul` over a dense expert stack w (E, K, N)
    of x's dtype (a masked stack's base, or a plain ``{"w"}`` stack with
    no adapters); returns (..., N)."""
    return _moe_matmul("grouped_dense_spmm", x, tile_expert, w, a_cat, b_cat, block_m,
                       grouped=True)


def grouped_nm_matmul(x: torch.Tensor, tile_expert: torch.Tensor, nmw: bm.NMWeight,
                      a_cat=None, b_cat=None, *, block_m: int = 128) -> torch.Tensor:
    """:func:`grouped_salr_matmul` over an N:M expert stack (group bits
    (E, K, N/m) uint8, values (E, K, N/m*n), groups along N), decoded
    inside the GEMM; returns (..., nmw.cols)."""
    return _moe_matmul("grouped_nm_spmm", x, tile_expert, nmw, a_cat, b_cat, block_m,
                       grouped=True)


def decode_dense_matmul(x: torch.Tensor, row_expert: torch.Tensor, w: torch.Tensor,
                        a_cat=None, b_cat=None, *, block_m: int = 8) -> torch.Tensor:
    """:func:`decode_salr_matmul` over a dense expert stack w (E, K, N)."""
    return _moe_matmul("decode_dense_spmm", x, row_expert, w, a_cat, b_cat, block_m,
                       grouped=False)


def decode_nm_matmul(x: torch.Tensor, row_expert: torch.Tensor, nmw: bm.NMWeight,
                     a_cat=None, b_cat=None, *, block_m: int = 8) -> torch.Tensor:
    """:func:`decode_salr_matmul` over an N:M expert stack."""
    return _moe_matmul("decode_nm_spmm", x, row_expert, nmw, a_cat, b_cat, block_m,
                       grouped=False)
