"""Tiled bitmap encoding of pruned weights (the kernels' storage format).

Layout, kept bit for bit from the reference (``repro.core.bitmap``), so
imported encodings decode the same way:

  * ``words``  : (rows, n_tiles, tile//32) -- per (row, column-tile) cell
    the bitmap packed 32 columns per word, bit j of word w = column
    32w+j of the tile (LSB first).  Held as ``torch.int32`` carrying the
    uint32 bit pattern: torch implements no shifts on uint32.
  * ``values`` : (rows, n_tiles, cap_t) -- the cell's kept values in
    column order, padded to the static capacity ``cap_t``; a set bit's
    slot is the exclusive popcount of the bits before it, clamped to
    ``cap_t - 1``.  Cells whose population exceeds ``cap_t`` spill their
    smallest-magnitude entries, returned so callers fold them into the
    SVD residual (W = W_hat + E stays exact).

The N:M (2:4) variant (``NMWeight``) keeps exactly n values in every
group of m consecutive columns: ``group_bits`` (rows, cols/m) uint8, bit
t of byte g marking column m*g + t, and ``values`` (rows, cols/m * n),
a set bit's slot being its exclusive popcount within the group.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quant import nf4_index, nf4_levels

_MASK32 = (1 << 32) - 1


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a boolean (rows, cols) mask into int32 words (rows, ceil(cols/32))
    holding the uint32 bit patterns."""
    rows, cols = mask.shape
    padded = round_up(cols, 32)
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, padded - cols))
    m = m.reshape(rows, padded // 32, 32)
    words = (m << _shifts(mask.device)).sum(dim=-1)          # < 2**32
    return (words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


def unpack_bits(words: torch.Tensor, cols: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns boolean (rows, cols)."""
    rows, n_words = words.shape
    w = words.to(torch.int64) & _MASK32
    bits = (w[:, :, None] >> _shifts(words.device)) & 1
    return bits.reshape(rows, n_words * 32)[:, :cols].to(torch.bool)


@dataclasses.dataclass(frozen=True)
class BitmapWeight:
    """Row-encoded bitmap matrix (one cell per row): the building block of
    the tiled format."""
    words: torch.Tensor     # int32 (rows, ceil(cols/32))
    values: torch.Tensor    # (rows, cap)
    cols: int
    cap: int


def encode(w_hat: torch.Tensor, mask: torch.Tensor, cap: int):
    """Encode ``w_hat`` (already-masked weights) under ``mask``.

    Returns (BitmapWeight, spill): ``spill`` holds the entries that did
    not fit in ``cap`` (smallest-magnitude entries of overflowing rows),
    so ``decode(bw) + spill == w_hat``."""
    rows, cols = w_hat.shape
    mag = w_hat.abs() * mask
    order = torch.argsort(-mag, dim=1, stable=True)
    mag_rank = torch.argsort(order, dim=1, stable=True)
    kept = mask & (mag_rank < cap)
    zero = torch.zeros((), dtype=w_hat.dtype, device=w_hat.device)
    spill = torch.where(mask & ~kept, w_hat, zero)
    kept_i = kept.to(torch.int64)
    slot = (torch.cumsum(kept_i, dim=1) - kept_i).clamp(max=cap - 1)
    rows_idx = torch.arange(rows, device=w_hat.device)[:, None].expand(rows, cols)
    values = torch.zeros((rows, cap), dtype=w_hat.dtype, device=w_hat.device)
    # kept slots are distinct (a row keeps at most ``cap`` entries)
    values[rows_idx[kept], slot[kept]] = w_hat[kept]
    return BitmapWeight(words=pack_bits(kept), values=values, cols=cols,
                        cap=cap), spill


def decode(bw: BitmapWeight) -> torch.Tensor:
    """Dense decode: exclusive-popcount slots clamped to ``cap - 1``."""
    bits = unpack_bits(bw.words, bw.cols)
    b = bits.to(torch.int64)
    slot = (torch.cumsum(b, dim=1) - b).clamp(max=bw.cap - 1)
    gathered = torch.gather(bw.values, 1, slot)
    return torch.where(bits, gathered, torch.zeros((), dtype=bw.values.dtype,
                                                   device=bw.values.device))


@dataclasses.dataclass(frozen=True)
class TiledBitmapWeight:
    """Bitmap matrix tiled along columns: each (row, column-tile) cell
    stores its own compact value segment of static capacity ``cap_t``.
    An expert stack carries a leading E axis on both leaves (all experts
    share ``tile`` and ``cap_t``)."""
    words: torch.Tensor     # int32 ([E,] rows, n_tiles, tile//32)
    values: torch.Tensor    # ([E,] rows, n_tiles, cap_t)
    cols: int
    tile: int
    cap_t: int

    @property
    def rows(self) -> int:
        return self.words.shape[-3]

    @property
    def n_tiles(self) -> int:
        return self.words.shape[-2]


def tiled_capacity(tile: int, p: float, slack_sigmas: float = 4.0,
                   align: int = 8) -> int:
    """Per-tile capacity: mean + slack_sigmas * binomial std, aligned."""
    mean = tile * (1.0 - p)
    std = math.sqrt(tile * p * (1.0 - p))
    return min(tile, round_up(int(math.ceil(mean + slack_sigmas * std)), align))


def default_tile(cols: int, tile: int = 256) -> int:
    """Kernel N-tile for a matrix with ``cols`` columns: a multiple of 32
    no wider than ``tile`` (columns are zero-padded to a tile multiple)."""
    return min(tile, round_up(cols, 32))


def tile_encode(w_hat: torch.Tensor, mask: torch.Tensor, tile: int, cap_t: int):
    """Encode into the tiled format.  Returns (TiledBitmapWeight, spill)."""
    rows, cols = w_hat.shape
    if cols % tile or tile % 32:
        raise ValueError(f"cols={cols} must be a multiple of tile={tile}, "
                         "itself a multiple of 32")
    n_tiles = cols // tile
    bw, spill = encode(w_hat.reshape(rows * n_tiles, tile),
                       mask.reshape(rows * n_tiles, tile), cap_t)
    tbw = TiledBitmapWeight(
        words=bw.words.reshape(rows, n_tiles, tile // 32),
        values=bw.values.reshape(rows, n_tiles, cap_t),
        cols=cols, tile=tile, cap_t=cap_t)
    return tbw, spill.reshape(rows, cols)


def tile_decode(tbw: TiledBitmapWeight) -> torch.Tensor:
    """Dense ([E,] rows, cols) decode of the tiled format."""
    lead = tbw.words.shape[:-2]                   # ([E,] rows)
    cells = tbw.words.numel() // (tbw.tile // 32)
    bw = BitmapWeight(words=tbw.words.reshape(cells, tbw.tile // 32),
                      values=tbw.values.reshape(cells, tbw.cap_t),
                      cols=tbw.tile, cap=tbw.cap_t)
    return decode(bw).reshape(*lead, tbw.cols)


@dataclasses.dataclass(frozen=True)
class QTiledBitmapWeight:
    """Tiled bitmap whose compact values are NF4-quantized per cell: the
    storage the fused dequant-decode kernel (``ops.qsalr_matmul``) reads."""
    words: torch.Tensor     # int32 ([E,] rows, n_tiles, tile//32)
    codes: torch.Tensor     # uint8 ([E,] rows, n_tiles, cap_t//2)
    scales: torch.Tensor    # f32   ([E,] rows, n_tiles, 1)
    cols: int
    tile: int
    cap_t: int

    @property
    def rows(self) -> int:
        return self.words.shape[-3]

    @property
    def n_tiles(self) -> int:
        return self.words.shape[-2]


def tile_quantize_nf4(tbw: TiledBitmapWeight):
    """Per-cell NF4 quantization of a tiled bitmap's compact values (an
    expert stack's too).  Returns (QTiledBitmapWeight sharing
    ``tbw.words``, dense ([E,] rows, cols) quantization error).  ``cap_t`` must be even."""
    if tbw.cap_t % 2:
        raise ValueError(f"cap_t={tbw.cap_t} must be even to pack NF4 nibbles")
    vals = tbw.values.float()                                # ([E,] rows, T, cap_t)
    scales = vals.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    idx = nf4_index(vals / scales)
    codes = idx[..., 0::2] | (idx[..., 1::2] << 4)
    q = QTiledBitmapWeight(words=tbw.words, codes=codes, scales=scales,
                           cols=tbw.cols, tile=tbw.tile, cap_t=tbw.cap_t)
    deq = nf4_levels(vals.device)[idx.long()] * scales
    qerr = tile_decode(dataclasses.replace(tbw, values=(vals - deq).to(tbw.values.dtype)))
    return q, qerr


def tile_dequantize_nf4(q: QTiledBitmapWeight, dtype=torch.float32) -> TiledBitmapWeight:
    """Value-carrying tiled bitmap of ``q``: level x cell scale in f32,
    then one rounding to ``dtype``.  Byte i of a cell's codes holds slot
    2i (low nibble) and slot 2i+1 (high nibble)."""
    idx = torch.stack([q.codes & 0x0F, q.codes >> 4], dim=-1).reshape(q.codes.shape[:-1] + (-1,))
    vals = nf4_levels(q.codes.device)[idx.long()] * q.scales
    return TiledBitmapWeight(words=q.words, values=vals.to(dtype), cols=q.cols,
                             tile=q.tile, cap_t=q.cap_t)


def qtile_decode(q: QTiledBitmapWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense ([E,] rows, cols) decode of the quantized tiled format."""
    return tile_decode(tile_dequantize_nf4(q, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class NMWeight:
    """N:M semi-structured matrix: exactly n nonzeros per m columns.  An
    expert stack carries a leading E axis on both leaves; ``rows`` and
    ``cols`` are one expert's."""
    group_bits: torch.Tensor    # uint8 ([E,] rows, cols//m), bit t = column m*g + t
    values: torch.Tensor        # ([E,] rows, cols//m * n)
    cols: int
    n: int
    m: int

    @property
    def rows(self) -> int:
        return self.group_bits.shape[-2]


def nm_encode(w: torch.Tensor, n: int = 2, m: int = 4, mask=None):
    """Encode ``w`` ([E,] rows, cols) under an N:M mask (``prune.nm_mask``
    of ``w`` unless given), groups along the last axis.  Returns
    (NMWeight, residual W - W_hat)."""
    from repro_torch.core import prune
    *lead, cols = w.shape
    if cols % m:
        raise ValueError(f"cols={cols} not divisible by m={m}")
    if mask is None:
        mask = prune.nm_mask(w, n=n, m=m)
    g = mask.reshape(*lead, cols // m, m)
    shifts = torch.arange(m, dtype=torch.int32, device=w.device)
    group_bits = (g.to(torch.int32) << shifts).sum(dim=-1).to(torch.uint8)
    ki = g.to(torch.int64)
    slot = (torch.cumsum(ki, dim=-1) - ki).clamp(max=n - 1)   # 0..n-1 in the group
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    kept = torch.where(g, w.reshape(*lead, cols // m, m), zero)
    values = torch.zeros((*lead, cols // m, n), dtype=w.dtype, device=w.device)
    values.scatter_add_(-1, slot, kept)
    nmw = NMWeight(group_bits=group_bits, values=values.reshape(*lead, cols // m * n),
                   cols=cols, n=n, m=m)
    return nmw, prune.residual(w, mask)


def nm_decode(nmw: NMWeight) -> torch.Tensor:
    """Dense ([E,] rows, cols) decode of an N:M matrix (slots clamped to
    n - 1)."""
    n, m = nmw.n, nmw.m
    shifts = torch.arange(m, dtype=torch.uint8, device=nmw.group_bits.device)
    bits = ((nmw.group_bits[..., None] >> shifts) & 1).to(torch.bool)
    b = bits.to(torch.int64)
    slot = (torch.cumsum(b, dim=-1) - b).clamp(max=n - 1)
    gathered = torch.gather(nmw.values.reshape(*nmw.group_bits.shape, n), -1, slot)
    zero = torch.zeros((), dtype=nmw.values.dtype, device=nmw.values.device)
    return torch.where(bits, gathered, zero).reshape(*nmw.group_bits.shape[:-1], nmw.cols)
