"""Per-row quantized embedding tables for serving (counterpart of
``llp_tpu/serve/quant.py``).

Scheme: ``q[i] = round(h[i] / s_i)`` with ``s_i = max|h[i]| / L`` (per-row
absmax, L = 127 for int8 and 7 for int4; zero rows get s = 1, so q = 0
exactly).  ``torch.round`` rounds half to even like ``jnp.round``, and the
scale and the division are the same fp32 operations as the JAX package's
(:func:`quantize_rows`), so the codes and scales equal its bit for bit.  The
int4 storage layout is byte-identical too (:func:`pack_int4`), so one table
serves both packages (:func:`llp_tpu_torch.utils.params.quant_from_jax`
reads a JAX table).

An int8 table is 4x, an int4 table 8x smaller than the fp32 one.  Retrieval
and pair scoring dequantize on the fly; 'inner' dots run directly on the
codes (:func:`code_dots`), with the rank-1 scale grid ``s_q s_c`` applied
after the integer sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch


@dataclass(frozen=True)
class QuantTable:
    """Per-row symmetric int8 or packed-int4 embedding table.

    ``bits=8``: ``q`` is (N, H) int8 codes.  ``bits=4``: ``q`` is
    lane-packed (ceil(N/2), H) uint8: two two's-complement nibbles per byte
    (low nibble = even column) and two logical rows per storage row (row
    ``r`` occupies bytes ``[(r%2)·H/2, (r%2+1)·H/2)`` of storage row
    ``r//2``).  ``scale`` is (N,) fp32 (``h ≈ codes * scale[:, None]``); its
    length carries the logical N for int4."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    @property
    def shape(self) -> Tuple[int, int]:  # the logical (N, H)
        return (self.scale.shape[0], self.q.shape[1])

    @property
    def dtype(self) -> torch.dtype:  # the storage type
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def fmt(self) -> str:
        return f"int{self.bits}"

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    def to(self, device) -> "QuantTable":
        return QuantTable(self.q.to(device), self.scale.to(device), self.bits)


TableLike = Union[torch.Tensor, QuantTable]


def _levels(bits: int) -> int:
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., W) int8 in [-7, 7] -> (..., W/2) uint8 (low nibble = even col)."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"int4 packing needs an even hidden dim, got H={codes.shape[-1]} "
            "(quantize='int8' supports any width)"
        )
    u = (codes.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) uint8 -> (..., 2W) int8 codes (sign-extended nibbles)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(M, H) int8 codes in [-7, 7] -> lane-packed (ceil(M/2), H) uint8: each
    row nibble-packed to H/2 bytes, then logical rows 2k and 2k+1 side by
    side in storage row k.  Odd M pads one zero half-row.  H must be even."""
    m = codes.shape[0]
    nib = _pack_nibbles(codes)  # (M, H/2)
    if m % 2:
        nib = torch.cat([nib, nib.new_zeros((1, nib.shape[1]))])
    return nib.reshape((m + 1) // 2, codes.shape[1])


def unpack_int4(packed: torch.Tensor, num_rows: int | None = None) -> torch.Tensor:
    """Lane-packed (R, H) uint8 -> (num_rows or 2R, H) int8 codes."""
    r, h_dim = packed.shape
    codes = _unpack_nibbles(packed.reshape(2 * r, h_dim // 2))
    return codes if num_rows is None else codes[:num_rows]


def quantize_rows(h: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax quantization of (M, H) rows: ``(codes, scales)``, the
    codes unpacked int8 in [-L, L].  Requantizing dequantized rows gives the
    same codes at either width (a dequantized row is ``q * s`` with
    ``max|q| = L``) and the scale within one ulp."""
    lv = _levels(bits)
    hf = h.float()
    a = hf.abs().amax(dim=1)
    # XLA folds the JAX package's ``a / L`` into a product with the fp32
    # reciprocal of L; the same product here keeps the scales bit-equal.
    inv = torch.tensor(1.0 / lv, dtype=torch.float32, device=h.device)
    scale = torch.where(a > 0, a * inv, torch.ones_like(a))
    q = torch.round(hf / scale[:, None])
    return q.clamp(-lv, lv).to(torch.int8), scale


def quantize_table(h: torch.Tensor, bits: int = 8) -> QuantTable:
    """Per-row absmax quantization of an (N, H) table, on ``h``'s device."""
    q, scale = quantize_rows(h, bits)
    if bits == 4:
        q = pack_int4(q)
    return QuantTable(q=q, scale=scale, bits=bits)


def codes_rows(table: QuantTable, idx: torch.Tensor) -> torch.Tensor:
    """Unpacked int8 codes of arbitrary rows (int4 gathers the packed
    storage row that holds each one, so the read stays packed)."""
    if table.bits != 4:
        return table.q.index_select(0, idx)
    h_dim = table.q.shape[1]
    halves = table.q.index_select(0, idx // 2).reshape(idx.shape[0], 2, h_dim // 2)
    sel = halves[torch.arange(idx.shape[0], device=idx.device), idx % 2]  # (M, H/2)
    return _unpack_nibbles(sel)


def _clamp(start: int, size: int, total: int) -> int:
    """The start of a ``size``-row window kept inside ``total`` rows, as
    ``jax.lax.dynamic_slice`` clamps it."""
    return max(0, min(start, total - size))


def codes_slice(table: QuantTable, start: int, size: int) -> torch.Tensor:
    """Unpacked int8 codes of the contiguous rows ``[start, start+size)``,
    the window clamped inside the table.  int4 reads ``size//2 + 1``
    storage rows (any start parity) and unpacks only those."""
    if table.bits != 4:
        s0 = _clamp(start, size, table.q.shape[0])
        return table.q[s0:s0 + size]
    r_total, h_dim = table.q.shape
    rs = min(size // 2 + 1, r_total)
    r0 = _clamp(start // 2, rs, r_total)
    codes = _unpack_nibbles(table.q[r0:r0 + rs].reshape(2 * rs, h_dim // 2))  # (2rs, H)
    off = _clamp(start - 2 * r0, size, 2 * rs)
    return codes[off:off + size]


def dequantize_rows(table: QuantTable, idx: torch.Tensor, *,
                    dtype=torch.float32) -> torch.Tensor:
    """Gather and dequantize rows (in fp32, then one cast to ``dtype``)."""
    rows = codes_rows(table, idx).float()
    return (rows * table.scale.index_select(0, idx)[:, None]).to(dtype)


def dequantize_slice(table: QuantTable, start: int, size: int, *,
                     dtype=torch.float32) -> torch.Tensor:
    """Dequantize the contiguous row block ``[start, start+size)``."""
    rows = codes_slice(table, start, size).float()
    s0 = _clamp(start, size, table.scale.shape[0])
    return (rows * table.scale[s0:s0 + size, None]).to(dtype)


# Inner dimension of one exact fp32 product of codes: H·127² < 2^24 holds
# for H <= 1040, so every partial sum of such a product is an exact integer.
_EXACT_K = 1024


def code_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer dots ``a @ b.T`` of int8 codes (M, H) and (B, H), as
    (M, B) int32.

    The product runs as fp32 matmuls of the codes over chunks of at most
    1024 columns: each partial sum is an integer below 2^24, so it is exact
    in any summation order (and under TF32 too, whose 10-bit mantissa holds
    every code), and the chunks add in int32.  ``torch._int_mm`` would read
    the codes as they are, but it takes only CUDA tensors with more than 16
    rows and widths that are multiples of 8; queries come one at a time."""
    out = None
    for k0 in range(0, max(a.shape[1], 1), _EXACT_K):
        part = (a[:, k0:k0 + _EXACT_K].float() @ b[:, k0:k0 + _EXACT_K].float().T).to(torch.int32)
        out = part if out is None else out + part
    return out


# Largest int4 table int8_dot_scores will unpack to (N, H) int8 at once;
# bigger tables go through the blocked retrieval path (per-block unpack).
# Module-level so tests can shrink it.
_INT4_UNPACK_MAX_BYTES = 256 * (1 << 20)


def int8_dot_scores(table: QuantTable, query_idx: torch.Tensor, *,
                    pad_to: int = 512) -> torch.Tensor:
    """``<h_q, h_c>`` of the query rows against the whole table, (Q, N_pad)
    fp32: the exact integer dot of the codes times the rank-1 scale grid
    ``s_q s_c``.  N pads to ``pad_to`` with zero rows (score 0)."""
    n, h_dim = table.shape
    n_pad = -(-n // pad_to) * pad_to
    if table.bits == 4:
        if n * h_dim > _INT4_UNPACK_MAX_BYTES:
            raise ValueError(
                f"int8_dot_scores would unpack the ENTIRE int4 table to a "
                f"({n}, {h_dim}) int8 transient ({n * h_dim / 2**30:.1f} GiB); "
                f"use top_k_partners / the blocked retrieval path for large "
                f"int4 tables (per-block unpack keeps the packed format's "
                f"memory edge)."
            )
        qp = unpack_int4(table.q, num_rows=n)
    else:
        qp = table.q
    sp = table.scale
    if n_pad != n:
        qp = torch.cat([qp, qp.new_zeros((n_pad - n, h_dim))])
        sp = torch.cat([sp, sp.new_zeros((n_pad - n,))])
    query_idx = torch.as_tensor(query_idx, dtype=torch.int64, device=table.device)
    dots = code_dots(codes_rows(table, query_idx), qp)
    s_q = table.scale.index_select(0, query_idx)
    return dots.float() * (s_q[:, None] * sp[None, :])


def table_num_nodes(h: TableLike) -> int:
    return int(h.shape[0])


def table_dim(h: TableLike) -> int:
    return int(h.shape[1])


def as_numpy_dense(h: TableLike) -> np.ndarray:
    """The fp32 view on the host (a test and debugging aid: N·H·4 bytes)."""
    if isinstance(h, QuantTable):
        codes = unpack_int4(h.q, num_rows=h.shape[0]) if h.bits == 4 else h.q
        return codes.cpu().numpy().astype(np.float32) * h.scale.cpu().numpy()[:, None]
    return h.detach().float().cpu().numpy()
