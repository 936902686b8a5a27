"""K5: one DIT stage of the radix-2 NTT, in place; K7: the fused column NTT.

`butterfly_stage(x, pows, log_m)` runs stage m = 2^log_m of the iterative
decimation-in-time transform along axis 0 of x int32[n, ..., 16]
(Montgomery, trailing axes batch), in place: for every group g and
j < m/2, a = x[g·m + j] and b = x[g·m + j + m/2] become a + b·w and a − b·w
with w = pows[j·(n/m)], pows the n/2 powers ω_n^j.  It computes what the
TPU's `butterfly_pallas` computes, for a whole stage per launch.

`ntt_cols(x, tw)` is the NTT along axis 0 of x int32[n1, cols, 16], natural
order in and out, with tw the n1/2 powers ω_{n1}^j (the inverse transform
takes the inverse powers); it is the TPU's `_axis0_ntt` (bit-reversal
gather and fused column kernel) in one launch.

On CUDA tensors each wrapper launches csrc/ntt.cu or raises; on CPU tensors
it runs the plain twin in this module, which composes the int64 K1 twins.
Each wrapper counts its launches in `.launches` and `.widths`.
"""

from __future__ import annotations

import functools

import torch

from . import build
from .field_ops import (FIELD_INDEX, L, count_launch, keep_operands, kernel_operand,
                        mod_add_plain, mod_sub_plain, mont_mul_plain, on_cpu, stream_handle)

MAX_COLS_LOGN = 12   # a 2^12 column and its twiddles fill 194 KB of shared memory


@functools.lru_cache(maxsize=None)
def bitrev_indices(log_n: int) -> torch.Tensor:
    """int64[2^log_n]: i -> i with its log_n bits reversed."""
    idx = torch.arange(1 << log_n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for i in range(log_n):
        rev = (rev << 1) | ((idx >> i) & 1)
    return rev


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    return n.bit_length() - 1


def _check(x: torch.Tensor, table: torch.Tensor, rows: int) -> None:
    for t in (x, table):
        if t.dtype != torch.int32 or t.shape[-1] != L:
            raise TypeError(f"expected int32[..., {L}], got {t.dtype}{list(t.shape)}")
    if table.shape != (rows, L):
        raise ValueError(f"twiddle table of shape {tuple(table.shape)}, expected ({rows}, {L})")


# ---------------------------------------------------------------------------
# K5: one DIT stage, in place
# ---------------------------------------------------------------------------

def butterfly_stage_plain(x: torch.Tensor, pows: torch.Tensor, log_m: int,
                          field: str = "fr") -> torch.Tensor:
    n = x.shape[0]
    m = 1 << log_m
    half = m // 2
    y = x.view(n // m, m, -1, L)
    w = pows[:: n // m][:half].reshape(1, half, 1, L)
    a, b = y[:, :half], y[:, half:]
    t = mont_mul_plain(b, w, field)
    lo, hi = mod_add_plain(a, t, field), mod_sub_plain(a, t, field)
    y[:, :half] = lo
    y[:, half:] = hi
    return x


def butterfly_stage(x: torch.Tensor, pows: torch.Tensor, log_m: int,
                    field: str = "fr") -> torch.Tensor:
    """DIT stage 2^log_m over axis 0 of the contiguous x, in place (K5);
    returns x."""
    n = x.shape[0]
    log_n = _log2(n)
    _check(x, pows, max(n // 2, 1))
    if not 1 <= log_m <= log_n:
        raise ValueError(f"stage 2^{log_m} of a 2^{log_n}-point transform")
    if not x.is_contiguous():
        raise ValueError("butterfly_stage works in place on a contiguous tensor")
    if on_cpu(x, pows):
        return butterfly_stage_plain(x, pows, log_m, field)
    batch = x.numel() // (n * L)
    if (n // 2) * batch >= 1 << 31:
        raise ValueError("a stage of 2^31 or more butterflies")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    keep_operands(butterfly_stage, (n // 2) * batch, x, pows, log_m, field)
    p = kernel_operand(pows)
    rc = build.library("ntt").ntt_stage_launch(x.data_ptr(), p.data_ptr(), n, batch, log_m,
                                               FIELD_INDEX[field], stream_handle(x.device))
    build.check(rc, "ntt_stage_launch")
    count_launch(butterfly_stage, (n // 2) * batch)
    return x


# ---------------------------------------------------------------------------
# K7: the fused column NTT
# ---------------------------------------------------------------------------

def ntt_cols_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    log_n1 = _log2(x.shape[0])
    y = x.index_select(0, bitrev_indices(log_n1).to(x.device)).contiguous()
    for s in range(1, log_n1 + 1):
        butterfly_stage_plain(y, tw, s, "fr")
    return y


def ntt_cols(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """NTT over Fr along axis 0 of x int32[n1, cols, 16], natural order in
    and out, twiddles tw = ω_{n1}^j for j < n1/2 (K7)."""
    if x.ndim != 3:
        raise ValueError(f"expected int32[n1, cols, {L}], got {list(x.shape)}")
    log_n1 = _log2(x.shape[0])
    _check(x, tw, max(x.shape[0] // 2, 1))
    if not 1 <= log_n1 <= MAX_COLS_LOGN:
        raise ValueError(f"a fused column of 2^{log_n1} points (1..{MAX_COLS_LOGN})")
    if on_cpu(x, tw):
        return ntt_cols_plain(x, tw)
    xt, t = kernel_operand(x), kernel_operand(tw)
    cols = x.shape[1]
    keep_operands(ntt_cols, cols, x, tw)
    out = torch.empty_like(xt)
    rc = build.library("ntt").ntt_cols_launch(xt.data_ptr(), t.data_ptr(), out.data_ptr(),
                                              log_n1, cols, stream_handle(x.device))
    build.check(rc, "ntt_cols_launch")
    count_launch(ntt_cols, cols)
    return out.view(x.shape)


for _wrapper in (butterfly_stage, ntt_cols):
    _wrapper.launches, _wrapper.widths = 0, {}
