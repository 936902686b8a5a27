"""K4: circomlib Poseidon t = 3 over BN254 Fr, two inputs to one hash.

`poseidon_hash2(left, right)` takes int32[..., 16] Montgomery tensors and
returns state[0] of the permutation of (0, left, right).  On CUDA tensors
it launches csrc/poseidon.cu (three threads per hash, any N), on CPU
tensors it runs the plain twin below.  The wrapper counts its launches in
`.launches` and `.widths`.

The twin keeps the three state words side by side and each round's words
below 2p: the round constants are added without a reduction (K1's
product takes such a sum), and the MDS mix sums each row's three products
column by column and reduces once (`field_ops.redc_cols`).  Every reduced
value is canonical, so the hash is the canonical state word 0, as the
kernel's.
"""

from __future__ import annotations

import functools
import time

import torch

from ..ops.constants import POSEIDON_RF, POSEIDON_RP, poseidon_params
from . import build
from .field_ops import (MODULI, broadcast_shape, count_launch, from_lm, keep_operands,
                        kernel_operand, limb_rows, mul_lm, on_cpu, plain_chunked, plain_consts,
                        redc_cols, stream_handle, to_lm, zero_counts)


@functools.lru_cache(maxsize=None)
def round_constants_lm(device: torch.device):
    """(round constants (n_rounds, 16, 3, 1), MDS (16, 3, 3) as [limb, i, j])
    as limb-major int64 Montgomery columns, and the full/partial split."""
    t = 3
    C, M = poseidon_params(t)
    p = MODULI["fr"]
    col = lambda v: limb_rows((v << 256) % p, device)  # noqa: E731
    n_rounds = POSEIDON_RF + POSEIDON_RP[t - 2]
    c = torch.stack([torch.cat([col(C[r * t + i]) for i in range(t)], dim=1)[:, :, None]
                     for r in range(n_rounds)])
    m = torch.stack([torch.cat([col(M[i][j]) for j in range(t)], dim=1) for i in range(t)], dim=1)
    return c, m, n_rounds


PLAIN_HASHES = 1 << 15   # hashes per twin call: the MDS products take 6 KB a hash


def _permute_lm(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """State word 0 of the permutation of (0, left, right), limb-major
    (16, n) in and out."""
    c, m, n_rounds = round_constants_lm(left.device)
    fr = plain_consts("fr", left.device)
    mul = lambda a, b: mul_lm(a, b, fr)  # noqa: E731

    def pow5(x):
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)

    n = left.shape[1]
    s = torch.stack([torch.zeros_like(left), left, right], dim=1)      # (16, 3, n)
    half = POSEIDON_RF // 2
    r_p = n_rounds - POSEIDON_RF
    for r in range(n_rounds):
        x = s + c[r]                                   # below 2p, limbs below 2^17
        if r < half or r >= half + r_p:
            x = pow5(x.view(16, 3 * n)).view(16, 3, n)
        else:
            x = torch.cat([pow5(x[:, 0])[:, None], x[:, 1:]], dim=1)
        # s_i = Σ_j M_ij·x_j: the limb products x_j[a]·M_ij[b] of every j
        # summed into columns a + b, one reduction for all three rows
        t = x.new_zeros(32, 3 * n)
        for j in range(3):
            t.index_add_(0, fr.col_of, (x[:, None, j, None] * m[None, :, :, j, None])
                         .reshape(256, 3 * n))
        s = redc_cols(t, fr).view(16, 3, n)
    return s[:, 0]


def poseidon_hash2_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    shape = broadcast_shape(left.shape, right.shape)
    rows = [x.expand(shape).reshape(-1, 16) for x in (left, right)]
    out = plain_chunked(lambda a, b: from_lm(_permute_lm(to_lm(a), to_lm(b)), (-1, 16)),
                        rows[0].shape[0], *rows, chunk=PLAIN_HASHES)
    return out.reshape(shape)


def poseidon_hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Poseidon(left, right) with circomlib t = 3 parameters (K4)."""
    t0 = time.perf_counter_ns()
    if on_cpu(left, right):
        return poseidon_hash2_plain(left, right)
    shape = broadcast_shape(left.shape, right.shape)
    lt = kernel_operand(left.expand(shape))
    rt = kernel_operand(right.expand(shape))
    n = lt.shape[0]
    keep_operands(poseidon_hash2, n, left, right)
    out = torch.empty((n, 16), dtype=torch.int32, device=lt.device)
    lib = build.library("poseidon")
    rc = lib.poseidon2_launch(lt.data_ptr(), rt.data_ptr(), out.data_ptr(), n,
                              stream_handle(lt.device))
    build.check(rc, "poseidon2_launch")
    count_launch(poseidon_hash2, n, t0)
    return out.reshape(shape)


zero_counts(poseidon_hash2)
