"""K4: circomlib Poseidon t = 3 over BN254 Fr, two inputs to one hash.

`poseidon_hash2(left, right)` takes int32[..., 16] Montgomery tensors and
returns state[0] of the permutation of (0, left, right).  On CUDA tensors
it launches csrc/poseidon.cu (three threads per hash, any N), on CPU
tensors it runs the plain twin below.  The wrapper counts its launches in
`.launches` and `.widths`.
"""

from __future__ import annotations

import functools

import torch

from ..ops.constants import POSEIDON_RF, POSEIDON_RP, poseidon_params
from . import build
from .field_ops import (MODULI, add_lm, count_launch, from_lm, kernel_operand, mul_lm, on_cpu,
                        plain_consts, stream_handle, to_lm)


@functools.lru_cache(maxsize=None)
def round_constants_lm(device: torch.device):
    """(round constants (n_rounds, 3, 16, 1), MDS (3, 3, 16, 1)) as
    limb-major int64 Montgomery columns, and the full/partial split."""
    t = 3
    C, M = poseidon_params(t)
    p = MODULI["fr"]
    col = lambda v: torch.tensor([((v << 256) % p >> (16 * i)) & 0xFFFF  # noqa: E731
                                  for i in range(16)], dtype=torch.int64,
                                 device=device)[:, None]
    n_rounds = POSEIDON_RF + POSEIDON_RP[t - 2]
    c = torch.stack([torch.stack([col(C[r * t + i]) for i in range(t)])
                     for r in range(n_rounds)])
    m = torch.stack([torch.stack([col(M[i][j]) for j in range(t)]) for i in range(t)])
    return c, m, n_rounds


def poseidon_hash2_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(left.shape, right.shape)
    c, m, n_rounds = round_constants_lm(left.device)
    fr = plain_consts("fr", left.device)
    mul = lambda a, b: mul_lm(a, b, fr)  # noqa: E731
    add = lambda a, b: add_lm(a, b, fr)  # noqa: E731

    def pow5(x):
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)

    # the three state words side by side: (16, 3N), word i in columns iN..
    l_lm = to_lm(left.expand(shape))
    n = l_lm.shape[1]
    s = torch.cat([torch.zeros_like(l_lm), l_lm, to_lm(right.expand(shape))], dim=1)
    blocks = lambda cols: torch.cat([x.expand(16, n) for x in cols], dim=1)  # noqa: E731
    mds = blocks([m[i, j] for i in range(3) for j in range(3)])   # (16, 9N)
    half = POSEIDON_RF // 2
    r_p = n_rounds - POSEIDON_RF
    for r in range(n_rounds):
        s = add(s, blocks([c[r, i] for i in range(3)]))
        if r < half or r >= half + r_p:
            s = pow5(s)
        else:
            s = torch.cat([pow5(s[:, :n]), s[:, n:]], dim=1)
        y = mul(s.repeat(1, 3), mds).view(16, 3, 3, n)           # [., i, j] = M[i, j]·s_j
        term = lambda j: y[:, :, j].reshape(16, 3 * n)  # noqa: E731
        s = add(add(term(0), term(1)), term(2))
    return from_lm(s[:, :n], shape)


def poseidon_hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Poseidon(left, right) with circomlib t = 3 parameters (K4)."""
    if on_cpu(left, right):
        return poseidon_hash2_plain(left, right)
    shape = torch.broadcast_shapes(left.shape, right.shape)
    lt = kernel_operand(left.expand(shape))
    rt = kernel_operand(right.expand(shape))
    n = lt.shape[0]
    out = torch.empty((n, 16), dtype=torch.int32, device=lt.device)
    lib = build.library("poseidon")
    rc = lib.poseidon2_launch(lt.data_ptr(), rt.data_ptr(), out.data_ptr(), n,
                              stream_handle(lt.device))
    build.check(rc, "poseidon2_launch")
    count_launch(poseidon_hash2, n)
    return out.reshape(shape)


poseidon_hash2.launches, poseidon_hash2.widths = 0, {}
