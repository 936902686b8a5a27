"""K6: circomlib MultiMiMC7([left, right], key 0) over BN254 Fr.

`mimc_hash2(left, right)` takes int32[..., 16] Montgomery tensors and
returns the MiMC Merkle node hash.  On CUDA tensors it launches
csrc/mimc.cu (one thread per hash, any N), on CPU tensors it runs the plain
twin below.  The wrapper counts its launches in `.launches` and `.widths`.
"""

from __future__ import annotations

import functools
import time

import torch

from ..ops.constants import mimc7_constants
from . import build
from .field_ops import (MODULI, add_lm, broadcast_shape, count_launch, from_lm, keep_operands,
                        kernel_operand, mul_lm, on_cpu, plain_consts, stream_handle, to_lm,
                        zero_counts)


@functools.lru_cache(maxsize=None)
def round_constants_lm(device: torch.device) -> torch.Tensor:
    """The 91 MiMC7 round constants as limb-major int64 Montgomery columns
    (91, 16, 1)."""
    p = MODULI["fr"]
    return torch.tensor([[[((c << 256) % p >> (16 * i)) & 0xFFFF] for i in range(16)]
                         for c in mimc7_constants()], dtype=torch.int64, device=device)


def mimc_hash2_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    shape = broadcast_shape(left.shape, right.shape)
    c = round_constants_lm(left.device)
    fr = plain_consts("fr", left.device)
    mul = lambda a, b: mul_lm(a, b, fr)  # noqa: E731
    add = lambda a, b: add_lm(a, b, fr)  # noqa: E731

    def pow7(x):
        x2 = mul(x, x)
        x4 = mul(x2, x2)
        return mul(mul(x4, x2), x)

    def mimc7(x, k):
        r = pow7(add(x, k))
        for i in range(1, c.shape[0]):
            r = pow7(add(add(r, k), c[i]))
        return add(r, k)

    xs = [to_lm(t.expand(shape)) for t in (left, right)]
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = add(add(acc, x), mimc7(x, acc))
    return from_lm(acc, shape)


def mimc_hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """MultiMiMC7([left, right], key 0) (K6)."""
    t0 = time.perf_counter_ns()
    if on_cpu(left, right):
        return mimc_hash2_plain(left, right)
    shape = broadcast_shape(left.shape, right.shape)
    lt = kernel_operand(left.expand(shape))
    rt = kernel_operand(right.expand(shape))
    n = lt.shape[0]
    keep_operands(mimc_hash2, n, left, right)
    out = torch.empty((n, 16), dtype=torch.int32, device=lt.device)
    rc = build.library("mimc").mimc2_launch(lt.data_ptr(), rt.data_ptr(), out.data_ptr(), n,
                                            stream_handle(lt.device))
    build.check(rc, "mimc2_launch")
    count_launch(mimc_hash2, n, t0)
    return out.reshape(shape)


zero_counts(mimc_hash2)
