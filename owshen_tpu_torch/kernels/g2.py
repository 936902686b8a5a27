"""K1's G2 point operations: complete projective G2 addition and doubling
over BN254 Fq2 = Fq[u]/(u² + 1), b3 = 3·b' = 9/(9 + u).

Points are (X, Y, Z) tuples of int32[..., 2, 16] Montgomery tensors
(component 0 = c0, 1 = c1, the JAX package's layout); the identity is
(0 : 1 : 0).  `g2_add` / `g2_double` launch csrc/g2.cu (two threads per
point, any N) on CUDA tensors, or run their plain twins on CPU tensors.
Each wrapper counts its launches in `.launches` and `.widths` (in points).

The plain twins run kernels/g1.py's RCB15 formulas (algorithms 7 and 9,
a = 0, the operation order of owshen_tpu/curves/weierstrass.py) over
`Fq2Ops`, on the limb-major int64 helpers of kernels/field_ops.py: an Fq2
product in the Karatsuba form of owshen_tpu/fields/fq2.py (three Fq
products), a square in the complex form (two).  These are the least work,
which chip_smoke.py's bound charges per point.
"""

from __future__ import annotations

import functools

import torch

from ..oracle.curve import B_G2
from ..oracle.field import P_FQ
from . import build
from .field_ops import (add_lm, count_launch, from_lm, keep_operands, kernel_operand, L, MASK,
                        mul_lm, on_cpu, PLAIN_CHUNK, plain_chunked, plain_consts, stream_handle,
                        sub_lm, to_lm)
from .g1 import add_lm_pts, broadcast_coords, double_lm_pts

B3 = ((3 * B_G2[0]) % P_FQ, (3 * B_G2[1]) % P_FQ)   # 3·b' as (c0, c1)


def b3_mont_words() -> list[int]:
    """b3's two components in Montgomery form, 8 little-endian words each
    (the g2 library's constant)."""
    return [w for c in B3 for w in build.words_le(c * (1 << 256) % P_FQ)]


@functools.lru_cache(maxsize=None)
def _b3_columns(device: torch.device) -> torch.Tensor:
    """(16, 3) limb-major Montgomery b3_0, b3_1 and b3_0 + b3_1."""
    vals = [B3[0], B3[1], (B3[0] + B3[1]) % P_FQ]
    mont = [v * (1 << 256) % P_FQ for v in vals]
    return torch.tensor([[(m >> (16 * i)) & MASK for m in mont] for i in range(L)],
                        dtype=torch.int64, device=device)


class Fq2Ops:
    """Fq2 ops for the RCB15 formulas: an element is a (c0, c1) pair of
    limb-major (16, N) int64 tensors; `cat` lays independent elements side
    by side so that they share one call, `split` undoes it."""

    def __init__(self, device):
        self.c = plain_consts("fq", device)
        self.b3 = _b3_columns(device)

    @staticmethod
    def cat(*xs):
        return (torch.cat([x[0] for x in xs], dim=1), torch.cat([x[1] for x in xs], dim=1))

    @staticmethod
    def split(x, k):
        return list(zip(x[0].chunk(k, dim=1), x[1].chunk(k, dim=1)))

    def _both(self, fn, a, b):
        """fn on both components in one call"""
        n = a[0].shape[1]
        r = fn(torch.cat(a, dim=1), torch.cat(b, dim=1), self.c)
        return r[:, :n], r[:, n:]

    def add(self, a, b):
        return self._both(add_lm, a, b)

    def sub(self, a, b):
        return self._both(sub_lm, a, b)

    def _karatsuba(self, a, b0, b1, bs):
        """(a0b0 − a1b1, (a0 + a1)(b0 + b1) − a0b0 − a1b1), bs = b0 + b1"""
        c, n = self.c, a[0].shape[1]
        a0, a1 = a
        sa = add_lm(a0, a1, c)
        v = mul_lm(torch.cat([a0, a1, sa], dim=1), torch.cat([b0, b1, bs], dim=1), c)
        v0, v1, t = v[:, :n], v[:, n:2 * n], v[:, 2 * n:]
        d = sub_lm(torch.cat([v0, t], dim=1), torch.cat([v1, v0], dim=1), c)
        return d[:, :n], sub_lm(d[:, n:], v1, c)

    def mul(self, a, b):
        return self._karatsuba(a, b[0], b[1], add_lm(b[0], b[1], self.c))

    def sqr(self, a):
        """((a0 + a1)(a0 − a1), 2·a0a1): two products where a product
        takes three"""
        c, n = self.c, a[0].shape[1]
        a0, a1 = a
        v = mul_lm(torch.cat([add_lm(a0, a1, c), a0], dim=1),
                   torch.cat([sub_lm(a0, a1, c), a1], dim=1), c)
        return v[:, :n], add_lm(v[:, n:], v[:, n:], c)

    def mul_b3(self, x):
        n = x[0].shape[1]
        b0, b1, bs = (self.b3[:, i:i + 1].expand(L, n) for i in range(3))
        return self._karatsuba(x, b0, b1, bs)


def _g2_coords(coords):
    coords, shape = broadcast_coords(*coords)
    if shape[-2:] != (2, L):
        raise TypeError(f"expected G2 coordinates int32[..., 2, {L}], got {list(shape)}")
    return coords, shape


def _plain(formula, coords):
    """The twin of one G2 operation: `formula` (add_lm_pts or
    double_lm_pts) over Fq2Ops on every point of the broadcast coords."""
    coords, shape = _g2_coords(coords)
    rows = [c.reshape(-1, 2, L) for c in coords]

    def run(*r):
        pts = [(to_lm(x[:, 0]), to_lm(x[:, 1])) for x in r]
        out = formula(Fq2Ops(r[0].device), *(pts[i:i + 3] for i in range(0, len(pts), 3)))
        return tuple(torch.stack([from_lm(c0, (-1, L)), from_lm(c1, (-1, L))], dim=1)
                     for c0, c1 in out)

    out = plain_chunked(run, rows[0].shape[0], *rows, chunk=PLAIN_CHUNK // 16)
    return tuple(o.reshape(shape) for o in out)


def g2_add_plain(p, q):
    return _plain(add_lm_pts, (*p, *q))


def g2_double_plain(p):
    return _plain(double_lm_pts, p)


def _launch(entry: str, wrapper, coords):
    pts = tuple(tuple(coords[i:i + 3]) for i in range(0, len(coords), 3))
    coords, shape = _g2_coords(coords)
    ops = [kernel_operand(c) for c in coords]         # (2N, 16): c0, c1 of each point
    n = ops[0].shape[0] // 2
    dev = ops[0].device
    keep_operands(wrapper, n, *pts)
    outs = [torch.empty((2 * n, L), dtype=torch.int32, device=dev) for _ in range(3)]
    lib = build.library("g2")
    rc = getattr(lib, entry)(*(t.data_ptr() for t in ops + outs), n, stream_handle(dev))
    build.check(rc, entry)
    count_launch(wrapper, n)
    return tuple(o.reshape(shape) for o in outs)


def g2_add(p, q):
    """Complete G2 addition p + q."""
    if on_cpu(*p, *q):
        return g2_add_plain(p, q)
    return _launch("g2_add_launch", g2_add, (*p, *q))


def g2_double(p):
    """Complete G2 doubling 2·p."""
    if on_cpu(*p):
        return g2_double_plain(p)
    return _launch("g2_double_launch", g2_double, p)


for _wrapper in (g2_add, g2_double):
    _wrapper.launches, _wrapper.widths = 0, {}
