"""K2 / K3: complete projective G1 addition and doubling over BN254 Fq.

Points are (X, Y, Z) tuples of int32[..., 16] Montgomery tensors; the
identity is (0 : 1 : 0).  `g1_add` / `g1_double` launch csrc/g1.cu (one
thread per point, any N) on CUDA tensors, or run their plain twins on CPU
tensors.  Each wrapper counts its launches in `.launches` and `.widths`.

The plain twins follow Renes–Costello–Batina 2015 algorithms 7 and 9 for
a = 0 in the operation order of the JAX package's
owshen_tpu/curves/weierstrass.py, on the limb-major int64 helpers of
kernels/field_ops.py.  `add_lm_pts` / `double_lm_pts` take the field's ops
as an argument, so the G2 twins of kernels/g2.py run the same formulas
over Fq2.
"""

from __future__ import annotations

import torch

from . import build
from .field_ops import (add_lm, count_launch, from_lm, keep_operands, kernel_operand, mul_lm,
                        on_cpu, PLAIN_CHUNK, plain_chunked, plain_consts, stream_handle, sub_lm,
                        to_lm)


class FqOps:
    """Fq ops on limb-major (16, k·N) operands, the RCB15 formulas' field
    for G1 (b3 = 9): `cat` lays independent operands side by side so they
    share one call, `split` undoes it."""

    def __init__(self, device):
        self.c = plain_consts("fq", device)

    def mul(self, a, b):
        return mul_lm(a, b, self.c)

    def sqr(self, a):
        return mul_lm(a, a, self.c)

    def add(self, a, b):
        return add_lm(a, b, self.c)

    def sub(self, a, b):
        return sub_lm(a, b, self.c)

    def mul_b3(self, x):
        """9·x as three doublings and an add"""
        t = self.add(x, x)
        t = self.add(t, t)
        t = self.add(t, t)
        return self.add(t, x)

    @staticmethod
    def cat(*xs):
        return torch.cat(xs, dim=1)

    @staticmethod
    def split(t, k):
        return t.chunk(k, dim=1)


def add_lm_pts(F, p, q):
    """RCB15 algorithm 7 (a = 0) over the field ops F (FqOps, or the Fq2
    ops of kernels/g2.py), the operation order of
    owshen_tpu/curves/weierstrass.py."""
    cat, split = F.cat, F.split
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2 = split(F.mul(cat(X1, Y1, Z1), cat(X2, Y2, Z2)), 3)
    sums = F.add(cat(X1, Y1, X1, X2, Y2, X2), cat(Y1, Z1, Z1, Y2, Z2, Z2))
    s1, s2 = split(sums, 2)
    # t3 = X1Y2 + X2Y1, t4 = Y1Z2 + Y2Z1, t5 = X1Z2 + X2Z1
    t3, t4, t5 = split(F.sub(F.mul(s1, s2), F.add(cat(t0, t1, t0), cat(t1, t2, t2))), 3)
    three_t0 = F.add(F.add(t0, t0), t0)
    t2b, y3 = split(F.mul_b3(cat(t2, t5)), 2)
    z3 = F.add(t1, t2b)
    t1b = F.sub(t1, t2b)
    u = split(F.mul(cat(t3, y3, z3, t4, t1b, three_t0),
                    cat(t1b, three_t0, t4, y3, z3, t3)), 6)
    X3 = F.sub(u[0], u[3])
    Y3, Z3 = split(F.add(cat(u[1], u[2]), cat(u[4], u[5])), 2)
    return X3, Y3, Z3


def double_lm_pts(F, p):
    """RCB15 algorithm 9 (a = 0) over the field ops F."""
    cat, split = F.cat, F.split
    X, Y, Z = p
    t0, zz = split(F.sqr(cat(Y, Z)), 2)
    t1, xy = split(F.mul(cat(Y, X), cat(Z, Y)), 2)
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)                               # 8Y²
    t2 = F.mul_b3(zz)
    X3, Z3 = split(F.mul(cat(t2, t1), cat(z3, z3)), 2)
    Y3 = F.add(t0, t2)
    t2 = F.add(F.add(t2, t2), t2)                    # 3·b3·Z²
    t0 = F.sub(t0, t2)
    ty, tx = split(F.mul(cat(t0, t0), cat(Y3, xy)), 2)
    return F.add(tx, tx), F.add(X3, ty), Z3


def broadcast_coords(*coords):
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    return [c.expand(shape) for c in coords], shape


def g1_add_plain(p, q):
    coords, shape = broadcast_coords(*p, *q)
    rows = [c.reshape(-1, 16) for c in coords]
    out = plain_chunked(
        lambda *r: tuple(from_lm(c, (-1, 16))
                         for c in add_lm_pts(FqOps(r[0].device), [to_lm(x) for x in r[:3]],
                                             [to_lm(x) for x in r[3:]])),
        rows[0].shape[0], *rows, chunk=PLAIN_CHUNK // 4)
    return tuple(o.reshape(shape) for o in out)


def g1_double_plain(p):
    coords, shape = broadcast_coords(*p)
    rows = [c.reshape(-1, 16) for c in coords]
    out = plain_chunked(
        lambda *r: tuple(from_lm(c, (-1, 16))
                         for c in double_lm_pts(FqOps(r[0].device), [to_lm(x) for x in r])),
        rows[0].shape[0], *rows, chunk=PLAIN_CHUNK // 4)
    return tuple(o.reshape(shape) for o in out)


def _launch(entry: str, wrapper, coords):
    pts = tuple(tuple(coords[i:i + 3]) for i in range(0, len(coords), 3))
    coords, shape = broadcast_coords(*coords)
    ops = [kernel_operand(c) for c in coords]
    n = ops[0].shape[0]
    dev = ops[0].device
    keep_operands(wrapper, n, *pts)
    outs = [torch.empty((n, 16), dtype=torch.int32, device=dev) for _ in range(3)]
    lib = build.library("g1")
    rc = getattr(lib, entry)(*(t.data_ptr() for t in ops + outs), n, stream_handle(dev))
    build.check(rc, entry)
    count_launch(wrapper, n)
    return tuple(o.reshape(shape) for o in outs)


def g1_add(p, q):
    """Complete G1 addition p + q (K2)."""
    if on_cpu(*p, *q):
        return g1_add_plain(p, q)
    return _launch("g1_add_launch", g1_add, (*p, *q))


def g1_double(p):
    """Complete G1 doubling 2·p (K3)."""
    if on_cpu(*p):
        return g1_double_plain(p)
    return _launch("g1_double_launch", g1_double, p)


for _wrapper in (g1_add, g1_double):
    _wrapper.launches, _wrapper.widths = 0, {}
