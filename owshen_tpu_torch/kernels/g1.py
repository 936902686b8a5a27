"""K2 / K3: complete projective G1 addition and doubling over BN254 Fq,
and the double-and-add ladder with a scalar per lane.

Points are (X, Y, Z) tuples of int32[..., 16] Montgomery tensors; the
identity is (0 : 1 : 0).  `g1_add` / `g1_double` / `g1_scalar_mul` launch
csrc/g1.cu (any N) on CUDA tensors, or run their plain twins on CPU
tensors.  Each wrapper counts its launches in `.launches` and `.widths`.

The plain twins follow Renes–Costello–Batina 2015 algorithms 7 and 9 for
a = 0 in the operation order of the JAX package's
owshen_tpu/curves/weierstrass.py, on the limb-major int64 helpers of
kernels/field_ops.py.  `add_lm_pts` / `double_lm_pts` take the field's ops
as an argument, so the G2 twins of kernels/g2.py run the same formulas
over Fq2; `ladder_lm_pts` runs both, a step each, as the ladder twin of
both curves.
"""

from __future__ import annotations

import time

import torch

from . import build
from ..oracle.field import P_FQ
from .field_ops import (add_lm, broadcast_shape, check_bits, count_launch, from_lm,
                        keep_operands, kernel_operand, L, limb_rows, mul_lm, on_cpu, PLAIN_CHUNK,
                        plain_chunked, plain_consts, stream_handle, sub_lm, to_lm, zero_counts)


B3 = 9   # 3·b of y² = x³ + 3: K2, K3 and FqOps.mul_b3 multiply by it as 2·2·2·x + x
MONT_ONE = (1 << 256) % P_FQ   # 1 in Montgomery form: the identity's Y


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

    @staticmethod
    def select(cond, a, b):
        """a where cond (N,) holds, else b, column by column"""
        return torch.where(cond, a, b)

    def identity(self, n):
        """(0 : 1 : 0) over n columns"""
        zero = torch.zeros((L, n), dtype=torch.int64, device=self.c.p_rows.device)
        return zero, limb_rows(MONT_ONE, zero.device).expand(L, n), zero


def add_lm_pts(F, p, q):
    """RCB15 algorithm 7 (a = 0) over the field ops F (FqOps, or the Fq2
    ops of kernels/g2.py): the products and sums of
    owshen_tpu/curves/weierstrass.py, the independent ones of a step
    side by side in one call."""
    cat, split = F.cat, F.split
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s1, s2 = split(F.add(cat(X1, Y1, X1, X2, Y2, X2), cat(Y1, Z1, Z1, Y2, Z2, Z2)), 2)
    t0, t1, t2, *st = split(F.mul(cat(X1, Y1, Z1, s1), cat(X2, Y2, Z2, s2)), 6)
    *q3, two_t0 = split(F.add(cat(t0, t1, t0, t0), cat(t1, t2, t2, t0)), 4)
    # t3 = X1Y2 + X2Y1, t4 = Y1Z2 + Y2Z1, t5 = X1Z2 + X2Z1
    t3, t4, t5 = split(F.sub(cat(*st), cat(*q3)), 3)
    t2b, y3 = split(F.mul_b3(cat(t2, t5)), 2)
    z3, three_t0 = split(F.add(cat(t1, two_t0), cat(t2b, t0)), 2)
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
    Y3, two_t2 = split(F.add(cat(t0, t2), cat(t2, t2)), 2)
    t0 = F.sub(t0, F.add(two_t2, t2))                # Y² − 3·b3·Z²
    X3, Z3, ty, tx = split(F.mul(cat(t2, t1, t0, t0), cat(z3, z3, Y3, xy)), 4)
    X3, Y3 = split(F.add(cat(tx, X3), cat(tx, ty)), 2)
    return X3, Y3, Z3


def ladder_lm_pts(F, base, k, n_bits: int):
    """Σ_{i < n_bits} bit_i(k)·2^i·base over the field ops F, a canonical
    scalar k (N, 16) a column: from bit n_bits − 1 down, a double and an add
    of (bit ? base : identity) each step, as the kernels do."""
    ident = F.identity(k.shape[0])
    i = torch.arange(n_bits - 1, -1, -1, device=k.device)
    bits = ((k[:, i // 16] >> (i % 16)) & 1).bool().T            # (n_bits, N), MSB first
    acc = ident
    for bit in bits:
        addend = tuple(F.select(bit, b, e) for b, e in zip(base, ident))
        acc = add_lm_pts(F, double_lm_pts(F, acc), addend)
    return acc


def broadcast_coords(*coords):
    shape = broadcast_shape(*(c.shape for c in coords))
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


def g1_scalar_mul_plain(p, scalars, n_bits: int):
    n_bits = check_bits(n_bits)
    coords, shape = broadcast_coords(*p, scalars)
    rows = [c.reshape(-1, 16) for c in coords]

    def run(*r):
        acc = ladder_lm_pts(FqOps(r[0].device), [to_lm(x) for x in r[:3]], r[3], n_bits)
        return tuple(from_lm(c, (-1, 16)) for c in acc)

    out = plain_chunked(run, rows[0].shape[0], *rows, chunk=PLAIN_CHUNK // 4)
    return tuple(o.reshape(shape) for o in out)


def _launch(entry: str, wrapper, coords, t0: int, extra=(), kept=None):
    pts = tuple(tuple(coords[i:i + 3]) for i in range(0, len(coords), 3))
    coords, shape = broadcast_coords(*coords)
    ops = [kernel_operand(c) for c in coords]
    n = ops[0].shape[0]
    dev = ops[0].device
    keep_operands(wrapper, n, *(pts if kept is None else kept))
    outs = [torch.empty((n, 16), dtype=torch.int32, device=dev) for _ in range(3)]
    lib = build.library("g1")
    rc = getattr(lib, entry)(*(t.data_ptr() for t in ops + outs), n, *extra, stream_handle(dev))
    build.check(rc, entry)
    count_launch(wrapper, n, t0)
    return tuple(o.reshape(shape) for o in outs)


def g1_add(p, q):
    """Complete G1 addition p + q (K2)."""
    t0 = time.perf_counter_ns()
    if on_cpu(*p, *q):
        return g1_add_plain(p, q)
    return _launch("g1_add_launch", g1_add, (*p, *q), t0)


def g1_double(p):
    """Complete G1 doubling 2·p (K3)."""
    t0 = time.perf_counter_ns()
    if on_cpu(*p):
        return g1_double_plain(p)
    return _launch("g1_double_launch", g1_double, p, t0)


def g1_scalar_mul(p, scalars, n_bits: int):
    """Σ_{i < n_bits} bit_i(k)·2^i·p for each lane's canonical scalar k
    (int32[..., 16] limbs): n_bits steps of the double-and-add ladder, MSB
    first, in one launch."""
    t0 = time.perf_counter_ns()
    n_bits = check_bits(n_bits)
    if on_cpu(*p, scalars):
        return g1_scalar_mul_plain(p, scalars, n_bits)
    return _launch("g1_scalar_mul_launch", g1_scalar_mul, (*p, scalars), t0, (n_bits,),
                   (p, scalars, n_bits))


zero_counts(g1_add, g1_double, g1_scalar_mul)
