"""Batched short-Weierstrass curve ops (y² = x³ + b, a = 0) in complete
homogeneous projective coordinates (Renes–Costello–Batina 2015, algorithms
7 and 9): identity (0 : 1 : 0), doubling and mixed cases share one
branchless path.

Points are (X, Y, Z) tuples of field tensors batched over leading axes.
Every add and double is one kernel launch: over Fq (BN254 G1) K2 / K3
(kernels/g1.py), over Fq2 (G2) g2_add / g2_double (kernels/g2.py), where
the JAX package composes the G2 formulas from Fq2 ops that XLA fuses
(owshen_tpu/curves/weierstrass.py).  A scalar multiplication is one
launch of the curve's ladder (g1_scalar_mul, g2_scalar_mul), all its steps
in registers, where the reference scans a double and an add a bit.  The
rest (`to_affine`, `eq`,
`on_curve_affine`) is K1 launches through the field ops (FQ or FQ2), a
formula's independent products stacked into one."""

from __future__ import annotations

import torch

from ..fields.field import FQ
from ..fields.fq2 import FQ2
from ..kernels import g1, g2
from ..kernels.field_ops import limbs_of_msb_bits


class Weierstrass:
    """K: field-op object (FQ for G1, FQ2 for G2); b3: 3·b as a plain K
    constant (an int for FQ, (c0, c1) ints for FQ2), as the reference takes
    it.  The add and double kernels carry their curve's b3 built in
    (kernels/g1.py `B3`, kernels/g2.py `B3`), so any other b3 is refused:
    the kernels would add on another curve."""

    def __init__(self, K, b3):
        if K is FQ:
            kernel_b3, self._add, self._double = g1.B3, g1.g1_add, g1.g1_double
            self._ladder = g1.g1_scalar_mul
            given = int(b3) % K.p
        elif K is FQ2:
            kernel_b3, self._add, self._double = g2.B3, g2.g2_add, g2.g2_double
            self._ladder = g2.g2_scalar_mul
            given = tuple(int(c) % K.p for c in b3)
        else:
            raise ValueError("the port's point kernels are over BN254 Fq (FQ) and Fq2 (FQ2)")
        if given != kernel_b3:
            raise ValueError(f"b3 = {b3}: the {'G1' if K is FQ else 'G2'} kernels are built "
                             f"for b3 = {kernel_b3}")
        self.K = K
        self.b3_int = b3
        self.b3 = K.encode_const(b3)

    def identity_like(self, x):
        K = self.K
        return (K.zeros_like(x), K.one_like(x), K.zeros_like(x))

    def is_identity(self, p):
        return self.K.is_zero(p[2])

    def add(self, p, q):
        """Complete addition (RCB15 algorithm 7, a = 0)."""
        return self._add(p, q)

    def double(self, p):
        """Complete doubling (RCB15 algorithm 9, a = 0)."""
        return self._double(p)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.K.neg(Y), Z)

    def select(self, cond, p, q):
        return tuple(self.K.select(cond, a, b) for a, b in zip(p, q))

    def scalar_mul(self, p, bits):
        """Batched double-and-add over the MSB-first bit array bits[n_bits,
        ...] (n_bits ≤ 256), branchless: per bit one double and one add of
        (bit ? p : identity).  Complete formulas make adding the identity
        exact, so this is the reference's select after each add.  The bits
        are packed into canonical limbs on their device and the ladder runs
        in one launch (`scalar_mul_limbs`)."""
        return self.scalar_mul_limbs(p, limbs_of_msb_bits(bits), bits.shape[0])

    def scalar_mul_limbs(self, p, scalars, n_bits: int = 254):
        """k·p for canonical scalars k (int32[..., 16] limbs, one a point of
        p's batch), from bits n_bits − 1 … 0 of each: one launch of the
        curve's ladder, `scalar_mul`'s steps."""
        return self._ladder(p, scalars, n_bits)

    def to_affine(self, p):
        """(X/Z, Y/Z) with the identity mapped to (0, 0): one inversion of Z
        (a Fermat chain of K1 products; over Fq2 through the norm, one Fq
        chain), then both products in one launch."""
        X, Y, Z = p
        xy = self.K.mul(torch.stack([X, Y]), self.K.inv(Z))
        return (xy[0], xy[1])

    def eq(self, p, q):
        """Projective equality: X1Z2 == X2Z1 and Y1Z2 == Y2Z1 (the four
        cross products in one launch), or both the identity."""
        K = self.K
        coords = torch.broadcast_tensors(*p, *q)
        p, q = coords[:3], coords[3:]
        x1z2, x2z1, y1z2, y2z1 = K.mul(torch.stack([p[0], q[0], p[1], q[1]]),
                                       torch.stack([q[2], p[2], q[2], p[2]]))
        id_p, id_q = self.is_identity(p), self.is_identity(q)
        return (id_p & id_q) | (~id_p & ~id_q & K.eq(x1z2, x2z1) & K.eq(y1z2, y2z1))

    def on_curve_affine(self, x, y):
        """y² == x³ + b, checked as 3y² == 3x³ + b3 as the reference does (b3
        is the constant the curve holds)."""
        K = self.K
        y2, x2 = K.mul(torch.stack([y, x]), torch.stack([y, x]))
        v = torch.stack([y2, K.mul(x2, x)])                   # y², x³
        v3 = K.add(K.add(v, v), v)
        rhs = K.add(v3[1], K.encode_const(self.b3_int, device=x.device))
        return K.eq(v3[0], rhs)

    def sum_reduce(self, p, axis: int = 0):
        """EC sum along `axis` as a halving tree (⌈log₂ n⌉ wide adds; an
        odd count's last row waits a level)."""
        pts = tuple(torch.movedim(a, axis, 0) for a in p)
        while pts[0].shape[0] > 1:
            n, h = pts[0].shape[0], pts[0].shape[0] // 2
            s = self.add(tuple(a[:h] for a in pts), tuple(a[h:2 * h] for a in pts))
            pts = tuple(torch.cat([x, a[2 * h:]]) for x, a in zip(s, pts)) if n % 2 else s
        return tuple(a[0] for a in pts)

    def cat(self, pts, dim: int = 0):
        """Concatenate point batches along a leading axis."""
        return tuple(torch.cat(leaves, dim=dim) for leaves in zip(*pts))
