"""Batched short-Weierstrass curve ops (y² = x³ + b, a = 0) in complete
homogeneous projective coordinates (Renes–Costello–Batina 2015, algorithms
7 and 9): identity (0 : 1 : 0), doubling and mixed cases share one
branchless path.

Points are (X, Y, Z) tuples of field tensors batched over leading axes.
Every add and double is one kernel launch: over Fq (BN254 G1) K2 / K3
(kernels/g1.py), over Fq2 (G2) g2_add / g2_double (kernels/g2.py), where
the JAX package composes the G2 formulas from Fq2 ops that XLA fuses
(owshen_tpu/curves/weierstrass.py)."""

from __future__ import annotations

import torch

from ..fields.field import FQ
from ..kernels import g1, g2


class Weierstrass:
    """K: field-op object (FQ for G1, FQ2 for G2); each curve's b3 = 3·b
    lives in its kernels and their twins."""

    def __init__(self, K):
        self.K = K
        if K is FQ:
            self._add, self._double = g1.g1_add, g1.g1_double
        else:
            self._add, self._double = g2.g2_add, g2.g2_double

    def identity_like(self, x):
        K = self.K
        return (K.zeros_like(x), K.one_like(x), K.zeros_like(x))

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
        ...]: per bit one double, one add and a select (branchless, as in
        the reference)."""
        acc = self.identity_like(p[0])
        for bit in bits:
            acc = self.double(acc)
            acc = self.select(bit != 0, self.add(acc, p), acc)
        return acc

    def to_affine(self, p):
        """(X/Z, Y/Z) with the identity mapped to (0, 0), one Fermat
        inversion of Z on K1.  Over Fq (G1) only: the port has no batched
        Fq2 product, and decodes G2 points on the host
        (bn254.g2_decode)."""
        X, Y, Z = p
        zinv = self.K.inv(Z)
        return (self.K.mul(X, zinv), self.K.mul(Y, zinv))

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
