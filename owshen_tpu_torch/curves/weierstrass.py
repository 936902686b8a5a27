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

    def cat(self, pts, dim: int = 0):
        """Concatenate point batches along a leading axis."""
        return tuple(torch.cat(leaves, dim=dim) for leaves in zip(*pts))
