"""Batched Fq2 = Fq[u]/(u² + 1) elements for BN254 G2.

An element is int32[..., 2, 16]: index 0 = c0, 1 = c1, Montgomery
components — the JAX package's layout (owshen_tpu/fields/fq2.py).

Every op is composed of K1 launches (kernels/field_ops.py) over both
components at once: `add`, `sub` and `neg` are one launch on the whole
[..., 2, 16] tensor, and a formula's independent Fq products share one
launch, stacked on a new leading axis (`mul`: one add for the two sums,
one launch for the three Karatsuba products, two subtracts — the
operation order of owshen_tpu/fields/fq2.py and kernels/g2.py `Fq2Ops`).
The G2 point operations do not come through here: they are whole kernels
(kernels/g2.py)."""

from __future__ import annotations

import numpy as np
import torch

from .field import FQ, Field


class Fq2:
    def __init__(self, base: Field = FQ):
        self.K = base
        self.p = base.p
        self.one_mont = np.stack([base.one_mont, base.zero])   # (2, L) uint32
        self._consts: dict = {}

    # -- host-side helpers: elements as (c0, c1) int pairs --
    def encode(self, xs, device=None) -> torch.Tensor:
        """[(c0, c1) ints] -> int32[n, 2, 16] Montgomery."""
        if isinstance(xs, tuple):
            xs = [xs]
        flat = [c for pair in xs for c in pair]
        return self.K.encode(flat, device=device).reshape(len(xs), 2, self.K.L)

    def decode(self, a: torch.Tensor):
        vals = self.K.decode(a.reshape(-1, self.K.L))
        return [(vals[i], vals[i + 1]) for i in range(0, len(vals), 2)]

    def const(self, c0: int, c1: int, device=None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else torch.device("cpu")
        key = (c0 % self.p, c1 % self.p, dev)
        c = self._consts.get(key)
        if c is None:
            c = self.encode([(c0, c1)], device=dev)[0]
            self._consts[key] = c
        return c

    def encode_const(self, c, device=None) -> torch.Tensor:
        return self.const(c[0], c[1], device=device)

    # -- batched ops; operands int32[..., 2, 16] --
    def add(self, a, b):
        return self.K.add(a, b)

    def sub(self, a, b):
        return self.K.sub(a, b)

    def neg(self, a):
        return self.K.neg(a)

    def _karatsuba(self, a, sa, b3):
        """(a0b0 − a1b1, (a0 + a1)(b0 + b1) − a0b0 − a1b1) from sa = a0 + a1
        and b3 = [b0, b1, b0 + b1] stacked: one launch of the three
        products, two subtracts"""
        K = self.K
        v0, v1, t = K.mul(torch.stack([a[..., 0, :], a[..., 1, :], sa]), b3)
        c0, t = K.sub(torch.stack([v0, t]), torch.stack([v1, v0]))
        return torch.stack([c0, K.sub(t, v1)], dim=-2)

    def mul(self, a, b):
        """Karatsuba, the two sums in one add."""
        a, b = torch.broadcast_tensors(a, b)
        sa, sb = self.K.add(torch.stack([a[..., 0, :], b[..., 0, :]]),
                            torch.stack([a[..., 1, :], b[..., 1, :]]))
        return self._karatsuba(a, sa, torch.stack([b[..., 0, :], b[..., 1, :], sb]))

    def sqr(self, a):
        """((a0 + a1)(a0 − a1), 2·a0a1): two products in one launch."""
        K = self.K
        a0, a1 = a[..., 0, :], a[..., 1, :]
        c0, m = K.mul(torch.stack([K.add(a0, a1), a0]), torch.stack([K.sub(a0, a1), a1]))
        return torch.stack([c0, K.add(m, m)], dim=-2)

    def mul_const(self, a, c):
        """Product with a fixed Fq2 constant c = (c0, c1) ints, Karatsuba as
        in `mul` with the constant's sum known on the host."""
        K, dev = self.K, a.device
        c0, c1 = c
        consts = torch.stack([K.const(x, device=dev) for x in (c0, c1, c0 + c1)])
        consts = consts.reshape((3,) + (1,) * (a.ndim - 2) + (K.L,))
        return self._karatsuba(a, K.add(a[..., 0, :], a[..., 1, :]), consts)

    def mul_base(self, a, c):
        """Product with a base-field array c (int32[..., 16]): both
        components in one launch."""
        return self.K.mul(a, c[..., None, :])

    def inv(self, a):
        """1/(c0 + c1·u) = (c0 − c1·u)/(c0² + c1²): both squares in one
        launch, one Fq inversion (`Field.inv`), both products in one;
        inv(0) = 0."""
        K = self.K
        sq = K.mul(a, a)
        ninv = K.inv(K.add(sq[..., 0, :], sq[..., 1, :]))
        r = K.mul(a, ninv[..., None, :])
        return torch.stack([r[..., 0, :], K.neg(r[..., 1, :])], dim=-2)

    def eq(self, a, b):
        return (a == b).all(dim=-1).all(dim=-1)

    def is_zero(self, a):
        return (a == 0).all(dim=-1).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self.const(1, 0, device=a.device).expand(a.shape).clone()


FQ2 = Fq2()
