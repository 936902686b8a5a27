"""Batched Fq2 = Fq[u]/(u² + 1) elements for BN254 G2.

An element is int32[..., 2, 16]: index 0 = c0, 1 = c1, Montgomery
components — the JAX package's layout (owshen_tpu/fields/fq2.py).

The G2 point operations do not come through here: they are whole kernels
(kernels/g2.py), and their plain twins hold the Fq2 arithmetic
(kernels/g2.py `Fq2Ops`).  What the port runs here is the element
surface: encode/decode, constants, `neg` (one K1 launch) and `select`
(the fixed-table MSM's y negation) and `zeros_like`/`one_like`
(identities)."""

from __future__ import annotations

import torch

from .field import FQ, Field


class Fq2:
    def __init__(self, base: Field = FQ):
        self.K = base
        self.p = base.p
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
    def neg(self, a):
        return self.K.neg(a)

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
