"""Batched prime-field arithmetic over BN254 Fr and Fq on torch tensors.

A field element is int32[..., 16]: 16 little-endian limbs of 16 bits, in
Montgomery form with R = 2^256 unless noted — the JAX package's layout
(owshen_tpu/fields/field.py), so both packages' tensors compare limb for
limb.  Every limb is < 2^16, so int32 holds it without sign trouble.

`mul`, `add` and `sub` go through the K1 wrappers (kernels/field_ops.py):
on a CUDA tensor they launch the hand-written kernel, on a CPU tensor they
run its plain twin.  Everything else here is composed from them (`pow_const`
and `inv` are square-and-multiply chains of K1 products, `sqrt` adds
Tonelli–Shanks rounds of them) or is a plain tensor op (select, compare,
bits).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels import field_ops
from ..oracle.field import P_FQ, P_FR

W = 16  # bits per limb
L = 16  # limbs per element


def ints_to_tensor(xs: Sequence[int], device=None) -> torch.Tensor:
    """[ints in [0, 2^256)] -> int32[len(xs), 16] limbs."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(raw, dtype="<u2").reshape(len(xs), L).astype(np.int32)
    return torch.from_numpy(arr).to(device) if device is not None else torch.from_numpy(arr)


def tensor_to_ints(a: torch.Tensor) -> list[int]:
    """int32[..., 16] limbs -> flat list of ints."""
    arr = a.detach().to("cpu").reshape(-1, L).numpy().astype("<u2")
    raw = arr.tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(arr.shape[0])]


class Field:
    """A prime field with batched tensor ops (Montgomery domain)."""

    def __init__(self, name: str, p: int):
        self.name = name
        self.p = p
        self.L = L
        self.R = (1 << (W * L)) % p
        self.R2 = self.R * self.R % p
        self.R_inv = pow(self.R, -1, p)
        self.two_adicity = ((p - 1) & -(p - 1)).bit_length() - 1
        self.generator = next(g for g in (7, 5, 3, 2, 6, 10, 11, 13)
                              if pow(g, (p - 1) // 2, p) == p - 1)
        self._consts: dict = {}

    # ---------- host-side conversions ----------

    def to_mont_int(self, x: int) -> int:
        return x * self.R % self.p

    def from_mont_int(self, x: int) -> int:
        return x * self.R_inv % self.p

    def encode(self, xs, mont: bool = True, device=None) -> torch.Tensor:
        """Python ints -> int32[n, 16] (Montgomery form by default)."""
        if isinstance(xs, int):
            xs = [xs]
        vals = [self.to_mont_int(x % self.p) if mont else x % self.p for x in xs]
        return ints_to_tensor(vals, device)

    def decode(self, a: torch.Tensor, mont: bool = True) -> list[int]:
        vals = tensor_to_ints(a)
        return [self.from_mont_int(v) for v in vals] if mont else vals

    def const(self, x: int, mont: bool = True, device=None) -> torch.Tensor:
        """One constant as int32[16], cached per device."""
        dev = torch.device(device) if device is not None else torch.device("cpu")
        key = (x % self.p, mont, dev)
        c = self._consts.get(key)
        if c is None:
            c = self.encode([x], mont=mont, device=dev)[0]
            self._consts[key] = c
        return c

    def encode_const(self, c: int, device=None) -> torch.Tensor:
        return self.const(c, device=device)

    # ---------- batched ops (K1 on the card) ----------

    def add(self, a, b):
        return field_ops.mod_add(a, b, self.name)

    def sub(self, a, b):
        return field_ops.mod_sub(a, b, self.name)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        return field_ops.mont_mul(a, b, self.name)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_const(self, a, c: int):
        """Montgomery product with a fixed plain-integer constant c."""
        return self.mul(a, self.const(c, device=a.device))

    def to_mont(self, a):
        return self.mul(a, self.const(self.R2, mont=False, device=a.device))

    def from_mont(self, a):
        return self.mul(a, self.const(1, mont=False, device=a.device))

    # ---------- predicates / selection ----------

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, cond, a, b):
        """cond ? a : b  (cond bool [...], broadcast over the limb axis)."""
        return torch.where(cond[..., None], a, b)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self.const(1, device=a.device).expand(a.shape).clone()

    # ---------- exponentiation ----------

    def pow_const(self, x, exp: int):
        """x ** exp for a fixed Python-int exponent, MSB first: one square
        per bit and one product per set bit (the exponent is known on the
        host, so the reference's select of the product is a branch here)."""
        acc = self.one_like(x)
        for bit in bin(exp)[2:] if exp > 0 else ():
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, x)
        return acc

    def inv(self, x):
        """Batched inverse by Fermat, x^(p − 2); inv(0) = 0."""
        return self.pow_const(x, self.p - 2)

    def sqrt(self, x):
        """Batched Tonelli–Shanks square root, branchless: s = two_adicity
        fixed rounds, every select on the card.  Returns (root, ok), ok[...]
        true where x is a square (0 included).  Which of the two roots comes
        back is unspecified; callers canonicalise by parity, as
        babyjubjub.decompress does."""
        p, s = self.p, self.two_adicity
        q = (p - 1) >> s
        one = self.const(1, device=x.device)
        c = self.const(pow(self.generator, q, p), device=x.device)   # the same in every lane
        w = self.pow_const(x, (q - 1) // 2)      # one chain: x^q = w²·x, x^((q+1)/2) = w·x
        r, t = self.mul(w, x), self.mul(self.sqr(w), x)
        for i in range(s - 1, 0, -1):
            t_pow = t
            for _ in range(i - 1):          # t^(2^(i-1)): i − 1 squares, fixed by i
                t_pow = self.sqr(t_pow)
            flip = ~self.eq(t_pow, one)
            c2 = self.sqr(c)
            r = self.select(flip, self.mul(r, c), r)
            t = self.select(flip, self.mul(t, c2), t)
            c = c2
        ok = self.eq(self.mul(r, r), x) | self.is_zero(x)
        return r, ok

    # ---------- misc ----------

    def to_bits_le(self, a, n_bits: int | None = None):
        """Canonical (non-Montgomery) limbs -> int32[..., n_bits] of 0/1,
        least significant bit first."""
        i = torch.arange(n_bits or W * self.L, device=a.device)
        return (a[..., i // W] >> (i % W)) & 1

    def is_odd(self, a):
        """Parity of the canonical value; `a` must be non-Montgomery."""
        return (a[..., 0] & 1) == 1


FR = Field("fr", P_FR)
FQ = Field("fq", P_FQ)
