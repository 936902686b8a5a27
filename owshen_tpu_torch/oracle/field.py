"""Pure-Python-int field oracle.

Plays the role of the single-threaded Rust reference (`ff`-derived `Fp`,
reference: src/blockchain/tx/owshen_airdrop/babyjubjub/mod.rs:7-11) for
bit-exactness gating of every CUDA kernel: plain modular arithmetic over
Python ints, little-endian reprs.
"""

from __future__ import annotations

P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
P_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583


class Fp:
    """Thin modular-arithmetic helper bound to a modulus."""

    def __init__(self, p: int):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def pow(self, a, e):
        return pow(a, e, self.p)

    def sqrt(self, a):
        """Tonelli–Shanks; returns None if a is not a QR."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        s = ((p - 1) & -(p - 1)).bit_length() - 1
        q = (p - 1) >> s
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

FR = Fp(P_FR)
FQ = Fp(P_FQ)
