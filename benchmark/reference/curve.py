"""BN254 G1 / G2 affine arithmetic on Python integers: a frozen copy of the
curve part of `owshen_tpu_torch/oracle/curve.py` at commit c2af7b2.  A point
is (x, y), None the identity; over G2 each coordinate is an Fq2 pair."""

from __future__ import annotations

from .field import P_FQ


class IntField:
    def __init__(self, p):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def neg(self, a):
        return (-a) % self.p


class Fq2Int:
    """Fq2 = Fq[u]/(u²+1) over int pairs."""

    def __init__(self, p):
        self.p = p

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % self.p, (a[0] * b[1] + a[1] * b[0]) % self.p)

    def inv(self, a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % self.p, -1, self.p)
        return (a[0] * n % self.p, (-a[1]) * n % self.p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)


class WCurve:
    """Affine short Weierstrass y² = x³ + b."""

    def __init__(self, K, b):
        self.K = K
        self.b = b

    def add(self, p, q):
        K = self.K
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if y1 == K.neg(y2):
                return None
            xx = K.mul(x1, x1)
            lam = K.mul(K.add(K.add(xx, xx), xx), K.inv(K.add(y1, y1)))
        else:
            lam = K.mul(K.sub(y2, y1), K.inv(K.sub(x2, x1)))
        x3 = K.sub(K.sub(K.mul(lam, lam), x1), x2)
        return (x3, K.sub(K.mul(lam, K.sub(x1, x3)), y1))

    def neg(self, p):
        return None if p is None else (p[0], self.K.neg(p[1]))

    def mul(self, p, k):
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, p)
            p = self.add(p, p)
            k >>= 1
        return acc

    def on_curve(self, p):
        if p is None:
            return True
        K = self.K
        x, y = p
        return K.mul(y, y) == K.add(K.mul(K.mul(x, x), x), self.b)


FQ1 = IntField(P_FQ)
FQ2 = Fq2Int(P_FQ)
B_G1 = 3
B_G2 = FQ2.mul((B_G1, 0), FQ2.inv((9, 1)))     # b' = 3/ξ, ξ = 9 + u
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
G1 = WCurve(FQ1, B_G1)
G2 = WCurve(FQ2, B_G2)


def g1_affine(X: int, Y: int, Z: int):
    """A projective G1 point (X : Y : Z), Z = 0 the identity, as affine."""
    if Z % P_FQ == 0:
        return None
    zi = pow(Z, -1, P_FQ)
    return (X * zi % P_FQ, Y * zi % P_FQ)
