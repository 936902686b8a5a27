"""Host-side curve oracle (pure Python ints): BN254 G1/G2 affine arithmetic
and BabyJubJub twisted-Edwards ops with the reference's exact semantics
(reference: babyjubjub/mod.rs:28-189).  Gates the batched CUDA kernels and their
plain twins."""

from __future__ import annotations

from .field import P_FR, P_FQ

# ---------------------------------------------------------------------------
# Generic short Weierstrass (a=0) over a pluggable field
# ---------------------------------------------------------------------------


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

    zero = 0
    one = 1


class Fq2Int:
    """Fq2 = Fq[u]/(u²+1) over python int pairs."""

    def __init__(self, p):
        self.p = p
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        return (
            (a[0] * b[0] - a[1] * b[1]) % self.p,
            (a[0] * b[1] + a[1] * b[0]) % self.p,
        )

    def inv(self, a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % self.p, -1, self.p)
        return (a[0] * n % self.p, (-a[1]) * n % self.p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)


class WCurve:
    """Affine short-Weierstrass y² = x³ + b; points (x, y) or None=identity."""

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
            # doubling: lam = 3x² / 2y
            xx = K.mul(x1, x1)
            three_xx = K.add(K.add(xx, xx), xx)
            lam = K.mul(three_xx, K.inv(K.add(y1, y1)))
        else:
            lam = K.mul(K.sub(y2, y1), K.inv(K.sub(x2, x1)))
        x3 = K.sub(K.sub(K.mul(lam, lam), x1), x2)
        y3 = K.sub(K.mul(lam, K.sub(x1, x3)), y1)
        return (x3, y3)

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
        x3b = K.add(K.mul(K.mul(x, x), x), self.b)
        return K.mul(y, y) == x3b

    def msm(self, points, scalars):
        acc = None
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.mul(p, s % P_FR))
        return acc


FQ1 = IntField(P_FQ)
FQ2I = Fq2Int(P_FQ)

# BN parameter x: q = 36x⁴+36x³+24x²+6x+1, r = 36x⁴+36x³+18x²+6x+1
BN_X = 4965661367192848881
B_G1 = 3
# ξ = 9 + u is the Fq2 sextic-twist non-residue; b' = 3/ξ
XI = (9, 1)
B_G2 = FQ2I.mul((B_G1, 0), FQ2I.inv(XI))
G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

G1 = WCurve(FQ1, B_G1)
G2 = WCurve(FQ2I, B_G2)


# ---------------------------------------------------------------------------
# BabyJubJub twisted Edwards over Fr (reference babyjubjub/mod.rs)
# ---------------------------------------------------------------------------

P = P_FR
JUB_A = 168700
JUB_D = 168696
# reference babyjubjub/mod.rs:177-183
JUB_BASE = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)
# reference babyjubjub/mod.rs:185-188 (curve order = 8 * prime subgroup order)
JUB_ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
JUB_SUBORDER = JUB_ORDER // 8


def jub_add(p, q):
    """Affine twisted-Edwards addition (complete; reference :29-43)."""
    x1, y1 = p
    x2, y2 = q
    dxy = JUB_D * x1 * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + y1 * x2) % P * pow(1 + dxy, -1, P) % P
    y3 = (y1 * y2 - JUB_A * x1 * x2) % P * pow(1 - dxy, -1, P) % P
    return (x3, y3)


def jub_mul(p, k):
    acc = (0, 1)
    base = p
    while k:
        if k & 1:
            acc = jub_add(acc, base)
        base = jub_add(base, base)
        k >>= 1
    return acc


def jub_on_curve(p):
    x, y = p
    return (JUB_A * x * x + y * y) % P == (1 + JUB_D * x * x % P * y * y) % P
