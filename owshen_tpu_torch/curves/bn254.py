"""BN254 (alt_bn128) G1/G2 instances, generators and host <-> tensor point
conversion.

G1: y² = x³ + 3 over Fq;  G2: y² = x³ + 3/(9+u) over Fq2 (sextic twist).
The curve constants are the host oracle's (oracle/curve.py); b3 = 3·b of
each curve is built into its kernels (kernels/g1.py, kernels/g2.py), and
`Weierstrass` checks it against the b3 given here."""

from __future__ import annotations

from ..fields.field import FQ, FR
from ..fields.fq2 import FQ2
from ..oracle.curve import B_G1, B_G2, BN_X, FQ2I, G1_GEN, G2_GEN, XI  # noqa: F401
from .weierstrass import Weierstrass

Q = FQ.p
R = FR.p

# BN parameter x: q = 36x⁴+36x³+24x²+6x+1, r = 36x⁴+36x³+18x²+6x+1
assert 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1 == Q
assert 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1 == R


def _check_generators():
    # G1 on curve
    x, y = G1_GEN
    assert (y * y - (x * x * x + B_G1)) % Q == 0
    # G2 on curve: y² = x³ + b'
    x2, y2 = G2_GEN
    lhs = FQ2I.mul(y2, y2)
    rhs = FQ2I.add(FQ2I.mul(FQ2I.mul(x2, x2), x2), B_G2)
    assert lhs == rhs, "G2 generator not on twist curve"


_check_generators()

G1 = Weierstrass(FQ, 3 * B_G1)
G2 = Weierstrass(FQ2, ((3 * B_G2[0]) % Q, (3 * B_G2[1]) % Q))


def g1_encode(points, device=None):
    """[(x, y) ints or None for identity] -> projective (X, Y, Z) tensors."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    return (FQ.encode(xs, device=device), FQ.encode(ys, device=device),
            FQ.encode(zs, device=device))


def g2_encode(points, device=None):
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append((0, 0)), ys.append((1, 0)), zs.append((0, 0))
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append((1, 0))
    return (FQ2.encode(xs, device=device), FQ2.encode(ys, device=device),
            FQ2.encode(zs, device=device))


def g1_decode(p):
    """Projective G1 tensors (any batch shape) -> flat [(x, y) or None],
    with the Z inversions done on the host."""
    X, Y, Z = (FQ.decode(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def g2_decode(p):
    """Projective G2 tensors -> flat [((x0, x1), (y0, y1)) or None]."""
    X, Y, Z = (FQ2.decode(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == (0, 0):
            out.append(None)
        else:
            zi = FQ2I.inv(z)
            out.append((FQ2I.mul(x, zi), FQ2I.mul(y, zi)))
    return out


# the names the port used before it took the reference's
g1_decode_many = g1_decode
g2_decode_many = g2_decode


def g1_decode_host(p):
    """One projective G1 point -> (x, y) ints or None."""
    return g1_decode(p)[0]


def g2_decode_host(p):
    """One projective G2 point -> ((x0, x1), (y0, y1)) or None."""
    return g2_decode(p)[0]
