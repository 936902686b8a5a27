"""BN254 (alt_bn128) G1/G2 instances and host <-> tensor point conversion.

G1: y² = x³ + 3 over Fq;  G2: y² = x³ + 3/(9+u) over Fq2 (sextic twist).
The curve constants live in the host oracle (oracle/curve.py); b3 = 3·b of
each curve is built into its kernels (kernels/g1.py, kernels/g2.py)."""

from __future__ import annotations

from ..fields.field import FQ, FR
from ..fields.fq2 import FQ2
from ..oracle.curve import FQ2I
from .weierstrass import Weierstrass

Q = FQ.p
R = FR.p

G1 = Weierstrass(FQ)
G2 = Weierstrass(FQ2)


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
