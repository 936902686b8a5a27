"""The G1 MSM over tiled multiples of the generator, worked out on its own.

Point i is (k0 + i mod B)·G for B distinct multiples, so
    Σ_i s_i·P_i = (Σ_j (k0 + j)·S_j mod r)·G,   S_j = Σ_{i ≡ j mod B} s_i,
and S_j comes from sums of the scalars' 16-bit limbs (plain torch, int64:
2^22 limbs below 2^16 sum below 2^38)."""

from __future__ import annotations

from . import curve
from .field import P_FQ, P_FR, from_mont, rows_to_ints


def bases(k0: int, count: int) -> list:
    """The affine points (k0 + j)·G, j < count."""
    pts = [curve.G1.mul(curve.G1_GEN, k0)]
    for _ in range(count - 1):
        pts.append(curve.G1.add(pts[-1], curve.G1_GEN))
    return pts


def expected(torch, scalars, k0: int, count: int):
    """Σ s_i·(k0 + i mod count)·G as an affine point (None: the identity);
    scalars: int32[n, 16] canonical limbs, n a multiple of count."""
    sums = scalars.view(-1, count, 16).to(torch.int64).sum(0).cpu().tolist()
    total = 0
    for j, limbs in enumerate(sums):
        total += (k0 + j) * sum(v << (16 * t) for t, v in enumerate(limbs))
    return curve.G1.mul(curve.G1_GEN, total % P_FR)


def affine_of(point):
    """The port's projective G1 output (X, Y, Z Montgomery limbs) as an
    affine point, None for Z = 0."""
    X, Y, Z = (from_mont(rows_to_ints(c.reshape(1, 16))[0], P_FQ) for c in point)
    return curve.g1_affine(X, Y, Z)
