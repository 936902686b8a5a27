"""BabyJubJub EdDSA verification on Python integers, with the semantics of
`owshen_tpu_torch/oracle/eddsa.py` at commit c2af7b2 (the reference's
babyjubjub/mod.rs:99-115): a signature (R, s) on message M under key A is
valid iff A and R lie on the curve and s·B = R + H(R.x, R.y, A.x, A.y, M)·A,
H the circomlib Poseidon.  The points are projective here, and s·B and h·A
are sums of 32 entries of 8-bit window tables, one table per fixed base."""

from __future__ import annotations

from . import poseidon
from .field import P_FR

P = P_FR
A = 168700
D = 168696
BASE = (5299619240641551281634865583518297030282874472190772894086521144482721001553,
        16950150798460657717958625567821834550301663161624707787222815936182638968203)
ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
SUBORDER = ORDER // 8
IDENTITY = (0, 1, 1)


def add(p, q):
    """Projective twisted-Edwards add (complete: A is a square, D is not)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    a = z1 * z2 % P
    b = a * a % P
    c = x1 * x2 % P
    d = y1 * y2 % P
    e = D * c % P * d % P
    f, g = b - e, b + e
    x3 = a * f % P * ((x1 + y1) * (x2 + y2) - c - d) % P
    y3 = a * g % P * (d - A * c) % P
    return x3, y3, f * g % P


def on_curve(x: int, y: int) -> bool:
    return (A * x * x + y * y) % P == (1 + D * x * x % P * y * y) % P


def window_table(point) -> list:
    """table[w][k] = k·2^(8w)·point, w < 32, k < 256 (projective)."""
    table = []
    base = (point[0], point[1], 1)
    for _ in range(32):
        row = [IDENTITY, base]
        for _ in range(254):
            row.append(add(row[-1], base))
        table.append(row)
        base = add(row[-1], base)
    return table


def fixed_mul(table, k: int):
    acc = IDENTITY
    for w in range(32):
        byte = (k >> (8 * w)) & 0xFF
        if byte:
            acc = add(acc, table[w][byte])
    return acc


def same(p, q) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and (p[1] * q[2] - q[1] * p[2]) % P == 0


_TABLES: dict = {}


def _tables(pk):
    if pk not in _TABLES:
        _TABLES[pk] = (window_table(BASE), window_table(pk))
    return _TABLES[pk]


def public_key(secret: int):
    """A = secret·B, affine."""
    x, y, z = fixed_mul(window_table(BASE), secret)
    zi = pow(z, -1, P)
    return x * zi % P, y * zi % P


def challenge(pk, message: int, r) -> int:
    return poseidon.poseidon([r[0], r[1], pk[0], pk[1], message])


def verify_many(pk, items) -> list:
    """items: [(message, (R.x, R.y), s)] -> [(valid, challenge h)]."""
    tb, ta = _tables(pk)
    pk_ok = on_curve(*pk)
    out = []
    for message, r, s in items:
        h = challenge(pk, message, r)
        ok = pk_ok and on_curve(*r) and same(
            fixed_mul(tb, s), add((r[0], r[1], 1), fixed_mul(ta, h)))
        out.append((ok, h))
    return out
