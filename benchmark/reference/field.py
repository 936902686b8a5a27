"""BN254 moduli and the port's limb format, read independently of the port.

A field element on the card is int32[..., 16]: sixteen 16-bit limbs, little
endian, in Montgomery form x·2^256 mod p.  `rows_to_ints` reads such rows
back as the integers they hold; `from_mont` divides out 2^256."""

from __future__ import annotations

import numpy as np

P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
P_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_MONT = 1 << 256


def rows_to_ints(rows) -> list[int]:
    """int32[n, 16] limbs (a tensor or an array) -> n Python ints."""
    a = np.ascontiguousarray(np.asarray(rows.cpu() if hasattr(rows, "cpu") else rows,
                                        dtype=np.int64).reshape(-1, 16))
    if a.size and (a.min() < 0 or a.max() > 0xFFFF):
        raise ValueError("a limb lies outside [0, 2^16)")
    raw = a.astype("<u2").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(a.shape[0])]


def ints_to_rows(values) -> np.ndarray:
    """Python ints below 2^256 -> int32[n, 16] limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").astype(np.int32).reshape(-1, 16)


def from_mont(x: int, p: int) -> int:
    return x * pow(R_MONT, -1, p) % p


def to_mont(x: int, p: int) -> int:
    return x * R_MONT % p


def generator(p: int) -> int:
    """The multiplicative generator the port's domains use: the first of
    7, 5, 3, 2, 6, 10, 11, 13 that is not a square mod p."""
    return next(g for g in (7, 5, 3, 2, 6, 10, 11, 13) if pow(g, (p - 1) // 2, p) == p - 1)


def root_of_unity(log_n: int, p: int = P_FR) -> int:
    """ω of the 2^log_n domain: generator^((p − 1) / 2^log_n)."""
    return pow(generator(p), (p - 1) >> log_n, p)
