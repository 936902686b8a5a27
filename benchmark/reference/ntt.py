"""The check of a radix-2 NTT over Fr by one random linear combination.

y = NTT_ω(x) (y_k = Σ_j x_j·ω^{jk}, natural order) holds iff, for a random ρ,
    Σ_k ρ^k·y_k = Σ_j x_j·Σ_k (ρ·ω^j)^k = (ρ^n − 1)·Σ_j x_j / (ρ·ω^j − 1),
up to a chance of n/p that a wrong y passes.  Both sides are linear, so
the check holds on Montgomery rows (x·2^256) as it does on values.  The
sums split into chunks that run in parallel."""

from __future__ import annotations

from .field import P_FR

P = P_FR


def _ints(raw: bytes) -> list[int]:
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def chunk_sums(job) -> tuple[int, int]:
    """(Σ ρ^k·y_k, Σ x_j/(ρ·ω^j − 1)) over one chunk starting at k0."""
    x_raw, y_raw, k0, rho, omega = job
    xs, ys = _ints(x_raw), _ints(y_raw)
    lhs = 0
    for y in reversed(ys):
        lhs = (lhs * rho + y) % P
    lhs = lhs * pow(rho, k0, P) % P
    step = pow(omega, k0, P) * rho % P
    dens, prefix, acc = [], [], 1
    for _ in xs:
        d = (step - 1) % P
        dens.append(d)
        prefix.append(acc)
        acc = acc * d % P
        step = step * omega % P
    inv = pow(acc, -1, P)
    rhs = 0
    for i in range(len(xs) - 1, -1, -1):
        rhs += xs[i] * (inv * prefix[i] % P)
        inv = inv * dens[i] % P
    return lhs, rhs % P


def is_ntt(x_raw: bytes, y_raw: bytes, log_n: int, omega: int, rho: int, pool,
           chunks: int = 16) -> bool:
    """Whether y_raw holds NTT_ω(x_raw), both 2^log_n rows of 32 bytes."""
    n = 1 << log_n
    if pow(rho, n, P) == 1:
        raise ValueError("ρ lies in the domain")
    size = n // chunks * 32
    jobs = [(x_raw[o:o + size], y_raw[o:o + size], o // 32, rho, omega)
            for o in range(0, n * 32, size)]
    lhs = rhs = 0
    for a, b in pool.map(chunk_sums, jobs):
        lhs += a
        rhs += b
    return lhs % P == (pow(rho, n, P) - 1) * rhs % P
