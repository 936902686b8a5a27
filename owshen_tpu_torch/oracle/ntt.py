"""Host NTT/polynomial oracle (python ints) for gating the device NTT."""

from __future__ import annotations

from .field import P_FR

P = P_FR
GENERATOR = 7  # matches reference PrimeFieldGenerator (babyjubjub/mod.rs:9)


def omega(log_n: int) -> int:
    return pow(GENERATOR, (P - 1) >> log_n, P)


def ntt(coeffs, w=None):
    """O(n log n) recursive NTT; natural order in/out."""
    n = len(coeffs)
    if w is None:
        w = omega(n.bit_length() - 1)
    if n == 1:
        return list(coeffs)
    even = ntt(coeffs[0::2], w * w % P)
    odd = ntt(coeffs[1::2], w * w % P)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % P
        out[k] = (even[k] + t) % P
        out[k + n // 2] = (even[k] - t) % P
        wk = wk * w % P
    return out


def intt(evals):
    n = len(evals)
    w_inv = pow(omega(n.bit_length() - 1), -1, P)
    n_inv = pow(n, -1, P)
    return [v * n_inv % P for v in ntt(evals, w_inv)]


def poly_mul(a, b):
    """Schoolbook polynomial multiply mod P (for convolution-theorem tests)."""
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % P
    return out
