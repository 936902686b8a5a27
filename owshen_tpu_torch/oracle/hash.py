"""Pure-Python MiMC7 / Poseidon oracle (circomlib-compatible semantics).

It defines the bit-exactness gate for the CUDA hash kernels — the real
permutations that replace the reference's placeholder `∏ inp` hash
(reference: babyjubjub/mod.rs:202-204)."""

from __future__ import annotations

from .field import P_FR
from ..ops.constants import mimc7_constants, poseidon_params, POSEIDON_RF, POSEIDON_RP

P = P_FR


def mimc7(x: int, k: int, p: int = P) -> int:
    """circomlib MiMC7(x_in, k): 91 rounds of r = (r + k + c[i])^7."""
    cts = mimc7_constants()
    r = pow((x + k) % p, 7, p)
    for i in range(1, len(cts)):
        r = pow((r + k + cts[i]) % p, 7, p)
    return (r + k) % p


def mimc7_multi(inputs: list[int], key: int = 0, p: int = P) -> int:
    """circomlib MultiMiMC7: r = k; for each x: r = r + x + MiMC7(x, r)."""
    r = key % p
    for x in inputs:
        r = (r + x + mimc7(x, r, p)) % p
    return r


def poseidon_permute(state: list[int], p: int = P) -> list[int]:
    t = len(state)
    C, M = poseidon_params(t, p)
    r_f, r_p = POSEIDON_RF, POSEIDON_RP[t - 2]
    half = r_f // 2
    s = list(state)
    for r in range(r_f + r_p):
        s = [(a + C[r * t + i]) % p for i, a in enumerate(s)]
        if r < half or r >= half + r_p:
            s = [pow(a, 5, p) for a in s]
        else:
            s[0] = pow(s[0], 5, p)
        s = [sum(M[i][j] * s[j] for j in range(t)) % p for i in range(t)]
    return s


def poseidon(inputs: list[int], p: int = P) -> int:
    """circomlib Poseidon hash: state = [0, *inputs]; output = state[0]."""
    t = len(inputs) + 1
    assert 2 <= t <= 17
    state = [0] + [x % p for x in inputs]
    return poseidon_permute(state, p)[0]
