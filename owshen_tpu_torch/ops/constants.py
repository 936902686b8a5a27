"""Round-constant derivation for MiMC7 and Poseidon over BN254 Fr.

These replace the reference's placeholder hash `hash(inp) = ∏ inp`
(reference: src/blockchain/tx/owshen_airdrop/babyjubjub/mod.rs:202-204) with
the real circomlib-compatible permutations named in BASELINE.json.

MiMC7 constants: iterated keccak256 chain seeded with the ASCII seed
(circomlib's mimc7 derivation): c[0] = 0, k = keccak256(seed),
c[i] = keccak256(c[i-1]) as big-endian ints reduced mod p.

Poseidon constants: Grain-LFSR stream per the Poseidon reference
parameter-generation procedure (GF(p), x^5 S-box, n=254), yielding
(R_F + R_P)·t round constants and a t×t Cauchy MDS matrix — the same
procedure circomlib's published constants were generated with.  Gated by
the known circomlib test vectors in tests/test_hash.py.
"""

from __future__ import annotations

import functools

from ..oracle.field import P_FR
from .keccak import keccak256

# circomlib parameterization: R_F = 8 full rounds; partial rounds per t
# (index t-2), x^5 S-box.
POSEIDON_RF = 8
POSEIDON_RP = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]

MIMC_ROUNDS = 91
MIMC_SEED = b"mimc"


@functools.lru_cache(maxsize=None)
def mimc7_constants(n_rounds: int = MIMC_ROUNDS, p: int = P_FR) -> tuple[int, ...]:
    cts = [0]
    c = keccak256(MIMC_SEED)
    for _ in range(1, n_rounds):
        c = keccak256(c)
        cts.append(int.from_bytes(c, "big") % p)
    return tuple(cts)


class _Grain:
    """80-bit Grain LFSR used by the Poseidon reference parameter generator."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254,
                 field_tag: int = 1, sbox_tag: int = 0):
        bits = []
        bits += _to_bits(field_tag, 2)
        bits += _to_bits(sbox_tag, 4)
        bits += _to_bits(n, 12)
        bits += _to_bits(t, 12)
        bits += _to_bits(r_f, 10)
        bits += _to_bits(r_p, 10)
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_bit(self) -> int:
        # von Neumann-style filtering: a 1 gate-bit admits the next bit
        while True:
            if self._next_raw() == 1:
                return self._next_raw()
            self._next_raw()

    def _raw_int(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.next_bit()
        return v

    def field_element(self, p: int, n: int = 254) -> int:
        """Round-constant sampling: REJECT out-of-range draws (the reference
        generator's GF(p) branch loops `while random_int >= prime_number`)."""
        while True:
            v = self._raw_int(n)
            if v < p:
                return v

    def field_element_mod(self, p: int, n: int = 254) -> int:
        """MDS x/y sampling: REDUCE mod p, no rejection (the reference
        generator's `create_mds_p` coerces the raw draw straight into GF(p)).
        The asymmetry between this and `field_element` is load-bearing: using
        rejection for the MDS draws silently diverges from the published
        poseidonperm_x5_254_3 tables with probability ~0.24 per draw."""
        return self._raw_int(n) % p


def _to_bits(x: int, n: int) -> list[int]:
    return [(x >> (n - 1 - i)) & 1 for i in range(n)]


@functools.lru_cache(maxsize=None)
def poseidon_params(t: int, p: int = P_FR):
    """Returns (C, M): C = list of (R_F+R_P)*t round constants (consumed one
    per state element per round), M = t×t MDS matrix (Cauchy)."""
    r_f = POSEIDON_RF
    r_p = POSEIDON_RP[t - 2]
    g = _Grain(t, r_f, r_p)
    n_consts = t * (r_f + r_p)
    C = [g.field_element(p) for _ in range(n_consts)]
    # MDS sampled from the *same* continuing Grain stream, with mod-reduction
    # (NOT rejection — see field_element_mod).  Verified against the published
    # poseidonperm_x5_254_3 full permutation vector and the circomlib hash
    # vectors for every arity t=2..7 (tests/test_hash.py).
    xs = [g.field_element_mod(p) for _ in range(t)]
    ys = [g.field_element_mod(p) for _ in range(t)]
    M = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
    return C, M
