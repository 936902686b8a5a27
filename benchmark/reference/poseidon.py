"""circomlib Poseidon over BN254 Fr on Python integers.

The round constants and MDS matrices come from the Grain LFSR procedure of
the Poseidon paper, as `owshen_tpu_torch/ops/constants.py` (c2af7b2) derives
them; the permutation is `owshen_tpu_torch/oracle/hash.py`'s, with each MDS
row summed before one reduction.  circomlib's vector Poseidon(1, 2) =
7853200120776062878684798364095072458815029376092732009249414926327459813530
holds it (benchmark/tests)."""

from __future__ import annotations

from .field import P_FR

P = P_FR
R_F = 8
R_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]   # by t − 2


class _Grain:
    """The 80-bit Grain LFSR of the Poseidon parameter generator."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254):
        bits = []
        for value, width in ((1, 2), (0, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        self.state = bits + [1] * 30
        for _ in range(160):
            self._raw()

    def _raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def _bit(self) -> int:
        while True:
            if self._raw() == 1:
                return self._raw()
            self._raw()

    def _int(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._bit()
        return v

    def rejected(self, n: int = 254) -> int:
        """A round constant: draws at or above p are rejected."""
        while True:
            v = self._int(n)
            if v < P:
                return v

    def reduced(self, n: int = 254) -> int:
        """An MDS draw: reduced mod p, never rejected."""
        return self._int(n) % P


_PARAMS: dict = {}


def params(t: int):
    """(round constants by round, MDS rows) for state width t, derived once
    a process (`preset` hands a worker process the parent's)."""
    if t not in _PARAMS:
        _PARAMS[t] = _derive(t)
    return _PARAMS[t]


def preset(derived: dict) -> None:
    _PARAMS.update(derived)


def _derive(t: int):
    r_p = R_P[t - 2]
    g = _Grain(t, R_F, r_p)
    flat = [g.rejected() for _ in range(t * (R_F + r_p))]
    xs = [g.reduced() for _ in range(t)]
    ys = [g.reduced() for _ in range(t)]
    mds = tuple(tuple(pow((xs[i] + ys[j]) % P, -1, P) for j in range(t)) for i in range(t))
    rounds = tuple(tuple(flat[r * t:(r + 1) * t]) for r in range(R_F + r_p))
    return rounds, mds


def poseidon(inputs) -> int:
    """circomlib Poseidon: state [0, *inputs], output state[0]."""
    t = len(inputs) + 1
    rounds, mds = params(t)
    half, r_p = R_F // 2, R_P[t - 2]
    s = [0] + [x % P for x in inputs]
    for r, c in enumerate(rounds):
        s = [a + b for a, b in zip(s, c)]
        if r < half or r >= half + r_p:
            s = [pow(a, 5, P) for a in s]
        else:
            s[0] = pow(s[0], 5, P)
        s = [sum(m * a for m, a in zip(row, s)) % P for row in mds]
    return s[0]


def hash2(left: int, right: int) -> int:
    return poseidon([left, right])


def sparse_root(leaves: dict, depth: int) -> int:
    """Root of a sparse Merkle tree of Poseidon(left, right) nodes whose
    empty leaves are 0, over {index: value}."""
    zero = [0]
    for _ in range(depth):
        zero.append(hash2(zero[-1], zero[-1]))
    level = dict(leaves)
    for lvl in range(depth):
        level = {i: hash2(level.get(2 * i, zero[lvl]), level.get(2 * i + 1, zero[lvl]))
                 for i in {j >> 1 for j in level}}
    return level.get(0, zero[depth])
