"""The withdraw statement's verifying key, worked out again from the setup
seed, and the Groth16 check of a proof against it.

The circuit is rebuilt here structure only: the R1CS builder
(`owshen_tpu_torch/groth16/r1cs.py`), the Poseidon and Merkle gadgets
(`circuits/gadgets.py`) and `withdraw_circuit` (`circuits/pool.py`) as at
commit c2af7b2, without witness values.  The simulated trusted setup draws
τ, α, β, γ, δ from the SHA-256 stream of `groth16.setup`; only the public
wires' terms are needed for the key."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import curve, poseidon
from .field import P_FQ, P_FR, root_of_unity
from .pairing import pairing_product_is_one

P = P_FR


class LC(dict):
    """Sparse linear combination {wire: coefficient}."""

    def __add__(self, other):
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) + v) % P
        return out

    def __sub__(self, other):
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) - v) % P
        return out

    def scale(self, c: int):
        return LC({k: v * c % P for k, v in self.items()})

    @staticmethod
    def const(c: int):
        return LC({0: c % P})


class Shape:
    """Wires [1, publics..., privates...] and (A, B, C) constraint rows."""

    def __init__(self):
        self.num_vars = 1
        self.n_pub = 0
        self.constraints: list[tuple[LC, LC, LC]] = []

    def wire(self, public: bool = False) -> LC:
        self.n_pub += public
        self.num_vars += 1
        return LC({self.num_vars - 1: 1})

    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((a, b, c))

    def enforce_eq(self, a: LC, b: LC):
        self.enforce(a - b, LC.const(1), LC.const(0))

    def mul(self, a: LC, b: LC) -> LC:
        out = self.wire()
        self.enforce(a, b, out)
        return out

    def bits(self, a: LC, n: int) -> list[LC]:
        bs = []
        for _ in range(n):
            b = self.wire()
            self.enforce(b, b - LC.const(1), LC.const(0))
            bs.append(b)
        acc = LC()
        for i, b in enumerate(bs):
            acc = acc + b.scale(pow(2, i, P))
        self.enforce_eq(acc, a)
        return bs

    def mux(self, bit: LC, a: LC, b: LC):
        t = self.mul(bit, b - a)
        return a + t, b - t


def _pow5(s: Shape, x: LC) -> LC:
    x2 = s.mul(x, x)
    x4 = s.mul(x2, x2)
    return s.mul(x4, x)


def poseidon_gadget(s: Shape, inputs: list) -> LC:
    t = len(inputs) + 1
    rounds, mds = poseidon.params(t)
    half, r_p = poseidon.R_F // 2, poseidon.R_P[t - 2]
    state = [LC.const(0)] + list(inputs)
    for r, c in enumerate(rounds):
        state = [x + LC.const(ci) for x, ci in zip(state, c)]
        if r < half or r >= half + r_p:
            state = [_pow5(s, x) for x in state]
        else:
            state[0] = _pow5(s, state[0])
        state = [sum((state[j].scale(row[j]) for j in range(t)), LC()) for row in mds]
    return state[0]


def withdraw_shape(depth: int) -> Shape:
    """Public [root, nullifier, recipient, amount, token]; commitment =
    Poseidon(secret, salt, amount, token) under root at index; nullifier =
    Poseidon(secret, index); recipient squared into a constraint."""
    s = Shape()
    root, null, recip, amount, token = (s.wire(public=True) for _ in range(5))
    secret, salt, idx = s.wire(), s.wire(), s.wire()
    sibs = [s.wire() for _ in range(depth)]
    node = poseidon_gadget(s, [secret, salt, amount, token])
    for bit, sib in zip(s.bits(idx, depth), sibs):
        left, right = s.mux(bit, node, sib)
        node = poseidon_gadget(s, [left, right])
    s.enforce_eq(node, root)
    s.enforce_eq(poseidon_gadget(s, [secret, idx]), null)
    s.mul(recip, recip)
    return s


def _rand_stream(seed: bytes):
    i = 0
    while True:
        v = int.from_bytes(hashlib.sha256(seed + i.to_bytes(4, "little")).digest(), "big") % P
        i += 1
        if v:
            yield v


@dataclass
class Key:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list
    trapdoor: dict      # τ, α, β, γ, δ and each public wire's β·A + α·B + C at τ


def verifying_key(shape: Shape, seed: bytes) -> Key:
    rs = _rand_stream(seed)
    tau, alpha, beta, gamma, delta = (next(rs) for _ in range(5))
    n = 1 << max(1, (len(shape.constraints) - 1).bit_length())
    omega = root_of_unity(n.bit_length() - 1)
    zh_over_n = (pow(tau, n, P) - 1) * pow(n, -1, P) % P
    n_pub = shape.n_pub + 1
    terms = [[0, 0, 0] for _ in range(n_pub)]
    wj = 1
    for a, b, c in shape.constraints:
        lj = None
        for k, lc in enumerate((a, b, c)):
            for i, v in lc.items():
                if i < n_pub:
                    if lj is None:
                        lj = zh_over_n * wj % P * pow(tau - wj, -1, P) % P
                    terms[i][k] = (terms[i][k] + v * lj) % P
        wj = wj * omega % P
    pub = [(beta * ta + alpha * tb + tc) % P for ta, tb, tc in terms]
    gamma_inv = pow(gamma, -1, P)
    return Key(
        alpha_g1=curve.G1.mul(curve.G1_GEN, alpha),
        beta_g2=curve.G2.mul(curve.G2_GEN, beta),
        gamma_g2=curve.G2.mul(curve.G2_GEN, gamma),
        delta_g2=curve.G2.mul(curve.G2_GEN, delta),
        ic=[curve.G1.mul(curve.G1_GEN, e * gamma_inv % P) for e in pub],
        trapdoor={"tau": tau, "alpha": alpha, "beta": beta, "gamma": gamma,
                  "delta": delta, "public_terms": pub})


def verify(key: Key, public_inputs: list, a, b, c) -> bool:
    """e(A, B) = e(α, β)·e(IC(pub), γ)·e(C, δ), with A, C on G1 and B on G2."""
    if a is None or b is None or c is None:
        return False
    if not (curve.G1.on_curve(a) and curve.G1.on_curve(c) and curve.G2.on_curve(b)):
        return False
    ic = key.ic[0]
    for x, pt in zip(public_inputs, key.ic[1:]):
        ic = curve.G1.add(ic, curve.G1.mul(pt, x % P))
    return pairing_product_is_one([((a[0], (-a[1]) % P_FQ), b), (key.alpha_g1, key.beta_g2),
                                   (ic, key.gamma_g2), (c, key.delta_g2)])
