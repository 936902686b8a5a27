"""Circuit gadgets: the Poseidon and MiMC7 permutations and Merkle paths as
R1CS.

Constraint shape: each x^5 S-box costs 3 multiplications (x², x⁴, x⁵); MDS
and round-constant layers are free linear combinations.  MiMC7's x^7 costs
4.  These define the in-circuit hashes whose outputs must bit-exactly match
the CUDA kernels behind ops/hash.py (same constants module)."""

from __future__ import annotations

from ..oracle.field import P_FR
from ..groth16.r1cs import LC, Builder
from ..ops.constants import POSEIDON_RF, POSEIDON_RP, mimc7_constants, poseidon_params

P = P_FR


def _pow5(b: Builder, x: LC) -> LC:
    x2 = b.square(x)
    x4 = b.square(x2)
    return b.mul(x4, x)


def poseidon_gadget(b: Builder, inputs: list[LC]) -> LC:
    """circomlib-parameterized Poseidon: state [0, *inputs] -> state[0]."""
    t = len(inputs) + 1
    C, M = poseidon_params(t)
    r_f, r_p = POSEIDON_RF, POSEIDON_RP[t - 2]
    half = r_f // 2
    state = [LC.const(0)] + list(inputs)
    for r in range(r_f + r_p):
        state = [s + LC.const(C[r * t + i]) for i, s in enumerate(state)]
        if r < half or r >= half + r_p:
            state = [_pow5(b, s) for s in state]
        else:
            state[0] = _pow5(b, state[0])
        state = [
            sum((state[j].scale(M[i][j]) for j in range(t)), LC())
            for i in range(t)
        ]
    return state[0]


def mimc7_gadget(b: Builder, x: LC, k: LC) -> LC:
    """circomlib MiMC7(x, k): 91 rounds of (r + k + c)^7, output r + k."""
    cts = mimc7_constants()

    def pow7(u: LC) -> LC:
        u2 = b.square(u)
        u4 = b.square(u2)
        u6 = b.mul(u4, u2)
        return b.mul(u6, u)

    r = pow7(x + k)
    for c in cts[1:]:
        r = pow7(r + k + LC.const(c))
    return r + k


def mimc7_multi_gadget(b: Builder, inputs: list[LC]) -> LC:
    """MultiMiMC7 with key 0: r += x + MiMC7(x, r)."""
    r = LC.const(0)
    for x in inputs:
        r = r + x + mimc7_gadget(b, x, r)
    return r


def merkle_path_gadget(b: Builder, leaf: LC, path_bits: list[LC],
                       siblings: list[LC], hash2=None) -> LC:
    """Computes the root from leaf + authentication path.

    path_bits[i] = 1 means the current node is the RIGHT child at level i.
    hash2(b, l, r) defaults to Poseidon(l, r)."""
    if hash2 is None:
        hash2 = lambda bb, l, r: poseidon_gadget(bb, [l, r])  # noqa: E731
    node = leaf
    for bit, sib in zip(path_bits, siblings):
        l, r = b.mux(bit, node, sib)
        node = hash2(b, l, r)
    return node
