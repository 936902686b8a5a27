"""Tornado Cash Nova's joinsplit statement, `Transaction(levels, nIns,
nOuts)` of tornado-nova's `circuits/transaction.circom`, in plain Python
integers: the values a transaction reveals, and the circuit's structure
for the verifying key.

Values: a note of `amount` owned by private key k is the commitment
Poseidon(amount, Poseidon(k), blinding); spent at leaf `index` it reveals
Poseidon(commitment, index, Poseidon(k, commitment, index)).  The
publics are [root, publicAmount, extDataHash, nullifiers...,
output commitments...], and the amounts balance: Σ in + publicAmount =
Σ out mod p.

Structure: the template rebuilt on `groth16.Shape` with
`groth16.poseidon_gadget` (circomlib's Poseidon and Num2Bits, the
switcher as `Shape.mux`) and circomlib's IsZero, IsEqual and
ForceEqualIfEnabled, wire for wire and row for row as the port's
`circuits/transaction.py` at this commit (the port's rows are held to
these by its tests)."""

from __future__ import annotations

from . import poseidon
from .groth16 import LC, Shape, poseidon_gadget

P = poseidon.P
OUTPUT_AMOUNT_BITS = 248


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

def public_key(private_key: int) -> int:
    return poseidon.poseidon([private_key])


def commitment(amount: int, pubkey: int, blinding: int) -> int:
    return poseidon.poseidon([amount, pubkey, blinding])


def nullifier(amount: int, private_key: int, blinding: int, index: int) -> int:
    """The nullifier of the note (amount, private_key, blinding) at leaf
    `index`: Poseidon(com, index, Poseidon(private_key, com, index))."""
    com = commitment(amount, public_key(private_key), blinding)
    signature = poseidon.poseidon([private_key, com, index])
    return poseidon.poseidon([com, index, signature])


def publics(root: int, public_amount: int, ext_data_hash: int, inputs, outputs) -> list[int]:
    """inputs: (amount, private_key, blinding, index) each; outputs:
    (amount, pubkey, blinding) each."""
    return ([root % P, public_amount % P, ext_data_hash % P]
            + [nullifier(*x) for x in inputs] + [commitment(*o) for o in outputs])


def balanced(in_amounts, public_amount: int, out_amounts) -> bool:
    return (sum(in_amounts) + public_amount - sum(out_amounts)) % P == 0 \
        and all(0 <= a < 1 << OUTPUT_AMOUNT_BITS for a in out_amounts)


def root_above(nodes: dict, height: int, levels: int) -> int:
    """The root of a height-`levels` Poseidon tree with empty leaves 0,
    from {index: node} at `height` (the roots of its subtrees there, as
    `poseidon.sparse_root` gives them for each block of 2^height leaves)."""
    zero = [0]
    for _ in range(levels):
        zero.append(poseidon.hash2(zero[-1], zero[-1]))
    level = dict(nodes)
    for lvl in range(height, levels):
        level = {i: poseidon.hash2(level.get(2 * i, zero[lvl]), level.get(2 * i + 1, zero[lvl]))
                 for i in {j >> 1 for j in level}}
    return level.get(0, zero[levels])


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------

def is_zero(s: Shape, x: LC) -> LC:
    """circomlib IsZero: the wires inv and out, x·inv = 1 − out, x·out = 0."""
    inv, out = s.wire(), s.wire()
    s.enforce(x, inv, LC.const(1) - out)
    s.enforce(x, out, LC.const(0))
    return out


def transaction_shape(levels: int, n_ins: int, n_outs: int) -> Shape:
    """Publics [root, publicAmount, extDataHash, inputNullifier[n_ins],
    outputCommitment[n_outs]]; then the private inputs in the template's
    order (inAmount, inPrivateKey, inBlinding, inPathIndices,
    inPathElements, outAmount, outPubkey, outBlinding)."""
    s = Shape()
    root, public_amount, ext_data_hash = (s.wire(public=True) for _ in range(3))
    nullifiers = [s.wire(public=True) for _ in range(n_ins)]
    commitments = [s.wire(public=True) for _ in range(n_outs)]
    in_amount, in_key, in_blinding, in_index = ([s.wire() for _ in range(n_ins)]
                                                for _ in range(4))
    in_path = [[s.wire() for _ in range(levels)] for _ in range(n_ins)]
    out_amount, out_pubkey, out_blinding = ([s.wire() for _ in range(n_outs)] for _ in range(3))

    sum_ins = LC.const(0)
    for i in range(n_ins):
        pubkey = poseidon_gadget(s, [in_key[i]])
        com = poseidon_gadget(s, [in_amount[i], pubkey, in_blinding[i]])
        sig = poseidon_gadget(s, [in_key[i], com, in_index[i]])
        s.enforce_eq(poseidon_gadget(s, [com, in_index[i], sig]), nullifiers[i])
        node = com
        for bit, sib in zip(s.bits(in_index[i], levels), in_path[i]):
            left, right = s.mux(bit, node, sib)
            node = poseidon_gadget(s, [left, right])
        # ForceEqualIfEnabled(root, node, amount)
        s.enforce(LC.const(1) - is_zero(s, node - root), in_amount[i], LC.const(0))
        sum_ins = sum_ins + in_amount[i]

    sum_outs = LC.const(0)
    for j in range(n_outs):
        com = poseidon_gadget(s, [out_amount[j], out_pubkey[j], out_blinding[j]])
        s.enforce_eq(com, commitments[j])
        s.bits(out_amount[j], OUTPUT_AMOUNT_BITS)
        sum_outs = sum_outs + out_amount[j]

    for i in range(n_ins - 1):
        for k in range(i + 1, n_ins):
            s.enforce_eq(is_zero(s, nullifiers[k] - nullifiers[i]), LC.const(0))
    s.enforce_eq(sum_ins + public_amount, sum_outs)
    s.mul(ext_data_hash, ext_data_hash)
    return s
