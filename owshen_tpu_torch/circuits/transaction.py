"""The joinsplit transaction of a Tornado Cash Nova-style UTXO pool:
`Transaction(levels, nIns, nOuts)` of tornado-nova's
`circuits/transaction.circom` (16 inputs and 2 outputs in
`circuits/transaction16.circom`), gadget for gadget.

A note (UTXO) is the commitment Poseidon(amount, pubkey, blinding) of its
owner's public key pubkey = Poseidon(privateKey).  Spending it at leaf
`index` reveals its nullifier Poseidon(commitment, index, signature), with
signature = Poseidon(privateKey, commitment, index).  Per input the circuit
proves the key pair, the commitment, the signature and the nullifier, and
the commitment's Merkle path to `root`, enforced only when the amount is
nonzero (ForceEqualIfEnabled: a zero-amount input is a dummy).  Per output
it proves the commitment and a 248-bit amount.  Over the transaction: no
two nullifiers are equal, Σ in + publicAmount = Σ out, and extDataHash is
squared into a row so that the proof binds the external data.

Publics, in the template's order: [root, publicAmount, extDataHash,
inputNullifier[nIns], outputCommitment[nOuts]].

As in `circuits/pool.py`, the circuit is one function over a builder:
`transaction_circuit` runs it on a `Builder` (the structure, with the
values when a witness is given) and `transaction_values` on a
`WitnessBuilder` (the values only, for a proof on a key that keeps the
structure)."""

from __future__ import annotations

from typing import NamedTuple

from ..groth16.r1cs import Builder, WitnessBuilder
from ..oracle import hash as ohash
from .gadgets import force_equal_if_enabled, is_equal, merkle_path_gadget, poseidon_gadget

OUTPUT_AMOUNT_BITS = 248


class TxInput(NamedTuple):
    """A note being spent, at leaf `index` of the pool's tree."""
    amount: int
    private_key: int
    blinding: int
    index: int


class TxOutput(NamedTuple):
    """A note being created for the owner of `pubkey`."""
    amount: int
    pubkey: int
    blinding: int


class TransactionWitness(NamedTuple):
    root: int
    public_amount: int
    ext_data_hash: int
    inputs: list          # TxInput per input
    paths: list           # each input's siblings, bottom-up
    outputs: list         # TxOutput per output


def public_key(private_key: int) -> int:
    return ohash.poseidon([private_key])


def commitment(amount: int, pubkey: int, blinding: int) -> int:
    return ohash.poseidon([amount, pubkey, blinding])


def input_commitment(note: TxInput) -> int:
    return commitment(note.amount, public_key(note.private_key), note.blinding)


def nullifier(note: TxInput) -> int:
    """Poseidon(commitment, index, Poseidon(privateKey, commitment, index))."""
    com = input_commitment(note)
    sig = ohash.poseidon([note.private_key, com, note.index])
    return ohash.poseidon([com, note.index, sig])


def publics(w: TransactionWitness) -> list[int]:
    """[root, publicAmount, extDataHash, nullifiers..., output commitments...]."""
    return ([w.root, w.public_amount, w.ext_data_hash] + [nullifier(x) for x in w.inputs]
            + [commitment(*o) for o in w.outputs])


def transaction_circuit(levels: int, n_ins: int, n_outs: int,
                        w: TransactionWitness | None = None) -> Builder:
    """Transaction(levels, n_ins, n_outs) on a `Builder`."""
    return _transaction(Builder(), levels, n_ins, n_outs, w)


def transaction_values(levels: int, n_ins: int, n_outs: int,
                       w: TransactionWitness) -> WitnessBuilder:
    """The witness of `transaction_circuit(levels, n_ins, n_outs, w)`, by the
    values-only pass."""
    return _transaction(WitnessBuilder(), levels, n_ins, n_outs, w)


def _transaction(b: Builder, levels: int, n_ins: int, n_outs: int,
                 w: TransactionWitness | None) -> Builder:
    if w is not None and (len(w.inputs), len(w.paths), len(w.outputs)) != (n_ins, n_ins, n_outs):
        raise ValueError(f"a Transaction({levels}, {n_ins}, {n_outs}) witness has {n_ins} "
                         f"inputs with paths and {n_outs} outputs")
    ins = w.inputs if w is not None else [None] * n_ins
    outs = w.outputs if w is not None else [None] * n_outs
    paths = w.paths if w is not None else [[None] * levels] * n_ins

    def alloc(notes, field):
        return [b.priv(None if x is None else getattr(x, field)) for x in notes]

    pubs = [b.pub(v) for v in (publics(w) if w is not None else [None] * (3 + n_ins + n_outs))]
    root, public_amount, ext_data_hash = pubs[:3]
    nullifiers, commitments = pubs[3:3 + n_ins], pubs[3 + n_ins:]
    in_amount, in_key = alloc(ins, "amount"), alloc(ins, "private_key")
    in_blinding, in_index = alloc(ins, "blinding"), alloc(ins, "index")
    in_path = [[b.priv(sib) for sib in path] for path in paths]
    out_amount, out_pubkey = alloc(outs, "amount"), alloc(outs, "pubkey")
    out_blinding = alloc(outs, "blinding")

    sum_ins = b.const(0)
    for i in range(n_ins):
        pubkey = poseidon_gadget(b, [in_key[i]])
        com = poseidon_gadget(b, [in_amount[i], pubkey, in_blinding[i]])
        sig = poseidon_gadget(b, [in_key[i], com, in_index[i]])
        b.enforce_eq(poseidon_gadget(b, [com, in_index[i], sig]), nullifiers[i])
        tree_root = merkle_path_gadget(b, com, b.bits(in_index[i], levels), in_path[i])
        force_equal_if_enabled(b, root, tree_root, in_amount[i])
        sum_ins = sum_ins + in_amount[i]

    sum_outs = b.const(0)
    for j in range(n_outs):
        com = poseidon_gadget(b, [out_amount[j], out_pubkey[j], out_blinding[j]])
        b.enforce_eq(com, commitments[j])
        b.bits(out_amount[j], OUTPUT_AMOUNT_BITS)
        sum_outs = sum_outs + out_amount[j]

    for i in range(n_ins - 1):
        for k in range(i + 1, n_ins):
            b.enforce_eq(is_equal(b, nullifiers[i], nullifiers[k]), b.const(0))
    b.enforce_eq(sum_ins + public_amount, sum_outs)
    b.mul(ext_data_hash, ext_data_hash)
    return b
