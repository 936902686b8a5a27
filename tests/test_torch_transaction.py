"""The joinsplit transaction of a Nova-style UTXO pool
(`circuits/transaction.py`, `protocol/utxo.py`) against the plain
reference's statement (`benchmark/reference/transaction.py`) at small
shapes, with no Groth16 setup or proof: `groth16.prove` and `verify` are
stubbed where the pool calls them."""

import random
from types import SimpleNamespace

import pytest
import torch

from benchmark.reference import transaction as rt
from owshen_tpu_torch.circuits import transaction as tx
from owshen_tpu_torch.groth16 import groth16, r1cs
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FR
from owshen_tpu_torch.protocol.pool import PoolError
from owshen_tpu_torch.protocol.utxo import UtxoPool
from owshen_tpu_torch.runtime.metrics import metrics

CPU = torch.device("cpu")


def n_constraints(levels, n_ins, n_outs):
    """Per input: Poseidon of 1 and three of 3 inputs (216 + 3·264), the
    nullifier's row, the path's index bits (levels + 1) and levels ×
    (switcher + Poseidon of 2 = 244), ForceEqualIfEnabled (3); per output:
    Poseidon of 3, its row, Num2Bits(248) (249); 3 rows a nullifier pair;
    the balance and extDataHash²."""
    return (n_ins * (1013 + 245 * levels) + 514 * n_outs + 3 * n_ins * (n_ins - 1) // 2 + 2)


def in_one_tree(rng, levels, amounts, out_amounts):
    """A witness spending notes of `amounts` at distinct seeded leaves of one
    tree (the other leaves 0) into outputs of `out_amounts`, its public
    amount Σ out − Σ in mod p."""
    ins = [tx.TxInput(a, rng.randrange(P_FR), rng.randrange(P_FR), i)
           for a, i in zip(amounts, rng.sample(range(1 << levels), len(amounts)))]
    level = [0] * (1 << levels)
    for note in ins:
        level[note.index] = tx.input_commitment(note)
    paths = [[] for _ in ins]
    for _ in range(levels):
        for path, note in zip(paths, ins):
            path.append(level[(note.index >> len(path)) ^ 1])
        level = [ohash.poseidon(level[j:j + 2]) for j in range(0, len(level), 2)]
    outs = [tx.TxOutput(a, rng.randrange(P_FR), rng.randrange(P_FR)) for a in out_amounts]
    return tx.TransactionWitness(level[0], (sum(out_amounts) - sum(amounts)) % P_FR,
                                 rng.randrange(P_FR), ins, paths, outs)


@pytest.mark.parametrize("levels,n_ins,n_outs", [(4, 2, 2), (1, 16, 2)])
def test_rows_match_the_reference_and_the_closed_form(levels, n_ins, n_outs):
    port, ref = tx.transaction_circuit(levels, n_ins, n_outs), \
        rt.transaction_shape(levels, n_ins, n_outs)
    assert (port.num_vars, port.n_pub) == (ref.num_vars, ref.n_pub)
    assert port.n_pub == 3 + n_ins + n_outs
    assert port.constraints == ref.constraints          # (A, B, C) dicts, row for row
    assert len(port.constraints) == n_constraints(levels, n_ins, n_outs)


def test_values_pass_and_publics_match_the_reference():
    """The values-only witness equals the full synthesis's and satisfies
    the rows; its publics are the reference's for the same notes."""
    rng = random.Random(0x7A)
    w = in_one_tree(rng, 4, [10 ** 21, 3], [5, 10 ** 21 - 9])     # withdraws 7
    full, vals = tx.transaction_circuit(4, 2, 2, w), tx.transaction_values(4, 2, 2, w)
    assert vals.witness() == full.witness() and full.check()
    want = rt.publics(w.root, w.public_amount, w.ext_data_hash, w.inputs, w.outputs)
    assert vals.witness()[1:vals.n_pub + 1] == want == tx.publics(w)
    assert w.public_amount == P_FR - 7 and rt.balanced([10 ** 21, 3], w.public_amount,
                                                       [5, 10 ** 21 - 9])


def test_the_statement_rejects_what_nova_rejects():
    """A wrong root fails with a nonzero amount and passes with a zero one;
    a repeated nullifier, a broken balance and an output of 2^248 fail.
    The pool's check over a key's kept matrices (`groth16.satisfied`, here
    on the CPU twins) says the same as the rows on host integers."""
    rng = random.Random(0x7B)
    shape = tx.transaction_circuit(3, 2, 2)
    pk = SimpleNamespace(device=CPU, n_domain=1 << 13, n_pub=shape.n_pub + 1,
                         a_g1=(torch.empty((shape.num_vars, 0)),))
    groth16._attach_r1cs(pk, shape)

    def holds(w):
        b = tx.transaction_values(3, 2, 2, w)
        host = r1cs.satisfied(shape.constraints, b.witness())
        assert groth16.satisfied(pk, b) == host
        return host

    w = in_one_tree(rng, 3, [40, 2], [30, 5])
    assert holds(w) and not holds(w._replace(root=w.root + 1))
    dummy = in_one_tree(rng, 3, [0, 0], [0, 0])
    assert holds(dummy._replace(root=dummy.root + 1))
    twice = w._replace(inputs=[w.inputs[0]] * 2, paths=[w.paths[0]] * 2,
                       public_amount=(35 - 80) % P_FR)
    assert not holds(twice)
    assert not holds(w._replace(public_amount=w.public_amount + 1))
    over = in_one_tree(rng, 3, [40, 2], [1 << 248, 5])
    assert not holds(over)
    assert holds(in_one_tree(rng, 3, [40, 2], [(1 << 248) - 1, 5]))


def test_the_published_shape_needs_the_sorted_engine():
    """Transaction(23, 16, 2): 107,758 rows, a 2^17 domain, 86.97 GB of
    fixed tables, so the default engine resolves to "sorted" (no key is
    built: the key's point sets are empty tensors of its sizes)."""
    rows = n_constraints(23, 16, 2)
    n = 1 << (rows - 1).bit_length()
    assert (rows, n) == (107_758, 1 << 17)
    pts = lambda k: (torch.empty((k, 0)),)  # noqa: E731
    pk = SimpleNamespace(a_g1=pts(rows + 21), h_g1=pts(n - 1), k_g1=pts(rows), n_pub=22)
    assert groth16._fixed_table_bytes(pk) == 64 * 9 * n * (4 * 192 + 384) == 86_973_087_744
    assert groth16._resolve_engine(pk, None, "fixed") == "sorted"


def test_pool_proves_and_transacts(monkeypatch):
    """`prove_transaction` proves the notes under the tree's root with one
    path call and the four stage spans, and `transact` spends the
    nullifiers once, appends the outputs as a batch `pop_batch` undoes, and
    refuses an unknown root, a repeated or spent nullifier and an
    overdrawn pool (proofs stubbed)."""
    rng = random.Random(0x7C)
    shape = tx.transaction_circuit(3, 2, 2)
    pk = SimpleNamespace(device=CPU, a_g1=(torch.empty((shape.num_vars, 0)),),
                         n_pub=shape.n_pub + 1)
    pool = UtxoPool(levels=3, n_ins=2, n_outs=2, keys=(pk, None), device="cpu")
    keys = [rng.randrange(P_FR) for _ in range(2)]
    notes = [tx.TxInput(10 + i, keys[i], rng.randrange(P_FR), i + 1) for i in range(2)]
    leaves = [5] + [tx.input_commitment(x) for x in notes]
    pool.deposit(leaves, [1, 2, 3], [0, 10, 11])
    proved = []
    monkeypatch.setattr(groth16, "prove", lambda pk_, b, seed=None, device=None:
                        proved.append(r1cs.satisfied(shape.constraints, b.witness())) or "proof")
    outs = [(15, 7, 8), (1, 9, 10)]
    with metrics.recording() as rec:
        proof, publics = pool.prove_transaction(notes, outs, P_FR - 5, 99)
    assert proof == "proof" and proved == [True]
    assert publics == rt.publics(pool.tree.root_int(), P_FR - 5, 99, notes, outs)
    names = {s.name for s in rec.spans}
    assert {"pool.prove_request", "pool.tree_path", "pool.synthesize", "pool.check",
            "pool.prove_transaction"} <= names

    monkeypatch.setattr(groth16, "verify", lambda vk, pub, pr: True)
    for bad, why in [([0] + publics[1:], "unknown root"),
                     (publics[:3] + [publics[3]] * 2 + publics[5:], "repeated"),
                     (publics[:1] + [P_FR - 22] + publics[2:], "insufficient")]:
        with pytest.raises(PoolError, match=why):
            pool.transact(proof, bad)
    root0 = pool.tree.root_int()
    assert pool.transact(proof, publics) == [3, 4]
    assert pool.balances[0] == 16 and set(publics[3:5]) <= pool.nullifiers
    assert pool.tree.root_int() == rt.root_above(dict(enumerate(leaves + publics[5:])), 0, 3)
    with pytest.raises(PoolError, match="spent"):
        pool.transact(proof, publics)
    assert pool.pop_batch() == 2 and pool.tree.root_int() == root0
    assert not set(publics[3:5]) & pool.nullifiers and pool.balances[0] == 21
