"""Port vs reference: the sequencer's host surface — the RLP wire codec
(protocol/wire.py), the tree's row restore, PrivacyPool.pop_batch and
withdraw_batch's guards.

Equality is exact throughout: wire bytes byte for byte against
owshen_tpu.protocol.wire, tree rows limb for limb against the JAX tree's
restore_rows, roots as integers against the host oracle.  The pool runs on
the CPU twins at depth 2 with the keys of a tiny circuit's port setup (no
JAX setup or prove).  withdraw_batch's guards are host code: there,
groth16.verify is stubbed, since the real proofs run in chip_smoke.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.ops import merkle as jmerkle
from owshen_tpu.protocol import pool as jpool
from owshen_tpu.protocol import wire as jwire
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.ops.merkle import SparseMerkleTree, oracle_sparse_root
from owshen_tpu_torch.oracle import eddsa as oeddsa
from owshen_tpu_torch.protocol import pool as tpool
from owshen_tpu_torch.protocol import wire
from owshen_tpu_torch.protocol.pool import PoolError, PrivacyPool, Voucher

torch.set_num_threads(1)

DEPTH = 2


@pytest.fixture(scope="module")
def tiny_keys():
    """Port keys of a circuit with the withdraw circuit's five publics."""
    b = Builder()
    for _ in range(5):
        b.pub()
    w = b.priv()
    b.enforce(w, w, w)
    return groth16.setup(b, seed=b"tiny-sequencer", device="cpu")


def tiny_pool(keys):
    return PrivacyPool(depth=DEPTH, keys=keys, device="cpu")


def test_wire_bytes_match_reference():
    long = "Lorem ipsum dolor sit amet, consectetur adipisicing elit"
    items = ["dog", ["cat", "dog"], "", 0, 15, 1024, long, b"\x00", [b"cat", [b"a", b""]],
             2 ** 255 - 19, ["x" * 60, list(range(30))]]
    for item in items:
        enc = wire.rlp_encode(item)
        assert enc == jwire.rlp_encode(item)
        assert wire.rlp_decode(enc) == jwire.rlp_decode(enc)
    assert wire.rlp_encode(["cat", "dog"]) == b"\xc8\x83cat\x83dog"
    for bad in (wire.rlp_encode(b"dog") + b"x", b"\x81\x05", b"\xc8\x83cat", b"\xb8\x05hello"):
        with pytest.raises(ValueError):
            wire.rlp_decode(bad)
        with pytest.raises(ValueError):
            jwire.rlp_decode(bad)
    enc = wire.encode_deposit(l1_tx_hash=0xABCDEF, commitment=12345, token=0xD17E, amount=777)
    assert enc == jwire.encode_deposit(0xABCDEF, 12345, 0xD17E, 777)
    assert wire.decode_deposit(enc) == jwire.decode_deposit(enc)
    with pytest.raises(PoolError, match="unknown deposit tag"):
        wire.decode_deposit(wire.rlp_encode(["burn", wire.VERSION, 1, 2, 3, 4]))
    # a voucher: the same bytes, the same decoded fields, the same checks
    chain_id, sec = 918273, 424242
    pub = oeddsa.to_pub(sec)
    binding = tpool._binding_hash(0xE1, 0xD17E, 500, 31337, chain_id)
    assert binding == jpool._binding_hash(0xE1, 0xD17E, 500, 31337, chain_id)
    R, s = oeddsa.sign(sec, 999, binding % FR.p)
    fields = dict(recipient=0xE1, amount=500, nullifier=31337, token=0xD17E,
                  binding=binding, sig_r=R, sig_s=s)
    enc = wire.encode_voucher(Voucher(**fields), chain_id)
    assert enc == jwire.encode_voucher(jpool.Voucher(**fields), chain_id)
    v, cid = wire.decode_voucher(enc)
    jv, jcid = jwire.decode_voucher(enc)
    assert (cid, v.__dict__) == (jcid, jv.__dict__)
    assert wire.verify_voucher_bytes(enc, pub, chain_id).binding == binding
    item = wire.rlp_decode(enc)
    item[4] = b"\x01\xf5"                                   # amount 500 -> 501
    with pytest.raises(PoolError, match="bad sequencer signature"):
        wire.verify_voucher_bytes(wire.rlp_encode(item), pub, chain_id)
    with pytest.raises(PoolError, match="chain id"):
        wire.verify_voucher_bytes(enc, pub, chain_id + 1)


def test_restore_rows_bit_exact_against_jax():
    rng = random.Random(7)
    tree = SparseMerkleTree(DEPTH, device="cpu")
    tree.insert_ints([1, 2], [rng.randrange(FR.p) for _ in range(2)])
    before = tree.nodes.clone()
    idxs = [0, 2, 3]
    rows = tree.touched_rows(idxs)
    prior = tree.snapshot_rows(rows)
    tree.insert_ints(idxs, [rng.randrange(FR.p) for _ in idxs])
    after = tree.nodes.clone()
    assert not torch.equal(after, before)
    tree.restore_rows(rows, prior)
    assert torch.equal(tree.nodes, before)
    # the JAX tree's restore on the same rows and values gives the same limbs
    jt = jmerkle.SparseMerkleTree.__new__(jmerkle.SparseMerkleTree)
    jt.depth = DEPTH
    jt.nodes = jnp.asarray(after.numpy().astype(np.uint32))
    assert np.array_equal(jt.touched_rows(idxs), rows)
    jt.restore_rows(rows, prior.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(jt.nodes).astype(np.int32), before.numpy())


def test_pop_batch_round_trip(tiny_keys):
    rng = random.Random(8)
    pool = tiny_pool(tiny_keys)
    with pytest.raises(PoolError, match="no batch to pop"):
        pool.pop_batch()
    coms_a = [rng.randrange(FR.p) for _ in range(2)]
    pool.deposit(coms_a, [0xA0, 0xA1], amounts=[5, 7], tokens=[0, 9])
    root_a, guards = pool.tree.root_int(), (set(pool.deposited), set(pool.minted))
    coms_b = [rng.randrange(FR.p) for _ in range(2)]
    idx_b = pool.deposit(coms_b, [0xB0, 0xB1], amounts=[1, 2])
    root_b = pool.tree.root_int()
    assert pool.pop_batch() == 2
    assert pool.tree.root_int() == root_a == pool.roots[-1]
    assert root_a == oracle_sparse_root(dict(enumerate(coms_a)), DEPTH)
    assert (pool.deposited, pool.minted) == guards
    assert (pool.next_index, pool.balances) == (2, {0: 5, 9: 7})
    # the same L1 transactions are accepted again, at the same leaves
    assert pool.deposit(coms_b, [0xB0, 0xB1], amounts=[1, 2]) == idx_b
    assert pool.tree.root_int() == root_b
    assert pool.pop_batch() == 2 and pool.pop_batch() == 2
    assert pool.tree.root_int() == pool.roots[-1] == pool.roots[0]
    assert (pool.next_index, pool.balances, pool.deposited) == (0, {0: 0, 9: 0}, set())
    with pytest.raises(PoolError, match="no batch to pop"):
        pool.pop_batch()


def test_withdraw_batch_guards_are_all_or_nothing(tiny_keys, monkeypatch):
    calls = []

    def fake_verify(vk, publics, proof):
        calls.append(tuple(publics))
        return proof != "bad"

    monkeypatch.setattr(tpool.groth16, "verify", fake_verify)
    pool = tiny_pool(tiny_keys)
    pool.deposit([11, 12], [0xC0, 0xC1], amounts=[100, 50], tokens=[0, 7])
    root = pool.roots[-1]
    state = lambda: (set(pool.nullifiers), dict(pool.balances))  # noqa: E731
    start = state()
    cases = [
        ([("p", root, 1, 0xE1, 10), ("p", root, 1, 0xE2, 10)], "nullifier already spent"),
        ([("p", root, 1, 0xE1, 60), ("p", root, 2, 0xE2, 60)], "insufficient pool balance"),
        ([("p", root, 1, 0xE1, 10, 7), ("p", root, 2, 0xE2, 41, 7)], "insufficient pool balance"),
        ([("p", root, 1, 0xE1, 10), ("p", 12345, 2, 0xE2, 1)], "unknown root"),
        ([("p", root, 1, 0xE1, 10), ("bad", root, 2, 0xE2, 1)], "invalid proof"),
        # the reference's order: a spent nullifier before the proof, the
        # proof before the balance
        ([("bad", root, 3, 0xE1, 10 ** 9), ("p", root, 3, 0xE2, 1)], "invalid proof"),
    ]
    for requests, err in cases:
        calls.clear()
        with pytest.raises(PoolError, match=err):
            pool.withdraw_batch(requests)
        assert state() == start                       # nothing changed
    assert calls == [(root, 3, 0xE1, 10 ** 9, 0)]      # the last case stopped at its proof
    pool.nullifiers.add(5)
    with pytest.raises(PoolError, match="nullifier already spent"):
        pool.withdraw_batch([("bad", root, 5, 0xE1, 1)])
