"""The withdraw circuit's structure kept with its proving key, and the
values-only witness pass a proof runs (`groth16/r1cs.py` `WitnessBuilder`,
`circuits/pool.py` `withdraw_values`, `groth16.prove` on the key's
matrices, `PrivacyPool.prove_withdraw`).

Keys come from `groth16.setup` with its fixed-base multiplication replaced
by a recorder of the exponents (the points are zeros of the right shape),
and the prover's MSM stage (`_prove_fixed`) by the same algebra on those
exponents, (Σ sᵢ·eᵢ mod r) times the generator: everything a kept
structure can change (the witness, the h scalars, r and s) reaches that
stage, and the proof it gives is checked by the host pairing.  No MSM or
table build runs, so the file takes seconds on the CPU."""

import dataclasses
import random

import pytest
import torch

from owshen_tpu_torch.circuits import pool as circuits
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16, r1cs
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FR
from owshen_tpu_torch.protocol.pool import PoolError, PrivacyPool
from owshen_tpu_torch.runtime import checkpoint
from owshen_tpu_torch.runtime.metrics import metrics

CPU = torch.device("cpu")


def note(rng, depth):
    """A seeded withdraw witness and its root: the note's commitment at a
    seeded leaf under seeded siblings."""
    w = circuits.WithdrawWitness(secret=rng.randrange(P_FR), salt=rng.randrange(P_FR),
                                 amount=rng.randrange(1, 10 ** 21),
                                 index=rng.randrange(1 << depth),
                                 siblings=[rng.randrange(P_FR) for _ in range(depth)],
                                 token=rng.getrandbits(160))
    node = circuits.commitment_of(w.secret, w.salt, w.amount, w.token)
    for level, sib in enumerate(w.siblings):
        node = ohash.poseidon([sib, node] if (w.index >> level) & 1 else [node, sib])
    return w, node


@pytest.mark.parametrize("depth,seed", [(2, 0x51), (16, 0x53), (None, 0x52)],
                         ids=["withdraw-d2", "withdraw-d16", "deposit"])
def test_values_pass_equals_full_synthesis(depth, seed):
    """The witness of the values-only pass equals a full synthesis's, element
    for element, and satisfies the structure; under a wrong root (a wrong
    commitment for the deposit) it does not."""
    rng = random.Random(seed)
    if depth is None:
        w = circuits.DepositWitness(secret=rng.randrange(P_FR), salt=rng.randrange(P_FR),
                                    amount=rng.randrange(1, 10 ** 21),
                                    token=rng.getrandbits(160))
        full, vals = circuits.deposit_circuit(w), circuits.deposit_values(w)
        structure = circuits.deposit_circuit().constraints
        wrong = r1cs.WitnessBuilder()
        wrong.values = [1, vals.values[1] + 1] + vals.values[2:]
    else:
        w, root = note(rng, depth)
        recipient = rng.getrandbits(160)
        full = circuits.withdraw_circuit(depth, w, root=root, recipient=recipient)
        vals = circuits.withdraw_values(depth, w, root=root, recipient=recipient)
        structure = circuits.withdraw_circuit(depth).constraints
        wrong = circuits.withdraw_values(depth, w, root=root + 1, recipient=recipient)
    assert vals.witness() == full.witness()
    assert (vals.num_vars, vals.n_pub) == (full.num_vars, full.n_pub)
    assert vals.constraints is None and structure == full.constraints
    assert full.check() and r1cs.satisfied(structure, vals.witness())
    assert not r1cs.satisfied(structure, wrong.witness())


@pytest.fixture(scope="module")
def fake_setup():
    """`groth16.setup` with its fixed-base multiplication recording the
    exponents: returns setup(builder, seed) -> (pk, vk, exponents)."""
    def run(builder, seed):
        exps = {}

        def batches(group, bs, device):
            exps[group] = [[e % P_FR for e in b] for b in bs]
            return [tuple(torch.zeros((len(b), FR.L), dtype=torch.int32, device=device)
                          for _ in range(3)) for b in bs]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(groth16, "_fixed_base_batches", batches)
            pk, vk = groth16.setup(builder, seed=seed, device=CPU)
        return pk, vk, exps
    return run


def dlog_engine(exps):
    """A stand-in for `_prove_fixed`: A, B and C from the setup's exponents,
    one scalar multiplication of a generator each."""
    a_t, b_t, k_exp, h_exp, (alpha,), (beta,), (delta,) = exps["g1"]
    dot = lambda xs, es: sum(x * e for x, e in zip(xs, es))  # noqa: E731

    def engine(pk, w_mont, r, s, h_sc):
        w, h = FR.decode(w_mont), FR.decode(h_sc, mont=False)
        a = (alpha + dot(w, a_t) + r * delta) % P_FR
        b = (beta + dot(w, b_t) + s * delta) % P_FR
        c = (dot(w[pk.n_pub:], k_exp) + dot(h, h_exp) + s * a + r * b - r * s * delta) % P_FR
        return groth16.Proof(a=ocurve.G1.mul(ocurve.G1_GEN, a),
                             b=ocurve.G2.mul(ocurve.G2_GEN, b),
                             c=ocurve.G1.mul(ocurve.G1_GEN, c))
    return engine


def counts():
    c = metrics.dump()["counters"]
    return c.get("groth16.r1cs_built", 0), c.get("groth16.r1cs_reused", 0)


@pytest.fixture(scope="module")
def depth2(fake_setup):
    return fake_setup(circuits.withdraw_circuit(2), b"r1cs-cache")


def test_key_keeps_compiled_matrices_for_its_shape(depth2):
    """setup keeps `Builder.compiled`'s matrices with the key, tensor for
    tensor on its device.  A builder with num_vars or n_pub other than the
    key's, or a values-only builder on a key that keeps no structure, is a
    ValueError before any proving."""
    pk = depth2[0]
    structure = circuits.withdraw_circuit(2)
    assert pk._r1cs.constraints == structure.constraints
    want = groth16._device_mats(structure.compiled(pk.n_domain), CPU)
    assert len(pk._r1cs.mats) == len(want) == 3
    for got_mat, want_mat in zip(pk._r1cs.mats, want):
        assert len(got_mat) == len(want_mat)
        for got_bucket, want_bucket in zip(got_mat, want_mat):
            assert all(torch.equal(g, x) and g.device == CPU
                       for g, x in zip(got_bucket, want_bucket))

    rng = random.Random(0x55)
    w, root = note(rng, 1)
    with pytest.raises(ValueError, match="num_vars"):
        groth16.prove(pk, circuits.withdraw_values(1, w, root, 7), device=CPU)
    b = r1cs.WitnessBuilder()
    for _ in range(pk.n_pub):              # one public more than the key's
        b.pub(1)
    while b.num_vars < pk.a_g1[0].shape[0]:
        b.priv(1)
    with pytest.raises(ValueError, match="num_vars"):
        groth16.prove(pk, b, device=CPU)
    w, root = note(rng, 2)
    with pytest.raises(ValueError, match="keeps no constraint structure"):
        groth16.prove(dataclasses.replace(pk), circuits.withdraw_values(2, w, root, 7),
                      device=CPU)


def test_proof_same_with_and_without_kept_structure(depth2, monkeypatch):
    """A fixed-seed depth-2 proof from a values-only witness on the key's
    matrices equals the proof from a full builder on a copy of the key that
    keeps none, which compiles them once; both verify."""
    pk, vk, exps = depth2
    monkeypatch.setattr(groth16, "_prove_fixed", dlog_engine(exps))
    rng = random.Random(0x54)
    w, root = note(rng, 2)
    recipient = rng.getrandbits(160)
    bare = dataclasses.replace(pk)
    assert getattr(bare, "_r1cs", None) is None
    built0, reused0 = counts()
    kept = groth16.prove(pk, circuits.withdraw_values(2, w, root, recipient), seed=b"s",
                         device=CPU)
    assert counts() == (built0, reused0 + 1)
    fresh = groth16.prove(bare, circuits.withdraw_circuit(2, w, root, recipient), seed=b"s",
                          device=CPU)
    assert counts() == (built0 + 1, reused0 + 1)
    assert (kept.a, kept.b, kept.c) == (fresh.a, fresh.b, fresh.c)
    assert bare._r1cs.constraints == pk._r1cs.constraints
    again = groth16.prove(bare, circuits.withdraw_values(2, w, root, recipient), seed=b"s",
                          device=CPU)
    assert counts() == (built0 + 1, reused0 + 2)
    assert (again.a, again.b, again.c) == (kept.a, kept.b, kept.c)
    publics = [root, circuits.nullifier_of(w.secret, w.index), recipient, w.amount, w.token]
    assert groth16.verify(vk, publics, kept)


def test_restored_pool_builds_once_then_reuses(depth2, tmp_path, monkeypatch):
    """A pool restored from a checkpoint keeps no structure with its key: its
    first proof synthesises it and compiles it once, every later proof
    reuses it; each proof verifies, and a note that is not in the tree is a
    PoolError from the check, on either path, before any proving."""
    pk, vk, exps = depth2
    monkeypatch.setattr(groth16, "_prove_fixed", dlog_engine(exps))
    rng = random.Random(0x56)
    secrets = [(rng.randrange(P_FR), rng.randrange(P_FR), rng.randrange(1, 1000))
               for _ in range(2)]
    pool = PrivacyPool(depth=2, keys=(pk, vk), device=CPU)
    pool.deposit([circuits.commitment_of(*s) for s in secrets] + [5], [21, 22, 23],
                 [s[2] for s in secrets] + [0])
    checkpoint.save_pool(pool, str(tmp_path / "pool"))
    loaded = checkpoint.load_pool(str(tmp_path / "pool"), device=CPU)
    assert getattr(loaded.pk, "_r1cs", None) is None

    built0, reused0 = counts()
    secret, salt, amount = secrets[0]
    with pytest.raises(PoolError, match="does not satisfy"):
        loaded.prove_withdraw(secret, salt + 1, amount, 0, 99)
    assert counts() == (built0, reused0) and getattr(loaded.pk, "_r1cs", None) is None
    for index, (secret, salt, amount) in enumerate(secrets):
        proof, root, nullifier = loaded.prove_withdraw(secret, salt, amount, index, 99,
                                                       seed=b"p%d" % index)
        assert counts() == (built0 + 1, reused0 + index)
        assert root == loaded.roots[-1] == pool.roots[-1]
        assert groth16.verify(loaded.vk, [root, nullifier, 99, amount, 0], proof)
    with pytest.raises(PoolError, match="does not satisfy"):
        loaded.prove_withdraw(secret, salt, amount + 1, 1, 99)
    assert counts() == (built0 + 1, reused0 + 1)
