"""The plain reference against known vectors and the port's own oracles."""

import random

from benchmark import profiling, work
from benchmark.reference import curve, eddsa, field, groth16 as rg, msm as rmsm, ntt as rntt
from benchmark.reference import pairing, poseidon


def test_poseidon_matches_circomlib_and_the_port():
    from owshen_tpu_torch.ops.merkle import oracle_sparse_root
    from owshen_tpu_torch.oracle import hash as ohash

    assert poseidon.poseidon([1, 2]) == \
        7853200120776062878684798364095072458815029376092732009249414926327459813530
    rng = random.Random(1)
    for n in (2, 4, 5):
        xs = [rng.randrange(field.P_FR) for _ in range(n)]
        assert poseidon.poseidon(xs) == ohash.poseidon(xs)
    leaves = {rng.randrange(1 << 16): rng.randrange(field.P_FR) for _ in range(9)}
    assert poseidon.sparse_root(leaves, 16) == oracle_sparse_root(leaves, 16)


def test_withdraw_statement_matches_the_port_circuit():
    from owshen_tpu_torch.circuits import pool as circuits

    mine, port = rg.withdraw_shape(16), circuits.withdraw_circuit(16)
    assert (mine.num_vars, mine.n_pub) == (port.num_vars, port.n_pub)
    assert [tuple(map(dict, c)) for c in mine.constraints] == \
        [tuple(map(dict, c)) for c in port.constraints]


def test_simulated_proofs_verify_and_tampered_ones_do_not():
    from .fakes import SimulatedPool

    pool = SimulatedPool(2, b"reference-test")
    pool.deposit([5, 6, 7, 8], None, None, None)
    proof, root, null = pool.prove_withdraw(3, 4, 10, 1, 99, token=0)
    publics = [root, null, 99, 10, 0]
    assert rg.verify(pool.key, publics, proof.a, proof.b, proof.c)
    assert not rg.verify(pool.key, [root, null, 98, 10, 0], proof.a, proof.b, proof.c)
    bad_c = curve.G1.add(proof.c, curve.G1_GEN)
    assert not rg.verify(pool.key, publics, proof.a, proof.b, bad_c)


def test_pairing_is_bilinear():
    p, q = curve.G1.mul(curve.G1_GEN, 6), curve.G2.mul(curve.G2_GEN, 7)
    neg = curve.G1.neg(curve.G1.mul(curve.G1_GEN, 42))
    assert pairing.pairing_product_is_one([(p, q), (neg, curve.G2_GEN)])


def test_eddsa_matches_the_port_oracle():
    from owshen_tpu_torch.oracle import eddsa as oeddsa

    rng = random.Random(4)
    secret = rng.randrange(1, eddsa.SUBORDER)
    assert eddsa.public_key(secret) == oeddsa.to_pub(secret)
    items, want = [], []
    for k in range(10):
        m = rng.randrange(field.P_FR)
        r, s = oeddsa.sign(secret, rng.randrange(field.P_FR), m)
        m, s = (m + (k % 5 == 1)) % field.P_FR, s + (k % 5 == 2) + eddsa.SUBORDER * (k % 5 == 3)
        if k % 5 == 4:
            r = (r[0], (r[1] + 1) % field.P_FR)
        items.append((m, r, s))
        want.append(oeddsa.verify(oeddsa.to_pub(secret), m, r, s))
    got = eddsa.verify_many(eddsa.public_key(secret), items)
    assert [ok for ok, _ in got] == want and True in want and False in want


def test_ntt_check_and_msm_reference_against_the_port_oracles():
    import torch

    from owshen_tpu_torch.oracle import curve as ocurve, ntt as ontt

    rng = random.Random(5)
    xs = [rng.randrange(field.P_FR) for _ in range(64)]
    ys = ontt.ntt(xs)
    raw = lambda v: b"".join(x.to_bytes(32, "little") for x in v)  # noqa: E731
    omega = field.root_of_unity(6)

    class Serial:
        map = staticmethod(map)

    assert rntt.is_ntt(raw(xs), raw(ys), 6, omega, 12345, Serial, chunks=4)
    ys[9] = (ys[9] + 1) % field.P_FR
    assert not rntt.is_ntt(raw(xs), raw(ys), 6, omega, 12345, Serial, chunks=4)

    k0, count, n = 1000, 4, 16
    pts = rmsm.bases(k0, count)
    scalars = [rng.randrange(field.P_FR) for _ in range(n)]
    rows = torch.from_numpy(field.ints_to_rows(scalars))
    want = ocurve.G1.msm([pts[i % count] for i in range(n)], scalars)
    assert rmsm.expected(torch, rows, k0, count) == want


def test_least_work_and_the_timeline():
    assert abs(work.ntt_stage_s(20, 20) * 1e3 - 0.0501) < 1e-4       # chip_smoke's K5 bound
    assert abs(work.g1_add_s(1 << 15) * 1e3 - 0.00665) < 1e-5        # and K2's at 2^15
    assert (work.JUB_ADD_OPS, work.JUB_DOUBLE_OPS) == (5816, 3368)
    assert work.ladder_work([0b1011, 1, 0]) == (3, 2)
    spans = [profiling.Span("k(int)", 10, 20), profiling.Span("void k2<1>(x)", 15, 30),
             profiling.Span("Memcpy HtoD (P)", 50, 60)]
    s = profiling.summary(spans, 0, 100, [profiling.Span("call", 0, 100)])
    assert s["busy_s"] == 30e-9 and s["kernels"] == 2
    assert s["by_name"] == {"k": [1, 10e-9], "k2<1>": [1, 15e-9], "Memcpy HtoD ": [1, 10e-9]}
    assert sum(v for _, v in s["breakdown"]["idle_gaps"]) == 70e-9
