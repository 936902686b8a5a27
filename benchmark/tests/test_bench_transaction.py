"""The joinsplit cell (`nova_pool_d23.transact16_prove`): the reference's
statement against known values, the new entries of BENCHMARK.json found
by the harness, and the cell driven on the CPU at a tiny size through a
simulated pool, sound and with each fault planted."""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.reference import curve, groth16 as rg, poseidon, transaction as rt
from benchmark.reference.field import P_FR

CELL = "nova_pool_d23.transact16_prove"
SIZES = {"levels": 4, "n_ins": 2, "deposit_batches": 2, "deposit_batch": 4, "users": 2,
         "warm_calls": 1}
SHARED = ("kernels_per_op.prove", "device_idle_pct.prove", "r1cs_ms_per_op.prove",
          "launch_host_ms_per_op.prove")     # the withdraw cell's readers, generic
READERS = ("synth_ms_per_op.transact", "groth16_ms_per_op.transact", "msm_ms_per_op.transact",
           "ladder_ms_per_op.transact")


class SimulatedUtxoPool:
    """The port's pool at CPU speed: proofs simulated with the setup's
    trapdoor (A = a·G, B = b·H, C solving the verification equation), so
    they verify against the reference's key exactly as sound proofs do."""

    def __init__(self, levels, n_ins, n_outs, setup_seed, device=None):
        self.levels = levels
        self.key = rg.verifying_key(rt.transaction_shape(levels, n_ins, n_outs), setup_seed)
        self.rng = random.Random(setup_seed)
        self.leaves = []

    def deposit(self, leaves, txs, amounts):
        self.leaves += leaves

    def prove_transaction(self, inputs, outputs, public_amount, ext_data_hash, *, seed=None):
        td = self.key.trapdoor
        root = poseidon.sparse_root(dict(enumerate(self.leaves)), self.levels)
        publics = rt.publics(root, public_amount, ext_data_hash, inputs, outputs)
        acc = sum(x * t for x, t in zip([1] + publics, td["public_terms"])) % P_FR
        a, b = self.rng.randrange(1, P_FR), self.rng.randrange(1, P_FR)
        c = (a * b - td["alpha"] * td["beta"] - acc) * pow(td["delta"], -1, P_FR) % P_FR
        proof = SimpleNamespace(a=curve.G1.mul(curve.G1_GEN, a), b=curve.G2.mul(curve.G2_GEN, b),
                                c=curve.G1.mul(curve.G1_GEN, c))
        return proof, publics


def test_reference_values_and_shape():
    """circomlib's Poseidon of 1 and 3 inputs; the note, nullifier and root
    helpers on known values; the shape's counts at small sizes; a root
    from subtrees equals the whole tree's."""
    assert rt.public_key(1) == \
        18586133768512220936620570745912940619677854269274689475585506675881198879027
    assert rt.commitment(1, 2, 3) == \
        6542985608222806190361240322586112750744169038454362455181422643027100751666
    com = rt.commitment(5, rt.public_key(7), 9)
    sig = poseidon.poseidon([7, com, 3])
    assert rt.nullifier(5, 7, 9, 3) == poseidon.poseidon([com, 3, sig])
    assert rt.publics(1, -4, 2, [(5, 7, 9, 3)], [(1, 2, 3)]) == \
        [1, P_FR - 4, 2, rt.nullifier(5, 7, 9, 3), rt.commitment(1, 2, 3)]
    assert rt.balanced([5, 6], P_FR - 3, [8, 0]) and not rt.balanced([1 << 248], 0, [1 << 248])
    for (levels, n_ins, n_outs), rows in (((4, 2, 2), 5019), ((2, 16, 2), 25438)):
        s = rt.transaction_shape(levels, n_ins, n_outs)
        assert (len(s.constraints), s.n_pub) == (rows, 3 + n_ins + n_outs)
    leaves = [random.Random(3).randrange(P_FR) for _ in range(12)]
    subs = {j: poseidon.sparse_root(dict(enumerate(leaves[4 * j:4 * j + 4])), 2) for j in range(3)}
    assert rt.root_above(subs, 2, 5) == poseidon.sparse_root(dict(enumerate(leaves)), 5)


def test_the_harness_finds_the_cell_and_its_readers():
    spec = harness.bench_spec()
    parts = harness.cell_spec(spec, CELL)
    assert parts["traffic"]["entry"] == "prove_transaction" and parts["cell"]["chips"] == 1
    assert (parts["config"]["levels"], parts["config"]["n_ins"], parts["config"]["n_outs"],
            parts["config"]["constraints"], parts["config"]["domain"]) == \
        (23, 16, 2, 107758, 1 << 17)
    assert harness.end_to_end_names(spec, CELL) == ["proofs_per_s", "setup_s"]
    assert harness.per_layer_names(spec, CELL) == list(SHARED + READERS)
    timers = {"pool.synthesize": (2, 1.0), "pool.check": (2, 3.0),
              "pool.prove_transaction": (2, 4.0), "groth16.msm": (2, 1.0),
              "groth16.ladders": (2, 0.5), "groth16.r1cs": (2, 0.001),
              "kernels.launch_host": (3000, 1.5)}
    reading = {"timers": timers, "ops": 2, "calls": 2, "kernels": 9000, "busy_s": 0.5,
               "window_s": 10.0}
    got = [harness.load_file(harness.HERE / "metrics" / f"{m}.py").read(reading)
           for m in SHARED + READERS]
    assert got == [4500.0, 95.0, 0.5, 750.0, 2000.0, 2000.0, 500.0, 250.0]
    assert all(harness.load_file(harness.HERE / "metrics" / f"{m}.py").read(
        {"timers": {}, "ops": 0, "calls": 0}) is None for m in SHARED + READERS)


@pytest.mark.parametrize("mode", ["sound", "control", "answer_altered"])
def test_cell_on_cpu(mode):
    program = SimpleNamespace(UtxoPool=SimulatedUtxoPool)
    out = harness.run_cell(harness.bench_spec(), CELL, 2 ** 33 + 5, 0.05, False, device="cpu",
                           program=program, fault=None if mode == "sound" else mode,
                           n_workers=2, sizes=SIZES)
    assert out["attempted"] >= 1 and out["failed"] == 0, out["errors"]
    compared = {name: value for name, value, _ in out["checks"]}
    assert out["correct"] == (mode == "sound"), compared
    assert out["metrics"]["proofs_per_s"]["value"] > 0
