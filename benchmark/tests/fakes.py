"""A stand-in for the port's pool at CPU speed: its withdraw proofs are
simulated with the setup's trapdoor (A = a·G, B = b·H and C solving the
verification equation), so they verify against the reference's key exactly
as sound proofs do."""

from __future__ import annotations

import random
from types import SimpleNamespace

from benchmark.reference import curve, groth16 as rg, poseidon
from benchmark.reference.field import P_FR


class SimulatedPool:
    def __init__(self, depth: int, setup_seed: bytes, device=None):
        self.depth = depth
        self.key = rg.verifying_key(rg.withdraw_shape(depth), setup_seed)
        self.rng = random.Random(setup_seed)
        self.root = None

    def deposit(self, leaves, txs, amounts, tokens):
        self.root = poseidon.sparse_root(dict(enumerate(leaves)), self.depth)
        return list(range(len(leaves)))

    def prove_withdraw(self, secret, salt, amount, index, recipient, token=0):
        td = self.key.trapdoor
        null = poseidon.poseidon([secret, index])
        publics = [1, self.root, null, recipient, amount, token]
        acc = sum(x * t for x, t in zip(publics, td["public_terms"])) % P_FR
        a, b = self.rng.randrange(1, P_FR), self.rng.randrange(1, P_FR)
        c = (a * b - td["alpha"] * td["beta"] - acc) * pow(td["delta"], -1, P_FR) % P_FR
        proof = SimpleNamespace(a=curve.G1.mul(curve.G1_GEN, a), b=curve.G2.mul(curve.G2_GEN, b),
                                c=curve.G1.mul(curve.G1_GEN, c))
        return proof, self.root, null


def withdraw_program():
    return SimpleNamespace(PrivacyPool=SimulatedPool)


def msm_program():
    """The port's window-serial engine at c = 8, which the CPU twins run in
    seconds (at 2^22 `msm` routes to it at c = 16)."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.ops import msm

    return SimpleNamespace(msm=lambda pts, sc: msm.msm_sorted(bn254.G1, pts, sc, c=8))
