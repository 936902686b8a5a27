"""The deposit proof, port vs reference, on the CPU.

1. The port's deposit_circuit equals the JAX package's: the same
   constraints, publics and witness, with chip_smoke's token and with
   token 0.
2. Setup: the port draws the reference's exponents (τ, α, β, γ, δ and the
   key's point exponents) and gives the reference's verifying key.  Both
   setups run with their fixed-base multiplication taken by the host
   (tests/host_msm.py), which records the exponents; the fixed-base kernels
   are held elsewhere (tests/test_torch_pool.py, chip_smoke.py).
3. The JAX deposit proof, from the JAX prover's own steps (`_rand_stream`,
   `_prove_core`) with its MSMs, its nine assembly adds (`_combine_jit`)
   and its h scalars (`_h_pipeline`) taken on the host, verifies under both
   packages and its digest is chip_smoke.DEPOSIT_DIGEST, the constant the
   card holds the port's proofs through all three engines against.  The
   host's h (tests/host_msm.py `host_h`: the JAX package's NTT oracle on its
   domain) equals `_h_pipeline`'s for this witness, with token ≠ 0 and 0;
   it spares the file ~35 s (warm XLA cache) to ~150 s (cold) of tracing
   and compiling that pipeline on XLA:CPU, which tests/test_torch_pool.py
   and the JAX package's own prover tests still run.
4. The port's h scalars for the deposit witness equal the JAX package's.
5. Fixed tables over the budget prove through the sorted engine, as in the
   reference (a spy stands in for the engines: no MSM runs).

The port's whole deposit proof runs only on the card: on the twins its
fixed-table build takes ~46 s, and a lane or sorted prove spends six
254-step scalar ladders (~4,500 single-point operations, ~85 s)."""

import numpy as np
import pytest
import torch

import chip_smoke
from host_msm import fixed_base, host_combine, host_h, pippenger
from owshen_tpu.circuits import pool as jcircuits
from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.fields.field import array_to_ints, ints_to_array
from owshen_tpu.groth16 import groth16 as jg
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu_torch import config
from owshen_tpu_torch.circuits import pool as circuits
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16

torch.set_num_threads(1)

NOTE = chip_smoke.DEPOSIT_NOTE
SEED = chip_smoke.DEPOSIT_SETUP_SEED
# the order of the JAX setup's fixed-base calls (owshen_tpu/groth16/groth16.py setup)
JAX_CALLS = (("g1", "a_g1"), ("g1", "b_g1"), ("g2", "b_g2"), ("g1", "k_g1"), ("g1", "h_g1"),
             ("g1", "alpha_g1"), ("g1", "beta_g1"), ("g1", "delta_g1"), ("g2", "beta_g2"),
             ("g2", "delta_g2"))
# the port's: one call per group over all of its lists (groth16.setup)
PORT_CALLS = {"g1": ("a_g1", "b_g1", "k_g1", "h_g1", "alpha_g1", "beta_g1", "delta_g1"),
              "g2": ("b_g2", "beta_g2", "delta_g2")}


@pytest.fixture(scope="module")
def keys():
    """Both packages' setups of the deposit circuit with the host's
    fixed-base multiplication, and the exponents and points each drew."""
    memo, jax_exps, port_exps = {}, [], {}

    def points(group, exps):
        key = (group, tuple(e % FR.p for e in exps))
        if key not in memo:
            memo[key] = fixed_base(group, exps)
        return memo[key]

    def jax_batch(group):
        def batch(exponents, c=8):
            jax_exps.append([e % FR.p for e in exponents])
            return (jbn.g1_encode if group == "g1" else jbn.g2_encode)(points(group, exponents))
        return batch

    def port_batches(group, batches, device):
        port_exps[group] = [[e % FR.p for e in b] for b in batches]
        enc = bn254.g1_encode if group == "g1" else bn254.g2_encode
        return [enc(points(group, b), device=device) for b in batches]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "_g1_batch_device", jax_batch("g1"))
        mp.setattr(jg, "_g2_batch_device", jax_batch("g2"))
        mp.setattr(groth16, "_fixed_base_batches", port_batches)
        jpk, jvk = jg.setup(jcircuits.deposit_circuit(), seed=SEED)
        pk, vk = groth16.setup(circuits.deposit_circuit(), seed=SEED, device="cpu")
    jax_named = {name: e for (_, name), e in zip(JAX_CALLS, jax_exps)}
    port_named = {name: e for group, names in PORT_CALLS.items()
                  for name, e in zip(names, port_exps[group])}
    host = {name: points(group, jax_named[name]) for group, name in JAX_CALLS}
    return {"jpk": jpk, "jvk": jvk, "pk": pk, "vk": vk, "jax_exps": jax_named,
            "port_exps": port_named, "points": host}


def builders(token):
    note = dict(NOTE, token=token)
    return (circuits.deposit_circuit(circuits.DepositWitness(**note)),
            jcircuits.deposit_circuit(jcircuits.DepositWitness(**note)))


@pytest.fixture(scope="module")
def jax_proof(keys):
    """The JAX deposit proof: jg.prove's steps with the MSMs, the assembly
    adds and the h scalars on the host."""
    jpk = keys["jpk"]
    builder = builders(NOTE["token"])[1]
    wit = builder.witness()
    rs = jg._rand_stream(chip_smoke.DEPOSIT_PROVE_SEED + b"|rs")
    r, s = next(rs), next(rs)
    n = jpk.n_domain
    h_sc = ints_to_array(host_h(builder, jg._domain(n.bit_length() - 1))[: n - 1])
    pts = keys["points"]
    by_key = {"a": "a_g1", "b1": "b_g1", "k": "k_g1", "h": "h_g1"}

    def mg1(which, sc):
        pt = pippenger(ocurve.G1, pts[by_key[which]], array_to_ints(np.asarray(sc)))
        return tuple(a[0] for a in jbn.g1_encode([pt]))

    def mg2(sc):
        pt = pippenger(ocurve.G2, pts["b_g2"], array_to_ints(np.asarray(sc)))
        return tuple(a[0] for a in jbn.g2_encode([pt]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "_combine_jit", host_combine)
        proof = jg._prove_core(jpk, wit, r, s, h_sc, mg1, mg2)
    return {"proof": proof, "h_sc": np.asarray(h_sc)}


def test_deposit_circuit_matches_reference():
    for token in (NOTE["token"], 0):
        port, ref = builders(token)
        assert len(port.constraints) == len(ref.constraints) == 301
        assert port.constraints == ref.constraints
        assert (port.n_pub, port.num_vars) == (ref.n_pub, ref.num_vars) == (3, 306)
        assert port.witness() == ref.witness()
        assert port.witness()[1:4] == [circuits.commitment_of(NOTE["secret"], NOTE["salt"],
                                                              NOTE["amount"], token),
                                       NOTE["amount"], token]
    assert circuits.deposit_circuit().constraints == jcircuits.deposit_circuit().constraints


def test_setup_exponents_match_reference(keys):
    assert keys["port_exps"] == keys["jax_exps"]
    pk, jpk, jvk = keys["pk"], keys["jpk"], keys["jvk"]
    assert (pk.n_domain, pk.n_pub) == (jpk.n_domain, jpk.n_pub) == (512, 4)
    assert keys["vk"] == groth16.VerifyingKey(jvk.alpha_g1, jvk.beta_g2, jvk.gamma_g2,
                                              jvk.delta_g2, jvk.ic)


def test_jax_deposit_proof_digest(keys, jax_proof):
    proof = jax_proof["proof"]
    pub = chip_smoke.deposit_publics(jcircuits.commitment_of)
    assert jg.verify(keys["jvk"], pub, proof)
    assert groth16.verify(keys["vk"], pub, groth16.Proof(a=proof.a, b=proof.b, c=proof.c))
    # the constant chip_smoke.py holds the card's deposit proofs against
    assert chip_smoke.proof_digest(proof) == chip_smoke.DEPOSIT_DIGEST


def test_port_h_scalars_match_jax(keys, jax_proof):
    pk = keys["pk"]
    builder = builders(NOTE["token"])[0]
    n = pk.n_domain
    mats = groth16._device_mats(builder.compiled(n), torch.device("cpu"))
    h_sc = groth16._h_scalars_device(groth16._domain(n.bit_length() - 1),
                                     FR.encode(builder.witness()), mats)[: n - 1]
    assert np.array_equal(h_sc.numpy(), jax_proof["h_sc"].astype(np.int32))


def test_fixed_over_budget_proves_through_sorted(keys, monkeypatch):
    """The deposit key's fixed tables take 64·9·512 rows per set; under a
    smaller OWSHEN_FIXED_TABLE_MAX_GB "fixed" resolves to "sorted" and the
    prove goes through the Pippenger path, never building the tables."""
    pk = keys["pk"]
    calls = []
    monkeypatch.setattr(groth16, "_prove_legacy",
                        lambda pk, w, r, s, h_sc, engine, c, lanes: calls.append(engine))
    monkeypatch.setattr(groth16, "_prove_fixed", lambda *args: calls.append("fixed"))
    table = groth16._fixed_table_bytes(pk)
    assert table == 64 * 9 * 512 * (4 * 3 * 64 + 2 * 3 * 64)
    for engine in ("fixed", "lane", "sorted"):
        assert groth16._resolve_engine(pk, None, engine) == engine
    monkeypatch.setenv("OWSHEN_FIXED_TABLE_MAX_GB", str(0.9 * table / (1 << 30)))
    config.settings.cache_clear()
    try:
        assert groth16._resolve_engine(pk, None, "fixed") == "sorted"
        groth16.prove(pk, builders(NOTE["token"])[0], seed=b"spy", device="cpu")
    finally:
        monkeypatch.undo()
        config.settings.cache_clear()
    assert calls == ["sorted"]
    assert getattr(pk, "_fixed", None) is None
