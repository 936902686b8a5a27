"""The slice end to end, port vs reference, at depth 2 on the CPU.

1. The port's setup of withdraw_circuit(2) equals the JAX package's keys
   (the shared depth-2 keys of tests/conftest.py, same seed) after affine
   decoding.
2. The JAX pool and the port's pool take the depth-2 statement of
   chip_smoke.py and agree on every root.
3. The port, holding the JAX keys (carried across by convert.py), proves
   the statement with chip_smoke.py's seed; the proof equals the JAX
   proof, whose digest is chip_smoke.DEPTH2_DIGEST — the constant the chip
   run checks its own depth-2 proof against.
4. Each side's verify accepts the other's proof and rejects a tampered
   public input; the port's pool issues a voucher, redeems it once and
   rejects a replay.

Two shortcuts keep this file to minutes on the CPU; neither touches what
is compared.  The JAX proof runs the JAX prover's own steps (`_rand_stream`,
`_prove_core`) with its MSMs taken on the host (Pippenger over the JAX
oracle), because the fixed-table engine spends about ten minutes of XLA:CPU
at depth 2, its nine assembly adds (`_combine_jit`) on the host too, whose
trace and compile on XLA:CPU take ~20 s, and its h scalars from the JAX
package's NTT oracle (tests/host_msm.py `host_h`, the values `_h_pipeline`
gives), whose XLA:CPU trace and compile take half a minute or more; the JAX
package's own prover tests run both.  The port proves through its fixed-table engine over
tables computed on the host oracle, because building 64·9·2048-row tables on
the plain int64 twins takes about four minutes; the rows `build_table`
gives are held against the oracle in tests/test_torch_ntt_msm.py, and a
wrong host row would show here as a proof that differs.  The host rows
come from tests/host_msm.py: affine sums on bare ints with one inversion
per batch, each window's rows encoded in one pass.

The file keeps six test items: pytest-xdist's loadfile mode queues files by
item count, and at six or fewer this file queues after the JAX package's
long pool files (test_protocol.py and the like) instead of holding a worker
they would start on."""

import numpy as np
import pytest
import torch

import chip_smoke
from host_msm import host_combine, host_h, host_table, oracle_affine, pippenger
from owshen_tpu.circuits import pool as jcircuits
from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.fields.field import array_to_ints, ints_to_array
from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.groth16 import groth16 as jg
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.protocol.pool import PrivacyPool as JPool
from owshen_tpu_torch import convert
from owshen_tpu_torch.circuits import pool as circuits
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.ops.msm_fixed import FixedMsm, FixedMsmGroup
from owshen_tpu_torch.protocol.pool import PoolError, PrivacyPool

torch.set_num_threads(1)

NOTE = chip_smoke.DEPTH2_NOTE
RECIPIENT = chip_smoke.DEPTH2_RECIPIENT
G1_SETS = ("a_g1", "b_g1", "k_g1", "h_g1")   # the port's table order


def limbs(pt):
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int32)) for a in pt)


def affine(pt, group):
    if pt is None:
        return None
    dec = bn254.g1_decode_many if group == "g1" else bn254.g2_decode_many
    return dec(pt)


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_keys():
    return groth16.setup(circuits.withdraw_circuit(2), seed=chip_smoke.DEPTH2_SETUP_SEED,
                         device="cpu")


@pytest.fixture(scope="module")
def jax_side(_small_pool_keys):
    """The JAX pool after the depth-2 deposits, and the JAX proof of the
    note: jg.prove's steps with the MSMs on the host."""
    jpk, jvk = _small_pool_keys
    pool = JPool(depth=2, keys=_small_pool_keys)
    coms, txs, amounts = chip_smoke.depth2_deposits(jcircuits.commitment_of)
    pool.deposit(coms, txs, amounts)
    sibs_dev, _ = pool.tree.path([1])
    sibs = [JFR.decode(sibs_dev[0, l][None])[0] for l in range(2)]
    w = jcircuits.WithdrawWitness(secret=NOTE["secret"], salt=NOTE["salt"],
                                  amount=NOTE["amount"], index=1, siblings=sibs,
                                  token=NOTE["token"])
    root = pool.tree.root_int()
    builder = jcircuits.withdraw_circuit(2, w, root=root, recipient=RECIPIENT)

    wit = builder.witness()
    rs = jg._rand_stream(chip_smoke.DEPTH2_PROVE_SEED + b"|rs")
    r, s = next(rs), next(rs)
    n = jpk.n_domain
    h_sc = ints_to_array(host_h(builder, jg._domain(n.bit_length() - 1))[: n - 1])
    points = {name: oracle_affine(getattr(jpk, name), "g1") for name in G1_SETS}
    points["b_g2"] = oracle_affine(jpk.b_g2, "g2")
    by_key = {"a": "a_g1", "b1": "b_g1", "k": "k_g1", "h": "h_g1"}

    def mg1(which, sc):
        pt = pippenger(ocurve.G1, points[by_key[which]], array_to_ints(np.asarray(sc)))
        return tuple(a[0] for a in jbn.g1_encode([pt]))

    def mg2(sc):
        pt = pippenger(ocurve.G2, points["b_g2"], array_to_ints(np.asarray(sc)))
        return tuple(a[0] for a in jbn.g2_encode([pt]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "_combine_jit", host_combine)
        proof = jg._prove_core(jpk, wit, r, s, h_sc, mg1, mg2)
    return {"pk": jpk, "vk": jvk, "pool": pool, "proof": proof, "root": root,
            "points": points, "nullifier": jcircuits.nullifier_of(NOTE["secret"], 1)}


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port's pool on the CPU with the JAX keys carried across, after
    the same deposits, and its proof of the note."""
    jpk, jvk = jax_side["pk"], jax_side["vk"]
    fields = {"n_domain": jpk.n_domain, "n_pub": jpk.n_pub}
    for name in convert.POINT_FIELDS:
        pt = getattr(jpk, name)
        fields[name] = None if pt is None else tuple(np.asarray(a) for a in pt)
    pk = convert.proving_key_from_numpy(fields, device="cpu")
    vk = convert.verifying_key_from_ints(jvk.alpha_g1, jvk.beta_g2, jvk.gamma_g2,
                                         jvk.delta_g2, jvk.ic)
    pts = jax_side["points"]
    n = groth16._table_n(pk)
    pad = lambda ps: ps + [None] * (n - len(ps))  # noqa: E731
    g1_rows, widths, shapes = host_table("g1", [p for name in G1_SETS for p in pad(pts[name])])
    g1 = FixedMsmGroup.from_rows(bn254.G1, g1_rows, (n, len(G1_SETS), widths, shapes))
    b2_rows, widths, shapes = host_table("g2", pad(pts["b_g2"]))
    b2 = FixedMsm(bn254.G2, None, _rows=b2_rows, _meta=(n, 1, widths, shapes))
    groth16.restore_fixed_tables(pk, g1, b2)

    pool = PrivacyPool(depth=2, keys=(pk, vk), device="cpu")
    roots = [pool.roots[-1]]
    coms, txs, amounts = chip_smoke.depth2_deposits(circuits.commitment_of)
    pool.deposit(coms, txs, amounts)
    roots.append(pool.roots[-1])
    proof, root, nullifier = pool.prove_withdraw(
        NOTE["secret"], NOTE["salt"], NOTE["amount"], 1, RECIPIENT,
        token=NOTE["token"], seed=chip_smoke.DEPTH2_PROVE_SEED)
    return {"pool": pool, "proof": proof, "root": root, "nullifier": nullifier,
            "roots": roots}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_setup_matches_jax_keys(_small_pool_keys, port_keys):
    jpk, jvk = _small_pool_keys
    pk, vk = port_keys
    assert (pk.n_domain, pk.n_pub) == (jpk.n_domain, jpk.n_pub)
    for name in convert.POINT_FIELDS:
        group = "g2" if name.endswith("g2") else "g1"
        mine, ref = getattr(pk, name), getattr(jpk, name)
        assert (mine is None) == (ref is None), name
        if mine is not None:
            assert affine(mine, group) == affine(limbs(ref), group), name
    assert vk == groth16.VerifyingKey(jvk.alpha_g1, jvk.beta_g2, jvk.gamma_g2,
                                      jvk.delta_g2, jvk.ic)


def test_pool_roots_match_jax(jax_side, port_side):
    assert port_side["roots"] == jax_side["pool"].roots
    assert port_side["root"] == jax_side["root"]
    assert torch.equal(port_side["pool"].tree.nodes,
                       limbs((jax_side["pool"].tree.nodes,))[0])


def test_proof_matches_jax_proof(jax_side, port_side):
    jp, pp = jax_side["proof"], port_side["proof"]
    assert (pp.a, pp.b, pp.c) == (jp.a, jp.b, jp.c)
    assert port_side["nullifier"] == jax_side["nullifier"]
    # the constant chip_smoke.py holds the card's depth-2 proof against
    assert chip_smoke.proof_digest(jp) == chip_smoke.DEPTH2_DIGEST


def test_verifiers_accept_each_other(jax_side, port_side):
    pub = [jax_side["root"], jax_side["nullifier"], RECIPIENT, NOTE["amount"], NOTE["token"]]
    pp, jp = port_side["proof"], jax_side["proof"]
    assert jg.verify(jax_side["vk"], pub, jg.Proof(a=pp.a, b=pp.b, c=pp.c))
    assert groth16.verify(port_side["pool"].vk, pub, groth16.Proof(a=jp.a, b=jp.b, c=jp.c))
    tampered = pub[:2] + [RECIPIENT + 1] + pub[3:]
    assert not groth16.verify(port_side["pool"].vk, tampered, pp)
    assert not jg.verify(jax_side["vk"], tampered, jg.Proof(a=pp.a, b=pp.b, c=pp.c))


def test_withdraw_voucher_redeem_once(port_side):
    pool = port_side["pool"]
    args = (port_side["proof"], port_side["root"], port_side["nullifier"], RECIPIENT,
            NOTE["amount"])
    with pytest.raises(PoolError, match="invalid proof"):
        pool.withdraw(args[0], args[1], args[2], RECIPIENT + 1, NOTE["amount"])
    voucher = pool.withdraw(*args)
    assert pool.redeem(voucher)
    with pytest.raises(PoolError, match="already executed"):
        pool.redeem(voucher)
    with pytest.raises(PoolError, match="already spent"):
        pool.withdraw(*args)


def test_deposit_guards(port_side):
    pool = port_side["pool"]
    before = list(pool.roots)
    _, txs, _ = chip_smoke.depth2_deposits(circuits.commitment_of)
    with pytest.raises(PoolError, match="already deposited"):
        pool.deposit([0x33], [txs[0]])
    with pytest.raises(PoolError, match="already deposited"):
        pool.deposit([0x33, 0x34], [0xAB, 0xAB])
    with pytest.raises(PoolError, match="pool full"):
        pool.deposit([0x33, 0x34], [0xAB, 0xAC])
    assert pool.roots == before

