"""The G1 and G2 ladders (`kernels/g1.py` `g1_scalar_mul`, `kernels/g2.py`
`g2_scalar_mul`) and the prover paths that run them, on the CPU twins: each
twin against the host oracle on `chip_smoke.ladder_edge_inputs`' edge rows,
`Weierstrass.scalar_mul` against the per-step loop it replaced, and proves
on the fixed and sorted engines, each running one ladder of each curve and,
on the fixed engine, no host scalar multiplication.  No JAX setup or prove;
the fixed tables come from `host_msm.restore_host_tables`."""

import pytest
import torch

import chip_smoke
from host_msm import restore_host_tables, tiny_circuit
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.kernels import g1, g2
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle.field import P_FR

LADDERS = {"g1": (g1, "g1_scalar_mul_plain"), "g2": (g2, "g2_scalar_mul_plain")}


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def spy_ladders(monkeypatch, fake=None):
    """Count each curve's ladder twin calls (the launches on the card);
    `fake` stands in for the twin when given."""
    calls = {"g1": 0, "g2": 0}
    for group, (mod, name) in LADDERS.items():
        real = getattr(mod, name)

        def twin(p, k, n_bits, group=group, real=real):
            calls[group] += 1
            return (fake or real)(p, k, n_bits)

        monkeypatch.setattr(mod, name, twin)
    return calls


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_twin_matches_oracle(group):
    """The identity, then the scalars 0, 1, r − 1 and 2^254 − 1 on a point
    and 2^254 − 1 on its negation, raw limbs, 254 steps: the twin equals
    the oracle's (k mod 2^254)·p."""
    p, k, want = chip_smoke.ladder_edge_inputs(torch, torch.Generator().manual_seed(1),
                                               chip_smoke.LADDER_HEAD, "cpu", group)
    rows = slice(1, 7)
    mod, name = LADDERS[group]
    got = getattr(mod, name)(tuple(c[rows] for c in p), k[rows], chip_smoke.LADDER_BITS)
    decode = bn254.g1_decode_many if group == "g1" else bn254.g2_decode_many
    assert decode(got) == want[rows]


def test_scalar_mul_is_one_ladder(monkeypatch):
    """`Weierstrass.scalar_mul` over 8 MSB-first bits gives, limb for limb,
    the points of the loop it replaced (every step's addend bit ? p :
    identity, then a double and an add per bit), in one ladder call."""
    calls = spy_ladders(monkeypatch)
    bits = torch.tensor([[1, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 1],
                         [0, 0, 1], [1, 0, 0], [0, 0, 1], [1, 0, 1]])
    for group, curve, oc, encode in (("g1", bn254.G1, ocurve.G1, bn254.g1_encode),
                                     ("g2", bn254.G2, ocurve.G2, bn254.g2_encode)):
        gen = ocurve.G1_GEN if group == "g1" else ocurve.G2_GEN
        p = encode([oc.mul(gen, 5), None, oc.mul(gen, 11)])
        got = curve.scalar_mul(p, bits)
        ident = curve.identity_like(p[0])
        addends = curve.select(bits != 0, tuple(a.expand(bits.shape[:1] + a.shape) for a in p),
                               ident)
        want = ident
        for i in range(bits.shape[0]):
            want = curve.add(curve.double(want), tuple(a[i] for a in addends))
        assert same(got, want)
    assert calls == {"g1": 1, "g2": 1}


@pytest.fixture(scope="module")
def key():
    pk, vk = groth16.setup(tiny_circuit(), seed=b"ladder", device="cpu")
    restore_host_tables(pk)
    return pk, vk


def test_fixed_prove_tails_on_the_ladders(monkeypatch, key):
    """A prove on the fixed engine (the key's tables and matrices in place)
    runs one ladder of each curve and no host scalar multiplication (the
    oracle's `mul` raises); its tails equal the host formula
    (α + r·δ, s·α + r·β + r·s·δ; β₂ + s·δ₂).  (test_torch_trace.py
    verifies such a proof.)"""
    pk, _ = key
    calls = spy_ladders(monkeypatch)
    tails = []
    real_tails = groth16._tails
    monkeypatch.setattr(groth16, "_tails",
                        lambda pk_, r, s: tails.append((r, s, real_tails(pk_, r, s))) or
                        tails[-1][2])

    def no_host_mul(*args):
        raise AssertionError("a host scalar multiplication in prove")

    for curve in (ocurve.G1, ocurve.G2):
        monkeypatch.setattr(curve, "mul", no_host_mul)
    proof = groth16.prove(pk, tiny_circuit(), seed=b"ladder-prove", device="cpu")
    monkeypatch.undo()
    assert calls == {"g1": 1, "g2": 1}
    assert proof.a is not None
    (r, s, (tails_g1, tail_b2)), = tails
    oG1, oG2 = ocurve.G1, ocurve.G2
    alpha, beta, delta = (bn254.g1_decode_host(pt) for pt in (pk.alpha_g1, pk.beta_g1,
                                                               pk.delta_g1))
    beta2, delta2 = (bn254.g2_decode_host(pt) for pt in (pk.beta_g2, pk.delta_g2))
    assert bn254.g1_decode_many(tails_g1) == [
        oG1.add(alpha, oG1.mul(delta, r)),
        oG1.add(oG1.add(oG1.mul(alpha, s), oG1.mul(beta, r)), oG1.mul(delta, r * s % P_FR))]
    assert bn254.g2_decode_host(tuple(a[None] for a in tail_b2)) == oG2.add(
        beta2, oG2.mul(delta2, s))


def test_sorted_prove_runs_one_ladder_each(monkeypatch, key):
    """A prove on the sorted engine scales its five G1 lanes in one ladder
    call and its G2 point in one (the MSMs and the ladders stubbed: only
    the calls are counted)."""
    pk, _ = key
    calls = spy_ladders(monkeypatch, fake=lambda p, k, n_bits: p)
    first = lambda pts: tuple(a[0] for a in pts)  # noqa: E731
    monkeypatch.setattr(groth16, "_msm_engine",
                        lambda curve, *args: lambda jobs: [first(pts) for pts, _ in jobs])
    groth16.prove(pk, tiny_circuit(), seed=b"ladder-sorted", engine="sorted", device="cpu")
    assert calls == {"g1": 1, "g2": 1}
