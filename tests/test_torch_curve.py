"""Port vs reference: K2 / K3 (complete G1 add and double), the composed G2
ops, point conversion and the fixed-base multiply of setup.

The JAX side runs g1_add_pallas / g1_double_pallas in interpret mode at
128 rows (as tests/test_pallas.py does) and its composed curve ops;
projective coordinates compare limb for limb, since every field op returns
canonical values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.pallas.field_kernels import g1_add_pallas, g1_double_pallas
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.curves.fixed_base import g1_fixed_base, g2_fixed_base
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.kernels import g1

torch.set_num_threads(1)


def same(tp, jp):
    return all(np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))
               for t, j in zip(tp, jp))


def edge_pairs(curve, gen, rng, n):
    """n (p, q) pairs: identities, P + P and P + (−P), then random
    multiples (chip_smoke.edge_pairs)."""
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    return chip_smoke.edge_pairs(curve, gen, ks)


def test_g1_kernels_match_pallas():
    rng = np.random.default_rng(21)
    ps, qs = edge_pairs(ocurve.G1, ocurve.G1_GEN, rng, 128)
    jp, jq = jbn.g1_encode(ps), jbn.g1_encode(qs)
    tp, tq = bn254.g1_encode(ps), bn254.g1_encode(qs)
    assert same(tp, jp)
    jp, jq = tuple(map(jnp.asarray, jp)), tuple(map(jnp.asarray, jq))
    got_add = g1.g1_add(tp, tq)
    assert same(got_add, g1_add_pallas(jp, jq, block_t=128))
    got_dbl = g1.g1_double(tp)
    assert same(got_dbl, g1_double_pallas(jp, block_t=128))
    assert bn254.g1_decode_many(got_add) == [ocurve.G1.add(p, q) for p, q in zip(ps, qs)]
    assert bn254.g1_decode_many(got_dbl) == [ocurve.G1.add(p, p) for p in ps]


def test_g1_matches_composed_jax_path():
    rng = np.random.default_rng(22)
    ps, qs = edge_pairs(ocurve.G1, ocurve.G1_GEN, rng, 8)
    jp = tuple(map(jnp.asarray, jbn.g1_encode(ps)))
    jq = tuple(map(jnp.asarray, jbn.g1_encode(qs)))
    tp, tq = bn254.g1_encode(ps), bn254.g1_encode(qs)
    assert same(bn254.G1.add(tp, tq), jbn.G1.add(jp, jq))
    assert same(bn254.G1.double(tp), jbn.G1.double(jp))


def test_g2_ops_match_jax():
    rng = np.random.default_rng(23)
    ps, qs = edge_pairs(ocurve.G2, ocurve.G2_GEN, rng, 6)
    jp = tuple(map(jnp.asarray, jbn.g2_encode(ps)))
    jq = tuple(map(jnp.asarray, jbn.g2_encode(qs)))
    tp, tq = bn254.g2_encode(ps), bn254.g2_encode(qs)
    assert same(tp, jp)
    got = bn254.G2.add(tp, tq)
    assert same(got, jbn.G2.add(jp, jq))
    assert same(bn254.G2.double(tp), jbn.G2.double(jp))
    assert bn254.g2_decode_many(got) == [ocurve.G2.add(p, q) for p, q in zip(ps, qs)]


def test_point_decode_matches_oracle():
    rng = np.random.default_rng(24)
    ps = [ocurve.G1.mul(ocurve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 40, 5)]
    ps.append(None)
    assert bn254.g1_decode_many(bn254.g1_encode(ps)) == ps
    assert bn254.g1_decode_host(tuple(a[2:3] for a in bn254.g1_encode(ps))) == ps[2]
    qs = [ocurve.G2.mul(ocurve.G2_GEN, int(k)) for k in rng.integers(1, 1 << 40, 3)]
    qs.append(None)
    assert bn254.g2_decode_many(bn254.g2_encode(qs)) == qs


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_matches_oracle(group):
    rng = np.random.default_rng(25)
    ks = [0, 1, FR.p - 1] + [int.from_bytes(rng.bytes(32), "little") % FR.p
                             for _ in range(3)]
    if group == "g1":
        got = bn254.g1_decode_many(g1_fixed_base().mul(FR.encode(ks, mont=False)))
        assert got == [ocurve.G1.mul(ocurve.G1_GEN, k) for k in ks]
    else:
        got = bn254.g2_decode_many(g2_fixed_base().mul(FR.encode(ks, mont=False)))
        assert got == [ocurve.G2.mul(ocurve.G2_GEN, k) for k in ks]
