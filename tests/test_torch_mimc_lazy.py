"""A Python-integer model of K6's arithmetic (kernels/csrc/field.cuh, lazy
section, modelled word for word in tests/lazy_words.py, and
kernels/csrc/mimc.cu): MultiMiMC7 with one canonicalisation at the end.
Every carry that a kernel chain drops is asserted to be 0, every result to
stay below 2r and to equal the exact value mod r; the model's MultiMiMC7
must equal the port's and the JAX package's oracles."""

import random

import numpy as np

from lazy_words import R, LazyField, value, words
from owshen_tpu.oracle import hash as jax_ohash
from owshen_tpu_torch.kernels import build
from owshen_tpu_torch.ops.constants import mimc7_constants
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FR as P

FR = LazyField(P)
# go-iden3-crypto mimc7_test.go (tests/test_hash.py:53-57)
MULTI_MIMC7_12_45_78_41 = \
    18226366069841799622585958305961373004333097209608110160936134895615261821931
CONSTS = [FR.mont(c) for c in mimc7_constants()]


def mimc7_lazy(x, k):
    r = x
    for c in CONSTS:                         # c_0 = 0: round 0 is (x + k)^7
        r = FR.add(FR.add(r, k), c)
        x2 = FR.sqr(r)
        x4 = FR.sqr(x2)
        r = FR.mul(FR.mul(x4, x2), r)
        assert value(r) < 2 * P
    return FR.add(r, k)


def multi_mimc7_lazy(inputs):
    """MultiMiMC7(inputs, key 0) on canonical ints, as mimc2_kernel runs it
    (Montgomery words in, the canonical Montgomery hash out)."""
    acc = [0] * 8
    for x in inputs:
        xm = FR.mont(x)
        h = mimc7_lazy(xm, acc)
        acc = FR.add(FR.add(acc, xm), h)
    out = FR.canon(acc)
    assert value(out) < P
    return FR.unmont(out)


def test_lazy_ops_stay_below_2r():
    rng = random.Random(0x1A2)
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals = edges + [rng.randrange(2 * P) for _ in range(120)] \
        + [2 * P - 1 - rng.randrange(1 << rng.randrange(1, 250)) for _ in range(60)]
    rinv = pow(R, -1, P)
    pairs = [(a, b) for a in edges for b in edges] + list(zip(vals, vals[7:] + vals[:7]))
    for a, b in pairs:
        prod, total = value(FR.mul(words(a), words(b))), value(FR.add(words(a), words(b)))
        assert prod < 2 * P and prod % P == a * b * rinv % P
        assert total < 2 * P and total % P == (a + b) % P
    for a in vals:
        sq = value(FR.sqr(words(a)))
        assert sq < 2 * P and sq % P == a * a * rinv % P
        assert value(FR.canon(words(a))) == a % P


def test_lazy_multimimc7_matches_oracles():
    vector = [12, 45, 78, 41]
    assert multi_mimc7_lazy(vector) == MULTI_MIMC7_12_45_78_41
    assert ohash.mimc7_multi(vector) == jax_ohash.mimc7_multi(vector) == MULTI_MIMC7_12_45_78_41
    rng = np.random.default_rng(0x6D1)
    pairs = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(2)] for _ in range(16)]
    pairs[:3] = [[0, 0], [P - 1, P - 1], [1, P - 1]]
    for pair in pairs:
        want = ohash.mimc7_multi(pair)
        assert want == jax_ohash.mimc7_multi(pair)
        assert multi_mimc7_lazy(pair) == want


def test_model_constants_are_the_uploaded_ones():
    field = build._field_consts_words().reshape(2, 17)
    assert field[0, :8].tolist() == FR.pw and int(field[0, 8]) == FR.n0
    assert field[0, 9:].tolist() == FR.p2w
    c, n_rounds = build._mimc_consts_words()
    assert n_rounds == 91 and c.tolist() == CONSTS and CONSTS[0] == [0] * 8
