"""A Python-integer model of K6's arithmetic (kernels/csrc/field.cuh, lazy
section, and kernels/csrc/mimc.cu), step for step: the word-serial CIOS
product on 32-bit words with its even and odd rows, the squaring from its
cross products, the lazy add, and MultiMiMC7 with one canonicalisation at
the end.  Every carry that a kernel chain drops is asserted to be 0, every
result to stay below 2r and to equal the exact value mod r; the model's
MultiMiMC7 must equal the port's and the JAX package's oracles."""

import random

import numpy as np

from owshen_tpu.oracle import hash as jax_ohash
from owshen_tpu_torch.kernels import build
from owshen_tpu_torch.ops.constants import mimc7_constants
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FR as P

MASK = 0xFFFFFFFF
R = 1 << 256
N0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
PW = build.words_le(P)
P2W = build.words_le(2 * P)
# go-iden3-crypto mimc7_test.go (tests/test_hash.py:53-57)
MULTI_MIMC7_12_45_78_41 = \
    18226366069841799622585958305961373004333097209608110160936134895615261821931


def words(x):
    return build.words_le(x)


def value(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


def chain(acc, pos, pairs, carry=0):
    """acc[pos..] += the lo/hi words of each product in `pairs`, as one
    carry chain (mad.lo.cc / madc.hi.cc); returns the carry out."""
    for a, b in pairs:
        prod = a * b
        for half in (prod & MASK, prod >> 32):
            v = acc[pos] + half + carry
            acc[pos], carry = v & MASK, v >> 32
            pos += 1
    return carry


def row(a, off, b):
    """(a[off]·b, a[off + 2]·b, ...) over four words of a, as 8 words."""
    return [(a[off + j] * b) >> (32 * h) & MASK for j in range(0, 8, 2) for h in (0, 1)]


def mad_redc_step(even, odd, a, bi, first):
    if first:
        odd[:] = row(a, 1, bi)
        even[:] = row(a, 0, bi)
    else:
        v = even[0] + odd[1]
        even[0], carry = v & MASK, v >> 32
        shifted = odd[2:] + [0, 0]
        odd[:] = shifted
        assert chain(odd, 0, [(a[j], bi) for j in range(1, 8, 2)], carry) == 0
        odd[7] += chain(even, 0, [(a[j], bi) for j in range(0, 8, 2)])
    m = even[0] * N0 & MASK
    assert chain(odd, 0, [(PW[j], m) for j in range(1, 8, 2)]) == 0
    odd[7] += chain(even, 0, [(PW[j], m) for j in range(0, 8, 2)])
    assert even[0] == 0 and odd[7] <= MASK


def fmul_lazy(a, b):
    even, odd = [0] * 8, [0] * 8
    for i in range(0, 8, 2):
        mad_redc_step(even, odd, a, b[i], i == 0)
        mad_redc_step(odd, even, a, b[i + 1], False)
    r = [0] * 8
    carry = 0
    for j in range(8):
        v = even[j] + (odd[j + 1] if j < 7 else 0) + carry
        r[j], carry = v & MASK, v >> 32
    assert carry == 0
    return r


def fsqr_lazy(a):
    ev, od = [0] * 16, [0] * 16
    for i in range(7):
        for acc, j0 in ((od, i + 1), (ev, i + 2)):
            if j0 < 8:
                top = i + max(range(j0, 8, 2)) + 2
                carry = chain(acc, i + j0, [(a[i], a[j]) for j in range(j0, 8, 2)])
                acc[top] += carry
                assert acc[top] <= MASK
    s = value(ev) + value(od)
    s = 2 * s + sum(a[i] * a[i] << (64 * i) for i in range(8))
    assert s < 1 << 512
    t, hi = words(s & (R - 1)), words(s >> 256)
    for _ in range(8):                       # REDC of the low half
        m = t[0] * N0 & MASK
        o = row(PW, 1, m)
        o[7] += chain(t, 0, [(PW[j], m) for j in range(0, 8, 2)])
        assert t[0] == 0
        t = words(value(t) // (1 << 32) + value(o))
        assert value(t) < R
    assert value(t) <= P and value(hi) < P
    return words(value(t) + value(hi))


def fadd_lazy(a, b):
    s = value(a) + value(b)
    assert s < R
    return words(s - 2 * P if s >= 2 * P else s)


def fcanon(a):
    return words(value(a) - P if value(a) >= P else value(a))


CONSTS = [words(c * R % P) for c in mimc7_constants()]


def mimc7_lazy(x, k):
    r = x
    for c in CONSTS:                         # c_0 = 0: round 0 is (x + k)^7
        r = fadd_lazy(fadd_lazy(r, k), c)
        x2 = fsqr_lazy(r)
        x4 = fsqr_lazy(x2)
        r = fmul_lazy(fmul_lazy(x4, x2), r)
        assert value(r) < 2 * P
    return fadd_lazy(r, k)


def multi_mimc7_lazy(inputs):
    """MultiMiMC7(inputs, key 0) on canonical ints, as mimc2_kernel runs it
    (Montgomery words in, the canonical Montgomery hash out)."""
    acc = [0] * 8
    for x in inputs:
        xm = words(x * R % P)
        h = mimc7_lazy(xm, acc)
        acc = fadd_lazy(fadd_lazy(acc, xm), h)
    out = value(fcanon(acc))
    assert out < P
    return out * pow(R, -1, P) % P


def test_lazy_ops_stay_below_2r():
    rng = random.Random(0x1A2)
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals = edges + [rng.randrange(2 * P) for _ in range(120)] \
        + [2 * P - 1 - rng.randrange(1 << rng.randrange(1, 250)) for _ in range(60)]
    rinv = pow(R, -1, P)
    pairs = [(a, b) for a in edges for b in edges] + list(zip(vals, vals[7:] + vals[:7]))
    for a, b in pairs:
        prod, total = value(fmul_lazy(words(a), words(b))), value(fadd_lazy(words(a), words(b)))
        assert prod < 2 * P and prod % P == a * b * rinv % P
        assert total < 2 * P and total % P == (a + b) % P
    for a in vals:
        sq = value(fsqr_lazy(words(a)))
        assert sq < 2 * P and sq % P == a * a * rinv % P
        assert value(fcanon(words(a))) == a % P


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
    assert field[0, :8].tolist() == PW and int(field[0, 8]) == N0
    assert field[0, 9:].tolist() == P2W
    c, n_rounds = build._mimc_consts_words()
    assert n_rounds == 91 and c.tolist() == CONSTS and CONSTS[0] == [0] * 8
