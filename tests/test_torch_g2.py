"""K1's G2 point operations: a Python-integer model of csrc/g2.cu's two
lanes per point on the word model of tests/lazy_words.py (every dropped
carry asserted 0, every value below 2q), held to both packages' oracles;
the CPU twins g2_add / g2_double against the port's oracle and the work
chip_smoke.py's bound counts; and the prover's halving-tree bucket sum.
No key, no prove, no JAX: the file takes seconds."""

import random

import numpy as np
import torch

import chip_smoke
from lazy_words import LazyField, value, words
from owshen_tpu.oracle import curve as jax_ocurve
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16.groth16 import _bucket_sum
from owshen_tpu_torch.kernels import field_ops, g2
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle.field import P_FQ

torch.set_num_threads(1)
FQ = LazyField(P_FQ)
B3 = [g2.b3_mont_words()[:8], g2.b3_mont_words()[8:]]


# -- the two-lane model: an Fq2 value is [lane 0's words, lane 1's words] --

def sub_add(u, v, lane):
    """lane 0: u − v, lane 1: u + v (both formed, one kept)"""
    s, d = FQ.add(u, v), FQ.sub(u, v)
    return s if lane else d


def f2mul(a, b):
    """g2.cu f2mul: each lane reads the other's components of a and b (the
    pair shuffle), then own(a)·b0 ∓ other(a)·b1."""
    out = []
    for lane in (0, 1):
        own, other = a[lane], a[1 - lane]
        b0, b1 = b[0], b[1]
        out.append(sub_add(FQ.mul(own, b0), FQ.mul(other, b1), lane))
    return out


def f2mul_b3(a):
    return [sub_add(FQ.mul(a[lane], B3[0]), FQ.mul(a[1 - lane], B3[1]), lane)
            for lane in (0, 1)]


def f2add(a, b):
    return [FQ.add(a[c], b[c]) for c in (0, 1)]


def f2sub(a, b):
    return [FQ.sub(a[c], b[c]) for c in (0, 1)]


def g2_add_lanes(p, q):
    """g2.cu g2_add_lazy, operation for operation (the six input sums right
    after t0, t1, t2), then each coordinate's fcanon"""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2 = f2mul(X1, X2), f2mul(Y1, Y2), f2mul(Z1, Z2)
    sxy1, sxy2, syz1, syz2, sxz1, sxz2 = (f2add(X1, Y1), f2add(X2, Y2), f2add(Y1, Z1),
                                          f2add(Y2, Z2), f2add(X1, Z1), f2add(X2, Z2))
    t3 = f2sub(f2mul(sxy1, sxy2), f2add(t0, t1))
    t4 = f2sub(f2mul(syz1, syz2), f2add(t1, t2))
    t5 = f2sub(f2mul(sxz1, sxz2), f2add(t0, t2))
    three_t0 = f2add(f2add(t0, t0), t0)
    t2b = f2mul_b3(t2)
    z3, t1b = f2add(t1, t2b), f2sub(t1, t2b)
    y3 = f2mul_b3(t5)
    X3 = f2sub(f2mul(t3, t1b), f2mul(t4, y3))
    Y3 = f2add(f2mul(y3, three_t0), f2mul(t1b, z3))
    Z3 = f2add(f2mul(z3, t4), f2mul(three_t0, t3))
    return [[FQ.canon(w) for w in c] for c in (X3, Y3, Z3)]


def g2_dbl_lanes(p):
    """g2.cu g2_dbl_lazy, operation for operation, then fcanon"""
    X, Y, Z = p
    t0 = f2mul(Y, Y)
    z3 = f2add(t0, t0)
    z3 = f2add(z3, z3)
    z3 = f2add(z3, z3)
    t1 = f2mul(Y, Z)
    t2 = f2mul_b3(f2mul(Z, Z))
    x3 = f2mul(t2, z3)
    y3 = f2add(t0, t2)
    Z3 = f2mul(t1, z3)
    t1 = f2add(t2, t2)
    t2 = f2add(t1, t2)
    t0 = f2sub(t0, t2)
    Y3 = f2add(x3, f2mul(t0, y3))
    t1 = f2mul(X, Y)
    x3 = f2mul(t0, t1)
    return [[FQ.canon(w) for w in c] for c in (f2add(x3, x3), Y3, Z3)]


def edge_pairs(n, seed):
    """n (p, q) pairs of G2 points: O + O, P + O, O + Q, P + P, P + (−P),
    then seeded multiples of the generator (chip_smoke.edge_pairs)."""
    rng = random.Random(seed)
    return chip_smoke.edge_pairs(ocurve.G2, ocurve.G2_GEN,
                                 [rng.randrange(1, 1 << 64) for _ in range(n)])


def lane_words(pt):
    """projective int32[n, 2, 16] tensors -> per point [[X0, X1], [Y0, Y1],
    [Z0, Z1]] as 8-word values"""
    def w(row):
        return [int(row[2 * i]) | int(row[2 * i + 1]) << 16 for i in range(8)]
    return [[[w(c[i, 0]), w(c[i, 1])] for c in pt] for i in range(pt[0].shape[0])]


def affine(coords):
    X, Y, Z = ((FQ.unmont(c[0]), FQ.unmont(c[1])) for c in coords)
    if Z == (0, 0):
        return None
    zi = ocurve.FQ2I.inv(Z)
    return ocurve.FQ2I.mul(X, zi), ocurve.FQ2I.mul(Y, zi)


def test_lane_products_match_fq2():
    """The two-lane Fq2 product and the b3 product on lazy inputs up to
    2q − 1 equal the Fq2 products of both oracles' arithmetic."""
    q = P_FQ
    rng = random.Random(0x62)
    vals = [0, 1, q - 1, q, 2 * q - 1, 2 * q - 2] + [rng.randrange(2 * q) for _ in range(6)]
    def plain(x):
        return tuple(FQ.unmont(w) for w in x)

    b3 = plain(B3)
    assert b3 == g2.B3 == ((3 * jax_ocurve.B_G2[0]) % q, (3 * jax_ocurve.B_G2[1]) % q)
    for i, (a0, a1) in enumerate(zip(vals, vals[::-1])):
        b0, b1 = vals[(i + 3) % len(vals)], vals[(i + 7) % len(vals)]
        a, b = [words(a0), words(a1)], [words(b0), words(b1)]
        want = ocurve.FQ2I.mul(plain(a), plain(b))
        assert want == jax_ocurve.FQ2I.mul(plain(a), plain(b))
        assert plain(f2mul(a, b)) == want
        assert plain(f2mul_b3(a)) == ocurve.FQ2I.mul(plain(a), b3)
        assert all(value(w) < 2 * q for w in f2mul(a, b) + f2mul_b3(a))


def test_lane_add_double_match_oracles():
    """The model of g2_add_kernel / g2_dbl_kernel on the edge pairs: the
    affine results equal both packages' oracles, and the canonical
    coordinates equal the plain twins' limb for limb."""
    ps, qs = edge_pairs(6, 0x6A)
    tp, tq = bn254.g2_encode(ps), bn254.g2_encode(qs)
    twin_add, twin_dbl = g2.g2_add_plain(tp, tq), g2.g2_double_plain(tp)
    rows = zip(ps, qs, lane_words(tp), lane_words(tq), lane_words(twin_add),
               lane_words(twin_dbl))
    for a, b, p, q, want_add, want_dbl in rows:
        got = g2_add_lanes(p, q)
        assert got == want_add
        assert affine(got) == ocurve.G2.add(a, b) == jax_ocurve.G2.add(a, b)
        got = g2_dbl_lanes(p)
        assert got == want_dbl
        assert affine(got) == ocurve.G2.add(a, a) == jax_ocurve.G2.add(a, a)


def test_twins_match_oracle_and_count_the_bound_work(monkeypatch):
    """The CPU twins on the edge pairs (and broadcast against one point)
    equal the port's oracle, and do per point the Fq products and adds that
    chip_smoke.py's bound counts."""
    ps, qs = edge_pairs(8, 0x6B)
    tp, tq = bn254.g2_encode(ps), bn254.g2_encode(qs)
    assert bn254.g2_decode_many(g2.g2_add(tp, tq)) == \
        [ocurve.G2.add(a, b) for a, b in zip(ps, qs)]
    assert bn254.g2_decode_many(g2.g2_double(tp)) == [ocurve.G2.add(a, a) for a in ps]
    one = tuple(c[5] for c in tq)
    assert bn254.g2_decode_many(g2.g2_add(tp, one)) == [ocurve.G2.add(a, qs[5]) for a in ps]

    counts = {"mul": 0, "add": 0}

    def counted(fn, kind):
        def run(a, b, c):
            counts[kind] += max(a.shape[1], b.shape[1])
            return fn(a, b, c)
        return run

    monkeypatch.setattr(g2, "mul_lm", counted(field_ops.mul_lm, "mul"))
    monkeypatch.setattr(g2, "add_lm", counted(field_ops.add_lm, "add"))
    monkeypatch.setattr(g2, "sub_lm", counted(field_ops.sub_lm, "add"))
    n = tp[0].shape[0]
    for fn, args, work in ((g2.g2_add_plain, (tp, tq), chip_smoke.G2_ADD_WORK),
                           (g2.g2_double_plain, (tp,), chip_smoke.G2_DOUBLE_WORK)):
        counts.update(mul=0, add=0)
        fn(*args)
        assert (counts["mul"], counts["add"]) == (n * work[0], n * work[1])


def test_bucket_sum_is_a_halving_tree(monkeypatch):
    """_matvec's bucket sum over random buckets (k = 1 … 9, odd k too)
    equals the sequential sum and the oracle, in ⌈log2 k⌉ adds."""
    rng = np.random.default_rng(0x3A7)
    for k in range(1, 10):
        vals = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(k)]
                for _ in range(5)]
        prods = FR.encode([v for row in vals for v in row]).reshape(5, k, FR.L)
        seq = prods[:, 0]
        for t in range(1, k):
            seq = FR.add(seq, prods[:, t])
        adds = []
        with monkeypatch.context() as m:
            m.setattr(FR, "add", lambda a, b, add=FR.add: adds.append(1) or add(a, b))
            got = _bucket_sum(prods)
        assert torch.equal(got, seq)
        assert FR.decode(got) == [sum(row) % FR.p for row in vals]
        assert len(adds) == (k - 1).bit_length()
