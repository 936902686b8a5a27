"""K1's BabyJubJub kernels (kernels/jub.py, csrc/jub.cu): the plain twins
against the JAX package's `add`, `double` and `scalar_mul` bit for bit and
the full 254-bit ladder against the port's oracle, on edge rows (the
identity, P + P, P + (−P), the 8-torsion, scalars 0, 1, 2^253, 2^254 − 1,
p − 1); a Python-integer model of both kernels' lazy chains on the word
model of tests/lazy_words.py (every dropped carry 0, every value below 2p),
whose products the kernels' four threads a point share out; the work that
chip_smoke.py's bounds count; and, on a card, both kernels against their
twins.

JAX is imported inside the tests that compare with it, so that the
`cuda`-marked test runs on a machine without JAX:
    python -m pytest --noconftest tests/test_torch_jub_kernels.py -m cuda -q
"""

import functools
import random

import numpy as np
import pytest
import torch

import chip_smoke
from lazy_words import LazyField, value, words
from owshen_tpu_torch.curves import babyjubjub as jub
from owshen_tpu_torch.fields.field import FR, ints_to_tensor, tensor_to_ints
from owshen_tpu_torch.kernels import field_ops, jub as jk
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle.field import P_FR

torch.set_num_threads(1)
FRL = LazyField(P_FR)
ONE, K_A, K_D = (jk.jub_consts_words()[8 * i:8 * i + 8] for i in range(3))
JAX_ROWS = 40                                        # edge rows held against the JAX package
# the 8-bit scalars of the JAX scan, one a row: 0, 1, 2^7, 2^8 − 1 and a
# repeat (the broadcast case) on the edge rows, seeded ones after
_rng = random.Random(0x7E)
SCAN_KS = [0xFF, 0, 1, 0x80, 0xFF] + [_rng.randrange(256) for _ in range(JAX_ROWS - 5)]
SCAN_KS[30] = 0x80
# the rows whose 254-bit ladder is held against the oracle: the identity,
# the 8-torsion and the multiples that carry the edge scalars
LADDER_ROWS = [*range(13), *range(24, chip_smoke.JUB_ORACLE)]


def head(pt, n):
    return tuple(c[:n] for c in pt)


def double_plain(p):
    """The ladder twin's double on int32[n, 16] coordinates."""
    c = field_ops.plain_consts("fr", p[0].device)
    return tuple(field_ops.from_lm(x, (-1, 16))
                 for x in jk.double_lm_jub(c, [field_ops.to_lm(x) for x in p]))


def same(tp, jp):
    return all(np.array_equal(t.numpy(), np.asarray(j).astype(np.int32)) for t, j in zip(tp, jp))


# -- the word model of jub.cu: jub_add_lazy and jub_dbl_lazy, operation for
# -- operation (fmul_lazy for products, fsqr_lazy for the double's squares)

def add_model(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s1, s2 = FRL.add(X1, Y1), FRL.add(X2, Y2)
    a, c, d, u = (FRL.mul(x, y) for x, y in ((Z1, Z2), (X1, X2), (Y1, Y2), (s1, s2)))
    xp = FRL.sub(u, FRL.add(c, d))
    b, cd, ac, axp = FRL.mul(a, a), FRL.mul(c, d), FRL.mul(c, K_A), FRL.mul(a, xp)
    e, adac = FRL.mul(cd, K_D), FRL.mul(a, FRL.sub(d, ac))
    f, g = FRL.sub(b, e), FRL.add(b, e)
    return [FRL.mul(axp, f), FRL.mul(adac, g), FRL.mul(f, g)]


def dbl_model(p):
    X, Y, Z = p
    b, c, d, h = (FRL.sqr(v) for v in (FRL.add(X, Y), X, Y, Z))
    e = FRL.mul(c, K_A)
    f = FRL.add(e, d)
    j = FRL.sub(f, FRL.add(h, h))
    t = FRL.sub(FRL.sub(b, c), d)
    return [FRL.mul(t, j), FRL.mul(f, FRL.sub(e, d)), FRL.mul(f, j)]


def ladder_model(base, k, n_bits):
    acc = [words(0), ONE, ONE]
    for i in range(n_bits - 1, -1, -1):
        acc = dbl_model(acc)
        if k >> i & 1:
            acc = add_model(acc, base)
    return [FRL.canon(w) for w in acc]


def row_words(pt, i):
    """Row i of projective int32[n, 16] coordinates as 8-word values."""
    return [words(v) for v in (FR.decode(c[i:i + 1], mont=False)[0] for c in pt)]


@functools.lru_cache(maxsize=None)
def edge_inputs(n=64, seed=0x7B):
    return chip_smoke.jub_edge_inputs(torch, torch.Generator().manual_seed(seed), n, "cpu")


@functools.lru_cache(maxsize=None)
def jax_reference():
    """The JAX package's add and double on the first JAX_ROWS edge rows and
    its scalar_mul of the same points by SCAN_KS over 8 MSB-first bits, in
    one jitted program.  While it is traced, the module's add and double
    are their jitted selves, so that the scan's body reuses the programs
    traced for the add and the double instead of tracing them again (the
    same functions; tracing is most of the time)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from owshen_tpu.curves import babyjubjub as J

    p, q, _, _, _ = edge_inputs()
    p, q = head(p, JAX_ROWS), head(q, JAX_ROWS)
    bits = np.array([[(k >> (7 - i)) & 1 for k in SCAN_KS] for i in range(8)], np.uint32)
    jp, jq = (tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in x) for x in (p, q))
    add, double = jax.jit(J.add), jax.jit(J.double)
    with mock.patch.object(J, "add", add), mock.patch.object(J, "double", double):
        want = jax.jit(lambda a, b, k: (add(a, b), double(a), J.scalar_mul(a, k)))(
            jp, jq, jnp.asarray(bits))
    return p, q, bits, want


@functools.lru_cache(maxsize=None)
def full_ladder():
    """The 254-bit ladder twin, through scalar_mul_int, on LADDER_ROWS."""
    p, _, k, _, _ = edge_inputs()
    return jub.scalar_mul_int(tuple(c[LADDER_ROWS] for c in p), k[LADDER_ROWS])


def test_twins_match_jax_add_and_double():
    """jub_add_plain and the ladder's double on the edge rows (and the add
    broadcast against one point) equal the JAX package's add and double
    limb for limb, and the host oracle."""
    p, q, _, (want, want_dbl, _) = jax_reference()
    got = jk.jub_add_plain(p, q)
    assert same(got, want)
    assert chip_smoke.jub_affine(got) == edge_inputs()[3][:JAX_ROWS]
    dbl = double_plain(p)
    assert same(dbl, want_dbl)
    assert chip_smoke.jub_affine(dbl) == [ocurve.jub_add(a, a) for a in chip_smoke.jub_affine(p)]
    one = tuple(c[7] for c in q)
    wide = jk.jub_add_plain(p, tuple(c.expand(JAX_ROWS, 16) for c in one))
    assert all(torch.equal(x, y) for x, y in zip(jk.jub_add_plain(p, one), wide))
    assert same(jub.add(p, q), got)                  # the curve's add is the wrapper


def test_ladder_twin_matches_jax_scalar_mul():
    """jub_scalar_mul_plain and the port's scalar_mul (its bits packed into
    limbs) equal the JAX package's lax.scan ladder over 8 MSB-first bits,
    limb for limb, on the identity, the 8-torsion and multiples, and with a
    scalar broadcast over lanes."""
    p, _, bits, (_, _, want) = jax_reference()
    ks = ints_to_tensor(SCAN_KS)
    assert same(jk.jub_scalar_mul_plain(p, ks, 8), want)
    assert same(jub.scalar_mul(p, torch.from_numpy(bits.astype(np.int32))), want)
    rows = [i for i, k in enumerate(SCAN_KS) if k == SCAN_KS[3]]
    one = jk.jub_scalar_mul_plain(tuple(c[rows] for c in p), ks[3], 8)
    assert same(one, tuple(np.asarray(w)[rows] for w in want))
    with pytest.raises(ValueError):
        jub.scalar_mul(p, torch.zeros((257, JAX_ROWS), dtype=torch.int32))
    for n_bits in (-1, 257):
        with pytest.raises(ValueError):
            jk.jub_scalar_mul(p, ks, n_bits)


def test_full_ladder_matches_oracle():
    """The 254-bit ladder twin, through scalar_mul_int, on the edge rows of
    chip_smoke.jub_edge_inputs: (k mod 2^254)·P by the host oracle, the
    scalars 0, 1, 2^253, 2^254 − 1 (on T and on a multiple) and p − 1 and
    the 8-torsion included."""
    p, _, k, _, want = edge_inputs()
    assert chip_smoke.jub_affine(full_ladder()) == [want[i] for i in LADDER_ROWS]
    torsion = chip_smoke.jub_affine(tuple(c[5:13] for c in p))   # k·T, k = 0 … 7
    assert torsion == chip_smoke.jub_small_order() and ocurve.jub_mul(torsion[1], 4) != (0, 1)
    assert {chip_smoke.ladder_work(torch, k[i:i + 1], 256)[0] for i in (6, 29)} == {253}


def test_word_model_of_both_kernels():
    """jub_add_lazy and jub_dbl_lazy on the word model: on lazy inputs up to
    2p − 1 every carry and bound holds and the values agree with the
    oracle's mod p; over the edge rows and in 254-bit ladders the model's
    canonical coordinates equal the twins' limb for limb."""
    rng = random.Random(0x1AB)
    lazy = [0, 1, P_FR - 1, P_FR, 2 * P_FR - 1, 2 * P_FR - 2] + \
        [rng.randrange(2 * P_FR) for _ in range(6)]
    for i in range(len(lazy)):
        p = [words(lazy[(i + j) % len(lazy)]) for j in range(3)]
        q = [words(lazy[(3 * i + j + 1) % len(lazy)]) for j in range(3)]
        s, dbl = add_model(p, q), dbl_model(p)
        assert all(value(w) < 2 * P_FR for w in s + dbl)
        pc, qc = ([FRL.unmont(w) for w in pt] for pt in (p, q))
        lp = [FR.encode([v]) for v in pc]
        lq = [FR.encode([v]) for v in qc]
        assert [FRL.unmont(w) for w in s] == FR.decode(torch.cat(jk.jub_add_plain(lp, lq)))
        assert [FRL.unmont(w) for w in dbl] == FR.decode(torch.cat(double_plain(lp)))
    p, q, k, _, _ = edge_inputs()
    twin_add, twin_dbl = jk.jub_add_plain(p, q), double_plain(p)
    for i in range(chip_smoke.JUB_HEAD):
        pw, qw = row_words(p, i), row_words(q, i)
        assert [FRL.canon(w) for w in add_model(pw, qw)] == row_words(twin_add, i)
        assert [FRL.canon(w) for w in dbl_model(pw)] == row_words(twin_dbl, i)
    row = 29                                         # 2^254 − 1 on a multiple
    assert tensor_to_ints(k[row:row + 1]) == [(1 << 254) - 1]
    assert ladder_model(row_words(p, row), (1 << 254) - 1, chip_smoke.JUB_BITS) == \
        row_words(full_ladder(), LADDER_ROWS.index(row))


def test_twins_count_the_bound_work(monkeypatch):
    """The twins do per point the Fr products, squares, adds and products
    by A or D that chip_smoke.py's bounds count (JUB_ADD_WORK,
    JUB_DOUBLE_WORK; a product column whose two operands are equal is a
    square, one whose second operand is Montgomery A or D a product by a
    constant), and ladder_work counts the least doubles and adds of a
    double-and-add."""
    gen = torch.Generator().manual_seed(0x7D)        # random rows: no equal operands
    p, q = (tuple(chip_smoke.rand_field(torch, gen, P_FR, 20, "cpu")[4:] for _ in range(3))
            for _ in range(2))
    counts = {"mul": 0, "sqr": 0, "add": 0, "small": 0}

    def mul(a, b, c):
        bb = b.expand(a.shape[0], max(a.shape[1], b.shape[1]))
        sq = int((a.expand_as(bb) == bb).all(0).sum())
        small = int(sum((bb == k).all(0) for k in jk._const_rows(a.device)[1:]).sum())
        counts["sqr"] += sq
        counts["small"] += small
        counts["mul"] += bb.shape[1] - sq - small
        return field_ops.mul_lm(a, b, c)

    def add(fn):
        def run(a, b, c):
            counts["add"] += max(a.shape[1], b.shape[1])
            return fn(a, b, c)
        return run

    monkeypatch.setattr(jk, "mul_lm", mul)
    monkeypatch.setattr(jk, "add_lm", add(field_ops.add_lm))
    monkeypatch.setattr(jk, "sub_lm", add(field_ops.sub_lm))
    n = p[0].shape[0]
    for fn, args, work in ((jk.jub_add_plain, (p, q), chip_smoke.JUB_ADD_WORK),
                           (double_plain, (p,), chip_smoke.JUB_DOUBLE_WORK)):
        counts.update(mul=0, sqr=0, add=0, small=0)
        fn(*args)
        assert tuple(counts.values()) == tuple(n * w for w in work)
    ks = ints_to_tensor([0, 1, 2, 0b1011, (1 << 254) - 1, 1 << 255])
    # 0 and 1 need nothing; 2: a double; 0b1011: 3 doubles, 2 adds; 2^254 − 1:
    # 253 and 253; bit 255 lies above the ladder's 254 bits
    assert chip_smoke.ladder_work(torch, ks, 254) == (1 + 3 + 253, 2 + 253)


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Both kernels against their twins on the card, edge rows first, at
    1, 63, 65 and 300 points; the wrappers count their launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    p, q, k, want_add, want_mul = chip_smoke.jub_edge_inputs(
        torch, torch.Generator().manual_seed(0x7C), 300, dev)
    twin_add = jk.jub_add_plain(p, q)
    twin_mul = jk.jub_scalar_mul_plain(p, k, chip_smoke.JUB_BITS)
    assert chip_smoke.jub_affine(head(twin_add, 64)) == want_add
    assert chip_smoke.jub_affine(head(twin_mul, len(want_mul))) == want_mul
    before = (jk.jub_add.launches, jk.jub_scalar_mul.launches)
    for m in (1, 63, 65, 300):
        for x, y in zip(jk.jub_add(head(p, m), head(q, m)), head(twin_add, m)):
            assert torch.equal(x, y)
        got = jk.jub_scalar_mul(head(p, m), k[:m], chip_smoke.JUB_BITS)
        for x, y in zip(got, head(twin_mul, m)):
            assert torch.equal(x, y)
    assert (jk.jub_add.launches, jk.jub_scalar_mul.launches) == (before[0] + 4, before[1] + 4)
