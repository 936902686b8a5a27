"""Port vs reference: BabyJubJub and batched EdDSA (curves/babyjubjub.py,
curves/fixed_base.py jub_fixed_base, the field's sqrt).

Every comparison is exact: projective coordinates limb for limb against the
JAX package (its add and double run eagerly, its decompress under one
jit), affine points and signatures as integers against the host oracle
(owshen_tpu/oracle), which the JAX package's own tests hold its ladder,
verify and batch signer to.  The port runs on the CPU twins of K1 and K4;
the JAX ladder, verify and signer are not traced here (each is a jit of
10 s and more on one core)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from owshen_tpu.curves import babyjubjub as J
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.oracle import eddsa as oeddsa
from owshen_tpu_torch.curves import babyjubjub as jub
from owshen_tpu_torch.curves.fixed_base import jub_fixed_base
from owshen_tpu_torch.fields.field import FR, ints_to_tensor

torch.set_num_threads(1)

P = FR.p
BASE = ocurve.JUB_BASE
IDENTITY = (0, 1)


def same(tp, jp):
    return all(np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))
               for t, j in zip(tp, jp))


def host_affine(pt):
    """Projective tensors -> [(x, y)] ints, the division done on the host."""
    X, Y, Z = (FR.decode(a) for a in pt)
    return [(x * pow(z, -1, P) % P, y * pow(z, -1, P) % P) for x, y, z in zip(X, Y, Z)]


def neg(pt):
    return ((-pt[0]) % P, pt[1])


def seeded_points(seed, n):
    rng = random.Random(seed)
    return [ocurve.jub_mul(BASE, rng.randrange(1, ocurve.JUB_ORDER)) for _ in range(n)]


def test_add_and_double_match_jax_and_oracle():
    pts = seeded_points(1, 6)
    ps = [IDENTITY, pts[0], pts[1], pts[2], pts[3], pts[4]]
    qs = [IDENTITY, IDENTITY, pts[1], neg(pts[2]), pts[5], pts[0]]   # O+O, P+O, P+P, P+(−P)
    jp, jq = J.jub_encode(ps), J.jub_encode(qs)
    tp, tq = jub.jub_encode(ps), jub.jub_encode(qs)
    assert same(tp, jp) and same(jub.encode_points(ps), J.encode_points(ps))
    jp, jq = tuple(map(jnp.asarray, jp)), tuple(map(jnp.asarray, jq))
    got_add, got_dbl = jub.add(tp, tq), jub.double(tp)
    assert same(got_add, J.add(jp, jq))
    assert same(got_dbl, J.double(jp))
    assert host_affine(got_add) == [ocurve.jub_add(p, q) for p, q in zip(ps, qs)]
    assert host_affine(got_dbl) == [ocurve.jub_add(p, p) for p in ps]
    assert host_affine(got_add)[3] == IDENTITY
    assert jub.eq(got_add, jub.identity_like(tq[0])).tolist() == [
        True, False, False, True, False, False]


def test_decompress_and_sqrt_match_jax():
    pts = seeded_points(2, 5)
    # x = 1 has no point: (1 − a)/(1 − d) is not a square in Fr
    y2 = (1 - ocurve.JUB_A) * pow(1 - ocurve.JUB_D, -1, P) % P
    assert pow(y2, (P - 1) // 2, P) == P - 1
    xs = [p[0] for p in pts] + [0, 1]
    odd = [p[1] & 1 == 1 for p in pts] + [True, False]
    x_aff = FR.encode([p[0] for p in pts])
    y_aff = FR.encode([p[1] for p in pts])
    xc, oc = jub.compress(x_aff, y_aff)
    assert FR.decode(xc, mont=False) == xs[:5] and oc.tolist() == odd[:5]
    x_plain = FR.encode(xs, mont=False)
    x, y, ok = jub.decompress(x_plain, torch.tensor(odd))
    jx, jy, jok = jax.jit(J.decompress)(jnp.asarray(x_plain.numpy().astype(np.uint32)),
                                        jnp.asarray(np.array(odd)))
    assert same((x, y), (jx, jy)) and ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist() == [True] * 6 + [False]          # FR.sqrt's flag: y2 of x = 1 has no root
    assert list(zip(FR.decode(x), FR.decode(y)))[:5] == pts
    assert FR.decode(y)[5] == 1                          # x = 0: y = ±1, the odd one


def test_scalar_mul_msb_first_matches_oracle():
    rng = random.Random(3)
    pts = seeded_points(3, 4)
    ks = [0, 1, 0xFFFF, rng.randrange(1 << 16)]
    bits = torch.tensor([[(k >> (15 - i)) & 1 for k in ks] for i in range(16)])  # MSB first
    got = jub.scalar_mul(jub.jub_encode(pts), bits)
    assert host_affine(got) == [ocurve.jub_mul(p, k) for p, k in zip(pts, ks)]


def test_fixed_base_keeps_all_256_bits():
    rng = random.Random(4)
    ks = [0, 1, rng.randrange(1 << 256), P, P + 5, ocurve.JUB_ORDER, (1 << 256) - 1]
    fb = jub_fixed_base()
    assert (fb.c, fb.n_windows) == (8, 32)
    got = fb.mul(ints_to_tensor(ks))
    assert host_affine(got) == [ocurve.jub_mul(BASE, k) for k in ks]


def test_eddsa_verify_lanes_match_oracle():
    rng = random.Random(5)
    a = rng.randrange(P)
    pub = oeddsa.to_pub(a)
    msgs = [rng.randrange(P) for _ in range(5)]
    sigs = [oeddsa.sign(a, rng.randrange(P), m) for m in msgs]
    Rs = [R for R, _ in sigs]
    ss = [s for _, s in sigs]
    ss[1] += ocurve.JUB_ORDER            # an equivalent s above p (B has order ORDER / 8)
    assert ss[1] >= P
    msgs[2] += 1                         # tampered message
    ss[3] += 1                           # tampered s
    Rs[4] = (Rs[4][0], Rs[4][1] + 1)     # R off the curve
    want = [oeddsa.verify(pub, m, R, s) for m, R, s in zip(msgs, Rs, ss)]
    assert want == [True, True, False, False, False]
    n = len(msgs)
    got = jub.eddsa_verify((FR.encode([pub[0]] * n), FR.encode([pub[1]] * n)),
                           FR.encode(msgs),
                           (FR.encode([R[0] for R in Rs]), FR.encode([R[1] for R in Rs])),
                           ints_to_tensor(ss))
    assert got.tolist() == want


def test_eddsa_sign_batch_matches_oracle():
    rng = random.Random(6)
    priv = [rng.randrange(P) for _ in range(3)]
    rand = [rng.randrange(P) for _ in range(3)]
    msgs = [rng.randrange(P) for _ in range(3)]
    got = jub.eddsa_sign_batch(priv, rand, msgs, device="cpu")
    assert got == [oeddsa.sign(a, r, m) for a, r, m in zip(priv, rand, msgs)]
