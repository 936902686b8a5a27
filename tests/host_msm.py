"""Host arithmetic on plain Python ints for the port's CPU tests (not a test
file): Pippenger MSMs over the JAX package's curve oracle, fixed-base
multiples of the generators, the port's fixed-table rows, and the Groth16
h polynomial on the JAX package's NTT oracle, so that a test can stand in
for the JAX prover's device MSMs and h pipeline and for the port's table
build (minutes of XLA:CPU or of the int64 twins) with the same values.

Affine sums go through `batch_add`, one field inversion per batch
(Montgomery's trick); over G1 it runs on bare ints, its hottest path."""

import functools

import numpy as np
import torch

from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.fields.field import FQ as JFQ
from owshen_tpu.fields.fq2 import FQ2 as JFQ2
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.oracle import ntt as ontt
from owshen_tpu.oracle.field import P_FR
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.ops.msm_fixed import FixedMsm, FixedMsmGroup

Q = ocurve.FQ1.p
R_MONT = (1 << 256) % Q
ZERO32 = bytes(32)
R32 = R_MONT.to_bytes(32, "little")


def oracle_affine(pt, group):
    """JAX projective limb arrays -> [(x, y) or None], decoded by the JAX
    package's field codecs."""
    F, K = (JFQ, ocurve.FQ1) if group == "g1" else (JFQ2, ocurve.FQ2I)
    out = []
    for x, y, z in zip(*(F.decode(np.asarray(a)) for a in pt)):
        zi = None if z == K.zero else K.inv(z)
        out.append(None if zi is None else (K.mul(x, zi), K.mul(y, zi)))
    return out


def host_combine():
    """A stand-in for the JAX prover's `_combine_jit()`: its nine assembly
    adds (A = a_w + tail_a, B₂ = b2_w + tail_b2, C = a_sw + b1_rw + k_w +
    h_h + tail_c) on the host oracle, returned as the JAX package's limb
    arrays.  Exact, like the host MSMs beside it; it spares a test the
    ~20 s of tracing and compiling nine curve adds on XLA:CPU."""
    def one(pt, group):
        return oracle_affine(tuple(np.asarray(a)[None] for a in pt), group)[0]

    def combine(a_w, tail_a, b2_w, tail_b2, a_sw, b1_rw, k_w, h_h, tail_c):
        c = None
        for pt in (a_sw, b1_rw, k_w, h_h, tail_c):
            c = ocurve.G1.add(c, one(pt, "g1"))
        a = ocurve.G1.add(one(a_w, "g1"), one(tail_a, "g1"))
        b2 = ocurve.G2.add(one(b2_w, "g2"), one(tail_b2, "g2"))
        return (tuple(x[0] for x in jbn.g1_encode([a])), tuple(x[0] for x in jbn.g2_encode([b2])),
                tuple(x[0] for x in jbn.g1_encode([c])))

    return combine


def _g1_batch_add(ps, qs):
    """G1 on bare ints: the slopes' denominators and their prefix products
    in one pass, one inversion, the sums in a second pass."""
    out = list(qs)
    todo, prefix, acc = [], [], 1
    for i, p in enumerate(ps):
        if p is None:
            continue
        q = qs[i]
        if q is None:
            out[i] = p
            continue
        x1, y1 = p
        x2, y2 = q
        if x1 != x2:
            num, den = y2 - y1, x2 - x1
        elif y1 == y2:
            num, den = 3 * x1 * x1, 2 * y1
        else:
            out[i] = None                          # P + (−P)
            continue
        prefix.append(acc)
        acc = acc * den % Q
        todo.append((i, x1, y1, x2, num, den))
    inv = pow(acc, -1, Q) if todo else 0
    for k in range(len(todo) - 1, -1, -1):
        i, x1, y1, x2, num, den = todo[k]
        lam = num * (inv * prefix[k] % Q) % Q
        inv = inv * den % Q
        x3 = (lam * lam - x1 - x2) % Q
        out[i] = (x3, (lam * (x1 - x3) - y1) % Q)
    return out


def _g2_batch_add(ps, qs):
    """G2 on bare int pairs (Fq2 = Fq[u]/(u² + 1)), as _g1_batch_add."""
    out = list(qs)
    todo, prefix, a0, a1 = [], [], 1, 0
    for i, p in enumerate(ps):
        if p is None:
            continue
        q = qs[i]
        if q is None:
            out[i] = p
            continue
        (x0, x1), (y0, y1) = p
        (u0, u1), (w0, w1) = q
        if (x0, x1) != (u0, u1):
            n0, n1, d0, d1 = w0 - y0, w1 - y1, u0 - x0, u1 - x1
        elif (y0, y1) == (w0, w1):
            n0, n1, d0, d1 = 3 * (x0 * x0 - x1 * x1), 6 * x0 * x1, 2 * y0, 2 * y1
        else:
            out[i] = None                          # P + (−P)
            continue
        prefix.append((a0, a1))
        a0, a1 = (a0 * d0 - a1 * d1) % Q, (a0 * d1 + a1 * d0) % Q
        todo.append((i, x0, x1, y0, y1, u0, u1, n0, n1, d0, d1))
    if not todo:
        return out
    norm_inv = pow((a0 * a0 + a1 * a1) % Q, -1, Q)
    i0, i1 = a0 * norm_inv % Q, -a1 * norm_inv % Q
    for k in range(len(todo) - 1, -1, -1):
        i, x0, x1, y0, y1, u0, u1, n0, n1, d0, d1 = todo[k]
        p0, p1 = prefix[k]
        v0, v1 = (i0 * p0 - i1 * p1) % Q, (i0 * p1 + i1 * p0) % Q      # 1 / den
        i0, i1 = (i0 * d0 - i1 * d1) % Q, (i0 * d1 + i1 * d0) % Q
        l0, l1 = (n0 * v0 - n1 * v1) % Q, (n0 * v1 + n1 * v0) % Q
        s0, s1 = (l0 * l0 - l1 * l1 - x0 - u0) % Q, (2 * l0 * l1 - x1 - u1) % Q
        t0, t1 = x0 - s0, x1 - s1
        out[i] = ((s0, s1), ((l0 * t0 - l1 * t1 - y0) % Q, (l0 * t1 + l1 * t0 - y1) % Q))
    return out


def batch_add(K, ps, qs):
    """Affine ps[i] + qs[i] (None = identity) over the oracle field K
    (FQ1 for G1, FQ2I for G2)."""
    return _g1_batch_add(ps, qs) if K is ocurve.FQ1 else _g2_batch_add(ps, qs)


def pippenger(curve, points, scalars, c=8):
    """Σ scalars[i]·points[i] on the oracle curve, bucket method."""
    pairs = [(p, s) for p, s in zip(points, scalars) if p is not None and s]
    acc = None
    for w in reversed(range(-(-254 // c))):
        for _ in range(c):
            acc = curve.add(acc, acc)
        buckets = [None] * (1 << c)
        for p, s in pairs:
            d = (s >> (w * c)) & ((1 << c) - 1)
            if d:
                buckets[d] = curve.add(buckets[d], p)
        run = tot = None
        for b in reversed(buckets[1:]):
            run = curve.add(run, b)
            tot = curve.add(tot, run)
        acc = curve.add(acc, tot)
    return acc


@functools.lru_cache(maxsize=None)
def _gen_tables(group, c):
    """d·2^(c·w)·gen for every window w and digit d (None at d = 0)."""
    curve, base = (ocurve.G1, ocurve.G1_GEN) if group == "g1" else (ocurve.G2, ocurve.G2_GEN)
    tables = []
    for _ in range(-(-254 // c)):
        table = [None, base]
        for _ in range(2, 1 << c):
            table.append(curve.add(table[-1], base))
        tables.append(table)
        base = curve.add(table[-1], base)
    return tables


def fixed_base(group, exps, c=8):
    """[e·gen for e in exps] as affine ints (None for e ≡ 0): per c-bit
    window one batched add of the window's table entry."""
    K = ocurve.FQ1 if group == "g1" else ocurve.FQ2I
    exps = [e % P_FR for e in exps]
    acc = [None] * len(exps)
    for w, table in enumerate(_gen_tables(group, c)):
        acc = batch_add(K, acc, [table[(e >> (w * c)) & ((1 << c) - 1)] for e in exps])
    return acc


def encode_rows(group, pts):
    """Affine points -> int32[len, F]: the port's projective Montgomery
    limbs (x | y | z; each Fq2 coordinate c0 | c1), the rows `_flat_rows`
    gives for bn254.g1_encode / g2_encode of the same points."""
    parts = []
    if group == "g1":
        ident = ZERO32 + R32 + ZERO32
        for pt in pts:
            if pt is None:
                parts.append(ident)
            else:
                parts += ((pt[0] * R_MONT % Q).to_bytes(32, "little"),
                          (pt[1] * R_MONT % Q).to_bytes(32, "little"), R32)
        width = 48
    else:
        ident = ZERO32 * 2 + R32 + ZERO32 * 3
        for pt in pts:
            if pt is None:
                parts.append(ident)
            else:
                (x0, x1), (y0, y1) = pt
                parts += tuple((v * R_MONT % Q).to_bytes(32, "little") for v in (x0, x1, y0, y1))
                parts += (R32, ZERO32)
        width = 96
    return np.frombuffer(b"".join(parts), dtype="<u2").reshape(len(pts), width).astype(np.int32)


def host_table(group, base, c=4):
    """The rows build_table(curve, encode(base), c) holds — rows[w, d] =
    d·2^(c·w)·base — computed with affine host arithmetic; with the
    (widths, shapes) that split a row into (x, y, z)."""
    K = ocurve.FQ1 if group == "g1" else ocurve.FQ2I
    W, D = 256 // c, (1 << (c - 1)) + 1
    n = len(base)
    first = encode_rows(group, [None])
    rows = np.empty((W, D, n, first.shape[1]), dtype=np.int32)
    for w in range(W):
        rows[w, 0] = first
        mults = [base]
        for _ in range(2, D):
            mults.append(batch_add(K, mults[-1], base))
        rows[w, 1:] = encode_rows(group, [p for m in mults for p in m]).reshape(D - 1, n, -1)
        base = batch_add(K, mults[-1], mults[-1])
    k = first.shape[1] // 3
    shape = (16,) if group == "g1" else (2, 16)
    return torch.from_numpy(rows), [k] * 3, [shape] * 3


def host_h(builder, dom):
    """The h scalars the JAX prover's `_h_pipeline(dom)` gives for the
    builder's witness (canonical ints, all n of them; the prover keeps the
    first n − 1): the constraint rows A·w, B·w, C·w (0 past the last
    constraint), each interpolated and evaluated on the coset g·H of the
    JAX domain `dom`, h = (A·B − C)/Z_H(g) there, interpolated back, on the
    JAX package's NTT oracle."""
    p, n = P_FR, dom.n
    wit = builder.witness()
    g, zinv = dom.coset_gen, dom.z_on_coset_inv()
    gi = pow(g, -1, p)
    pows = [pow(g, i, p) for i in range(n)]
    evals = []
    for which in range(3):
        rows = [sum(v * wit[i] for i, v in c[which].items()) % p for c in builder.constraints]
        coeffs = ontt.intt(rows + [0] * (n - len(rows)))
        evals.append(ontt.ntt([c * t % p for c, t in zip(coeffs, pows)]))
    h_s = [(a * b - c) * zinv % p for a, b, c in zip(*evals)]
    return [c * pow(gi, i, p) % p for i, c in enumerate(ontt.intt(h_s))]


def tiny_circuit():
    """x·y = 12 with x = 3, y = 4: a one-constraint circuit whose key the
    port's setup makes in about a second on the twins."""
    b = Builder()
    out = b.pub(12)
    b.enforce_eq(b.mul(b.priv(3), b.priv(4)), out)
    return b


def restore_host_tables(pk):
    """Give a port key the fixed tables `host_table` computes, so that its
    first fixed-engine prove skips the table build (~40 s on the twins)."""
    n = groth16._table_n(pk)

    def host(pts, decode):
        got = decode(pts)
        return list(got) + [None] * (n - len(got))

    g1_pts = [p for name in ("a_g1", "b_g1", "k_g1", "h_g1")
              for p in host(getattr(pk, name), bn254.g1_decode)]
    rows, widths, shapes = host_table("g1", g1_pts)
    g1 = FixedMsmGroup.from_rows(bn254.G1, rows, (n, 4, widths, shapes))
    rows, widths, shapes = host_table("g2", host(pk.b_g2, bn254.g2_decode))
    b2 = FixedMsm(bn254.G2, None, _rows=rows, _meta=(n, 1, widths, shapes))
    groth16.restore_fixed_tables(pk, g1, b2)
