"""The port's Pippenger engines and their building blocks on the CPU (the
plain twins of K1–K3), held against the host curve oracle, as the JAX
package's tests/test_msm.py holds its own engines: no JAX MSM runs here (each
cold XLA:CPU compile of one costs minutes).  G2 and the full-size cases
(2^22 G1, 2^16 lane, G2 msm_sorted and lane) run on the card, in
chip_smoke.py and tests/test_torch_cuda.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.ops import msm as jmsm
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FQ, FR
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.ops import msm as pmsm

torch.set_num_threads(1)

P = FR.p
G1 = bn254.G1


def multiples(ks):
    return [ocurve.G1.mul(ocurve.G1_GEN, k) for k in ks]


def one_point(pt):
    return bn254.g1_decode_host(tuple(a[None] for a in pt))


def test_msm_sorted_matches_oracle(monkeypatch):
    """c = 8 (the 2^22 engine's structure with a 128-bucket boundary batch)
    on the inputs of tests/test_msm.py: zero, p − 1, 1 and 2^253 scalars;
    `msm_sorted_many` of that job and a shorter one, its 64 (window, job)
    pairs in passes of 24, 24 and 16.  A window's gather gives the same
    points from rows padded to the reference's 128 words
    (OWSHEN_MSM_GATHER_PAD) as from the rows' own."""
    rng = random.Random(11)
    n = 70
    pts = multiples([rng.randrange(1000) + 1 for _ in range(n)])
    scalars = [rng.randrange(P) for _ in range(n)]
    scalars[:4] = [0, P - 1, 1, 1 << 253]
    dev_p, dev_s = bn254.g1_encode(pts), FR.encode(scalars, mont=False)
    got = pmsm.msm_sorted(G1, dev_p, dev_s, c=8)
    assert one_point(got) == ocurve.G1.msm(pts, scalars)
    short = [rng.randrange(P) for _ in range(9)]
    monkeypatch.setattr(pmsm, "GATHER_BUDGET", 24 * 128 * 48 * 4)   # 24 windows of rows
    both = pmsm.msm_sorted_many(G1, [(dev_p, dev_s), (tuple(a[:9] for a in dev_p),
                                                       FR.encode(short, mont=False))], c=8)
    assert [one_point(pt) for pt in both] == [ocurve.G1.msm(pts, scalars),
                                             ocurve.G1.msm(pts[:9], short)]
    dev_p, dev_s = pmsm._pad_identity(G1, dev_p, dev_s, 128)
    mag, sgn = pmsm._signed_digits(dev_s, 8)
    gathered = []
    for pad in (None, 128):
        rows, widths, shapes = pmsm._point_rows(dev_p, pad)
        assert rows.shape[1] == (48 if pad is None else 128)
        gathered.append(pmsm._gather_window(rows, widths, shapes, mag[3], sgn[3], 32, 4))
    (xyz, neg, keys), (xyz128, neg128, keys128) = gathered
    assert all(torch.equal(a, b) for a, b in zip(xyz + (neg, keys), xyz128 + (neg128, keys128)))
    assert bn254.g1_decode_many(xyz) == [pts[i] if i < n else None
                                         for i in torch.sort(mag[3], stable=True)[1]
                                         .view(32, 4).T.reshape(-1).tolist()]


def test_lane_msm_matches_oracle():
    """The lane engine at c = 4 (64 windows, 16 buckets) on 13 points in 8
    lanes (the last row padded with identities), zero and p − 1 among the
    scalars; pad_to_pow2 fills to 16 with identities and zeros."""
    rng = random.Random(12)
    n = 13
    pts = multiples([rng.randrange(500) + 1 for _ in range(n)])
    scalars = [rng.randrange(P) for _ in range(n)]
    scalars[:2] = [0, P - 1]
    want = ocurve.G1.msm(pts, scalars)
    dev_p, dev_s = bn254.g1_encode(pts), FR.encode(scalars, mont=False)
    assert one_point(pmsm.msm(G1, dev_p, dev_s, c=4, lanes=8)) == want
    pad_p, pad_s = pmsm.pad_to_pow2(dev_p, dev_s, G1)
    assert FR.decode(pad_s, mont=False) == scalars + [0] * 3
    assert bn254.g1_decode_many(pad_p) == pts + [None] * 3


def test_scans_match_host_prefix_sums():
    rng = random.Random(13)
    ks = [rng.randrange(100) + 1 for _ in range(16)]
    pts = bn254.g1_encode(multiples(ks))
    # segmented, 4 lanes of 4 and a recursion over their totals
    flags = torch.zeros(16, dtype=torch.bool)
    flags[[0, 3, 9]] = True
    outs, outf = pmsm.segmented_scan(G1, pts, flags, chunk=4)
    want, run = [], 0
    for i, k in enumerate(ks):
        run = k if flags[i] else run + k
        want.append(run)
    assert bn254.g1_decode_many(outs) == multiples(want)
    assert bool(outf.all())
    # plain: 2 lanes of 4
    head = tuple(a[:8] for a in pts)
    assert bn254.g1_decode_many(pmsm.plain_scan(G1, head, chunk=4)) == \
        multiples(np.cumsum(ks[:8]).tolist())
    # exclusive Hillis–Steele prefix (identity first)
    assert bn254.g1_decode_many(pmsm._hs_exclusive_prefix(G1, head)) == \
        [None] + multiples(np.cumsum(ks[:7]).tolist())
    # total: folded 16 -> 4, then an inclusive prefix; and wide >= n
    for wide in (4, 32):
        assert one_point(pmsm.total_sum_wide(G1, pts, wide=wide)) == multiples([sum(ks)])[0]


def test_scalar_mul_sum_reduce_to_affine():
    rng = random.Random(14)
    ks = [rng.randrange(1, 1 << 20) for _ in range(5)]
    pts = multiples(ks)
    pts[2] = None
    dev = bn254.g1_encode(pts)
    # a short MSB-first ladder, one scalar per point
    mults = [0b101101, 0, 0b111111, 1, 0b100000]
    bits = torch.tensor([[(m >> (5 - i)) & 1 for m in mults] for i in range(6)])
    got = bn254.g1_decode_many(G1.scalar_mul(dev, bits))
    assert got == [ocurve.G1.mul(p, m) if p else None for p, m in zip(pts, mults)]
    # the legacy prover's 254-step ladder, a scalar per lane
    full = [P - 1, (1 << 253) + 5, 0, 12345, P + 2]
    got = bn254.g1_decode_many(groth16._scale_points(G1, dev, full))
    assert got == [ocurve.G1.mul(p, m % P) if p else None for p, m in zip(pts, full)]
    # sum_reduce over an odd count (the last row waits a level)
    want = None
    for p in pts:
        want = ocurve.G1.add(want, p)
    assert one_point(G1.sum_reduce(dev)) == want
    # to_affine: one Fermat inversion on K1, the identity to (0, 0)
    xs, ys = G1.to_affine(G1.double(dev))
    doubled = [ocurve.G1.add(p, p) for p in pts]
    assert list(zip(FQ.decode(xs), FQ.decode(ys))) == [p or (0, 0) for p in doubled]
    # the field helpers it rests on, against the reference
    vals = [0, 1, P - 1, rng.randrange(P)]
    assert FR.decode(FR.inv(FR.encode(vals))) == [pow(v, -1, P) if v else 0 for v in vals]
    assert FR.decode(FR.pow_const(FR.encode(vals), 5)) == [pow(v, 5, P) for v in vals]
    assert np.array_equal(FR.to_bits_le(FR.encode(vals, mont=False), 254).numpy(),
                          np.asarray(JFR.to_bits_le(jnp.asarray(JFR.encode(vals, mont=False)),
                                                    254)))


def test_msm_routes_large_batches_to_sorted(monkeypatch):
    """From 2^17 points `msm` takes the sorted engine, as the reference
    does, after checking the top limb: a scalar ≥ 2^255 would lose its top
    carry there.  Both packages' sorted engines are stubbed: no MSM runs."""
    calls = []

    def stub(curve, points, scalars, c=None, gather_pad=None):
        calls.append((curve, scalars.shape[0], c))
        return "sorted"

    monkeypatch.setattr(pmsm, "msm_sorted", stub)
    monkeypatch.setattr(jmsm, "msm_sorted", stub)
    n = 1 << 17
    pts = tuple(torch.zeros((n, 16), dtype=torch.int32) for _ in range(3))
    scalars = torch.zeros((n, 16), dtype=torch.int32)
    scalars[7, 15] = (1 << 15) - 1                  # the largest top limb let through
    jpts = tuple(jnp.asarray(a.numpy()) for a in pts)
    assert pmsm.msm(G1, pts, scalars) == "sorted"
    assert jmsm.msm(jbn.G1, jpts, jnp.asarray(scalars.numpy().astype(np.uint32))) == "sorted"
    assert [(n, c) for _, n, c in calls] == [(1 << 17, None)] * 2
    scalars[7, 15] = 1 << 15
    with pytest.raises(ValueError, match="top limb 0x8000 overflows"):
        pmsm.msm(G1, pts, scalars)
    with pytest.raises(AssertionError, match="top limb 0x8000 overflows"):
        jmsm.msm(jbn.G1, jpts, jnp.asarray(scalars.numpy().astype(np.uint32)))
    with pytest.raises(ValueError, match="window width 3"):
        pmsm.msm(G1, pts, scalars, c=3)
    assert len(calls) == 2
