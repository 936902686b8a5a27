"""Python-integer models of the redesigned K3 (G1 double, four lanes per
point) and K7 (fused column NTT, 8 elements a thread in passes) as the CUDA
kernels run them, on the word model of tests/lazy_words.py: every dropped
carry is asserted to be 0 and every value to stay below 2p, and each model
must equal the plain twin and both packages' oracles.  A pure index test
holds K7's thread-to-element map and its shared-memory layout to the
radix-2 DIT schedule and to the bank claims of csrc/ntt.cu, and the work
chip_smoke.py's bounds charge is held to what the twin (K3) and the
transform's schedule (K7) need.  No key, no prove and no Pallas: the file
takes seconds."""

import random
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
from lazy_words import LazyField, value
from owshen_tpu.oracle import curve as jax_ocurve
from owshen_tpu.oracle import ntt as jax_ontt
from owshen_tpu_torch.fields.field import FQ as TFQ
from owshen_tpu_torch.fields.field import FR as TFR
from owshen_tpu_torch.kernels import g1, ntt
from owshen_tpu_torch.ops.ntt import col_twiddles
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle import ntt as ontt
from owshen_tpu_torch.oracle.field import P_FQ, P_FR

FQ = LazyField(P_FQ)
FR = LazyField(P_FR)


class Checked:
    """A LazyField whose every result is asserted to stay below 2p."""

    def __init__(self, field):
        self.f = field

    def __getattr__(self, op):
        fn = getattr(self.f, op)

        def run(*args):
            r = fn(*args)
            assert value(r) < 2 * self.f.p, op
            return r
        return run


def mont_words(t):
    """int32[n, 16] Montgomery limbs -> 8 words per row"""
    return [[int(r[2 * i]) | int(r[2 * i + 1]) << 16 for i in range(8)] for r in t]


# ---------------------------------------------------------------------------
# K3: csrc/g1.cu g1_dbl_kernel, lane by lane
# ---------------------------------------------------------------------------

def dbl_adds(F, t0, zz):
    """g1.cu dbl_adds: z3 = 8·Y², t2 = 9·Z², y3 = Y² + t2, t0 = Y² − 3·t2"""
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)
    t2 = F.mul9(zz)
    y3 = F.add(t0, t2)
    t3 = F.add(F.add(t2, t2), t2)
    return F.sub(t0, t3), z3, t2, y3


def shfl(values, src):
    """__shfl_sync within one point's lanes: every lane gets lane src's value"""
    return [list(values[src]) for _ in values]


def k3_lanes(X, Y, Z):
    """The kernel's schedule for one point: each lane's products in rounds,
    the exchanges as explicit copies; returns the stored (X3, Y3, Z3)."""
    F = Checked(FQ)
    a = [Y, Z, Y, X]
    b = [Y, Z, Z, Y]
    own = [F.mul(a[k], b[k]) for k in range(4)]          # round 1
    t0s, zzs = shfl(own, 0), shfl(own, 1)                # exchange 1
    adds = [dbl_adds(F, t0s[k], zzs[k]) for k in range(4)]
    assert all(x == adds[0] for x in adds)               # the same in every lane
    t0, z3, t2, y3 = adds[0]
    a = [t2, t0, own[2], t0]
    b = [z3, y3, z3, own[3]]
    r = [F.mul(a[k], b[k]) for k in range(4)]            # round 2
    up = [r[0], r[0], r[1], r[2]]                        # __shfl_up_sync by 1
    y_out = F.add(up[1], r[1])
    x_out = F.add(r[3], r[3])
    return FQ.canon(x_out), FQ.canon(y_out), FQ.canon(r[2])


def projective(pt, z):
    """(x, y) -> (x·z : y·z : z); the identity as (0 : 1 : 0)"""
    if pt is None:
        return (0, 1, 0)
    return (pt[0] * z % P_FQ, pt[1] * z % P_FQ, z)


def test_k3_lane_schedule_matches_twin_and_oracles():
    """The identity, outputs of the twins' double and add (Z ≠ 1) and 64
    seeded points with a random Z: the model's canonical coordinates equal
    g1_double_plain's limb for limb, and its affine point equals both
    packages' doubling."""
    rng = random.Random(0x3DC)
    G = ocurve.G1_GEN
    real = [None, G, ocurve.G1.mul(G, 3)] + [ocurve.G1.mul(G, rng.randrange(1, 1 << 128))
                                             for _ in range(64)]
    pts = [projective(pt, rng.randrange(1, P_FQ) if k > 2 else 1) for k, pt in enumerate(real)]
    enc = tuple(TFQ.encode(list(c)) for c in zip(*pts))
    # doubled and added projective points: the twins' outputs, Z ≠ 1
    dbl = g1.g1_double_plain(tuple(c[1:3] for c in enc))
    add = g1.g1_add_plain(tuple(c[1:3] for c in enc), tuple(c[3:5] for c in enc))
    cols = tuple(torch.cat([e, d, a]) for e, d, a in zip(enc, dbl, add))
    want_real = real + [ocurve.G1.add(p, p) for p in real[1:3]] \
        + [ocurve.G1.add(p, q) for p, q in zip(real[1:3], real[3:5])]
    twin = g1.g1_double_plain(cols)
    for k, (xyz, tw) in enumerate(zip(zip(*(mont_words(c) for c in cols)),
                                      zip(*(mont_words(c) for c in twin)))):
        if k >= len(real):
            assert FQ.unmont(xyz[2]) not in (0, 1)
        got = k3_lanes(*xyz)
        assert [value(c) for c in got] == [value(c) for c in tw]
        X, Y, Z = (FQ.unmont(c) for c in got)
        affine = None if Z == 0 else (X * pow(Z, -1, P_FQ) % P_FQ, Y * pow(Z, -1, P_FQ) % P_FQ)
        p = want_real[k]
        assert affine == ocurve.G1.add(p, p) == jax_ocurve.G1.add(p, p)


# ---------------------------------------------------------------------------
# K7: csrc/ntt.cu ntt_cols_kernel, pass by pass
# ---------------------------------------------------------------------------

def swz(i):
    """ntt.cu swz: where element i sits in its shared-memory plane"""
    return i ^ ((i >> 5) & 7) ^ (((i >> 6) & 3) << 3)


def twz(j):
    """ntt.cu twz: where twiddle j sits in its plane"""
    return j + (j >> 5)


def k7_passes(log_n1):
    """The kernel's schedule, mirroring its index arithmetic: for each pass
    (first, last, window ws) the threads' element indices, and for each
    thread its butterflies in order as (stage, lo register, hi register,
    twiddle index)."""
    log_r = min(3, log_n1)                          # ntt_cols_launch's switch
    n1, R = 1 << log_n1, 1 << log_r
    n_threads, passes = n1 >> log_r, -(-log_n1 // log_r)
    out = []
    for p in range(passes):
        ws = min(p * log_r, log_n1 - log_r)
        h0 = p * log_r - ws
        low = (1 << ws) - 1
        threads = []
        for t in range(n_threads):
            base = (t & low) | ((t >> ws) << (ws + log_r))
            elems = [base + (j << ws) for j in range(R)]
            flies = []
            for h in range(h0, log_r):
                s = ws + h + 1
                for j in range(R):
                    if j & (1 << h):
                        continue
                    u = (t & low) + ((j & ((1 << h) - 1)) << ws)
                    flies.append((s, j, j + (1 << h), u << (log_n1 - s)))
            threads.append((elems, flies))
        out.append({"first": p == 0, "last": p == passes - 1, "threads": threads})
    return out


def k7_lazy(xs, tws):
    """One column through the kernel's passes on lazy words: the first pass
    reads bit-reversed, the exchanges go through a word-major shared memory
    at swz(i), the last pass leaves each output canonical there, and the
    store reads row i back from swz(i)."""
    F = Checked(FR)
    n1 = len(xs)
    log_n1 = n1.bit_length() - 1
    shared = {}
    for ps in k7_passes(log_n1):
        for elems, flies in ps["threads"]:
            if ps["first"]:
                e = [list(xs[int(ntt.bitrev_indices(log_n1)[i])]) for i in elems]
            else:
                e = [list(shared[swz(i)]) for i in elems]
            for _, lo, hi, tw in flies:
                tb = F.mul(e[hi], tws[tw])
                e[hi] = F.sub(e[lo], tb)
                e[lo] = F.add(e[lo], tb)
            for i, v in zip(elems, e):
                shared[swz(i)] = FR.canon(v) if ps["last"] else v
    return [shared[swz(i)] for i in range(n1)]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k7_pass_schedule_matches_twin_and_oracles(inverse):
    """Columns of 2^1 … 2^6 points with 0, 1 and p − 1 among the inputs:
    the lazy model equals ntt_cols_plain limb for limb and both packages'
    oracle NTT."""
    rng = np.random.default_rng(0x7F)
    for log_n1 in range(1, 7):
        n1 = 1 << log_n1
        vals = [int.from_bytes(rng.bytes(32), "little") % P_FR for _ in range(n1)]
        vals[:3] = [0, 1, P_FR - 1][:n1]
        rng.shuffle(vals)
        x = TFR.encode(vals).view(n1, 1, 16)
        tw = col_twiddles(log_n1, inverse, torch.device("cpu"))
        got = k7_lazy(mont_words(x.view(n1, 16)), mont_words(tw))
        twin = ntt.ntt_cols_plain(x, tw).view(n1, 16)
        assert [value(v) for v in got] == [value(v) for v in mont_words(twin)]
        if inverse:
            want = [v * n1 % P_FR for v in ontt.intt(vals)]
            assert want == [v * n1 % P_FR for v in jax_ontt.intt(vals)]
        else:
            want = ontt.ntt(vals)
            assert want == jax_ontt.ntt(vals)
        assert [FR.unmont(v) for v in got] == want


def bank_ways(addrs):
    """Shared-memory wavefronts of one warp access: the most distinct
    words that fall in one of the 32 banks (1: conflict-free)."""
    banks = {}
    for a in set(addrs):
        banks.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in banks.values())


def test_k7_index_map_and_banks():
    """For log_n1 = 1 … 12: every butterfly of the radix-2 DIT transform
    (stage s pairs i and i + 2^(s−1) with twiddle (i mod 2^(s−1))·2^(log n1
    − s)) is done exactly once, stages in order, each pass's threads hold
    every element once, and swz is a bijection.  Banks: every exchange
    through shared memory, a warp's accesses of one word (one register j)
    hit as many banks as the warp has lanes, and so do the store's reads
    (four lanes a row, words 2c and 2c + 1 of planes n1 + 4 words apart)
    except at log_n1 = 2, where the planes are 8 words apart (2-way);
    twiddle reads are free of conflicts (distinct banks or one broadcast
    word) for log_n1 ≤ 11, and 2-way at log_n1 = 12 in one stage."""
    for log_n1 in range(1, 13):
        n1 = 1 << log_n1
        done = {}
        last_stage = 0
        tw_ways = {}
        log_r = min(3, log_n1)
        for ps in k7_passes(log_n1):
            assert sorted(i for elems, _ in ps["threads"] for i in elems) == list(range(n1))
            assert sorted(swz(i) for i in range(n1)) == list(range(n1))
            stages = sorted({s for _, flies in ps["threads"] for s, *_ in flies})
            assert stages and stages[0] == last_stage + 1
            last_stage = stages[-1]
            for elems, flies in ps["threads"]:
                for s, lo, hi, tw in flies:
                    i, k = elems[lo], elems[hi]
                    assert k - i == 1 << (s - 1) and not i & (1 << (s - 1))
                    assert tw == (i % (1 << (s - 1))) << (log_n1 - s)
                    done[s, i] = done.get((s, i), 0) + 1
            threads = ps["threads"]
            shared = not (ps["first"] and ps["last"])
            for w0 in range(0, len(threads), 32):
                warp = threads[w0:w0 + 32]
                for j in range(1 << log_r):
                    addrs = [swz(elems[j]) for elems, _ in warp]
                    if shared:
                        assert bank_ways(addrs) == 1 and len(set(addrs)) == len(warp)
                for f in range(len(warp[0][1])):
                    s = warp[0][1][f][0]
                    ways = bank_ways([twz(flies[f][3]) for _, flies in warp])
                    tw_ways[s] = max(tw_ways.get(s, 1), ways)
        vp = n1 + 4
        for w0 in range(0, 4 * n1, 32):              # the store: lane idx -> (i, c)
            lanes = range(w0, min(w0 + 32, 4 * n1))
            for word in (0, 1):
                addrs = [(2 * (idx & 3) + word) * vp + swz(idx >> 2) for idx in lanes]
                assert bank_ways(addrs) == (2 if log_n1 == 2 else 1)
                assert len(set(addrs)) == len(lanes)
        assert last_stage == log_n1
        assert done == {(s, i): 1 for s in range(1, log_n1 + 1) for i in range(n1)
                        if not i & (1 << (s - 1))}
        conflicted = {s: w for s, w in tw_ways.items() if w > 1}
        if log_n1 <= 11:
            assert conflicted == {}
        else:
            assert conflicted == {4: 2}


# ---------------------------------------------------------------------------
# The work chip_smoke.py's bounds charge: the least each function needs
# ---------------------------------------------------------------------------

class CountingFq(g1.FqOps):
    """The twin's Fq ops, counting products, squares and adds per column"""

    def __init__(self, device):
        super().__init__(device)
        self.n = Counter()

    def mul(self, a, b):
        self.n["mul"] += a.shape[1]
        return super().mul(a, b)

    def sqr(self, a):
        self.n["sqr"] += a.shape[1]
        return super().sqr(a)

    def add(self, a, b):
        self.n["add"] += a.shape[1]
        return super().add(a, b)

    def sub(self, a, b):
        self.n["add"] += a.shape[1]
        return super().sub(a, b)


@pytest.mark.parametrize("kernel", ["g1_double", "ntt_cols"])
def test_bounds_charge_the_least_work(kernel):
    """K3: the twin's double (RCB15 algorithm 9, b3 = 9 as three doublings
    and an add) does per point the products, squares and adds of
    chip_smoke.G1_DOUBLE_WORK, which PER_ITEM charges.  K7: for log_n1 =
    1 … 12, chip_smoke.ntt_cols_work is the kernel schedule's butterflies
    (two adds each) and its products by a twiddle other than entry 0, which
    is ω^0 = 1 in both directions."""
    if kernel == "g1_double":
        n = 5
        pts = [ocurve.G1.mul(ocurve.G1_GEN, k) for k in range(1, n + 1)]
        enc = [g1.to_lm(TFQ.encode(list(c))) for c in zip(*((x, y, 1) for x, y in pts))]
        F = CountingFq(torch.device("cpu"))
        g1.double_lm_pts(F, enc)
        work = chip_smoke.G1_DOUBLE_WORK
        assert (F.n["mul"], F.n["sqr"], F.n["add"]) == tuple(n * w for w in work)
        mul, sqr, add = work
        assert chip_smoke.PER_ITEM[kernel][1] == (mul * chip_smoke.MUL_OPS
                                                  + sqr * chip_smoke.SQR_OPS
                                                  + add * chip_smoke.ADD_OPS)
        return
    for inverse in (False, True):
        assert mont_words(col_twiddles(3, inverse, torch.device("cpu"))[:1]) == \
            mont_words(TFR.encode([1]))
    for log_n1 in range(1, 13):
        flies = [f for ps in k7_passes(log_n1) for _, fl in ps["threads"] for f in fl]
        products = sum(tw != 0 for *_, tw in flies)
        assert chip_smoke.ntt_cols_work(log_n1) == (products, 2 * len(flies))
