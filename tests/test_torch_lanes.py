"""The port's prover API against the reference's, and Python-integer models
of the redesigned K2 (G1 add on the lazy Fq arithmetic) and K4 (Poseidon,
three lanes per hash) as the CUDA kernels run them, on the word model of
tests/lazy_words.py: every dropped carry is asserted to be 0 and every
value to stay below 2p, and each model must equal both packages'
oracles.  No key, no prove and no Pallas: the whole file takes seconds."""

import dataclasses
import inspect
import random
import types

import numpy as np
import pytest
import torch

import chip_smoke
from lazy_words import LazyField, value, words
from owshen_tpu import config as jax_config
from owshen_tpu.groth16 import groth16 as jax_groth16
from owshen_tpu.oracle import curve as jax_ocurve
from owshen_tpu.oracle import hash as jax_ohash
from owshen_tpu.protocol import pool as jax_pool
from owshen_tpu.runtime import metrics as jax_metrics
from owshen_tpu_torch import config
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.kernels import build, g1
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FQ, P_FR
from owshen_tpu_torch.protocol import pool
from owshen_tpu_torch.runtime import metrics

FQ = LazyField(P_FQ)
FR = LazyField(P_FR)


def _params(fn):
    return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()]


def test_prover_signatures_match_reference():
    """`prove` and `prove_withdraw` take the reference's parameters in its
    order, with its defaults, then the port's keyword-only extras."""
    for port, ref, extras in (
            (groth16.prove, jax_groth16.prove, ["device"]),
            (pool.PrivacyPool.prove_withdraw, jax_pool.PrivacyPool.prove_withdraw, ["seed"])):
        got, want = _params(port), _params(ref)
        assert got[:len(want)] == want
        assert [(name, kind) for name, _, kind in got[len(want):]] == \
            [(name, inspect.Parameter.KEYWORD_ONLY) for name in extras]


def test_prover_engine_errors_come_before_any_work(monkeypatch):
    """An unknown engine is a ValueError with the reference's message and a
    mesh a NotImplementedError naming its ROADMAP item, before any work
    (None stands in for the key and the builder).  "lane" and "sorted" are
    served, and "fixed" with tables over the budget resolves to "sorted",
    where the reference's prover goes too."""
    assert config.settings().prover_engine == jax_config.settings().prover_engine == "fixed"
    message = r"unknown prover engine 'bogus': expected fixed\|lane\|sorted"
    with pytest.raises(ValueError, match=message):
        groth16.prove(None, None, engine="bogus")
    for engine in ("lane", "sorted"):
        assert groth16._resolve_engine(None, None, engine) == engine
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        groth16.prove(None, None, mesh=object())
    # the engine from OWSHEN_PROVER_ENGINE, and tables over the budget
    monkeypatch.setenv("OWSHEN_PROVER_ENGINE", "bogus")
    monkeypatch.setenv("OWSHEN_FIXED_TABLE_MAX_GB", "1e-6")
    config.settings.cache_clear()
    try:
        with pytest.raises(ValueError, match="unknown prover engine 'bogus'"):
            groth16.prove(None, None)
        pts = (torch.zeros((100, 16), dtype=torch.int32),)
        key = types.SimpleNamespace(a_g1=pts, h_g1=pts, k_g1=None)
        assert groth16._resolve_engine(key, None, "fixed") == "sorted"
        assert not jax_groth16._fixed_tables_fit(key)
    finally:
        monkeypatch.undo()
        config.settings.cache_clear()


def test_native_token_and_metrics_reset_match_reference():
    assert dataclasses.astuple(pool.NATIVE) == dataclasses.astuple(jax_pool.NATIVE)
    assert pool.NATIVE.is_native and jax_pool.NATIVE.is_native
    for address in (0, 1, 0xDEAD):
        assert pool.Token(address).is_native == jax_pool.Token(address).is_native
    dumps = []
    for registry in (metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()):
        registry.inc("pool.deposits", 3)
        registry.gauge("pool.next_index", 7)
        with registry.timer("pool.prove_withdraw"):
            pass
        registry.reset()
        dumps.append(registry.dump())
        registry.inc("pool.deposits")
        dumps.append(registry.dump())
    assert dumps[0] == dumps[2] == {"counters": {}, "gauges": {}, "timers": {}}
    assert dumps[1] == dumps[3] == {"counters": {"pool.deposits": 1.0}, "gauges": {},
                                    "timers": {}}


def test_lazy_fq_sub_and_mul9_stay_below_2q():
    """fsub_lazy and fmul9_lazy over Fq on edge values, including values
    just under 2q, as K2 feeds them (the word model asserts the ranges and
    the carries)."""
    q = P_FQ
    rng = random.Random(0xF5)
    vals = [0, 1, q - 2, q - 1, q, q + 1, 2 * q - 2, 2 * q - 1] \
        + [2 * q - 1 - rng.randrange(1 << rng.randrange(1, 250)) for _ in range(24)] \
        + [rng.randrange(2 * q) for _ in range(24)]
    for a in vals:
        for b in vals[::3]:
            d = value(FQ.sub(words(a), words(b)))
            assert d % q == (a - b) % q
        assert value(FQ.mul9(words(a))) % q == 9 * a % q
    field = build._field_consts_words().reshape(2, 17)
    assert field[1, :8].tolist() == FQ.pw and field[1, 9:].tolist() == FQ.p2w


def g1_add_lazy(p, q):
    """g1.cu g1_add_lazy, operation for operation (RCB15 algorithm 7, a = 0,
    b3 = 9), then the store's fcanon of each coordinate."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    mul, add, sub = FQ.mul, FQ.add, FQ.sub
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    t5 = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))
    three_t0 = add(add(t0, t0), t0)
    t2b = FQ.mul9(t2)
    z3, t1b = add(t1, t2b), sub(t1, t2b)
    y3 = FQ.mul9(t5)
    X3 = sub(mul(t3, t1b), mul(t4, y3))
    Y3 = add(mul(y3, three_t0), mul(t1b, z3))
    Z3 = add(mul(z3, t4), mul(three_t0, t3))
    return tuple(FQ.canon(c) for c in (X3, Y3, Z3))


def test_lazy_g1_add_matches_oracles():
    """The model of K2 on chip_smoke.edge_pairs (O + O, P + O, O + Q,
    P + P, P + (−P)) and on seeded multiples of G: the affine sums equal
    both packages' oracles, and the canonical coordinates equal the plain
    twin's limb for limb."""
    pts, qs = chip_smoke.edge_pairs(ocurve.G1, ocurve.G1_GEN,
                                    (3, 5, 7, 11, 13, 17, 1 << 200))
    tp, tq = bn254.g1_encode(pts), bn254.g1_encode(qs)
    twin = g1.g1_add_plain(tp, tq)

    def mont_words(t):   # int32[n, 16] Montgomery limbs -> 8 words per row
        return [[int(r[2 * i]) | int(r[2 * i + 1]) << 16 for i in range(8)] for r in t]

    cols_p, cols_q, cols_t = (list(zip(*(mont_words(c) for c in pt))) for pt in (tp, tq, twin))
    for a, b, p, q, want in zip(pts, qs, cols_p, cols_q, cols_t):
        got = g1_add_lazy(p, q)
        assert [value(c) for c in got] == [value(c) for c in want]
        X, Y, Z = (FQ.unmont(c) for c in got)
        affine = None if Z == 0 else (X * pow(Z, -1, P_FQ) % P_FQ, Y * pow(Z, -1, P_FQ) % P_FQ)
        assert affine == ocurve.G1.add(a, b) == jax_ocurve.G1.add(a, b)


def poseidon_lanes(left: int, right: int) -> int:
    """poseidon.cu's poseidon2_kernel for one hash, lane by lane: lane k
    holds state word k; each round's slot products and the exchange through
    shared memory in the kernel's order, on lazy values; lane 0's word made
    canonical at the end."""
    c, m, n_rounds = build._poseidon_consts_words()
    C = [[list(map(int, c[r, k])) for k in range(3)] for r in range(n_rounds)]
    M = [[list(map(int, m[i, j])) for j in range(3)] for i in range(3)]
    half, r_p = 4, n_rounds - 8
    s = [[0] * 8, FR.mont(left), FR.mont(right)]
    for r in range(n_rounds):
        x = [[None] * 3 for _ in range(3)]          # exchange: x[lane][slot]
        t = [FR.add(s[k], C[r][k]) for k in range(3)]
        if r < half or r >= half + r_p:             # full round
            for k in range(3):                      # slots 1–3: t^5
                p = FR.sqr(FR.sqr(t[k]))
                x[k][2] = FR.mul(p, t[k])
            for k in range(3):                      # slots 4–6: row k of M
                acc = FR.mul(x[0][2], M[k][0])
                acc = FR.add(acc, FR.mul(x[1][2], M[k][1]))
                s[k] = FR.add(acc, FR.mul(x[2][2], M[k][2]))
        else:                                       # partial round
            for k in range(3):
                k0 = k == 0
                r1 = FR.mul(t[k], t[k] if k0 else M[0][k])
                r2 = FR.mul(r1 if k0 else t[k], r1 if k0 else M[1][k])
                x[k][0], x[k][1] = r1, r2
                x[k][2] = FR.mul(t[k], r2 if k0 else M[2][k])
            for k in range(3):                      # slot 4
                cross = FR.add(x[1][k], x[2][k])
                s[k] = FR.add(FR.mul(x[0][2], M[k][0]), cross)
        assert all(value(w) < 2 * P_FR for w in s)
    return FR.unmont(FR.canon(s[0]))


def test_k4_lane_model_matches_oracles():
    p = P_FR
    rng = np.random.default_rng(0x4A4E)
    pairs = [(0, 0), (p - 1, p - 1), (1, 2)] \
        + [tuple(int.from_bytes(rng.bytes(32), "little") % p for _ in range(2)) for _ in range(3)]
    # circomlib's Poseidon([1, 2]) (the verify skill's hash interop vector)
    assert ohash.poseidon([1, 2]) == \
        7853200120776062878684798364095072458815029376092732009249414926327459813530
    for left, right in pairs:
        want = ohash.poseidon([left, right])
        assert want == jax_ohash.poseidon([left, right])
        assert poseidon_lanes(left, right) == want
