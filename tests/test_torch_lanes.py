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
import host_msm
from lazy_words import LazyField, value, words
from owshen_tpu import config as jax_config
from owshen_tpu.circuits import gadgets as jax_gadgets
from owshen_tpu.groth16 import groth16 as jax_groth16
from owshen_tpu.ops import msm_fixed as jax_msm_fixed
from owshen_tpu.oracle import curve as jax_ocurve
from owshen_tpu.oracle import hash as jax_ohash
from owshen_tpu.parallel import merkle_dist as jax_merkle_dist
from owshen_tpu.parallel import mesh as jax_mesh
from owshen_tpu.parallel import msm_dist as jax_msm_dist
from owshen_tpu.parallel import ntt_dist as jax_ntt_dist
from owshen_tpu.protocol import pool as jax_pool
from owshen_tpu.runtime import dryrun as jax_dryrun
from owshen_tpu.runtime import metrics as jax_metrics
from owshen_tpu_torch import config
from owshen_tpu_torch.circuits import gadgets
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FR as FRF
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.kernels import build, g1
from owshen_tpu_torch.ops import msm as pmsm
from owshen_tpu_torch.ops import msm_fixed
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle import hash as ohash
from owshen_tpu_torch.oracle.field import P_FQ, P_FR
from owshen_tpu_torch.parallel import merkle_dist, msm_dist, ntt_dist
from owshen_tpu_torch.parallel import mesh as pmesh
from owshen_tpu_torch.protocol import pool
from owshen_tpu_torch.runtime import dryrun, metrics

FQ = LazyField(P_FQ)
FR = LazyField(P_FR)


def _params(fn):
    return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()]


def _same_params(port, ref, extras=()):
    """port takes ref's parameters in its order, with its plain defaults
    (ints, strings, None; a field default is compared by name), then
    `extras`."""
    norm = lambda d: d if d is None or isinstance(d, (int, str)) else getattr(d, "name", "?")  # noqa: E731
    got = [(n, norm(d), k) for n, d, k in _params(port)]
    want = [(n, norm(d), k) for n, d, k in _params(ref)]
    assert got[:len(want)] == want, port
    assert [n for n, _, _ in got[len(want):]] == list(extras), port


def test_prover_signatures_match_reference():
    """`prove` and `prove_withdraw` take the reference's parameters in its
    order, with its defaults, then the port's keyword-only extras; so do
    the fixed-table MSM (`msm_fixed`, the folds, `FixedMsm.from_table`),
    `merkle_path_gadget`, the mesh layer and the dry run, and bn254 has
    `g1_decode` / `g2_decode`.  A host-built table restored by
    `FixedMsm.from_table` gives the oracle's MSM through `msm_fixed` and
    `.mul`, and a MiMC authentication path built with
    `merkle_path_gadget(hash2=...)` gives the oracle's root."""
    for port, ref, extras in (
            (groth16.prove, jax_groth16.prove, ["device"]),
            (pool.PrivacyPool.prove_withdraw, jax_pool.PrivacyPool.prove_withdraw, ["seed"])):
        got, want = _params(port), _params(ref)
        assert got[:len(want)] == want
        assert [(name, kind) for name, _, kind in got[len(want):]] == \
            [(name, inspect.Parameter.KEYWORD_ONLY) for name in extras]
    pairs = [(getattr(msm_fixed, f), getattr(jax_msm_fixed, f), ())
             for f in ("msm_fixed", "fold_sum", "fold_sum_batched", "msm_fixed_multi")]
    pairs += [(msm_fixed.FixedMsm.from_table, jax_msm_fixed.FixedMsm.from_table, ()),
              (gadgets.merkle_path_gadget, jax_gadgets.merkle_path_gadget, ()),
              (pmesh.make_mesh, jax_mesh.make_mesh, ("devices",)),
              (dryrun.run, jax_dryrun.run, ("devices",)),
              (dryrun.run_subprocess, jax_dryrun.run_subprocess, ())]
    for module, ref in ((pmesh, jax_mesh), (ntt_dist, jax_ntt_dist), (msm_dist, jax_msm_dist),
                        (merkle_dist, jax_merkle_dist)):
        names = [n for n, v in vars(ref).items() if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__]
        assert names and all(hasattr(module, n) for n in names), module
        pairs += [(getattr(module, n), getattr(ref, n), ()) for n in names
                  if (module, n) != (pmesh, "make_mesh")]
    for cls in (ntt_dist.DistNtt, merkle_dist.DistSparseMerkleTree):
        ref = getattr(jax_ntt_dist if cls is ntt_dist.DistNtt else jax_merkle_dist, cls.__name__)
        pairs += [(getattr(cls, n), getattr(ref, n), ()) for n in vars(ref)
                  if not n.startswith("_") and callable(getattr(ref, n))]
    for port, ref, extras in pairs:
        _same_params(port, ref, extras)
    assert bn254.g1_decode is bn254.g1_decode_many and bn254.g2_decode is bn254.g2_decode_many

    rng = random.Random(0x7AB)
    pts = [jax_ocurve.G1.mul(jax_ocurve.G1_GEN, rng.randrange(1, 1 << 60)) for _ in range(2)]
    rows, widths, shapes = host_msm.host_table("g1", pts)
    table = tuple(a.reshape((64, 9, 2) + tuple(sh))
                  for a, sh in zip(pmsm._unflat_rows(rows.reshape(-1, 48), widths, shapes),
                                   shapes))
    fx = msm_fixed.FixedMsm.from_table(bn254.G1, table)
    assert torch.equal(fx.rows, rows) and all(map(torch.equal, fx.table, table))
    scalars = [P_FR - 1, rng.randrange(P_FR)]
    want = jax_ocurve.G1.msm(pts, scalars)
    sc = FRF.encode(scalars, mont=False)
    assert bn254.g1_decode_host(tuple(a[None] for a in msm_fixed.msm_fixed(
        bn254.G1, table, sc))) == want
    assert bn254.g1_decode_host(tuple(a[None] for a in fx.mul(sc[:1]))) == \
        jax_ocurve.G1.mul(pts[0], scalars[0])

    b = Builder()
    leaf, sibs = rng.randrange(P_FR), [rng.randrange(P_FR) for _ in range(2)]
    bits = [1, 0]
    root = gadgets.merkle_path_gadget(
        b, b.priv(leaf), [b.priv(x) for x in bits], [b.priv(x) for x in sibs],
        hash2=lambda bb, l, r: gadgets.mimc7_multi_gadget(bb, [l, r]))
    node = leaf
    for bit, sib in zip(bits, sibs):
        node = jax_ohash.mimc7_multi([sib, node] if bit else [node, sib])
    assert b.check() and root.eval(b.witness()) == node


def test_prover_engine_errors_come_before_any_work(monkeypatch):
    """An unknown engine is a ValueError with the reference's message before
    any work, with or without a mesh (None stands in for the key and the
    builder).  "lane" and "sorted" are served, "fixed" with tables over the
    budget resolves to "sorted", where the reference's prover goes too,
    and a mesh proves through msm_dist without looking at the tables."""
    assert config.settings().prover_engine == jax_config.settings().prover_engine == "fixed"
    message = r"unknown prover engine 'bogus': expected fixed\|lane\|sorted"
    with pytest.raises(ValueError, match=message):
        groth16.prove(None, None, engine="bogus")
    for engine in ("lane", "sorted"):
        assert groth16._resolve_engine(None, None, engine) == engine
    with pytest.raises(ValueError, match=message):
        groth16.prove(None, None, mesh=object(), engine="bogus")
    assert groth16._resolve_engine(None, object(), "fixed") == "fixed"
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
