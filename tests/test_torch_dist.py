"""The mesh layer (owshen_tpu_torch/parallel/) on meshes of CPU shards,
against the host oracles and the JAX package, as tests/test_dist.py holds
the JAX package's mesh on its 8-device CPU mesh.

A mesh here is `make_mesh(d, devices=[cpu])`: d shards on the CPU, no
process group.  Each shard runs the plain twins, so every check is exact.
No JAX setup or prove runs; the JAX package's DistNtt runs once, at d = 2
on the conftest's 8-device CPU mesh.  The mesh prove of the dry run's
circuit takes ~21 s on the twins, so the proof-level check here is
`_prove_core` over msm_dist backends (`_prove_mesh`) on a hand-made key
whose points are known multiples of the generators; the whole prove runs
in chip_smoke.py (depth 16, d = 2 and 4, equal to the fixed engine's
proof) and in `dryrun.run`."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.oracle import ntt as ontt
from owshen_tpu.parallel import mesh as jmesh
from owshen_tpu.parallel.ntt_dist import DistNtt as JDistNtt
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.ops.merkle import oracle_sparse_root
from owshen_tpu_torch.parallel import mesh as pmesh
from owshen_tpu_torch.parallel.merkle_dist import DistSparseMerkleTree, merkle_root_dist
from owshen_tpu_torch.parallel.msm_dist import msm_dist
from owshen_tpu_torch.parallel.ntt_dist import DistNtt

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = FR.p


def cpu_mesh(d):
    return pmesh.make_mesh(d, devices=[CPU])


@pytest.mark.parametrize("d", [2, 8])
def test_dist_ntt_fwd_inv(d):
    """DistNtt at log_n 6 against the host NTT, forward and inverse, on a
    batch of two columns too; at d = 2 limb for limb against the JAX
    package's DistNtt on its CPU mesh."""
    rng = random.Random(50 + d)
    log_n = 6
    xs = [rng.randrange(P) for _ in range(1 << log_n)]
    xs[:3] = [0, 1, P - 1]
    dn = DistNtt(cpu_mesh(d), log_n)
    fwd = dn.ntt(FR.encode(xs))
    assert FR.decode(fwd) == ontt.ntt(xs, dn.omega)
    assert FR.decode(dn.intt(fwd)) == xs
    ys = [rng.randrange(P) for _ in range(1 << log_n)]
    both = dn.ntt(torch.stack([FR.encode(ys), FR.encode(xs)], dim=1))    # (n, 2, 16)
    assert torch.equal(both[:, 1], fwd) and FR.decode(both[:, 0]) == ontt.ntt(ys, dn.omega)
    if d == 2:
        ref = JDistNtt(jmesh.make_mesh(2), log_n)
        got = np.asarray(ref.ntt(jnp.asarray(JFR.encode(xs))))
        assert np.array_equal(got.astype(np.int32), fwd.numpy())


def test_mesh_and_msm_dist(monkeypatch):
    """make_mesh lays shards round robin and raises with no card and no
    devices; shard_leading, gather, all_gather and all_to_all follow JAX's
    tiled semantics.  msm_dist at d = 8 (c = 4, lanes = 2, tests/test_dist.py's
    shape) equals the host MSM, and n not a multiple of the mesh is
    refused; G2's msm_dist (d = 2) is held in test_prove_core_over_msm_dist."""
    mesh = pmesh.make_mesh(3, devices=["cpu", "meta"])
    assert mesh.size == 3 and mesh.devices == (CPU, torch.device("meta"), CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(2)
    mesh = cpu_mesh(4)
    x = torch.arange(8 * 4).reshape(8, 4)
    blocks = pmesh.shard_leading(mesh, x)
    assert [b.tolist() for b in blocks] == [x[2 * c:2 * c + 2].tolist() for c in range(4)]
    pairs = pmesh.shard_leading(mesh, (x, -x))
    assert all(torch.equal(p[1], -b) for p, b in zip(pairs, blocks))
    assert all(torch.equal(g, x) for g in pmesh.all_gather(mesh, blocks))
    assert torch.equal(pmesh.gather(blocks, CPU, dim=1), torch.cat(blocks, dim=1))
    # shard j receives chunk j of every shard's block, in shard order
    out = pmesh.all_to_all(mesh, blocks, split_dim=1, cat_dim=0)
    assert all(torch.equal(o, x[:, j:j + 1]) for j, o in enumerate(out))
    assert all(torch.equal(r, x) for r in pmesh.replicated(mesh, x))
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_leading(mesh, x[:6])
    mesh = cpu_mesh(8)
    rng = random.Random(51)
    n = 2 * 8
    pts = [ocurve.G1.mul(ocurve.G1_GEN, rng.randrange(500) + 1) for _ in range(n)]
    pts[3] = None
    # 64-bit scalars at n_bits = 64: each shard's Horner is a quarter of the
    # 256-bit one (~1 s of twin doubles a shard); the lane engine's full
    # width is held in tests/test_torch_msm.py, the mesh's on the card
    scalars = [rng.randrange(1 << 64) for _ in range(n)]
    scalars[:3] = [0, 1, (1 << 64) - 1]
    acc = msm_dist(mesh, bn254.G1, bn254.g1_encode(pts), FR.encode(scalars, mont=False),
                   c=4, n_bits=64, lanes=2)
    assert bn254.g1_decode(tuple(a[None] for a in acc))[0] == ocurve.G1.msm(pts, scalars)
    with pytest.raises(ValueError, match="does not divide"):
        msm_dist(mesh, bn254.G1, bn254.g1_encode(pts[:12]),
                 FR.encode(scalars[:12], mont=False), c=4, n_bits=64, lanes=2)


def test_dist_merkle():
    """merkle_root_dist at d = 4 against oracle_sparse_root; the sharded
    sparse tree at depth 16, d = 8, with tests/test_dist.py's two batches
    (an overwrite and a new shard) against oracle_sparse_root after each,
    and a duplicate index in a batch rejected with no state change."""
    rng = random.Random(52)
    n = 2 * 4                   # a level hashed on every shard, then the two top levels
    leaves = [rng.randrange(P) for _ in range(n)]
    root = merkle_root_dist(cpu_mesh(4), FR.encode(leaves), "poseidon")
    assert FR.decode(root[None])[0] == oracle_sparse_root(dict(enumerate(leaves)), 3)

    depth = 16
    t = DistSparseMerkleTree(cpu_mesh(8), depth)
    assert (t.local_depth, len(t.trees)) == (13, 8)
    entries = {}
    for batch in ([(0, 111), (3, 222), (40000, 333), (65535, 444)],
                  [(1, 555), (40000, 666), (30000, 777)]):
        got = t.insert_ints([i for i, _ in batch], [v for _, v in batch])
        entries.update(dict(batch))
        want = oracle_sparse_root(entries, depth)
        assert FR.decode(got[None])[0] == t.root_int() == want
    with pytest.raises(ValueError, match="unique leaf indices"):
        t.insert_ints([7, 7], [1, 2])
    assert t.root_int() == want


def dryrun_circuit():
    b = Builder()
    y = b.pub(49)
    x = b.priv(7)
    b.enforce_eq(b.mul(x, x), y)
    for k in range(32):
        v = b.priv(k + 2)
        b.enforce_eq(b.mul(v, v), b.priv((k + 2) ** 2))
    assert b.check()
    return b


def test_h_scalars_dist_equals_device():
    """The mesh's h pipeline (three DistNtt round trips) equals the
    single-device one limb for limb on the dry run's 33-constraint circuit
    (66 rows, n = 128), at d = 2 and 8."""
    b = dryrun_circuit()
    n = 128
    dom = groth16._domain(n.bit_length() - 1)
    mats = groth16._device_mats(b.compiled(n), CPU)
    w_mont = FR.encode(b.witness())
    want = groth16._h_scalars_device(dom, w_mont, mats)
    for d in (2, 8):
        assert torch.equal(groth16._h_scalars_dist(cpu_mesh(d), dom, w_mont, mats), want)


def test_prove_core_over_msm_dist(monkeypatch):
    """`_prove_mesh` (`_prove_core` over msm_dist backends, G1 and G2, at
    d = 2, with the point sets padded to the mesh) on a hand-made key whose
    points are e·G for seeded exponents e: A, B and C equal the host's
    A = α + Σ wᵢaᵢ + r·δ, B = β + Σ wᵢbᵢ + s·δ and
    C = Σ hᵢHᵢ + Σ_priv wᵢkᵢ + s·A + r·B₁ − r·s·δ on the exponents.
    w, h, r and s are drawn so that every MSM scalar (w, s·w, r·w, h) is
    below 2^64, and msm_dist runs at n_bits = 64: its twelve shard MSMs'
    Horner doublings on the twins are a quarter of the 256-bit ones."""
    from owshen_tpu_torch.parallel import msm_dist as pmsm_dist

    full = pmsm_dist.msm_dist

    def msm_dist_64(mesh, curve, points, scalars, c=8, n_bits=256, lanes=1024):
        assert n_bits == 256
        return full(mesh, curve, points, scalars, c=c, n_bits=64, lanes=lanes)

    monkeypatch.setattr(pmsm_dist, "msm_dist", msm_dist_64)
    rng = random.Random(53)
    m, n_pub, n_h = 5, 2, 3
    e = {name: [rng.randrange(1, P) for _ in range(k)]
         for name, k in (("a", m), ("b", m), ("k", m - n_pub), ("h", n_h),
                         ("alpha", 1), ("beta", 1), ("delta", 1))}
    g1 = lambda es: bn254.g1_encode([ocurve.G1.mul(ocurve.G1_GEN, x) for x in es])  # noqa: E731
    g2 = lambda es: bn254.g2_encode([ocurve.G2.mul(ocurve.G2_GEN, x) for x in es])  # noqa: E731
    pk = groth16.ProvingKey(
        n_domain=4, n_pub=n_pub, a_g1=g1(e["a"]), b_g1=g1(e["b"]), b_g2=g2(e["b"]),
        k_g1=g1(e["k"]), h_g1=g1(e["h"]), alpha_g1=g1(e["alpha"]), beta_g1=g1(e["beta"]),
        delta_g1=g1(e["delta"]), beta_g2=g2(e["beta"]), delta_g2=g2(e["delta"]))
    w = [1] + [rng.randrange(1 << 32) for _ in range(m - 1)]
    h = [rng.randrange(1 << 64) for _ in range(n_h)]
    r, s = rng.randrange(1, 1 << 32), rng.randrange(1, 1 << 32)
    proof = groth16._prove_mesh(pk, w, r, s, FR.encode(h, mont=False), cpu_mesh(2),
                                msm_c=4, msm_lanes=2)
    dot = lambda xs, ys: sum(x * y for x, y in zip(xs, ys)) % P  # noqa: E731
    (alpha,), (beta,), (delta,) = e["alpha"], e["beta"], e["delta"]
    a_exp = (alpha + dot(w, e["a"]) + r * delta) % P
    b_exp = (beta + dot(w, e["b"]) + s * delta) % P
    c_exp = (dot(h, e["h"]) + dot(w[n_pub:], e["k"]) + s * a_exp + r * b_exp
             - r * s * delta) % P
    assert proof.a == ocurve.G1.mul(ocurve.G1_GEN, a_exp)
    assert proof.b == ocurve.G2.mul(ocurve.G2_GEN, b_exp)
    assert proof.c == ocurve.G1.mul(ocurve.G1_GEN, c_exp)
