"""Port vs reference: K4 (Poseidon t = 3), the composed Poseidon widths,
K6 (MultiMiMC7) and the composed MiMC7, the sparse Merkle tree of deposits,
the dense and sparse MiMC trees, and the MiMC7 gadget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.ops import hash as jhash
from owshen_tpu.ops import merkle as jmerkle
from owshen_tpu.ops.merkle import SparseMerkleTree as JTree
from owshen_tpu.oracle import hash as ohash
from owshen_tpu.pallas.field_kernels import poseidon_hash2_pallas
from owshen_tpu_torch.circuits import gadgets
from owshen_tpu_torch.convert import tree_from_numpy
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.ops import hash as phash
from owshen_tpu_torch.ops.merkle import (SparseMerkleTree, build_levels, merkle_path,
                                         oracle_sparse_root, verify_path, zero_hashes)
from owshen_tpu_torch.oracle import hash as pohash

torch.set_num_threads(1)

CIRCOMLIB_POSEIDON_1_2 = \
    7853200120776062878684798364095072458815029376092732009249414926327459813530
# go-iden3-crypto mimc7_test.go (tests/test_hash.py:53-57)
MIMC7_12_45 = 19746142529723647765530752502670948774458299263315590587358840390982005703908
MULTI_MIMC7_12_45_78_41 = \
    18226366069841799622585958305961373004333097209608110160936134895615261821931


def rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def test_poseidon_kernel_matches_pallas():
    rng = np.random.default_rng(31)
    xs, ys = rand_ints(rng, 128), rand_ints(rng, 128)
    xs[:3] = [0, 1, FR.p - 1]
    ys[:3] = [FR.p - 1, 0, FR.p - 1]
    ja, jb = jnp.asarray(JFR.encode(xs)), jnp.asarray(JFR.encode(ys))
    got = phash.poseidon_hash2(FR.encode(xs), FR.encode(ys))
    assert same(got, poseidon_hash2_pallas(ja, jb, block_t=128))
    assert same(got[:16], jhash.poseidon_hash2(ja[:16], jb[:16]))
    assert FR.decode(got[:8]) == [ohash.poseidon([x, y]) for x, y in zip(xs[:8], ys[:8])]


def test_poseidon_vectors_and_widths():
    one_two = phash.poseidon([FR.encode([1]), FR.encode([2])])
    assert FR.decode(one_two) == [CIRCOMLIB_POSEIDON_1_2]
    rng = np.random.default_rng(32)
    for width in (1, 4):
        ins = [rand_ints(rng, 3) for _ in range(width)]
        got = FR.decode(phash.poseidon([FR.encode(v) for v in ins]))
        assert got == [ohash.poseidon(list(col)) for col in zip(*ins)]


def test_sparse_tree_matches_jax_tree():
    depth = 4
    rng = np.random.default_rng(33)
    jt, pt = JTree(depth), SparseMerkleTree(depth, device="cpu")
    assert same(pt.nodes, jt.nodes)
    assert pt.zero_hashes == zero_hashes(depth)
    entries = {}
    for idx in ([0, 1, 5, 6], [2, 9, 15]):
        vals = rand_ints(rng, len(idx))
        rows = pt.touched_rows(idx)
        assert np.array_equal(rows, jt.touched_rows(idx))
        assert same(pt.snapshot_rows(rows), jt.snapshot_rows(rows))
        jt.insert_ints(idx, vals)
        pt.insert_ints(idx, vals)
        entries.update(zip(idx, vals))
        assert same(pt.nodes, jt.nodes)
    assert pt.root_int() == jt.root_int() == oracle_sparse_root(entries, depth)
    sibs, bits = pt.path([5, 9])
    jsibs, jbits = jt.path(jnp.asarray([5, 9]))
    assert same(sibs, jsibs)
    assert same(bits, jbits)
    assert same(pt.leaf([9, 3]), jt.leaf(jnp.asarray([9, 3])))
    copy = tree_from_numpy(np.asarray(jt.nodes), depth, device="cpu")
    assert torch.equal(copy.nodes, pt.nodes)
    with pytest.raises(ValueError):
        pt.insert_ints([3, 3], [1, 2])


def test_mimc_kernel_matches_jax_and_vectors():
    """K6's twin against the JAX package's mimc_hash2 (its composed path:
    on the CPU it costs the same as the Pallas kernel in interpret mode),
    edge values included; the published MiMC7 vectors through the port's
    oracle copy, the composed mimc7 and mimc7_multi with a key (MultiMiMC7
    over [12, 45, 78, 41] continues from the K6 hash of (12, 45))."""
    rng = np.random.default_rng(34)
    xs, ys = rand_ints(rng, 128), rand_ints(rng, 128)
    xs[:4] = [0, 1, FR.p - 1, 12]
    ys[:4] = [FR.p - 1, 0, FR.p - 1, 45]
    got = phash.mimc_hash2(FR.encode(xs), FR.encode(ys))
    assert same(got, jhash.mimc_hash2(jnp.asarray(JFR.encode(xs)), jnp.asarray(JFR.encode(ys))))
    assert FR.decode(got[:4]) == [ohash.mimc7_multi([x, y]) for x, y in zip(xs[:4], ys[:4])]
    assert pohash.mimc7(12, 45) == MIMC7_12_45
    assert pohash.mimc7_multi([12, 45, 78, 41]) == MULTI_MIMC7_12_45_78_41
    assert FR.decode(phash.mimc7(FR.encode([12]), FR.encode([45]))) == [MIMC7_12_45]
    rest = phash.mimc7_multi([FR.encode([78]), FR.encode([41])], key=got[3:4])
    assert FR.decode(rest) == [MULTI_MIMC7_12_45_78_41]


def test_mimc_trees_match_jax():
    """Depth 4: the sparse MiMC tree against JAX's (zero-subtree hashes, a
    partial batch insert, the host oracle's root); the dense tree over the
    same leaves (zeros elsewhere) against the JAX tree's heap rows; paths
    against JAX's merkle_path; verify_path against JAX's, accepting three
    paths and rejecting a tampered leaf."""
    depth = 4
    rng = np.random.default_rng(35)
    idx = [1, 6, 7, 12]
    vals = rand_ints(rng, len(idx))
    vals[:2] = [0, FR.p - 1]
    jt, pt = JTree(depth, "mimc"), SparseMerkleTree(depth, "mimc", device="cpu")
    assert same(pt.nodes, jt.nodes)
    assert pt.zero_hashes == zero_hashes(depth, "mimc") == jmerkle.zero_hashes(depth, "mimc")
    jt.insert_ints(idx, vals)
    pt.insert_ints(idx, vals)
    assert same(pt.nodes, jt.nodes)
    assert pt.root_int() == oracle_sparse_root(dict(zip(idx, vals)), depth, "mimc")
    assert pt.root_int() == jmerkle.oracle_sparse_root(dict(zip(idx, vals)), depth, "mimc")

    leaves = torch.zeros(1 << depth, FR.L, dtype=torch.int32)
    leaves[idx] = FR.encode(vals)
    levels = build_levels(leaves, "mimc")
    heap = np.asarray(jt.nodes)
    jlevels = [heap[1 << (depth - l):2 << (depth - l)] for l in range(depth + 1)]
    for got, want in zip(levels, jlevels):
        assert same(got, want)
    probe = [6, 12, 3]
    sibs, bits = merkle_path(levels, probe)
    jsibs, jbits = jmerkle.merkle_path([jnp.asarray(v) for v in jlevels], jnp.asarray(probe))
    assert same(sibs, jsibs)
    assert same(bits, jbits)
    leaf = leaves[probe].clone()
    leaf[2, 0] ^= 1                      # tamper with the third path's leaf
    ok = verify_path(leaf, sibs, bits, levels[-1][0], "mimc")
    assert ok.tolist() == [True, True, False]
    jleaf = jnp.asarray(leaf.numpy().astype(np.uint32))
    jok = jmerkle.verify_path(jleaf, jsibs, jbits, jnp.asarray(jlevels[-1][0]), "mimc")
    assert np.asarray(jok).tolist() == ok.tolist()


def test_mimc_gadget_matches_oracle():
    rng = np.random.default_rng(36)
    x, k = rand_ints(rng, 2)
    b = Builder()
    out = gadgets.mimc7_gadget(b, b.priv(x), b.priv(k))
    multi = gadgets.mimc7_multi_gadget(b, [b.priv(12), b.priv(45), b.priv(78), b.priv(41)])
    assert b.check()
    assert out.eval(b.witness()) == pohash.mimc7(x, k) == ohash.mimc7(x, k)
    assert multi.eval(b.witness()) == MULTI_MIMC7_12_45_78_41
