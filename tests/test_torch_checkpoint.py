"""Port vs reference: the KV store (runtime/store.py over native/store.cc)
and checkpoints (runtime/checkpoint.py).

Files are read across packages: a store written by the port's engine is
read by owshen_tpu.runtime.store's and the reverse (the same puts give the
same bytes on disk), and a tree saved by either package's save_tree loads
in the other's with the same limbs.  The JAX engine's library is built
into the test's own directory, so this file never races the JAX package's
tests for its build.  The pool checkpoint runs on the CPU at depth 2 with a
tiny circuit's port keys; its prover tables are seeded rows, since a table
build on the CPU twins takes minutes (chip_smoke.py resumes the depth-16
pool on the card and proves from its restored tables).  Equality is exact
throughout."""

import dataclasses
import os
import pickle
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.groth16 import groth16 as jgroth16
from owshen_tpu.oracle import curve as ocurve
from owshen_tpu.ops import merkle as jmerkle
from owshen_tpu.runtime import checkpoint as jcheckpoint
from owshen_tpu.runtime import store as jstore
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.groth16.r1cs import Builder
from owshen_tpu_torch.ops.merkle import SparseMerkleTree, oracle_sparse_root
from owshen_tpu_torch.ops.msm_fixed import FixedMsm, FixedMsmGroup
from owshen_tpu_torch.protocol.pool import PrivacyPool
from owshen_tpu_torch.runtime import checkpoint, store

torch.set_num_threads(1)

DEPTH = 2


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native engine, its library built under tmp_path."""
    monkeypatch.setattr(jstore, "_SO", str(tmp_path / "jax_store.so"))
    monkeypatch.setattr(jstore, "_lib", None)
    monkeypatch.setattr(jstore, "_lib_failed", False)
    if jstore._load_lib() is None or store._load_lib() is None:
        pytest.skip("no g++: the native engines cannot be built")
    return jstore


def write_batches(st):
    st.put(b"a", b"1")
    st.put(b"b", bytes(range(256)) * 3)
    st.put(b"c", b"")
    st.commit()
    st.put(b"a", b"overwritten")
    st.delete(b"b")
    st.put(b"k" * 70, b"\x00" * 100)
    st.commit()


def contents(st):
    return {k: st.get(k) for k in st.keys()}


def test_store_files_read_across_packages(tmp_path, jax_native):
    assert os.path.dirname(store._SO).endswith(os.path.join("owshen_tpu_torch", "kernels", "_build"))
    for ours, theirs in ((store.NativeKvStore, jstore.NativeKvStore),
                         (store.PyKvStore, jstore.PyKvStore)):
        mine, ref = str(tmp_path / f"{ours.__name__}.port"), str(tmp_path / f"{ours.__name__}.jax")
        with ours(mine) as st:
            write_batches(st)
        with theirs(ref) as st:
            write_batches(st)
        if ours is store.NativeKvStore:
            with open(mine, "rb") as f1, open(ref, "rb") as f2:
                assert f1.read() == f2.read()          # the same log, byte for byte
        with theirs(mine) as st1, ours(ref) as st2:
            want = {b"a": b"overwritten", b"c": b"", b"k" * 70: b"\x00" * 100}
            assert contents(st1) == contents(st2) == want


@pytest.mark.parametrize("engine", ["native", "py"])
def test_store_contract(tmp_path, engine):
    cls = store.NativeKvStore if engine == "native" else store.PyKvStore
    if engine == "native" and store._load_lib() is None:
        pytest.skip("no g++: the native engine cannot be built")
    path = str(tmp_path / f"{engine}.db")
    st = cls(path)
    for call in (lambda: st.put(b"", b"v"), lambda: st.delete(b"")):
        with pytest.raises(ValueError, match="empty keys"):
            call()

    class _FakeLen(bytes):
        def __len__(self):
            return store.MAX_RECORD

    with pytest.raises(ValueError, match="chunk large blobs"):
        st.put(b"k", _FakeLen(b"v"))
    st.put(b"committed", b"yes")
    st.commit()
    st.put(b"pending", b"no")
    with pytest.raises(IOError, match="pending"):
        st.compact()                                  # refuses while dirty
    st.close()                                        # discards the pending put
    st = cls(path)
    assert contents(st) == {b"committed": b"yes"}
    st.put(b"second", b"batch")
    st.commit()
    st.compact()
    want = {b"committed": b"yes", b"second": b"batch"}
    assert contents(st) == want
    st.put(b"third", b"torn")
    st.commit()
    st.close()
    if engine == "native":
        # a torn tail: the last batch's commit marker sheared off mid-write
        with open(path, "r+b") as fh:
            fh.seek(0, os.SEEK_END)
            fh.truncate(fh.tell() - 5)
        with cls(path) as st:
            assert contents(st) == want


def test_tree_files_load_across_packages(tmp_path, jax_native):
    rng = random.Random(9)
    tree = SparseMerkleTree(DEPTH, device="cpu")
    entries = {i: rng.randrange(FR.p) for i in (0, 3)}
    tree.insert_ints(list(entries), list(entries.values()))
    with store.open_store(str(tmp_path / "port.db")) as st:
        checkpoint.save_tree(st, tree)
        st.commit()
    with jstore.open_store(str(tmp_path / "port.db")) as st:
        jtree = jcheckpoint.load_tree(st)
        port_record = st.get(b"smt/nodes")
    assert jtree.depth == DEPTH and jtree.nodes.dtype == jnp.uint32
    assert np.array_equal(np.asarray(jtree.nodes).astype(np.int32), tree.nodes.numpy())
    assert jtree.root_int() == tree.root_int() == oracle_sparse_root(entries, DEPTH)
    # the reverse: a JAX tree (nodes set directly) saved by the JAX package
    jt = jmerkle.SparseMerkleTree.__new__(jmerkle.SparseMerkleTree)
    jt.depth, jt.hash_name = DEPTH, "poseidon"
    jt.nodes = jnp.asarray(np.asarray(jtree.nodes)[::-1].copy())
    with jstore.open_store(str(tmp_path / "jax.db")) as st:
        jcheckpoint.save_tree(st, jtree)
        jcheckpoint.save_tree(st, jt, key=b"rev")
        st.commit()
    with store.open_store(str(tmp_path / "jax.db")) as st:
        assert st.get(b"smt/nodes") == port_record   # the same record, byte for byte
        back = checkpoint.load_tree(st, key=b"rev", device="cpu")
    assert back.nodes.dtype == torch.int32 and back.device == torch.device("cpu")
    assert np.array_equal(back.nodes.numpy(), np.asarray(jt.nodes).astype(np.int32))


def tiny_pool():
    """A depth-2 port pool on the CPU with a tiny circuit's keys, two
    deposit batches, a spent nullifier, and seeded rows standing in for
    built fixed tables: (pool, root after the first batch, commitments,
    G1 rows and meta, G2 rows and meta)."""
    b = Builder()
    for _ in range(5):
        b.pub()
    w = b.priv()
    b.enforce(w, w, w)
    pool = PrivacyPool(depth=DEPTH, keys=groth16.setup(b, seed=b"tiny-checkpoint", device="cpu"),
                       device="cpu")
    rng = random.Random(10)
    coms = [rng.randrange(FR.p) for _ in range(4)]
    pool.deposit(coms[:2], [0xD0, 0xD1], amounts=[3, 4])
    root_a = pool.tree.root_int()
    pool.deposit(coms[2:], [0xD2, 0xD3], amounts=[5, 7], tokens=[0, 8])
    pool.nullifiers.add(0x5EED)
    pool.executed.add(0x5EED)
    gen = torch.Generator().manual_seed(11)
    g1 = (torch.randint(0, 1 << 16, (64, 9, 2 * 4, 48), generator=gen, dtype=torch.int32),
          (4, 2, [16, 16, 16], [(16,)] * 3))
    b2 = (torch.randint(0, 1 << 16, (64, 9, 4, 96), generator=gen, dtype=torch.int32),
          (4, 1, [32, 32, 32], [(2, 16)] * 3))
    groth16.restore_fixed_tables(pool.pk, FixedMsmGroup.from_rows(bn254.G1, *g1),
                                 FixedMsm.from_rows(bn254.G2, *b2))
    return pool, root_a, coms, g1, b2


def assert_same_pool(got, pool, g1, b2):
    for attr in ("depth", "next_index", "deposited", "minted", "nullifiers", "executed",
                 "balances", "roots", "vk", "seq_pub", "_seq_priv", "device"):
        assert getattr(got, attr) == getattr(pool, attr), attr
    assert torch.equal(got.tree.nodes, pool.tree.nodes)
    for f in pool.pk.__dataclass_fields__:
        a, b = getattr(pool.pk, f), getattr(got.pk, f)
        assert (a == b) if not isinstance(a, tuple) else all(map(torch.equal, a, b)), f
    fx = got.pk._fixed
    assert torch.equal(fx.g1.rows, g1[0]) and torch.equal(fx.b2.rows, b2[0])
    assert (fx.g1.meta, fx.b2.meta) == (g1[1], b2[1])
    assert [(list(r["rows"]), r["count"]) for r in got._undo] == \
        [(list(r["rows"]), r["count"]) for r in pool._undo]
    assert all(torch.equal(r["prior"], s["prior"]) for r, s in zip(got._undo, pool._undo))


def test_pool_checkpoint_keeps_undo_log_and_tables(tmp_path, monkeypatch):
    pool, root_a, coms, g1, b2 = tiny_pool()
    monkeypatch.setattr(checkpoint, "_BLOB_CHUNK", 1 << 16)    # the tables span chunks
    path = str(tmp_path / "pool.db")
    checkpoint.save_pool(pool, path)
    with store.open_store(path) as st:
        assert int(st.get(b"fxtab/n")) > 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_pool(path)                    # the card unless the CPU is asked for
    got = checkpoint.load_pool(path, device="cpu")
    assert_same_pool(got, pool, g1, b2)
    # a pop after the reload restores the earlier root
    assert got.pop_batch() == 2
    assert got.tree.root_int() == root_a == oracle_sparse_root(dict(enumerate(coms[:2])), DEPTH)
    assert got.balances == {0: 7, 8: 0}


def reference_tables(point_sets, c: int = 4):
    """Fixed tables in the JAX package's own objects, built on the host
    with no jit: table[w, d] = d·2^(c·w)·P (`build_table`'s definition) for
    each G1 set, its (W, D, n) points encoded by the JAX package's
    `g1_encode`, flattened by its `_flat_rows` and stacked set after set as
    its FixedMsmGroup does; the G2 table is seeded placeholder limbs.
    Returns a stand-in key whose `_fixed` its save_prover_tables writes."""
    from types import SimpleNamespace

    from owshen_tpu.curves import bn254 as jbn254
    from owshen_tpu.ops import msm_fixed as jmsm_fixed
    from owshen_tpu.ops.msm import _flat_rows

    W, D, n = 256 // c, (1 << (c - 1)) + 1, len(point_sets[0])
    tabs = []
    for pts in point_sets:
        table = [[None] * n for _ in range(W * D)]          # row (w·D + d), point i
        for i, base in enumerate(pts):
            for w in range(W):
                acc = None
                for d in range(D):
                    table[w * D + d][i] = acc
                    acc = ocurve.G1.add(acc, base)
                for _ in range(c):
                    base = ocurve.G1.add(base, base)
        rows, widths, shapes = _flat_rows(jbn254.g1_encode([p for row in table for p in row]))
        tabs.append(rows)
    g1 = jmsm_fixed.FixedMsmGroup.from_rows(
        jbn254.G1, jnp.concatenate(tabs), (n, len(tabs), widths, shapes), c=c)
    gen = np.random.default_rng(12)
    b2 = jmsm_fixed.FixedMsm.from_table(jbn254.G2, tuple(
        jnp.asarray(gen.integers(0, 1 << 16, (W, D, n, 2, 16), dtype=np.uint32))
        for _ in range(3)), c=c)
    return SimpleNamespace(_fixed=SimpleNamespace(n=n, has_k=False, g1=g1, b2=b2))


def test_pool_files_load_across_packages(tmp_path, jax_native, monkeypatch):
    """A pool saved by the port has the JAX package's keys, layout and
    uint32 dtypes, and the JAX package's load_pool reads it; saved again by
    the JAX package, with its own VerifyingKey, it loads in the port with
    every owshen_tpu module made unimportable, equal to the pool saved; a
    host record holding any other class of the JAX package is refused by
    name.  Fixed G1 tables of real points (two sets of two), saved by the
    JAX package's save_prover_tables, load in the port and its mul_multi
    gives the oracle's MSMs."""
    pool, _, _, g1, b2 = tiny_pool()
    port_path, jax_path = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    checkpoint.save_pool(pool, port_path)
    with jstore.open_store(port_path) as st:
        tables = pickle.loads(jcheckpoint._get_blob(st, b"fxtab"))
        pk_payload = pickle.loads(st.get(b"pk"))
        undo = pickle.loads(st.get(b"pool/host"))["undo"]
    assert set(tables) == {"n", "has_k", "g1_rows", "g1_meta", "g1_c", "b2_table", "b2_c"}
    assert (tables["n"], tables["has_k"]) == (pool.pk._fixed.n, pool.pk._fixed.has_k)
    # the reference's layout: table t's row (w, d, i) at t·W·D·n + (w·D + d)·n + i
    want = g1[0].view(64, 9, 2, 4, 48).permute(2, 0, 1, 3, 4).reshape(-1, 48)
    assert tables["g1_rows"].dtype == np.uint32
    assert np.array_equal(tables["g1_rows"].astype(np.int32), want.numpy())
    assert [a.shape for a in tables["b2_table"]] == [(64, 9, 4, 2, 16)] * 3
    arrays = list(tables["b2_table"]) + [r["prior"] for r in undo] \
        + [a for v in pk_payload.values() if isinstance(v, tuple) for a in v]
    assert all(a.dtype == np.uint32 for a in arrays)
    jpool = jcheckpoint.load_pool(port_path)
    assert jpool.tree.root_int() == pool.tree.root_int()
    assert np.array_equal(np.asarray(jpool.pk._fixed.g1.rows), tables["g1_rows"])
    jpool.vk = jgroth16.VerifyingKey(**dataclasses.asdict(pool.vk))
    jcheckpoint.save_pool(jpool, jax_path)
    bad_path = str(tmp_path / "bad.db")
    with store.open_store(bad_path) as st:
        st.put(b"pool/host", pickle.dumps({"depth": DEPTH, "vk": jgroth16.Proof(None, None, None)}))
        st.commit()
    rng = random.Random(13)
    sets = [[ocurve.G1.mul(ocurve.G1_GEN, rng.randrange(1, FR.p)) for _ in range(2)]
            for _ in range(2)]
    scalars = [[rng.randrange(FR.p) for _ in range(2)] for _ in range(3)]
    slots = (0, 1, 1)
    table_path = str(tmp_path / "tables.db")
    with jstore.open_store(table_path) as st:
        assert jcheckpoint.save_prover_tables(st, reference_tables(sets))
        st.commit()

    for name in [m for m in sys.modules if m == "owshen_tpu" or m.startswith("owshen_tpu.")]:
        monkeypatch.setitem(sys.modules, name, None)
    got = checkpoint.load_pool(jax_path, device="cpu")
    assert type(got.vk) is groth16.VerifyingKey
    assert_same_pool(got, pool, g1, b2)
    with pytest.raises(pickle.UnpicklingError, match=r"owshen_tpu\.groth16\.groth16\.Proof"):
        checkpoint.load_pool(bad_path, device="cpu")
    with store.open_store(table_path) as st:
        assert checkpoint.load_prover_tables(st, got.pk)
    sums = got.pk._fixed.g1.mul_multi(torch.stack([FR.encode(k, mont=False) for k in scalars]),
                                      slots)
    assert bn254.g1_decode(sums) == [ocurve.G1.msm(sets[t], k) for t, k in zip(slots, scalars)]
