"""Checkpoint and resume of pool state and proving keys, after
owshen_tpu/runtime/checkpoint.py.

The Owshen node keeps its chain state in LevelDB (src/db/disk.rs:26-35), so
a restart resumes at the persisted height.  The port's live state is
tensors on the card (the tree's node heap, the proving key's points, the
fixed prover tables) plus host guard sets; this module writes all of it
through the KV store (runtime/store.py), so that a restarted process
resumes with the same root, guards and undo log, and proves from the
reloaded key without rebuilding its tables.

Each object is one KV entry (a pickled numpy or host payload); a commit
after the writes makes the checkpoint atomic.  Tensors go to host numpy on
save and, on load, to the device that `resolve_device(device)` gives (the
card unless the caller asks for the CPU).  The tree's nodes are written as
uint32, the JAX package's dtype, so that a tree saved by either package
loads in the other with the same limbs.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..config import resolve_device
from ..ops.merkle import SparseMerkleTree
from .store import open_store


def _to_host(pt):
    """Tuple of tensors -> tuple of int32 numpy arrays (None passes)."""
    return None if pt is None else tuple(a.detach().cpu().numpy() for a in pt)


def _to_device(pt, device: torch.device):
    return None if pt is None else tuple(torch.from_numpy(np.asarray(a, np.int32)).to(device)
                                         for a in pt)


def save_tree(store, tree: SparseMerkleTree, key: bytes = b"smt"):
    meta = {"depth": tree.depth, "hash_name": tree.hash_name}
    store.put(key + b"/meta", pickle.dumps(meta))
    store.put(key + b"/nodes", pickle.dumps(tree.nodes.cpu().numpy().astype(np.uint32)))


def load_tree(store, key: bytes = b"smt", device=None) -> SparseMerkleTree:
    meta = pickle.loads(store.get(key + b"/meta"))
    nodes = np.asarray(pickle.loads(store.get(key + b"/nodes")), np.int32)
    return SparseMerkleTree(meta["depth"], meta["hash_name"], device=device,
                            _nodes=torch.from_numpy(nodes))


def save_proving_key(store, pk, key: bytes = b"pk"):
    """ProvingKey: point tuples to host arrays, ints as they are, one blob."""
    payload = {f: (v if isinstance(v, (int, type(None))) else _to_host(v))
               for f in pk.__dataclass_fields__ for v in [getattr(pk, f)]}
    store.put(key, pickle.dumps(payload))


def load_proving_key(store, key: bytes = b"pk", device=None):
    from ..groth16.groth16 import ProvingKey

    dev = resolve_device(device)
    payload = pickle.loads(store.get(key))
    return ProvingKey(**{k: (_to_device(v, dev) if isinstance(v, tuple) else v)
                         for k, v in payload.items()})


_BLOB_CHUNK = 256 << 20


def _put_blob(store, key: bytes, data: bytes):
    """Store a blob of any size as chunks of at most 256 MB: the log rejects
    records of 1 GB and more (its replay guard would discard the batch)."""
    n = (len(data) + _BLOB_CHUNK - 1) // _BLOB_CHUNK or 1
    store.put(key + b"/n", str(n).encode())
    for i in range(n):
        store.put(key + b"/%d" % i, data[i * _BLOB_CHUNK:(i + 1) * _BLOB_CHUNK])


def _get_blob(store, key: bytes) -> bytes | None:
    raw = store.get(key + b"/n")
    if raw is None:
        return None
    return b"".join(store.get(key + b"/%d" % i) for i in range(int(raw)))


def save_prover_tables(store, pk, key: bytes = b"fxtab", build: bool = False) -> bool:
    """Persist the fixed prover MSM tables, deterministic derived data whose
    build is the first prove's largest cost.  Only tables already built are
    saved, unless build=True.  Returns True if saved."""
    from ..groth16.groth16 import _fixed_tables

    fx = getattr(pk, "_fixed", None)
    if fx is None and build:
        fx = _fixed_tables(pk)
    if fx is None:
        return False
    payload = {"g1_rows": fx.g1.rows.cpu().numpy(), "g1_meta": fx.g1.meta, "g1_c": fx.g1.c,
               "b2_rows": fx.b2.rows.cpu().numpy(), "b2_meta": fx.b2.meta, "b2_c": fx.b2.c}
    _put_blob(store, key, pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
    return True


def load_prover_tables(store, pk, key: bytes = b"fxtab") -> bool:
    """Attach checkpointed fixed tables to a ProvingKey on the key's device
    (no build).  Returns False when the store holds none under `key`."""
    from ..curves import bn254
    from ..groth16.groth16 import restore_fixed_tables
    from ..ops.msm_fixed import FixedMsm, FixedMsmGroup

    raw = _get_blob(store, key)
    if raw is None:
        return False
    p = pickle.loads(raw)
    dev = pk.device
    g1 = FixedMsmGroup.from_rows(bn254.G1, torch.from_numpy(p["g1_rows"]).to(dev),
                                 p["g1_meta"], c=p["g1_c"])
    b2 = FixedMsm.from_rows(bn254.G2, torch.from_numpy(p["b2_rows"]).to(dev),
                            p["b2_meta"], c=p["b2_c"])
    restore_fixed_tables(pk, g1, b2)
    return True


def save_pool(pool, path: str):
    """Checkpoint a PrivacyPool: tree, counters, guard sets, keys, the undo
    log, and the fixed prover tables when already built."""
    with open_store(path) as store:
        save_tree(store, pool.tree)
        host = {
            "depth": pool.depth,
            "next_index": pool.next_index,
            "deposited": sorted(pool.deposited),
            "minted": sorted(pool.minted),
            "nullifiers": sorted(pool.nullifiers),
            "executed": sorted(pool.executed),
            "balances": dict(pool.balances),
            "roots": list(pool.roots),
            "vk": pool.vk,
            "seq_pub": pool.seq_pub,
            "seq_priv": pool._seq_priv,
            # per-batch inverse deltas, so a rollback survives a restart (the
            # node persists Key::Delta per block, src/blockchain/mod.rs:284-287)
            "undo": [{**rec, "prior": rec["prior"].cpu().numpy()} for rec in pool._undo],
        }
        store.put(b"pool/host", pickle.dumps(host))
        save_proving_key(store, pool.pk)
        save_prover_tables(store, pool.pk)
        store.commit()


def load_pool(path: str, device=None):
    """Resume a PrivacyPool on `device` (the card unless the caller asks for
    the CPU) without a trusted setup or a replay of inserts."""
    from ..protocol.pool import PrivacyPool

    dev = resolve_device(device)
    with open_store(path) as store:
        host = pickle.loads(store.get(b"pool/host"))
        pool = PrivacyPool.__new__(PrivacyPool)
        pool.depth = host["depth"]
        pool.device = dev
        pool.tree = load_tree(store, device=dev)
        pool.next_index = host["next_index"]
        pool.deposited = set(host["deposited"])
        pool.minted = set(host["minted"])
        pool.nullifiers = set(host["nullifiers"])
        pool.executed = set(host["executed"])
        pool.balances = dict(host["balances"])
        pool.roots = list(host["roots"])
        pool.vk = host["vk"]
        pool.seq_pub = host["seq_pub"]
        pool._seq_priv = host["seq_priv"]
        pool.pk = load_proving_key(store, device=dev)
        load_prover_tables(store, pool.pk)
        pool._undo = [{**rec, "prior": torch.from_numpy(rec["prior"]).to(dev)}
                      for rec in host["undo"]]
    return pool
