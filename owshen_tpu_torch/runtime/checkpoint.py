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
card unless the caller asks for the CPU).

The files are the JAX package's: a tree, a store or a pool saved by either
package loads in the other.  Limb arrays are written as uint32, its dtype,
and read as either uint32 or int32; the prover tables are written under its
keys and in its layout (`n`, `has_k`, the G1 group's tables one after
another in `g1_rows`, the G2 table as a point tuple in `b2_table`); and the
pool's host record is read through `_PoolUnpickler`, which maps the JAX
package's VerifyingKey to the port's without importing that package.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from ..config import resolve_device
from ..ops.merkle import SparseMerkleTree
from .store import open_store


def _u32(t: torch.Tensor) -> np.ndarray:
    """An int32 limb tensor (values < 2^16) -> uint32 numpy, the JAX
    package's dtype (the same bits, no copy on the host)."""
    return t.detach().contiguous().cpu().numpy().view(np.uint32)


def _i32(a, device) -> torch.Tensor:
    """A uint32 or int32 limb array -> int32 tensor on `device`."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.astype(np.int32, copy=False)).to(device)


def _to_host(pt):
    """Tuple of tensors -> tuple of uint32 numpy arrays (None passes)."""
    return None if pt is None else tuple(_u32(a) for a in pt)


def _to_device(pt, device: torch.device):
    return None if pt is None else tuple(_i32(a, device) for a in pt)


# The classes of the JAX package that a pool's host record holds, and the
# port's class each one loads as.  The JAX VerifyingKey is a dataclass of
# host ints with the port's fields.
_JAX_CLASSES = {("owshen_tpu.groth16.groth16", "VerifyingKey"):
                ("owshen_tpu_torch.groth16.groth16", "VerifyingKey")}


class _PoolUnpickler(pickle.Unpickler):
    """Loads a host record written by either package without importing the
    JAX package: its classes map to the port's (`_JAX_CLASSES`), and any
    other class of it is refused by name."""

    def find_class(self, module, name):
        if module == "owshen_tpu" or module.startswith("owshen_tpu."):
            if (module, name) not in _JAX_CLASSES:
                raise pickle.UnpicklingError(
                    f"{module}.{name}: a class of the JAX package with no "
                    "counterpart in the port's checkpoints")
            module, name = _JAX_CLASSES[(module, name)]
        return super().find_class(module, name)


def _load_host(raw: bytes):
    return _PoolUnpickler(io.BytesIO(raw)).load()


def save_tree(store, tree: SparseMerkleTree, key: bytes = b"smt"):
    meta = {"depth": tree.depth, "hash_name": tree.hash_name}
    store.put(key + b"/meta", pickle.dumps(meta))
    store.put(key + b"/nodes", pickle.dumps(_u32(tree.nodes)))


def load_tree(store, key: bytes = b"smt", device=None) -> SparseMerkleTree:
    meta = pickle.loads(store.get(key + b"/meta"))
    nodes = _i32(pickle.loads(store.get(key + b"/nodes")), "cpu")
    return SparseMerkleTree(meta["depth"], meta["hash_name"], device=device, _nodes=nodes)


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
    build is the first prove's largest cost, in the JAX package's payload.
    Only tables already built are saved, unless build=True.  Returns True
    if saved."""
    from ..groth16.groth16 import _fixed_tables
    from ..ops.msm_fixed import _to_table_major

    fx = getattr(pk, "_fixed", None)
    if fx is None and build:
        fx = _fixed_tables(pk)
    if fx is None:
        return False
    payload = {"n": fx.n, "has_k": fx.has_k,
               "g1_rows": _u32(_to_table_major(fx.g1.rows, fx.g1.n_tables)),
               "g1_meta": fx.g1.meta, "g1_c": fx.g1.c,
               "b2_table": _to_host(fx.b2.table), "b2_c": fx.b2.c}
    _put_blob(store, key, pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
    return True


def load_prover_tables(store, pk, key: bytes = b"fxtab") -> bool:
    """Attach checkpointed fixed tables, saved by either package, to a
    ProvingKey on the key's device (no build).  Returns False when the
    store holds none under `key`."""
    from ..curves import bn254
    from ..groth16.groth16 import restore_fixed_tables
    from ..ops.msm_fixed import FixedMsm, FixedMsmGroup, _from_table_major

    raw = _get_blob(store, key)
    if raw is None:
        return False
    p = pickle.loads(raw)
    dev = pk.device
    n, n_tables, widths, shapes = p["g1_meta"]
    meta = (n, n_tables, list(widths), [tuple(s) for s in shapes])
    rows = _from_table_major(_i32(p["g1_rows"], dev), n, n_tables, p["g1_c"])
    g1 = FixedMsmGroup.from_rows(bn254.G1, rows, meta, c=p["g1_c"])
    b2 = FixedMsm.from_table(bn254.G2, _to_device(p["b2_table"], dev), c=p["b2_c"])
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
            "undo": [{**rec, "prior": _u32(rec["prior"])} for rec in pool._undo],
        }
        store.put(b"pool/host", pickle.dumps(host))
        save_proving_key(store, pool.pk)
        save_prover_tables(store, pool.pk)
        store.commit()


def load_pool(path: str, device=None):
    """Resume a PrivacyPool saved by either package on `device` (the card
    unless the caller asks for the CPU) without a trusted setup or a replay
    of inserts."""
    from ..protocol.pool import PrivacyPool

    dev = resolve_device(device)
    with open_store(path) as store:
        host = _load_host(store.get(b"pool/host"))
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
        pool._undo = [{**rec, "prior": _i32(rec["prior"], dev)} for rec in host["undo"]]
    return pool
