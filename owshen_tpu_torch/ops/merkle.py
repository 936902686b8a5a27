"""Merkle trees over BN254 Fr, after owshen_tpu/ops/merkle.py.

* `build_levels` / `merkle_root`: the dense bottom-up tree (BASELINE
  config 1: MiMC7, 20 levels), one node-hash launch per level (K6 for
  "mimc", K4 for "poseidon").
* `merkle_path` / `verify_path`: batched authentication paths.
* `SparseMerkleTree`: the sparse tree of deposit commitments, one
  int32[2^(depth+1), 16] tensor in binary-heap layout on its device: root at
  node 1, leaf i at node 2^depth + i, children of j at 2j and 2j + 1;
  untouched subtrees hold their zero-subtree hash.  A batch insert scatters
  k leaves, then walks up `depth` levels, each one node-hash launch over the
  k parents and one scatter (sibling leaves recompute the same parent
  redundantly, with identical values)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..fields.field import FR
from ..oracle import hash as ohash
from .hash import mimc_hash2, poseidon_hash2

HASH2 = {"poseidon": poseidon_hash2, "mimc": mimc_hash2}
HASH2_ORACLE = {
    "poseidon": lambda l, r: ohash.poseidon([l, r]),
    "mimc": lambda l, r: ohash.mimc7_multi([l, r]),
}


@functools.lru_cache(maxsize=None)
def zero_hashes(depth: int, hash_name: str = "poseidon") -> tuple[int, ...]:
    """zero_hashes[l] = root of an all-zero subtree of height l (host ints)."""
    h2 = HASH2_ORACLE[hash_name]
    out = [0]
    for _ in range(depth):
        out.append(h2(out[-1], out[-1]))
    return tuple(out)


def build_levels(leaves: torch.Tensor, hash_name: str = "poseidon") -> list[torch.Tensor]:
    """Dense tree: leaves int32[n, 16] (Montgomery, n a power of two) ->
    [leaves, ..., root level int32[1, 16]]."""
    n = leaves.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} leaves: a dense tree needs a power of two")
    h2 = HASH2[hash_name]
    levels = [leaves]
    x = leaves
    while x.shape[0] > 1:
        x = h2(x[0::2], x[1::2])
        levels.append(x)
    return levels


def merkle_root(leaves: torch.Tensor, hash_name: str = "poseidon") -> torch.Tensor:
    """Root int32[16] of the dense tree over int32[n, 16] Montgomery leaves."""
    return build_levels(leaves, hash_name)[-1][0]


def merkle_path(levels: list[torch.Tensor], indices):
    """Authentication paths of a batch of leaf indices in a dense tree
    (`build_levels`' output): (siblings int32[k, depth, 16], bits
    int32[k, depth]); bits[i, l] = 1 iff the node is the right child at
    level l."""
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=levels[0].device)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= levels[0].shape[0]):
        raise ValueError("leaf index out of range")
    sibs, bits = [], []
    for lvl in levels[:-1]:
        sibs.append(lvl[idx ^ 1])
        bits.append((idx & 1).to(torch.int32))
        idx = idx >> 1
    return torch.stack(sibs, dim=1), torch.stack(bits, dim=1)


def verify_path(leaf, siblings, bits, root, hash_name: str = "poseidon") -> torch.Tensor:
    """Recompute the root from (leaf int32[k, 16], siblings int32[k, depth,
    16], bits int32[k, depth]) and compare with root (int32[16] or
    int32[k, 16]): bool[k]."""
    h2 = HASH2[hash_name]
    node = leaf
    for l in range(siblings.shape[1]):
        sib = siblings[:, l]
        right = bits[:, l] != 0
        node = h2(FR.select(right, sib, node), FR.select(right, node, sib))
    return FR.eq(node, root)


class SparseMerkleTree:
    """Fixed-depth sparse Merkle tree (Poseidon or MiMC node hash) stored
    densely on a device."""

    def __init__(self, depth: int, hash_name: str = "poseidon", device=None, _nodes=None):
        self.depth = depth
        self.hash_name = hash_name
        self.device = resolve_device(device)
        self.zero_hashes = zero_hashes(depth, hash_name)
        if _nodes is not None:
            if _nodes.shape != (1 << (depth + 1), FR.L):
                raise ValueError(f"nodes of shape {tuple(_nodes.shape)} do not "
                                 f"fit depth {depth}")
            self.nodes = _nodes.to(self.device, torch.int32)
            return
        zh = FR.encode(list(self.zero_hashes))
        level = torch.zeros(1 << (depth + 1), dtype=torch.int64)
        for l in range(depth + 1):
            lo = 1 << (depth - l)
            level[lo:2 * lo] = l
        self.nodes = zh[level].to(self.device)   # node j at level l holds zh[l]

    # ---------- batch insert ----------

    def batch_insert(self, indices, values: torch.Tensor) -> None:
        """indices: k leaf indices, UNIQUE within the batch; values:
        int32[k, 16] Montgomery.  Duplicates would race through the leaf
        scatter, so they are rejected: split them across calls."""
        host_idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        if len(np.unique(host_idx)) != host_idx.size:
            raise ValueError("batch_insert requires unique leaf indices within a batch")
        if host_idx.size and (host_idx.min() < 0 or host_idx.max() >= (1 << self.depth)):
            raise ValueError("leaf index out of range")
        h2 = HASH2[self.hash_name]
        j = torch.as_tensor(host_idx, device=self.device) + (1 << self.depth)
        nodes = self.nodes
        nodes[j] = values.to(self.device)
        for _ in range(self.depth):
            p = j >> 1
            nodes[p] = h2(nodes[p << 1], nodes[(p << 1) | 1])
            j = p

    def insert_ints(self, indices, values_int) -> None:
        self.batch_insert(indices, FR.encode(list(values_int), device=self.device))

    # ---------- reads ----------

    @property
    def root(self) -> torch.Tensor:
        return self.nodes[1]

    def root_int(self) -> int:
        return FR.decode(self.root)[0]

    def path(self, indices):
        """(siblings int32[k, depth, 16], bits int32[k, depth]); bits[i, l]
        = 1 iff the node is the right child at level l."""
        j = torch.as_tensor(np.asarray(indices, np.int64), device=self.device) \
            + (1 << self.depth)
        sibs, bits = [], []
        for _ in range(self.depth):
            sibs.append(self.nodes[j ^ 1])
            bits.append((j & 1).to(torch.int32))
            j = j >> 1
        return torch.stack(sibs, dim=1), torch.stack(bits, dim=1)

    def leaf(self, indices) -> torch.Tensor:
        j = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        return self.nodes[j + (1 << self.depth)]

    # ---------- inverse-delta support (undo of a batch) ----------

    def touched_rows(self, indices) -> np.ndarray:
        """Heap rows (deduplicated, host int64) that a batch insert at
        `indices` modifies: the leaves and every ancestor up to the root."""
        j = np.unique(np.asarray(indices, np.int64)) + (1 << self.depth)
        out = []
        for _ in range(self.depth + 1):
            out.append(j)
            j = np.unique(j >> 1)
        return np.unique(np.concatenate(out))

    def snapshot_rows(self, rows) -> torch.Tensor:
        """Prior values of the given heap rows."""
        return self.nodes[torch.as_tensor(np.asarray(rows, np.int64), device=self.device)]

    def restore_rows(self, rows, values: torch.Tensor) -> None:
        """Scatter prior values back into the given heap rows (the undo of
        a batch; reference pop_block, src/blockchain/mod.rs:291-315)."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        self.nodes[idx] = values.to(self.device, torch.int32)


def oracle_sparse_root(entries: dict[int, int], depth: int,
                       hash_name: str = "poseidon") -> int:
    """Pure-Python sparse root over {leaf_index: value} (host ints)."""
    h2 = HASH2_ORACLE[hash_name]
    zh = zero_hashes(depth, hash_name)
    level = dict(entries)
    for l in range(depth):
        nxt = {}
        for idx in {i >> 1 for i in level}:
            left = level.get(idx * 2, zh[l])
            right = level.get(idx * 2 + 1, zh[l])
            nxt[idx] = h2(left, right)
        level = nxt
    return level.get(0, zh[depth])
