"""Merkle trees across a mesh, after owshen_tpu/parallel/merkle_dist.py.

Leaf i lives on shard i >> (depth − log₂ d): the top log₂ d address bits
select the shard, so each shard owns one contiguous dense subtree and
computes its root with no communication; the d subtree roots are gathered
(d field elements) and the top log₂ d levels are hashed once more.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.field import FR
from ..ops.merkle import HASH2, HASH2_ORACLE, SparseMerkleTree, build_levels
from .mesh import Mesh, gather, on, shard_leading


def _hash_tops(tops, hash_name: str):
    """Hash [d, 16] subtree roots up to the root [16]."""
    h2 = HASH2[hash_name]
    while tops.shape[0] > 1:
        tops = h2(tops[0::2], tops[1::2])
    return tops[0]


def merkle_root_dist(mesh: Mesh, leaves, hash_name: str = "poseidon"):
    """Distributed dense root.  leaves: int32[n, 16] Montgomery (n a power
    of two, n ≥ mesh size).  Returns the root int32[16] on the leaves'
    device."""
    roots = []
    for dev, shard in zip(mesh.devices, shard_leading(mesh, leaves)):
        with on(dev):
            roots.append(build_levels(shard, hash_name)[-1])     # [1, 16]
    with on(leaves.device):
        return _hash_tops(gather(roots, leaves.device), hash_name)


class DistSparseMerkleTree:
    """Sparse Merkle tree sharded by leaf-index prefix.

    Shard c owns the dense subtree of the 2^local_depth leaves whose top
    log₂ d address bits equal c: a port `SparseMerkleTree(local_depth)` on
    its device.  A batch is split by owner on the host and only the owners
    re-hash their paths; then the d subtree roots are gathered and the top
    log₂ d levels hashed (the reference scatters every shard's non-owned
    rows into an inert heap slot instead, to keep one shard_map body)."""

    def __init__(self, mesh: Mesh, depth: int, hash_name: str = "poseidon"):
        d = mesh.size
        self.d = d
        self.log_d = (d - 1).bit_length()
        assert 1 << self.log_d == d, "mesh size must be a power of two"
        assert depth > self.log_d
        self.depth = depth
        self.local_depth = depth - self.log_d
        self.hash_name = hash_name
        self.mesh = mesh
        self.trees = [SparseMerkleTree(self.local_depth, hash_name, device=dev)
                      for dev in mesh.devices]

    def _tops(self):
        return gather([t.nodes[1:2] for t in self.trees], self.mesh.devices[0])

    def batch_insert(self, indices, values):
        """indices: k global leaf indices, UNIQUE within the batch; values:
        int32[k, 16] Montgomery.  Returns the root int32[16] (on the first
        shard's device).

        Duplicate indices in one batch are rejected on the host, as in the
        reference; split duplicates across calls for last-wins."""
        host_idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        if len(np.unique(host_idx)) != host_idx.size:
            raise ValueError(
                "batch_insert requires unique leaf indices within a batch "
                "(split duplicates across calls for last-wins semantics)")
        if host_idx.size and (host_idx.min() < 0 or host_idx.max() >= (1 << self.depth)):
            raise ValueError("leaf index out of range")
        owner = host_idx >> self.local_depth
        local = host_idx & ((1 << self.local_depth) - 1)
        for c in np.unique(owner).tolist():
            sel = np.nonzero(owner == c)[0]
            tree, dev = self.trees[c], self.mesh.devices[c]
            with on(dev):
                tree.batch_insert(local[sel], values[torch.as_tensor(sel, device=values.device)].to(dev))
        with on(self.mesh.devices[0]):
            return _hash_tops(self._tops(), self.hash_name)

    def insert_ints(self, indices, values_int):
        return self.batch_insert(indices, FR.encode(list(values_int),
                                                    device=self.mesh.devices[0]))

    def root_int(self) -> int:
        """The root from the shards' subtree roots, hashed on the host."""
        vals = FR.decode(self._tops())
        h2o = HASH2_ORACLE[self.hash_name]
        while len(vals) > 1:
            vals = [h2o(vals[i], vals[i + 1]) for i in range(0, len(vals), 2)]
        return vals[0]
