"""The NTT across a mesh: the 4-step (Bailey) decomposition with one
all_to_all, after owshen_tpu/parallel/ntt_dist.py.

A length-n NTT over Fr factors as n = n1·n2 (the input viewed as an
[n1, n2] matrix, index i = i1·n2 + i2):

  A[k1, i2] = NTT_n1 over i1   (columns: local when i2 is sharded)
  B[k1, i2] = A · ω_n^{k1·i2}  (the twiddle, one K1 product)
  C[k1, k2] = NTT_n2 over i2   (rows: local after one all_to_all that
                                re-shards from i2-blocks to k1-blocks)
  X[k1 + n1·k2] = C[k1, k2]

Each shard's column and row transforms are `NttDomain._transform` (one K5
launch per stage), as in the reference; the output is gathered back in
natural order on the input's device.  Trailing axes between the transform
axis and the limbs are batch, as in `NttDomain`.
"""

from __future__ import annotations

import torch

from ..fields.field import FR, Field
from ..ops.ntt import NttDomain, powers_device
from .mesh import Mesh, all_to_all, gather, on, shard_leading


class DistNtt:
    """Radix-2 NTT / iNTT at n = 2^log_n over a 1-D mesh.  The mesh size d
    must divide n1 = 2^(log_n // 2) and n2 = n / n1."""

    def __init__(self, mesh: Mesh, log_n: int, field: Field = FR):
        self.mesh = mesh
        self.F = field
        self.log_n = log_n
        self.n = 1 << log_n
        self.log_n1 = log_n // 2
        self.n1 = 1 << self.log_n1
        self.n2 = self.n // self.n1
        d = mesh.size
        assert self.n1 % d == 0 and self.n2 % d == 0, (
            f"mesh size {d} must divide n1={self.n1} and n2={self.n2}")
        self.d = d
        self.dom1 = NttDomain(self.log_n1, field)
        self.dom2 = NttDomain(log_n - self.log_n1, field)
        p = field.p
        self.omega = pow(field.generator, (p - 1) >> log_n, p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(self.n, -1, p)
        self._twiddles: dict = {}

    def _twiddle(self, c: int, inverse: bool):
        """Shard c's ω^{k1·i2} block (n1, n2/d, 16) for its global i2,
        built once on the shard's device as the powers k1 of each column's
        ω^{i2}: log₂ n1 select-and-multiply steps over the block."""
        key = (c, inverse)
        tw = self._twiddles.get(key)
        if tw is None:
            F, dev, n2d = self.F, self.mesh.devices[c], self.n2 // self.d
            w = self.omega_inv if inverse else self.omega
            col = F.mul(powers_device(F, w, n2d, dev),
                        F.const(pow(w, c * n2d, F.p), device=dev))      # ω^{i2}
            k1 = torch.arange(self.n1, device=dev)[:, None]
            tw = F.const(1, device=dev).expand(self.n1, n2d, F.L).clone()
            for b in range(self.log_n1):
                tw = F.select(((k1 >> b) & 1) == 1, F.mul(tw, col), tw)
                col = F.mul(col, col)
            self._twiddles[key] = tw
        return tw

    def _run(self, x, inverse: bool):
        F, n1, n2, mesh = self.F, self.n1, self.n2, self.mesh
        if x.shape[0] != self.n or x.shape[-1] != F.L:
            raise ValueError(f"expected int32[{self.n}, ..., {F.L}], got {list(x.shape)}")
        batch = tuple(x.shape[1:-1])
        bones = (1,) * len(batch)
        pows = "pows_inv" if inverse else "pows"
        # i2-blocks: shard c holds columns [c·n2/d, (c+1)·n2/d) of [n1, n2]
        cols = shard_leading(mesh, x.reshape((n1, n2) + batch + (F.L,)).transpose(0, 1))
        blocks = []
        for c, (dev, blk) in enumerate(zip(mesh.devices, cols)):
            with on(dev):
                a = self.dom1._transform(blk.transpose(0, 1), self.dom1._table(pows, dev))
                tw = self._twiddle(c, inverse)
                blocks.append(F.mul(a, tw.reshape(tw.shape[:2] + bones + (F.L,))))
        # the transpose: i2-sharded [n1, n2/d] -> k1-sharded [n1/d, n2]
        blocks = all_to_all(mesh, blocks, split_dim=0, cat_dim=1)
        out = []
        for dev, blk in zip(mesh.devices, blocks):
            with on(dev):
                rows = self.dom2._transform(blk.transpose(0, 1), self.dom2._table(pows, dev))
                if inverse:
                    rows = F.mul(rows, F.const(self.n_inv, device=dev))
                out.append(rows)                    # [n2, n1/d]: columns of C^T
        # X[k1 + n1·k2] = C[k1, k2]: natural order is C^T [n2, n1] flattened
        return gather(out, x.device, dim=1).reshape(x.shape)

    def ntt(self, x):
        """x: int32[n, ..., 16] Montgomery, natural order -> NTT along
        axis 0, natural order, on x's device."""
        return self._run(x, inverse=False)

    def intt(self, x):
        return self._run(x, inverse=True)
