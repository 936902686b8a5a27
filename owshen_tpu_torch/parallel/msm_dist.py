"""The MSM across a mesh, after owshen_tpu/parallel/msm_dist.py.

Σᵢ kᵢ·Pᵢ = Σ_shards Σ_{i∈shard} kᵢ·Pᵢ: each shard runs the whole Pippenger
pipeline (`ops.msm.msm`) on its 1/d of the points, the d projective
partials are gathered (three field elements each), and the sum is a
halving tree of complete adds (`Weierstrass.sum_reduce`): EC addition is
not a ring sum, so the reduce is an explicit gather and local adds.
"""

from __future__ import annotations

import functools

from ..ops.msm import msm
from .mesh import Mesh, gather, on, shard_leading


def msm_dist(mesh: Mesh, curve, points, scalars, c: int = 8,
             n_bits: int = 256, lanes: int = 1024):
    """Distributed MSM.  points: projective tuple of [n, ...] leaves;
    scalars: canonical int32[n, 16]; n divisible by the mesh size.
    Returns one projective point on the device of `scalars`: every
    shard's partial gathered there and summed (the reference's replicated
    result, read once by the controller)."""
    parts = []
    for dev, pts, sc in zip(mesh.devices, shard_leading(mesh, points),
                            shard_leading(mesh, scalars)):
        with on(dev):
            parts.append(tuple(a[None] for a in msm(curve, pts, sc, c=c, n_bits=n_bits,
                                                    lanes=lanes)))
    with on(scalars.device):
        return curve.sum_reduce(gather(parts, scalars.device))


def msm_dist_jit(mesh: Mesh, curve, c: int = 8, n_bits: int = 256, lanes: int = 1024):
    """The reference's compiled closure; eager PyTorch compiles nothing, so
    this is the call with its parameters bound."""
    return functools.partial(msm_dist, mesh, curve, c=c, n_bits=n_bits, lanes=lanes)
