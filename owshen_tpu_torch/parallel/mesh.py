"""The mesh: the port's counterpart of owshen_tpu/parallel/mesh.py.

The JAX package's mesh is single-controller SPMD: one Python program holds
a `jax.sharding.Mesh` and runs `shard_map` bodies on every device, with
all_gather / all_to_all between them.  The port keeps that model with
`torch.device` in place of `jax.Device`.  One process holds a `Mesh` of
shards, each with a device; shard-local work is launched shard by shard
(on a CUDA shard inside `torch.cuda.device`, so the kernels' wrappers find
their operands on the current device); each collective is an explicit copy
between shards (`Tensor.to`, peer to peer across cards) and a `torch.cat`.
Shards may share a device: d shards on one card run the real decomposition
and its kernels, and d shards on the CPU run the plain twins, with no
process group.  There is no `torch.distributed` here.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch

CHIP = "chip"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices[c]` is shard c's device (devices repeat when
    shards share one)."""

    devices: tuple
    axis: str = CHIP

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = CHIP, devices=None) -> Mesh:
    """1-D mesh of n shards over `devices` (default: every visible CUDA
    device; raises when there is none).  n defaults to the device count;
    a larger n lays the shards round robin over the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass devices= "
                               "(e.g. [torch.device('cpu')]) for a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = len(devices) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"make_mesh: {n} shards")
    return Mesh(tuple(devices[i % len(devices)] for i in range(n)), axis)


@functools.lru_cache(maxsize=None)
def default_mesh() -> Mesh:
    return make_mesh()


def on(device: torch.device):
    """The context a shard's launches run in: its card made current."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _map(fn, x):
    """fn over a tensor, or over each tensor of a tuple."""
    return tuple(fn(a) for a in x) if isinstance(x, tuple) else fn(x)


def shard_leading(mesh: Mesh, x, axis: str = CHIP):
    """One block of x's leading axis per shard, on that shard's device: a
    list of tensors, or of tuples when x is a tuple of tensors (a point).
    The leading axis must divide by the mesh size; `axis` names the mesh's
    one axis."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh has one axis, {mesh.axis!r}, not {axis!r}")
    n = (x[0] if isinstance(x, tuple) else x).shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide by the mesh size {mesh.size}")
    b = n // mesh.size
    return [_map(lambda a: a[c * b:(c + 1) * b].to(dev), x)
            for c, dev in enumerate(mesh.devices)]


def replicated(mesh: Mesh, x):
    """x (a tensor or a tuple of tensors) on every shard's device."""
    return [_map(lambda a: a.to(dev), x) for dev in mesh.devices]


def gather(blocks, device, dim: int = 0):
    """The shards' blocks concatenated along `dim` on one device: the copy
    of an all_gather that the controller reads."""
    if isinstance(blocks[0], tuple):
        return tuple(torch.cat([a.to(device) for a in leaves], dim=dim)
                     for leaves in zip(*blocks))
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def all_gather(mesh: Mesh, blocks):
    """The shards' blocks concatenated along axis 0 on every shard (JAX's
    tiled all_gather)."""
    return [gather(blocks, dev) for dev in mesh.devices]


def all_to_all(mesh: Mesh, blocks, split_dim: int, cat_dim: int):
    """JAX's tiled all_to_all: shard c's block splits into `mesh.size`
    chunks along split_dim; shard j receives chunk j of every shard, in
    shard order, concatenated along cat_dim."""
    parts = [b.chunk(mesh.size, dim=split_dim) for b in blocks]
    if any(len(p) != mesh.size or p[0].shape != p[-1].shape for p in parts):
        raise ValueError(f"axis {split_dim} does not divide by the mesh size {mesh.size}")
    return [torch.cat([p[j].to(dev) for p in parts], dim=cat_dim)
            for j, dev in enumerate(mesh.devices)]
