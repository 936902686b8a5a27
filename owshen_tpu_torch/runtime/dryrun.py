"""Mesh dry run: the distributed proving steps on a mesh of n shards at
tiny shapes, after owshen_tpu/runtime/dryrun.py.

DistNtt forward and inverse against the host NTT, msm_dist against the
host MSM, merkle_root_dist against oracle_sparse_root, and one mesh prove
of a 33-constraint circuit, verified.  Every stage prints a timestamped
line, so a run cut short leaves a tail to read.  Shards may share a
device: n shards on one card run the real decomposition and kernels.

    python -m owshen_tpu_torch.runtime.dryrun [n_shards] [device]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_T0 = time.time()


def _stage(msg: str) -> None:
    print(f"[dryrun t+{time.time() - _T0:.0f}s] {msg}", flush=True)


def run(n_devices: int, devices=None) -> None:
    """The dry run on make_mesh(n_devices, devices=devices): every visible
    card unless `devices` is given (e.g. [torch.device("cpu")])."""
    import numpy as np

    from ..curves import bn254
    from ..fields.field import FR, ints_to_tensor
    from ..groth16 import groth16
    from ..groth16.r1cs import Builder
    from ..ops import merkle
    from ..oracle import curve as ocurve
    from ..oracle import ntt as ontt
    from ..parallel.merkle_dist import merkle_root_dist
    from ..parallel.mesh import make_mesh
    from ..parallel.msm_dist import msm_dist
    from ..parallel.ntt_dist import DistNtt

    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.devices[0]
    rng = np.random.RandomState(7)
    _stage(f"mesh up: {n_devices} shards on {', '.join(sorted(set(map(str, mesh.devices))))}")

    # the NTT across the mesh (one all_to_all)
    log_n = 6
    n = 1 << log_n
    xs = [int(rng.randint(0, 1 << 30)) for _ in range(n)]
    dn = DistNtt(mesh, log_n)
    got = FR.decode(dn.ntt(FR.encode(xs, device=dev)))
    assert got == ontt.ntt(xs, dn.omega), "DistNtt forward mismatch"
    back = FR.decode(dn.intt(FR.encode(got, device=dev)))
    assert back == [x % FR.p for x in xs], "DistNtt inverse mismatch"
    _stage("DistNtt fwd/inv OK")

    # the MSM: a shard's Pippenger each, the partials gathered and summed
    n_pts = 2 * n_devices
    ks = [int(rng.randint(1, 1000)) for _ in range(n_pts)]
    scalars = [int(rng.randint(0, 1 << 62)) for _ in range(n_pts)]
    pts = [ocurve.G1.mul(ocurve.G1_GEN, k) for k in ks]
    acc = msm_dist(mesh, bn254.G1, bn254.g1_encode(pts, device=dev),
                   ints_to_tensor(scalars, dev), c=4, lanes=2)
    got_pt = bn254.g1_decode(tuple(x[None] for x in acc))[0]
    assert got_pt == ocurve.G1.msm(pts, scalars), "msm_dist mismatch"
    _stage("msm_dist OK")

    # the dense root: a subtree per shard, the tops hashed
    leaves = [int(rng.randint(0, 1 << 31)) for _ in range(8 * n_devices)]
    root = merkle_root_dist(mesh, FR.encode(leaves, device=dev), "poseidon")
    want_root = merkle.oracle_sparse_root(
        dict(enumerate(leaves)), (8 * n_devices - 1).bit_length(), "poseidon")
    assert FR.decode(root[None])[0] == want_root, "merkle_root_dist mismatch"
    _stage("merkle_root_dist OK")

    # one Groth16 prove over the mesh, verified by the host pairing check
    b = Builder()
    y = b.pub(49)
    xvar = b.priv(7)
    b.enforce_eq(b.mul(xvar, xvar), y)
    for k in range(32):  # pad rows so the NTT domain (n = 64) shards at d = 8
        v = b.priv(k + 2)
        b.enforce_eq(b.mul(v, v), b.priv((k + 2) ** 2))
    assert b.check()
    _stage("dryrun circuit built (33 constraints)")
    pk, vk = groth16.setup(b, seed=b"dryrun", device=dev)
    _stage("setup done")
    proof = groth16.prove(pk, b, seed=b"dr", msm_c=4, msm_lanes=2, mesh=mesh, device=dev)
    _stage("distributed prove done")
    assert groth16.verify(vk, [49], proof), "distributed proof rejected"
    _stage("verify OK")
    print(f"MULTICHIP OK: ntt/msm/merkle/groth16-prove distributed on {n_devices} shards "
          f"({dev.type})", flush=True)


def run_subprocess(n_devices: int) -> None:
    """`run` over every visible card in a clean interpreter."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = (f"import sys; sys.path.insert(0, {repo!r}); "
            f"from owshen_tpu_torch.runtime.dryrun import run; run({int(n_devices)})")
    subprocess.run([sys.executable, "-c", code], check=True)


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
        [sys.argv[2]] if len(sys.argv) > 2 else None)
