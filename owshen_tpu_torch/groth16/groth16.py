"""Groth16 setup / prove / verify over BN254, after
owshen_tpu/groth16/groth16.py, with the prover's hot path on the card.

  * witness: host (the builder assigns values during synthesis);
  * A·w, B·w, C·w: sparse matvec over nnz-bucketed rows (K1);
  * h(x) = intt_coset((A·B − C)·Z⁻¹): NTTs over the domain (K1);
  * commitments: the fixed-table MSM engine (ops/msm_fixed.py) — one
    gather and one batched fold for the five G1 MSMs (K2), the G2 MSM on
    the G2 add kernel, and the assembly adds — or, by choice or when the
    tables do not fit, the Pippenger engines of ops/msm.py with scalar
    ladders for the randomizer terms;
  * over a mesh (parallel/): the h pipeline's NTTs across the shards
    (DistNtt) and every commitment MSM sharded (msm_dist, the lane
    engine on each shard);
  * setup points: fixed-base windowed multiplication (K2, K1);
  * verification: host pairing product (groth16/pairing.py).

Setup is a simulated trusted setup from a seed.  `setup` and `prove` draw
every random value from `_rand_stream(seed)`, a SHA-256 stream, so the
same seeds give the JAX package's keys and proofs point for point.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass

import torch

from ..config import resolve_device, settings
from ..curves import bn254
from ..curves.fixed_base import g1_fixed_base, g2_fixed_base
from ..fields.field import FR, ints_to_tensor
from ..ops.msm import _pad_identity, msm, msm_sorted
from ..ops.msm_fixed import FixedMsm, FixedMsmGroup
from ..ops.ntt import NttDomain
from ..oracle import curve as ocurve
from .pairing import pairing_product_is_one
from .r1cs import Builder

P = FR.p


@functools.lru_cache(maxsize=None)
def _domain(log_n: int) -> NttDomain:
    return NttDomain(log_n)


def _rand_stream(seed: bytes):
    i = 0
    while True:
        v = int.from_bytes(hashlib.sha256(seed + i.to_bytes(4, "little")).digest(),
                           "big") % P
        i += 1
        if v != 0:
            yield v


@dataclass
class ProvingKey:
    n_domain: int
    n_pub: int
    # projective point tuples on the key's device
    a_g1: tuple
    b_g1: tuple
    b_g2: tuple
    k_g1: tuple | None  # private-variable coefficients / δ
    h_g1: tuple         # τ^i·Z(τ)/δ
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    beta_g2: tuple
    delta_g2: tuple

    @property
    def device(self) -> torch.device:
        return self.a_g1[0].device


@dataclass
class VerifyingKey:
    alpha_g1: tuple  # host affine ints
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list  # host affine per public var (incl. the constant-1 wire)


@dataclass
class Proof:
    a: tuple  # G1 affine ints
    b: tuple  # G2 affine
    c: tuple  # G1 affine


def _lagrange_at_tau(n: int, tau: int, omega: int):
    """L_j(τ) for j < n over the radix-2 domain: Zh(τ)·ω^j / (n·(τ − ω^j)),
    with one batched inversion for all n denominators."""
    zh = (pow(tau, n, P) - 1) % P
    n_inv = pow(n, -1, P)
    wjs, dens = [], []
    wj = 1
    for _ in range(n):
        wjs.append(wj)
        dens.append((tau - wj) % P)
        wj = wj * omega % P
    prefix = [1] * (n + 1)
    for i, d in enumerate(dens):
        prefix[i + 1] = prefix[i] * d % P
    inv_all = pow(prefix[n], -1, P)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv_all * prefix[i] % P
        inv_all = inv_all * dens[i] % P
    return [zh * wjs[j] % P * invs[j] % P * n_inv % P for j in range(n)]


def _fixed_base_batches(group: str, batches, device):
    """Several exponent lists -> one projective point tuple each, through
    one fixed-base multiply over all of them side by side."""
    fb = g1_fixed_base() if group == "g1" else g2_fixed_base()
    flat = [e % P for b in batches for e in b]
    pts = fb.mul(ints_to_tensor(flat, device))
    out, off = [], 0
    for b in batches:
        out.append(tuple(a[off:off + len(b)] for a in pts))
        off += len(b)
    return out


def setup(builder: Builder, seed: bytes = b"owshen-tpu-setup", device=None):
    """Simulated trusted setup -> (ProvingKey on `device`, VerifyingKey)."""
    dev = resolve_device(device)
    rs = _rand_stream(seed)
    tau, alpha, beta, gamma, delta = (next(rs) for _ in range(5))
    m = builder.num_vars
    n_pub = builder.n_pub + 1  # include the constant wire
    n = 1 << max(1, (len(builder.constraints) - 1).bit_length())
    dom = _domain(n.bit_length() - 1)
    lag = _lagrange_at_tau(n, tau, dom.omega)

    a_t = [0] * m
    b_t = [0] * m
    c_t = [0] * m
    for j, (a, b, c) in enumerate(builder.constraints):
        lj = lag[j]
        for i, v in a.items():
            a_t[i] = (a_t[i] + v * lj) % P
        for i, v in b.items():
            b_t[i] = (b_t[i] + v * lj) % P
        for i, v in c.items():
            c_t[i] = (c_t[i] + v * lj) % P

    gamma_inv = pow(gamma, -1, P)
    delta_inv = pow(delta, -1, P)
    k_exp = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % P * delta_inv % P
             for i in range(n_pub, m)]
    ic_exp = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % P * gamma_inv % P
              for i in range(n_pub)]
    zh_tau = (pow(tau, n, P) - 1) % P
    h_exp = [pow(tau, i, P) * zh_tau % P * delta_inv % P for i in range(n - 1)]

    a_g1, b_g1, k_g1, h_g1, alpha_g1, beta_g1, delta_g1 = _fixed_base_batches(
        "g1", [a_t, b_t, k_exp, h_exp, [alpha], [beta], [delta]], dev)
    b_g2, beta_g2, delta_g2 = _fixed_base_batches("g2", [b_t, [beta], [delta]], dev)
    pk = ProvingKey(n_domain=n, n_pub=n_pub, a_g1=a_g1, b_g1=b_g1, b_g2=b_g2,
                    k_g1=k_g1 if k_exp else None, h_g1=h_g1, alpha_g1=alpha_g1,
                    beta_g1=beta_g1, delta_g1=delta_g1, beta_g2=beta_g2,
                    delta_g2=delta_g2)
    vk = VerifyingKey(
        alpha_g1=ocurve.G1.mul(ocurve.G1_GEN, alpha),
        beta_g2=ocurve.G2.mul(ocurve.G2_GEN, beta),
        gamma_g2=ocurve.G2.mul(ocurve.G2_GEN, gamma),
        delta_g2=ocurve.G2.mul(ocurve.G2_GEN, delta),
        ic=[ocurve.G1.mul(ocurve.G1_GEN, e) for e in ic_exp],
    )
    return pk, vk


def _bucket_sum(prods: torch.Tensor) -> torch.Tensor:
    """Σ over axis 1 of (r, k, 16) field elements as a halving tree:
    ⌈log2 k⌉ adds, each of the lower half and the upper half (an odd k's
    last column waits a level).  Modular addition is exact, so this equals
    the sequential sum limb for limb."""
    while prods.shape[1] > 1:
        h = prods.shape[1] // 2
        s = FR.add(prods[:, :h], prods[:, h:2 * h])
        prods = torch.cat([s, prods[:, 2 * h:]], dim=1) if prods.shape[1] % 2 else s
    return prods[:, 0]


def _matvec(w_mont: torch.Tensor, mat, n_rows: int) -> torch.Tensor:
    """Sparse LC·w over nnz-bucketed rows (r1cs.Builder.compiled): returns
    int32[n_rows, 16]; every row lives in exactly one bucket."""
    acc = torch.zeros((n_rows, FR.L), dtype=torch.int32, device=w_mont.device)
    for rids, idx, coeff in mat:
        acc[rids] = _bucket_sum(FR.mul(w_mont[idx], coeff))   # (r, k, 16) products
    return acc


def _h_scalars_device(dom: NttDomain, w_mont: torch.Tensor, mats) -> torch.Tensor:
    """Witness -> A/B/C evaluations -> h coefficients -> canonical scalars
    for the MSM, all on the card."""
    F = FR
    evals = torch.stack([_matvec(w_mont, m, dom.n) for m in mats], dim=1)  # (n, 3, 16)
    a_s, b_s, c_s = dom.coset_ntt(dom.intt(evals)).unbind(dim=1)    # A, B, C together
    zinv = F.const(dom.z_on_coset_inv(), device=w_mont.device)
    h_s = F.mul(F.sub(F.mul(a_s, b_s), c_s), zinv)
    return F.from_mont(dom.coset_intt(h_s))


def _pad_for_mesh(pts, sc, d: int, curve):
    """Pad (points, scalars) so n divides by the mesh size (identity points
    with zero scalars add nothing)."""
    n = sc.shape[0]
    pad = (-n) % d
    return (pts, sc) if pad == 0 else _pad_identity(curve, pts, sc, n + pad)


def _h_scalars_dist(mesh, dom: NttDomain, w_mont: torch.Tensor, mats) -> torch.Tensor:
    """The h pipeline with its three NTT round trips across the mesh (the
    Bailey all_to_all of parallel/ntt_dist.DistNtt); the sparse matvec and
    the coset and 1/Z products stay on the controller's device.  Equals
    `_h_scalars_device` limb for limb."""
    from ..parallel.ntt_dist import DistNtt

    F = FR
    dn = DistNtt(mesh, dom.log_n)
    evals = torch.stack([_matvec(w_mont, m, dom.n) for m in mats], dim=1)  # (n, 3, 16)
    coeffs = dn.intt(evals)
    a_s, b_s, c_s = dn.ntt(F.mul(coeffs, dom._per_row("coset", coeffs))).unbind(dim=1)
    zinv = F.const(dom.z_on_coset_inv(), device=w_mont.device)
    h_s = F.mul(F.sub(F.mul(a_s, b_s), c_s), zinv)
    h_c = dn.intt(h_s)
    return F.from_mont(F.mul(h_c, dom._per_row("coset_inv", h_c)))


def _table_n(pk: ProvingKey) -> int:
    """The padded point count shared by all of a key's fixed tables."""
    n_min = max(pk.a_g1[0].shape[0], pk.h_g1[0].shape[0],
                pk.k_g1[0].shape[0] if pk.k_g1 is not None else 1)
    return 1 << (n_min - 1).bit_length()


def _fixed_table_bytes(pk: ProvingKey) -> int:
    """Card memory of the fixed prover tables: W·D·n points per set."""
    n = _table_n(pk)
    W, D = 64, 9                        # c = 4, signed digits
    g1_sets = 3 + (1 if pk.k_g1 is not None else 0)
    per_g1 = 3 * 16 * 4                 # x/y/z × 16 int32 limbs
    per_g2 = 2 * per_g1                 # Fq2 coordinates
    return W * D * n * (g1_sets * per_g1 + per_g2)


class _FixedTables:
    """Per-ProvingKey fixed-point MSM tables, built at first prove (or
    restored with `restore_fixed_tables`) and cached on the key."""

    def __init__(self, pk: ProvingKey, restored=None):
        self.n = _table_n(pk)
        self.has_k = pk.k_g1 is not None
        if restored is not None:
            self.g1, self.b2 = restored
        else:
            # one table for [a, b1, (k,) h]: the five G1 MSMs of a proof
            # share one gather and one batched fold
            sets = [pk.a_g1, pk.b_g1] + ([pk.k_g1] if self.has_k else []) + [pk.h_g1]
            self.g1 = FixedMsmGroup(bn254.G1, sets, n_min=self.n)
            self.b2 = FixedMsm(bn254.G2, pk.b_g2, n_min=self.n)


def _fixed_tables(pk: ProvingKey) -> _FixedTables:
    fx = getattr(pk, "_fixed", None)
    if fx is None:
        fx = _FixedTables(pk)
        object.__setattr__(pk, "_fixed", fx)
    return fx


def restore_fixed_tables(pk: ProvingKey, g1: FixedMsmGroup, b2: FixedMsm) -> None:
    """Attach tables built elsewhere (they are deterministic derived data)
    so the first prove skips the build."""
    object.__setattr__(pk, "_fixed", _FixedTables(pk, restored=(g1, b2)))


def _tail_host(pk: ProvingKey) -> dict:
    """The fixed tail points (α, β, δ)₁ / (β, δ)₂ as host affine ints."""
    th = getattr(pk, "_tail_host_cache", None)
    if th is None:
        first = lambda pt: tuple(a[:1] for a in pt)  # noqa: E731
        th = {
            "alpha1": bn254.g1_decode_host(first(pk.alpha_g1)),
            "beta1": bn254.g1_decode_host(first(pk.beta_g1)),
            "delta1": bn254.g1_decode_host(first(pk.delta_g1)),
            "beta2": bn254.g2_decode_host(first(pk.beta_g2)),
            "delta2": bn254.g2_decode_host(first(pk.delta_g2)),
        }
        object.__setattr__(pk, "_tail_host_cache", th)
    return th


def _tails(pk: ProvingKey, r: int, s: int):
    """The randomizer tails from the host's affine (α, β, δ)₁ / (β, δ)₂,
    five oracle scalar multiplications, encoded on the key's device:
    (tail_a = α + r·δ, tail_c = s·α + r·β + r·s·δ) as a two-point G1
    batch, and tail_b2 = β₂ + s·δ₂ as one G2 point."""
    th = _tail_host(pk)
    dev = pk.device
    oG1, oG2 = ocurve.G1, ocurve.G2
    tail_a = oG1.add(th["alpha1"], oG1.mul(th["delta1"], r % P))
    tail_c = oG1.add(oG1.add(oG1.mul(th["alpha1"], s % P), oG1.mul(th["beta1"], r % P)),
                     oG1.mul(th["delta1"], (r * s) % P))
    tail_b2 = oG2.add(th["beta2"], oG2.mul(th["delta2"], s % P))
    return (bn254.g1_encode([tail_a, tail_c], device=dev),
            tuple(a[0] for a in bn254.g2_encode([tail_b2], device=dev)))


def _assemble(a_w, a_sw, b1_rw, k_w, h_h, b2_w, tails_g1, tail_b2) -> Proof:
    """A = a_w + tail_a, B₂ = b2_w + tail_b2 and
    C = a_sw + b1_rw (+ k_w) + h_h + tail_c from one-point G1 batches (k_w
    None when the key has no K points) and G2 points; A and C's first sum
    share one two-point add."""
    G1, G2 = bn254.G1, bn254.G2
    pair = G1.add(G1.cat([a_w, a_sw]), G1.cat([tuple(t[0:1] for t in tails_g1), b1_rw]))
    A = tuple(a[0:1] for a in pair)
    C = tuple(a[1:2] for a in pair)
    if k_w is not None:
        C = G1.add(C, k_w)
    C = G1.add(C, h_h)
    C = G1.add(C, tuple(t[1:2] for t in tails_g1))
    B2 = G2.add(b2_w, tail_b2)
    return Proof(a=bn254.g1_decode_host(A), b=bn254.g2_decode_host(B2),
                 c=bn254.g1_decode_host(C))


def _prove_core(pk: ProvingKey, w: list[int], r: int, s: int, h_sc: torch.Tensor,
                mg1, mg2) -> Proof:
    """The tail-free prover algebra over pluggable MSM backends.  Uses
    s·A = s·α + MSM_a(s·w) + s·r·δ and r·B₁ = r·β + MSM_b1(r·w) + r·s·δ, so
      C = MSM_h(h) + MSM_k(w_priv) + MSM_a(s·w) + MSM_b1(r·w)
          + (s·α + r·β + r·s·δ)
    needs no variable-point scalar multiplication.  mg1(which, scalars)
    (which in "a", "b1", "k", "h") and mg2(scalars) return one projective
    point each: msm_dist over a mesh."""
    dev = pk.device
    enc = lambda xs: FR.encode(xs, mont=False, device=dev)  # noqa: E731
    one = lambda pt: tuple(a[None] for a in pt)  # noqa: E731
    w_sc = enc(w)
    a_w = one(mg1("a", w_sc))
    a_sw = one(mg1("a", enc([(s * wi) % P for wi in w])))
    b1_rw = one(mg1("b1", enc([(r * wi) % P for wi in w])))
    b2_w = mg2(w_sc)
    k_w = one(mg1("k", w_sc[pk.n_pub:])) if pk.k_g1 is not None else None
    h_h = one(mg1("h", h_sc))
    return _assemble(a_w, a_sw, b1_rw, k_w, h_h, b2_w, *_tails(pk, r, s))


def _prove_fixed(pk: ProvingKey, w_mont: torch.Tensor, r: int, s: int,
                 h_sc: torch.Tensor) -> Proof:
    """`_prove_core`'s algebra over the fixed tables, its five G1 MSMs
    stacked into one gather and one batched fold (`mul_multi`) and s·w,
    r·w taken on the card."""
    fx = _fixed_tables(pk)
    dev = pk.device
    n, n_pub = fx.n, pk.n_pub
    slots = (0, 0, 1, 2, 3) if fx.has_k else (0, 0, 1, 2)
    if w_mont.shape[0] != n:
        w_mont = torch.cat([w_mont, torch.zeros((n - w_mont.shape[0], FR.L),
                                                dtype=torch.int32, device=dev)])
    sr = FR.encode([s, r], device=dev)[:, None]                  # (2, 1, 16)
    w_sc = FR.from_mont(w_mont)                                   # (n, 16)
    sw, rw = FR.from_mont(FR.mul(w_mont[None], sr))               # (2, n, 16)
    h_pad = torch.zeros((n, FR.L), dtype=torch.int32, device=dev)
    h_pad[: h_sc.shape[0]] = h_sc
    sets = [w_sc, sw, rw]
    if fx.has_k:
        sets.append(torch.cat([w_sc[n_pub:], torch.zeros((n_pub, FR.L), dtype=torch.int32,
                                                           device=dev)]))
    sets.append(h_pad)
    g1s = fx.g1.mul_multi(torch.stack(sets), slots)               # (S, ...) sums
    pick = lambda i: tuple(a[i:i + 1] for a in g1s)  # noqa: E731
    return _assemble(pick(0), pick(1), pick(2), pick(3) if fx.has_k else None,
                     pick(len(slots) - 1), fx.b2.mul(w_sc), *_tails(pk, r, s))


def _prove_mesh(pk: ProvingKey, w: list[int], r: int, s: int, h_sc: torch.Tensor, mesh,
                msm_c: int, msm_lanes: int) -> Proof:
    """The multi-device prover: `_prove_core` over msm_dist backends, each
    MSM's points sharded across the mesh (padded with identities to a
    multiple of its size) and the partials gathered and summed."""
    from ..parallel.msm_dist import msm_dist

    d = mesh.size
    pts_g1 = {"a": pk.a_g1, "b1": pk.b_g1, "k": pk.k_g1, "h": pk.h_g1}

    def mg1(which, sc):
        pts, sc = _pad_for_mesh(pts_g1[which], sc, d, bn254.G1)
        return msm_dist(mesh, bn254.G1, pts, sc, c=msm_c, lanes=msm_lanes)

    def mg2(sc):
        pts, sc = _pad_for_mesh(pk.b_g2, sc, d, bn254.G2)
        return msm_dist(mesh, bn254.G2, pts, sc, c=msm_c, lanes=msm_lanes)

    return _prove_core(pk, w, r, s, h_sc, mg1, mg2)


def _device_mats(mats, device):
    return tuple(tuple((rids.to(device), idx.to(device), coeff.to(device))
                       for rids, idx, coeff in mat) for mat in mats)


def _fixed_tables_fit(pk: ProvingKey) -> bool:
    """True when the key's fixed tables are built or fit the card budget
    (OWSHEN_FIXED_TABLE_MAX_GB); past it the prover takes the sorted engine
    instead of running out of memory, as the reference does."""
    if getattr(pk, "_fixed", None) is not None:
        return True
    return _fixed_table_bytes(pk) <= settings().fixed_table_max_gb * (1 << 30)


def _resolve_engine(pk: ProvingKey, mesh, engine: str | None) -> str:
    """The engine a single-device prove runs: `engine`, or
    OWSHEN_PROVER_ENGINE when None, with "fixed" sent to "sorted" when the
    key's tables do not fit.  An engine the reference does not know is a
    ValueError before any work, with or without a mesh; a mesh proves
    through msm_dist whatever the engine, so its tables are not looked at."""
    if engine is None:
        engine = settings().prover_engine
    if engine not in ("fixed", "lane", "sorted"):
        raise ValueError(f"unknown prover engine {engine!r}: expected fixed|lane|sorted")
    if mesh is None and engine == "fixed" and not _fixed_tables_fit(pk):
        return "sorted"
    return engine


def _scale_point(curve, p, k: int):
    """k · p for one projective point: the 254-bit double-and-add ladder."""
    bits = FR.to_bits_le(ints_to_tensor([k % P], p[0].device), 254)[0]
    return curve.scalar_mul(p, bits.flip(0))


def _scale_first(curve, pts, k: int):
    """k · pts[0] (the single point of a batch of one)."""
    return _scale_point(curve, tuple(a[0] for a in pts), k)


def _msm_engine(curve, engine: str, msm_c: int, msm_lanes: int):
    """The legacy engines' MSM: "lane" is `msm` (c = msm_c, msm_lanes
    lanes), "sorted" (or OWSHEN_PROVER_SORTED_MSM=1) `msm_sorted` at c = 8.
    Every batch is padded with identities to a power of two ≥ 2^9 points,
    as in the reference (there, so that the MSMs share one compiled
    shape)."""
    use_sorted = engine == "sorted" or settings().prover_sorted_msm

    def call(pts, sc):
        pts, sc = _pad_identity(curve, pts, sc, 1 << max(9, (sc.shape[0] - 1).bit_length()))
        if use_sorted:
            return msm_sorted(curve, pts, sc, c=8)
        return msm(curve, pts, sc, c=msm_c, lanes=msm_lanes)

    return call


def _prove_legacy(pk: ProvingKey, w: list[int], r: int, s: int, h_sc: torch.Tensor,
                  engine: str, msm_c: int, msm_lanes: int) -> Proof:
    """Commitments through the Pippenger engines, the reference's legacy
    single-device path:
      A = α + Σ w_i·A_i(τ) + r·δ,   B = β + Σ w_i·B_i(τ) + s·δ (G2 and G1),
      C = Σ h_i·H_i + Σ_priv w_i·K_i + s·A + r·B₁ − r·s·δ,
    the scalar multiples by 254-step double-and-add ladders on the card."""
    G1, G2 = bn254.G1, bn254.G2
    msm_g1 = _msm_engine(G1, engine, msm_c, msm_lanes)
    msm_g2 = _msm_engine(G2, engine, msm_c, msm_lanes)
    w_sc = FR.encode(w, mont=False, device=pk.device)
    first = lambda pt: tuple(a[0] for a in pt)  # noqa: E731

    a_acc = G1.add(msm_g1(pk.a_g1, w_sc), first(pk.alpha_g1))
    a_acc = G1.add(a_acc, _scale_first(G1, pk.delta_g1, r))
    b2_acc = G2.add(msm_g2(pk.b_g2, w_sc), first(pk.beta_g2))
    b2_acc = G2.add(b2_acc, _scale_first(G2, pk.delta_g2, s))
    b1_acc = G1.add(msm_g1(pk.b_g1, w_sc), first(pk.beta_g1))
    b1_acc = G1.add(b1_acc, _scale_first(G1, pk.delta_g1, s))
    c_acc = msm_g1(pk.h_g1, h_sc)
    if pk.k_g1 is not None:
        c_acc = G1.add(c_acc, msm_g1(pk.k_g1, w_sc[pk.n_pub:]))
    c_acc = G1.add(c_acc, _scale_point(G1, a_acc, s))
    c_acc = G1.add(c_acc, _scale_point(G1, b1_acc, r))
    c_acc = G1.add(c_acc, _scale_first(G1, pk.delta_g1, (-r * s) % P))
    one = lambda pt: tuple(a[None] for a in pt)  # noqa: E731
    return Proof(a=bn254.g1_decode_host(one(a_acc)), b=bn254.g2_decode_host(one(b2_acc)),
                 c=bn254.g1_decode_host(one(c_acc)))


def prove(pk: ProvingKey, builder: Builder, seed: bytes | None = None,
          msm_c: int = 8, msm_lanes: int = 1024, mesh=None,
          engine: str | None = None, *, device=None) -> Proof:
    """Proof from a fully assigned builder, on `device` (the key's device;
    CUDA unless asked otherwise).  The parameters before `device` are the
    reference's, in its order.

    The randomizers (r, s) default to fresh `os.urandom` entropy: zero
    knowledge collapses if they are predictable.  Pass an explicit `seed`
    only for reproducible tests.

    engine: "fixed" (the fixed-table engine, the default), "lane" (`msm`)
    or "sorted" (`msm_sorted` at c = 8); resolved from OWSHEN_PROVER_ENGINE
    when None.  "fixed" with tables over OWSHEN_FIXED_TABLE_MAX_GB proves
    through "sorted".  `msm_c` and `msm_lanes` tune the lane engine; the
    others ignore them, as in the reference.

    mesh: a parallel.mesh.Mesh (the multi-device prover): the h pipeline's
    NTTs run across its shards (DistNtt) and every commitment MSM is
    sharded (msm_dist, the lane engine at `msm_c` / `msm_lanes` on each
    shard), whatever the engine.  All engines and meshes give the same
    proof for the same seed."""
    engine = _resolve_engine(pk, mesh, engine)
    dev = resolve_device(device)
    if pk.device != dev:
        raise ValueError(f"proving key lives on {pk.device}, prove asked for {dev}")
    w = builder.witness()
    rs = _rand_stream((seed if seed is not None else os.urandom(32)) + b"|rs")
    r, s = next(rs), next(rs)
    n = pk.n_domain
    dom = _domain(n.bit_length() - 1)
    mats = _device_mats(builder.compiled(n), dev)
    w_mont = FR.encode(w, device=dev)
    if mesh is not None:
        h_sc = _h_scalars_dist(mesh, dom, w_mont, mats)[: n - 1]
        return _prove_mesh(pk, w, r, s, h_sc, mesh, msm_c, msm_lanes)
    h_sc = _h_scalars_device(dom, w_mont, mats)[: n - 1]
    if engine == "fixed":
        return _prove_fixed(pk, w_mont, r, s, h_sc)
    return _prove_legacy(pk, w, r, s, h_sc, engine, msm_c, msm_lanes)


def verify(vk: VerifyingKey, public_inputs: list[int], proof: Proof) -> bool:
    """e(A, B) == e(α, β)·e(IC(pub), γ)·e(C, δ)  (host pairing product)."""
    if len(public_inputs) != len(vk.ic) - 1:
        raise ValueError(f"expected {len(vk.ic) - 1} public inputs, "
                         f"got {len(public_inputs)}")
    ic = vk.ic[0]
    for x, pt in zip(public_inputs, vk.ic[1:]):
        ic = ocurve.G1.add(ic, ocurve.G1.mul(pt, x % P))
    neg_a = None if proof.a is None else (proof.a[0], (-proof.a[1]) % bn254.Q)
    return pairing_product_is_one([
        (neg_a, proof.b),
        (vk.alpha_g1, vk.beta_g2),
        (ic, vk.gamma_g2),
        (proof.c, vk.delta_g2),
    ])
