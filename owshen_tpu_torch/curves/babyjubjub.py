"""Batched BabyJubJub twisted-Edwards curve and EdDSA over BN254 Fr, after
owshen_tpu/curves/babyjubjub.py (reference: the Owshen node's
babyjubjub/mod.rs).

* Points are projective (X : Y : Z) tuples of Montgomery Fr tensors.  The
  projective add and double (mod.rs:118-172) are complete on BabyJubJub (a
  is a square in Fr, d is not), so one branchless path serves every input.
* Every product, add and subtract is a K1 launch on the card (the plain
  twin on the CPU).  The path is bound by launches, so the products of a
  formula that do not wait on each other are stacked on a new leading axis
  and go through one launch: the same field operations on the same values
  as the reference's, in fewer launches.  The 5-input Poseidon challenge
  hash composes the t = 6 permutation from K1 launches, the 2-input nonce
  hash is one K4 launch.
* Scalar multiplication is a 254-step double-and-add over the batch, its
  select a `torch.where` on the card (no host sync in the ladder); fixed-base
  products (s·B, r·B, a·B) go through `fixed_base.jub_fixed_base`: one row
  gather and 31 batched adds.
* EdDSA follows the reference (mod.rs:202-236): h = H(R.x, R.y, A.x, A.y, M),
  accept iff s·B == R + h·A.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..fields.field import FR, ints_to_tensor, tensor_to_ints
from ..ops.hash import poseidon

F = FR

A = 168700
D = 168696
BASE = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)
ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
SUBORDER = ORDER // 8


def identity_like(x):
    return (F.zeros_like(x), F.one_like(x), F.one_like(x))


def jub_encode(pts, device=None):
    """[(x, y) ints | None] -> projective tensors (None = the identity)."""
    xs = F.encode([0 if p is None else p[0] for p in pts], device=device)
    ys = F.encode([1 if p is None else p[1] for p in pts], device=device)
    zs = F.encode([1] * len(pts), device=device)
    return (xs, ys, zs)


def encode_points(pts, device=None):
    """[(x, y) ints] -> projective tensors (Montgomery)."""
    return jub_encode(pts, device)


def decode_points(p):
    """Projective -> [(x, y) ints]; the identity decodes to (0, 1)."""
    x, y = to_affine(p)
    return list(zip(F.decode(x), F.decode(y)))


def _muls(xs, ys):
    """The products xs[i]·ys[i] of equal-shape tensors, one K1 launch."""
    return F.mul(torch.stack(xs), torch.stack(ys)).unbind(0)


def _adds(xs, ys):
    return F.add(torch.stack(xs), torch.stack(ys)).unbind(0)


def _subs(xs, ys):
    return F.sub(torch.stack(xs), torch.stack(ys)).unbind(0)


def add(p, q):
    """Complete projective twisted-Edwards addition (mod.rs:118-142): the
    reference's products and sums, those that do not wait on each other
    stacked into one launch (8 K1 launches for its 13 products and 7 adds)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    a, c, d = _muls((Z1, X1, Y1), (Z2, X2, Y2))
    s1, s2, cpd = _adds((X1, X2, c), (Y1, Y2, d))
    k_a = F.const(A, device=c.device).expand_as(c)
    b, cd, u, c_a = _muls((a, c, s1, c), (a, d, s2, k_a))     # b = a², c·A
    e = F.mul_const(cd, D)
    f, x_part, d_ca = _subs((b, u, d), (e, cpd, c_a))
    g = F.add(b, e)
    af, ag, Z3 = _muls((a, a, f), (f, g, g))
    X3, Y3 = _muls((af, ag), (x_part, d_ca))
    return (X3, Y3, Z3)


def double(p):
    """Projective doubling (mod.rs:152-163), the identity included; 7 K1
    launches for the reference's 8 products and 7 adds."""
    X1, Y1, Z1 = p
    s = F.add(X1, Y1)
    b, c, d, h = _muls((s, X1, Y1, Z1), (s, X1, Y1, Z1))     # squares
    e = F.mul_const(c, A)
    f, h2 = _adds((e, h), (d, h))
    b_c, e_d = _subs((b, e), (c, d))
    j, b_cd = _subs((f, b_c), (h2, d))
    X3, Y3, Z3 = _muls((b_cd, f, f), (j, e_d, j))
    return (X3, Y3, Z3)


def select(cond, p, q):
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


class _JubOps:
    """The curve-ops protocol of curves/weierstrass.py, so that FixedBase and
    ops.msm.sum_scan drive the Edwards curve too."""

    @staticmethod
    def add(p, q):
        return add(p, q)

    @staticmethod
    def double(p):
        return double(p)

    @staticmethod
    def select(cond, p, q):
        return select(cond, p, q)

    @staticmethod
    def identity_like(x):
        return identity_like(x)


JUB_OPS = _JubOps()


class _JubOracle:
    """Host affine adds with identity = None (FixedBase's table builder)."""

    @staticmethod
    def add(p, q):
        from ..oracle.curve import jub_add

        if p is None:
            return q
        if q is None:
            return p
        return jub_add(p, q)


def scalar_mul(p, bits):
    """bits: int[n_bits, ...] MSB-first (the reference walks
    to_le_bits().rev(), mod.rs:71): per bit a double, an add and a select."""
    acc = identity_like(p[0])
    for bit in bits:
        acc = double(acc)
        acc = select(bit != 0, add(acc, p), acc)
    return acc


def scalar_mul_int(p, scalars_canonical):
    """scalars: canonical (non-Montgomery) limbs int32[..., 16], below 2^254."""
    bits = F.to_bits_le(scalars_canonical, 254)             # (..., 254)
    return scalar_mul(p, bits.movedim(-1, 0).flip(0))      # MSB first, leading axis


def to_affine(p):
    X, Y, Z = p
    zinv = F.inv(Z)
    return tuple(_muls((X, Y), (zinv, zinv)))


def eq(p, q):
    """Projective equality by cross-multiplication."""
    xp, xq, yp, yq = _muls((p[0], q[0], p[1], q[1]), (q[2], p[2], q[2], p[2]))
    return F.eq(xp, xq) & F.eq(yp, yq)


def on_curve_affine(x, y):
    """a·x² + y² == 1 + d·x²·y² (mod.rs:47-49)."""
    x2, y2 = F.sqr(x), F.sqr(y)
    lhs = F.add(F.mul_const(x2, A), y2)
    rhs = F.add(F.one_like(x), F.mul_const(F.mul(x2, y2), D))
    return F.eq(lhs, rhs)


def compress(x_aff, y_aff):
    """(x canonical limbs, y odd) (mod.rs:82-84)."""
    return F.from_mont(x_aff), F.is_odd(F.from_mont(y_aff))


def decompress(x_plain, odd):
    """Recover y from x and its parity (mod.rs:88-98): (x_mont, y_mont, ok)."""
    x = F.to_mont(x_plain)
    x2 = F.sqr(x)
    one = F.one_like(x)
    num = F.sub(one, F.mul_const(x2, A))
    den = F.sub(one, F.mul_const(x2, D))
    y2 = F.mul(num, F.inv(den))
    y, ok = F.sqrt(y2)
    y_parity = F.is_odd(F.from_mont(y))
    y = F.select(y_parity == odd, y, F.neg(y))
    return x, y, ok


# ---------------------------------------------------------------------------
# EdDSA (mod.rs:194-236)
# ---------------------------------------------------------------------------

def placeholder_hash(elems):
    """The reference's stand-in challenge hash, the product of the inputs
    (mod.rs:202-204); for parity tests only."""
    acc = elems[0]
    for e in elems[1:]:
        acc = F.mul(acc, e)
    return acc


def poseidon_hash5(elems):
    """The protocol's challenge hash: Poseidon over the inputs."""
    return poseidon(list(elems))


def _hash_fn(hash_mode: str):
    return poseidon_hash5 if hash_mode == "poseidon" else placeholder_hash


def _sign_device(rand_m, msg_m, a_can, hash_mode: str):
    """The device half of a batched sign: r = H(rand, M); R = r·B and
    A = a·B through the fixed-base tables, both in one multiplication and
    one inversion over 2n lanes; h = H(R.x, R.y, A.x, A.y, M).  Returns
    (R.x, R.y, r, h), canonical limbs."""
    from .fixed_base import jub_fixed_base

    h_fn = _hash_fn(hash_mode)
    n = rand_m.shape[0]
    r = h_fn([rand_m, msg_m])
    r_can = F.from_mont(r)
    x, y = to_affine(jub_fixed_base().mul(torch.cat([r_can, a_can])))
    (Rx, Ax), (Ry, Ay) = x.split(n), y.split(n)
    h = h_fn([Rx, Ry, Ax, Ay, msg_m])
    return F.from_mont(Rx), F.from_mont(Ry), r_can, F.from_mont(h)


def eddsa_sign_batch(priv, randomness, messages, hash_mode="poseidon", device=None):
    """Batched EdDSA sign with the reference's semantics (mod.rs:210-236):
    [(R=(x, y), s)] per input.  priv, randomness, messages: equal-length
    lists of host ints (priv < 2^254).  Only s = r + h·a mod ORDER is
    folded on the host (ORDER ≠ p; the reference reduces it through BigUint,
    mod.rs:228-233)."""
    if not len(priv) == len(randomness) == len(messages):
        raise ValueError("priv, randomness and messages differ in length")
    dev = resolve_device(device)
    p = F.p
    rand_m = F.encode([x % p for x in randomness], device=dev)
    msg_m = F.encode([m % p for m in messages], device=dev)
    a_can = ints_to_tensor(list(priv), dev)
    Rx, Ry, r_can, h_can = _sign_device(rand_m, msg_m, a_can, hash_mode)
    rx, ry, rs, hs = (tensor_to_ints(t) for t in (Rx, Ry, r_can, h_can))
    return [((x, y), (r + h * a) % ORDER) for x, y, r, h, a in zip(rx, ry, rs, hs, priv)]


def eddsa_verify(pk_affine, msg, sig_r_affine, sig_s_canonical, hash_mode="poseidon"):
    """Batched verify, s·B == R + H(R, A, M)·A (mod.rs:99-115), on the
    inputs' device.  pk_affine, sig_r_affine: (x, y) Montgomery tensors; msg:
    Montgomery tensor; sig_s_canonical: raw limbs of s (s may exceed p, as
    ORDER > p, so it is never reduced).  Returns bool[...]."""
    ax, ay = pk_affine
    rx, ry = sig_r_affine
    h = _hash_fn(hash_mode)([rx, ry, ax, ay, msg])
    h_canonical = F.from_mont(h)

    on_curve = on_curve_affine(ax, ay) & on_curve_affine(rx, ry)

    pk_proj = (ax, ay, F.one_like(ax))
    r_proj = (rx, ry, F.one_like(rx))

    from .fixed_base import jub_fixed_base

    sb = jub_fixed_base().mul(sig_s_canonical.reshape(-1, F.L))     # all 256 bits of s
    sb = tuple(a.reshape(ax.shape) for a in sb)
    ha = scalar_mul_int(pk_proj, h_canonical)
    rhs = add(r_proj, ha)
    return eq(sb, rhs) & on_curve
