"""K1's BabyJubJub point operations: the complete projective twisted-Edwards
add over BN254 Fr, and the double-and-add ladder with a scalar per lane.

Points are (X, Y, Z) tuples of int32[..., 16] Montgomery Fr tensors; the
identity is (0 : 1 : 1).  `jub_add` / `jub_scalar_mul` launch csrc/jub.cu
(four threads a point) on CUDA tensors, or run their plain twins on CPU
tensors.  Each wrapper counts its launches in `.launches` and
`.widths` (in points).

The plain twins run the reference's formulas (owshen_tpu/curves/
babyjubjub.py `add`, `double`; reference mod.rs:118-163) on the limb-major
int64 helpers of kernels/field_ops.py, a step's independent products in one
call, in the kernel's grouping; every value they form is canonical, so they
equal the kernel's stored coordinates limb for limb.  The ladder twin is a
loop of the double, the add and a select over n_bits steps, MSB first.
"""

from __future__ import annotations

import functools
import time

import torch

from ..oracle.field import P_FR
from . import build
from .field_ops import (add_lm, check_bits, count_launch, from_lm, keep_operands, kernel_operand,
                        L, limb_rows, MAX_BITS, mul_lm, on_cpu, PLAIN_CHUNK, plain_chunked,
                        plain_consts, stream_handle, sub_lm, to_lm, zero_counts)
from .g1 import broadcast_coords

A = 168700
D = 168696


def _mont(v: int) -> int:
    return v * (1 << 256) % P_FR


def jub_consts_words() -> list[int]:
    """Montgomery 1, A and D, 8 little-endian words each (the jub library's
    constants)."""
    return [w for v in (1, A, D) for w in build.words_le(_mont(v))]


@functools.lru_cache(maxsize=None)
def _const_rows(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(16, 1) limb-major Montgomery 1, A and D."""
    return tuple(limb_rows(_mont(v), device) for v in (1, A, D))


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _split(t, k):
    return t.chunk(k, dim=1)


def add_lm_jub(c, p, q):
    """p + q on limb-major (16, N) coordinates: the kernel's four groups of
    products (4, 4, 2, 3), X3 = (a·(u − c − d))·f, Y3 = (a·(d − A·c))·g."""
    _, k_a, k_d = _const_rows(p[0].device)
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    n = X1.shape[1]
    s1, s2 = _split(add_lm(_cat(X1, X2), _cat(Y1, Y2), c), 2)
    a, cc, d, u = _split(mul_lm(_cat(Z1, X1, Y1, s1), _cat(Z2, X2, Y2, s2), c), 4)
    xp = sub_lm(u, add_lm(cc, d, c), c)
    b, cd, ac, axp = _split(mul_lm(_cat(a, cc, cc, a), _cat(a, d, k_a.expand(L, n), xp), c), 4)
    e, adac = _split(mul_lm(_cat(cd, a), _cat(k_d.expand(L, n), sub_lm(d, ac, c)), c), 2)
    f = sub_lm(b, e, c)
    g = add_lm(b, e, c)
    return _split(mul_lm(_cat(axp, adac, f), _cat(f, g, g), c), 3)


def double_lm_jub(c, p):
    """2·p on limb-major (16, N) coordinates: four squares, A·c, three
    products."""
    _, k_a, _ = _const_rows(p[0].device)
    X, Y, Z = p
    s = add_lm(X, Y, c)
    b, cc, d, h = _split(mul_lm(_cat(s, X, Y, Z), _cat(s, X, Y, Z), c), 4)
    e = mul_lm(cc, k_a, c)
    f, h2 = _split(add_lm(_cat(e, h), _cat(d, h), c), 2)
    bc, ed = _split(sub_lm(_cat(b, e), _cat(cc, d), c), 2)
    j, bcd = _split(sub_lm(_cat(f, bc), _cat(h2, d), c), 2)
    return _split(mul_lm(_cat(bcd, f, f), _cat(j, ed, j), c), 3)


def _rows(coords):
    coords, shape = broadcast_coords(*coords)
    if shape[-1] != L:
        raise TypeError(f"expected coordinates int32[..., {L}], got {list(shape)}")
    return [x.reshape(-1, L) for x in coords], shape


def jub_add_plain(p, q):
    rows, shape = _rows((*p, *q))

    def run(*r):
        c = plain_consts("fr", r[0].device)
        lm = [to_lm(x) for x in r]
        return tuple(from_lm(x, (-1, L)) for x in add_lm_jub(c, lm[:3], lm[3:]))

    out = plain_chunked(run, rows[0].shape[0], *rows, chunk=PLAIN_CHUNK // 8)
    return tuple(o.reshape(shape) for o in out)


def jub_scalar_mul_plain(p, scalars, n_bits: int):
    n_bits = check_bits(n_bits)
    rows, shape = _rows((*p, scalars))

    def run(*r):
        c = plain_consts("fr", r[0].device)
        one = _const_rows(r[0].device)[0]
        base = [to_lm(x) for x in r[:3]]
        k = r[3]
        acc = (torch.zeros_like(base[0]), one.expand_as(base[0]), one.expand_as(base[0]))
        for i in range(n_bits - 1, -1, -1):
            acc = double_lm_jub(c, acc)
            bit = ((k[:, i // 16] >> (i % 16)) & 1).bool()
            acc = tuple(torch.where(bit, s, a) for s, a in zip(add_lm_jub(c, acc, base), acc))
        return tuple(from_lm(x, (-1, L)) for x in acc)

    # one chunk up to 2^16 lanes: on the card each of a step's ~40 ops syncs
    # (`ripple`), so a chunk costs its 254 steps' ops whatever its width
    out = plain_chunked(run, rows[0].shape[0], *rows, chunk=2 * PLAIN_CHUNK)
    return tuple(o.reshape(shape) for o in out)


def _launch(entry: str, wrapper, coords, extra, kept, t0: int):
    coords, shape = broadcast_coords(*coords)
    ops = [kernel_operand(c) for c in coords]
    n = ops[0].shape[0]
    dev = ops[0].device
    keep_operands(wrapper, n, *kept)
    outs = [torch.empty((n, L), dtype=torch.int32, device=dev) for _ in range(3)]
    rc = getattr(build.library("jub"), entry)(*(t.data_ptr() for t in ops + outs), n, *extra,
                                               stream_handle(dev))
    build.check(rc, entry)
    count_launch(wrapper, n, t0)
    return tuple(o.reshape(shape) for o in outs)


def jub_add(p, q):
    """Complete BabyJubJub addition p + q."""
    t0 = time.perf_counter_ns()
    if on_cpu(*p, *q):
        return jub_add_plain(p, q)
    return _launch("jub_add_launch", jub_add, (*p, *q), (), (p, q), t0)


def jub_scalar_mul(p, scalars, n_bits: int):
    """Σ_{i < n_bits} bit_i(k)·2^i·p for each lane's canonical scalar k
    (int32[..., 16] limbs): n_bits steps of the double-and-add ladder, MSB
    first, in one launch."""
    t0 = time.perf_counter_ns()
    n_bits = check_bits(n_bits)
    if on_cpu(*p, scalars):
        return jub_scalar_mul_plain(p, scalars, n_bits)
    return _launch("jub_scalar_mul_launch", jub_scalar_mul, (*p, scalars), (n_bits,),
                   (p, scalars, n_bits), t0)


zero_counts(jub_add, jub_scalar_mul)
