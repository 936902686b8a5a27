"""K1: modular multiply (Montgomery), add and subtract over BN254 Fr / Fq.

`mont_mul`, `mod_add` and `mod_sub` take int32[..., 16] tensors (16-bit
little-endian limbs, canonical values < p) that broadcast against each
other, and return the canonical result.  On a CUDA tensor each launches
csrc/field_ops.cu (one thread per element) or raises; on a CPU tensor it
runs the plain PyTorch twin in this module, which the tests compare with
the JAX package.  Each wrapper counts its kernel launches in `.launches`,
in `.widths` by width, and its host time per launch in `.host_ns`
(`count_launch`).

The plain twins work limb-major on int64 (16, N) and run on any device.
Over more than `SMALL_N` columns the Montgomery product scans the
multiplier in eight 32-bit words: each step adds a_i·b and m_i·p (32-bit
digit × 16-bit limb < 2^48) into lazily carried 16-bit columns, eight
terms of each per column, so every column stays below 2^52.  Over fewer
columns, where each PyTorch op costs its dispatch and not its width, it
reduces in one shot (`redc_cols`: the TPU kernel's `_redc_from_cols` form)
in about a fifth of the ops.  Both equal the CUDA kernel's word-serial CIOS
and the TPU kernel's `_mul_lm_pend`: all return the canonical
a·b·2^-256 mod p.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..oracle.field import P_FQ, P_FR
from . import build

L = 16
MASK = 0xFFFF
FIELD_INDEX = {"fr": 0, "fq": 1}
MODULI = {"fr": P_FR, "fq": P_FQ}


def limb_rows(v: int, device, n: int = L) -> torch.Tensor:
    """An integer as n limb-major int64 rows (n, 1)."""
    return torch.tensor([(v >> (16 * i)) & MASK for i in range(n)],
                        dtype=torch.int64, device=device)[:, None]


class PlainConsts:
    """Per-modulus, per-device constants of the plain twins."""

    def __init__(self, p: int, device):
        self.p = p
        self.p_rows = limb_rows(p, device)
        n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)      # −p^-1 mod 2^32
        self.n0_lo, self.n0_hi = n0 & MASK, n0 >> 16
        # one-shot reduction (`redc_cols`): −p^-1 mod 2^256, and 2^256 − k·p
        # (k = 0, 1, 2), added to a value below 3p so that the carry out of
        # candidate k says whether k·p fits
        self.nprime_rows = limb_rows((-pow(p, -1, 1 << 256)) % (1 << 256), device)
        self.minus_kp = torch.cat([limb_rows(((1 << 256) - k * p) % (1 << 256), device)
                                   for k in range(3)], dim=1)                   # (16, 3)
        i = torch.arange(L, device=device)
        self.col_of = (i[:, None] + i[None, :]).reshape(-1)     # limb product i·j → column i + j


@functools.lru_cache(maxsize=None)
def plain_consts(field: str, device: torch.device) -> PlainConsts:
    return PlainConsts(MODULI[field], device)


# ---------------------------------------------------------------------------
# plain twins, limb-major int64 (L, N)
# ---------------------------------------------------------------------------

def ripple(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate (K, ...) int64 columns in place into 16-bit limbs and
    return the carry out of the top row (negative for a borrow: the shift
    is arithmetic, so signed columns resolve the same way).  Every row
    passes its carry up at once, until no row has one: each pass keeps the
    value, and 16-bit limbs with a carry out are unique, so this gives the
    row-by-row ripple's limbs in a few passes (one per limb of the longest
    carry chain) instead of K − 1 steps."""
    carry = torch.zeros_like(t[-1])
    while True:
        c = t >> 16
        if not bool(c.any()):
            return carry
        t &= MASK
        t[1:] += c[:-1]
        carry += c[-1]


def _reduce_once(t: torch.Tensor, hi: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    """t − p where (hi != 0 or t >= p), else t; t canonical limbs < 2p."""
    d = t - c.p_rows
    top = ripple(d)                      # 0 when t >= p, −1 on a borrow
    return torch.where((hi != 0) | (top == 0), d, t)


SMALL_N = 256   # columns up to which mul_lm reduces in one shot: the two forms
                # cost the same at 256 on one CPU core, one shot is 2× faster at 64


def _fold(x: torch.Tensor, top: torch.Tensor | None = None) -> None:
    """One carry pass over limb axis 0, in place: each limb keeps its low
    16 bits and passes the rest up; the carry out of the top limb is added
    to `top`, or dropped (the value is then kept mod 2^256)."""
    c = x >> 16
    x &= MASK
    x[1:] += c[:-1]
    if top is not None:
        top += c[-1]


def prod_cols(a: torch.Tensor, b: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    """(2L, N) column sums of the limb products a_i·b_j at column i + j;
    a, b (L, N) or (L, 1) with limbs below 2^17: each column < 2^38."""
    n = max(a.shape[1], b.shape[1])
    return a.new_zeros(2 * L, n).index_add_(0, c.col_of, (a[:, None] * b[None]).reshape(L * L, n))


def redc_cols(t: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    """Canonical T·2^-256 mod p of T given as (2L, N) lazily carried columns
    below 2^40 (changed in place), for T < 1.9·2^256·p: a product of two
    values below 2p, a sum of three products of a value below 2p and a
    canonical one, or a canonical 2L-limb T < 2^256·p.

    One-shot Montgomery reduction: m ≡ T·(−p^-1) mod 2^256 from the low
    columns (three carry passes leave m's limbs ≤ 2^16 + 2^12, so
    m < 1.07·2^256), U = T + m·p has a low half ≡ 0 mod 2^256, whose carry
    out follows from its top three columns alone (the lower ones add less
    than 1 after division, and the division is exact), and U / 2^256 < 3p:
    its three candidates U/2^256 − k·p are carried out together (three
    passes, then `ripple` for what is left) and the largest k that fits is
    taken."""
    n = t.shape[1]
    m = t.new_zeros(2 * L, n).index_add_(
        0, c.col_of, (t[:L, None] * c.nprime_rows[None]).reshape(L * L, n))[:L]
    for _ in range(3):
        _fold(m)
    t.index_add_(0, c.col_of, (m[:, None] * c.p_rows[None]).reshape(L * L, n))
    hi = t[L:]
    hi[0] += (t[L - 1] + ((t[L - 2] + (t[L - 3] >> 16)) >> 16) + MASK) >> 16
    x = (hi[:, None] + c.minus_kp[:, :, None]).reshape(L, 3 * n)
    top = t.new_zeros(3 * n)
    for _ in range(3):
        _fold(x, top)
    top += ripple(x)                                # limbs ≤ 2^16: rarely a pass
    k = top.view(3, n)[1:].sum(0)                   # how many p fit: 0, 1 or 2
    return x.view(L, 3, n).gather(1, k.expand(L, 1, n))[:, 0]


def mul_lm(a: torch.Tensor, b: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    """Montgomery product a·b·2^-256 mod p; a (L, N), b (L, N) or (L, 1);
    values below 2p with limbs below 2^17 (a lazy sum of two canonical
    values) are taken as well as canonical ones."""
    n = max(a.shape[1], b.shape[1])
    if n <= SMALL_N:
        return redc_cols(prod_cols(a, b, c), c)
    a32 = a[0::2] + (a[1::2] << 16)                  # (8, ·) 32-bit words
    acc = torch.zeros(2 * L + 1, n, dtype=torch.int64, device=a.device)
    for i in range(L // 2):
        r = 2 * i
        s = acc[r:r + L]
        s.addcmul_(a32[i:i + 1], b)
        # m = (low 32 bits of the running value)·(−p^-1) mod 2^32, from
        # 16-bit halves so no product reaches 2^63
        lo = acc[r] & MASK
        mid = (acc[r + 1] + (acc[r] >> 16)) & MASK
        m = (lo * c.n0_lo + (((lo * c.n0_hi + mid * c.n0_lo) & MASK) << 16)) & 0xFFFFFFFF
        s.addcmul_(c.p_rows, m[None])                # low 32 bits now zero
        acc[r + 1] += acc[r] >> 16
        acc[r + 2] += acc[r + 1] >> 16
    t = acc[L:]                                      # value < 2p < 2^255
    ripple(t)
    return _reduce_once(t[:L], t[L], c)


def add_lm(a: torch.Tensor, b: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    t = a + b
    hi = ripple(t)
    return _reduce_once(t, hi, c)


def sub_lm(a: torch.Tensor, b: torch.Tensor, c: PlainConsts) -> torch.Tensor:
    d = a - b
    borrow = ripple(d) < 0
    d = d + c.p_rows * borrow[None]
    ripple(d)                            # carry out of 2^256 dropped
    return d


def broadcast_shape(*shapes) -> torch.Size:
    """torch.broadcast_shapes by numpy's rule: the same shape, without
    torch's first-call import of its symbolic-shape machinery (~0.7 s) and
    at ~4 µs a call instead of ~20 (one CPU core)."""
    return torch.Size(np.broadcast_shapes(*shapes))


def to_lm(x: torch.Tensor) -> torch.Tensor:
    """int32 (..., 16) -> int64 limb-major (16, N)."""
    return x.reshape(-1, L).T.to(torch.int64).contiguous()


def from_lm(t: torch.Tensor, shape) -> torch.Tensor:
    return t.T.to(torch.int32).reshape(shape)


MAX_BITS = 256   # the ladders' longest scalar (jub_scalar_mul, g1_ / g2_scalar_mul)


def check_bits(n_bits: int) -> int:
    n_bits = int(n_bits)
    if not 0 <= n_bits <= MAX_BITS:
        raise ValueError(f"n_bits = {n_bits}: the ladder takes 0 to {MAX_BITS} bits")
    return n_bits


def limbs_of_msb_bits(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first bits[n_bits, ...] (n_bits ≤ MAX_BITS; any nonzero value a
    set bit) -> the canonical scalars they spell, int32[..., 16] limbs on
    the bits' device: the ladders' operand."""
    n_bits = check_bits(bits.shape[0])
    lsb = (bits != 0).flip(0).to(torch.int32)
    lsb = torch.cat([lsb, lsb.new_zeros((MAX_BITS - n_bits,) + lsb.shape[1:])])
    weights = (1 << torch.arange(16, dtype=torch.int32, device=lsb.device)).view(
        (1, 16) + (1,) * (lsb.dim() - 1))
    limbs = (lsb.view((16, 16) + lsb.shape[1:]) * weights).sum(1, dtype=torch.int32)
    return limbs.movedim(0, -1)


PLAIN_CHUNK = 1 << 15   # columns per plain call: keeps int64 temporaries in cache


def plain_chunked(fn, n: int, *args, chunk: int = PLAIN_CHUNK):
    """fn over row blocks [i, i + chunk) of (N, ...) arguments (a 1-row
    argument is passed whole), outputs concatenated on axis 0.  fn runs
    under torch.inference_mode, which skips autograd's bookkeeping (about a
    quarter of a small twin call, one CPU core); the outputs are copied out
    of it, so callers may change them in place."""
    with torch.inference_mode():
        if n <= chunk:
            out = fn(*args)
        else:
            outs = [fn(*(x if x.shape[0] == 1 else x[i:i + chunk] for x in args))
                    for i in range(0, n, chunk)]
            out = (tuple(torch.cat(parts) for parts in zip(*outs))
                   if isinstance(outs[0], tuple) else torch.cat(outs))
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


def _plain_binary(fn, a, b, field):
    shape = broadcast_shape(a.shape, b.shape)
    c = plain_consts(field, a.device)
    rows = [x.reshape(1, L) if x.numel() == L else x.expand(shape).reshape(-1, L)
            for x in (a, b)]
    n = max(r.shape[0] for r in rows)
    out = plain_chunked(lambda x, y: from_lm(fn(to_lm(x), to_lm(y), c), (-1, L)),
                        n, *rows)
    return out.reshape(shape)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    return _plain_binary(mul_lm, a, b, field)


def mod_add_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    return _plain_binary(add_lm, a, b, field)


def mod_sub_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    return _plain_binary(sub_lm, a, b, field)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain twin runs);
    False when every operand lies on the current CUDA device; raises on a
    mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")
    return False


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """Contiguous int32 (N, 16) with a 16-byte aligned base, as the kernels
    load rows with 16-byte vector loads."""
    if x.dtype != torch.int32 or x.shape[-1] != L:
        raise TypeError(f"expected int32[..., {L}], got {x.dtype}{list(x.shape)}")
    x = x.reshape(-1, L).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def count_launch(wrapper, n: int, t0: int) -> None:
    """Count one launch of `wrapper`'s kernel over n items: `.launches`,
    `.widths[w] = [launches, items]` for the power of two w at or above n,
    and in `.host_ns` the host's time since the wrapper's entry at t0
    (`time.perf_counter_ns()`)."""
    wrapper.launches += 1
    bucket = wrapper.widths.setdefault(1 << max(0, n - 1).bit_length(), [0, 0])
    bucket[0] += 1
    bucket[1] += n
    wrapper.host_ns += time.perf_counter_ns() - t0


def zero_counts(*wrappers) -> None:
    """Set each wrapper's launch counts and host time to zero."""
    for fn in wrappers:
        fn.launches, fn.widths, fn.host_ns = 0, {}, 0


# {(wrapper, width): operands} while kernels.capture_operands() is on, else None
CAPTURED = None


def _copy(x):
    return tuple(_copy(a) for a in x) if isinstance(x, tuple) else (
        x.clone() if isinstance(x, torch.Tensor) else x)


def keep_operands(wrapper, n: int, *args) -> None:
    """Under kernels.capture_operands(): a copy of the operands of
    `wrapper`'s first launch over n items at n's width (bucketed as
    `count_launch` does), taken before the launch; its plain twin takes the
    same arguments.  Counts nothing."""
    if CAPTURED is not None:
        key = (wrapper, 1 << max(0, n - 1).bit_length())
        if key not in CAPTURED:
            CAPTURED[key] = _copy(args)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_binary(entry: str, wrapper, a, b, field: str, t0: int) -> torch.Tensor:
    shape = broadcast_shape(a.shape, b.shape)
    n = 1
    for d in shape[:-1]:
        n *= d
    ops, steps = [], []
    for x in (a, b):
        if x.numel() == L and n != 1:
            ops.append(kernel_operand(x))
            steps.append(0)
        else:
            ops.append(kernel_operand(x.expand(shape)))
            steps.append(1)
    keep_operands(wrapper, n, a, b, field)
    out = torch.empty((n, L), dtype=torch.int32, device=a.device)
    lib = build.library("field_ops")
    rc = getattr(lib, entry)(ops[0].data_ptr(), ops[1].data_ptr(), out.data_ptr(),
                             n, steps[0], steps[1], FIELD_INDEX[field],
                             stream_handle(a.device))
    build.check(rc, entry)
    count_launch(wrapper, n, t0)
    return out.reshape(shape)


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """Montgomery product a·b·2^-256 mod p (K1)."""
    t0 = time.perf_counter_ns()
    if on_cpu(a, b):
        return mont_mul_plain(a, b, field)
    return _launch_binary("field_mul_launch", mont_mul, a, b, field, t0)


def mod_add(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """(a + b) mod p (K1)."""
    t0 = time.perf_counter_ns()
    if on_cpu(a, b):
        return mod_add_plain(a, b, field)
    return _launch_binary("field_add_launch", mod_add, a, b, field, t0)


def mod_sub(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """(a − b) mod p (K1)."""
    t0 = time.perf_counter_ns()
    if on_cpu(a, b):
        return mod_sub_plain(a, b, field)
    return _launch_binary("field_sub_launch", mod_sub, a, b, field, t0)


zero_counts(mont_mul, mod_add, mod_sub)
