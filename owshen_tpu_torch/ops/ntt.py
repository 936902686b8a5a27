"""Radix-2 NTT over BN254 Fr, after owshen_tpu/ops/ntt.py and
owshen_tpu/pallas/ntt_kernels.py.

`NttDomain.ntt/intt` run an iterative decimation-in-time transform: a
bit-reversal gather, then log₂n stages, each one launch of K5
(kernels/ntt.py `butterfly_stage`) in place on the transform's array, at
every size (the TPU's 2^14-row threshold for its butterfly kernel came from
Mosaic's lane tiling).  From `settings().ntt_pallas_min_logn` up (default 31,
opt-in, as on the TPU) they route 2-D inputs to `ntt_fused`, the port of
`ntt_pallas`: a recursive Bailey split into fused column NTTs (K7) of at
most 2^FUSED_MAX_LOGN points, with one K1 multiply for the ω^{k1·i2}
correction between the levels and a transpose outside the kernels.  The
1/n scaling of `intt` and the coset multiplies are K1 launches.  Twiddle
and coset tables are built on the device by binary index decomposition and
cached per device."""

from __future__ import annotations

import functools

import torch

from ..config import resolve_device, settings
from ..fields.field import FR, Field
from ..kernels.ntt import bitrev_indices, butterfly_stage, ntt_cols

# Largest fused column of the Bailey split.  The TPU capped it at 2^7 to
# bound Mosaic's compile time; on the card the limit is shared memory: a
# 2^10 column and its 2^9 twiddles take 48.6 KB (8 words each, padded), and
# three blocks of 128 threads share an SM (their registers bound it before
# the SM's 227 KB does).  At 2^20, any cap from 10 up gives the same split
# (2^10 × 2^10: two fused levels, one correction multiply, one transpose);
# a larger cap only changes sizes above 2^20, and costs blocks per SM
# (2^11: two, 2^12: one).
FUSED_MAX_LOGN = 10


def powers_device(F: Field, base: int, n: int, device) -> torch.Tensor:
    """[1, base, base², …, base^(n−1)] in Montgomery form on `device`: the
    host computes base^(2^b); the card combines them by the bits of each
    index in log₂n full-width select-and-multiply steps."""
    logn = max((n - 1).bit_length(), 1)
    idx = torch.arange(n, device=device)
    arr = F.const(1, device=device).expand(n, F.L).clone()
    for b in range(logn):
        mult = F.mul(arr, F.const(pow(base, 1 << b, F.p), device=device))
        arr = F.select(((idx >> b) & 1) == 1, mult, arr)
    return arr


class NttDomain:
    """Power-of-two evaluation domain over Fr with per-device tables.

    `pows`, `pows_inv` (n/2 twiddles, at least 1), `coset_pows` and
    `coset_pows_inv` (n each) are the reference's tables, on `device`: the
    card unless the caller asks for another (config.resolve_device).  The
    transforms take their tables on their input's device."""

    def __init__(self, log_n: int, field: Field = FR, *, device=None):
        if log_n > field.two_adicity:
            raise ValueError(f"2^{log_n} exceeds the field's two-adicity")
        self.F = field
        self.log_n = log_n
        self.n = 1 << log_n
        p = field.p
        self.omega = pow(field.generator, (p - 1) >> log_n, p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(self.n, -1, p)
        self.coset_gen = field.generator   # the generator lies outside H
        self.device = device
        self._tables: dict = {}

    @functools.cached_property
    def pows(self) -> torch.Tensor:
        return self._table("pows", resolve_device(self.device))

    @functools.cached_property
    def pows_inv(self) -> torch.Tensor:
        return self._table("pows_inv", resolve_device(self.device))

    @functools.cached_property
    def coset_pows(self) -> torch.Tensor:
        return self._table("coset", resolve_device(self.device))

    @functools.cached_property
    def coset_pows_inv(self) -> torch.Tensor:
        return self._table("coset_inv", resolve_device(self.device))

    def _table(self, name: str, device):
        dev = torch.device(device)
        key = (name, dev)
        t = self._tables.get(key)
        if t is None:
            F, n = self.F, self.n
            if name == "bitrev":
                t = bitrev_indices(self.log_n).to(dev)
            elif name == "pows":
                t = powers_device(F, self.omega, max(n // 2, 1), dev)
            elif name == "pows_inv":
                t = powers_device(F, self.omega_inv, max(n // 2, 1), dev)
            elif name == "coset":
                t = powers_device(F, self.coset_gen, n, dev)
            elif name == "coset_inv":
                t = powers_device(F, pow(self.coset_gen, -1, F.p), n, dev)
            else:
                raise KeyError(name)
            self._tables[key] = t
        return t

    def _transform(self, x: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
        """x: int32[n, ..., 16] Montgomery -> NTT along axis 0, natural order
        in and out; trailing axes are batch.  One K5 launch per stage."""
        x = x.index_select(0, self._table("bitrev", x.device)).contiguous()
        for s in range(1, self.log_n + 1):
            butterfly_stage(x, pows, s, self.F.name)
        return x

    def _fused_ok(self, x: torch.Tensor) -> bool:
        return (self.F is FR and x.ndim == 2
                and self.log_n >= settings().ntt_pallas_min_logn)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused_ok(x):
            return ntt_fused(x, self.log_n)
        return self._transform(x, self._table("pows", x.device))

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused_ok(x):
            y = ntt_fused(x, self.log_n, inverse=True)
        else:
            y = self._transform(x, self._table("pows_inv", x.device))
        return self.F.mul(y, self.F.const(self.n_inv, device=x.device))

    # ---- coset transforms (h(x) = (AB − C)/Z on a coset, Groth16) ----

    def _per_row(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Table `name` shaped to scale row i of x (n, ..., 16)."""
        t = self._table(name, x.device)
        return t.reshape((self.n,) + (1,) * (x.ndim - 2) + (self.F.L,))

    def coset_ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate a polynomial (coefficient form) on the coset g·H."""
        return self.ntt(self.F.mul(coeffs, self._per_row("coset", coeffs)))

    def coset_intt(self, evals: torch.Tensor) -> torch.Tensor:
        """Inverse: coset evaluations -> coefficient form."""
        return self.F.mul(self.intt(evals), self._per_row("coset_inv", evals))

    def z_on_coset_inv(self) -> int:
        """1 / Z_H(g) where Z_H(x) = x^n − 1 (constant on the coset)."""
        p = self.F.p
        return pow((pow(self.coset_gen, self.n, p) - 1) % p, -1, p)


# ---------------------------------------------------------------------------
# The fused transform (K7 columns, recursive Bailey split)
# ---------------------------------------------------------------------------

def _root(log_n: int, inverse: bool) -> int:
    p = FR.p
    w = pow(FR.generator, (p - 1) >> log_n, p)
    return pow(w, -1, p) if inverse else w


@functools.lru_cache(maxsize=None)
def col_twiddles(log_n1: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """ω_{n1}^j for j < n1/2 (Montgomery), K7's stage table."""
    return powers_device(FR, _root(log_n1, inverse), max((1 << log_n1) // 2, 1), device)


@functools.lru_cache(maxsize=None)
def _full_twiddles(log_m: int, log_a: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """The ω_m^{k1·i2} correction table (a, b, 16) of the split m = a·b,
    built on the device: the m powers of ω_m, then one gather by
    (k1·i2) mod m."""
    m = 1 << log_m
    a, b = 1 << log_a, 1 << (log_m - log_a)
    pows = powers_device(FR, _root(log_m, inverse), m, device)
    k1 = torch.arange(a, device=device)[:, None]
    i2 = torch.arange(b, device=device)[None, :]
    return pows[((k1 * i2) % m).reshape(-1)].reshape(a, b, FR.L)


def _axis0_ntt_rec(mat: torch.Tensor, log_m: int, inverse: bool) -> torch.Tensor:
    """NTT along axis 0 of int32[m, batch, 16] (natural order in and out),
    Bailey-split until a column fits one K7 block: out[k1 + a·k2]."""
    m, batch = mat.shape[0], mat.shape[1]
    if log_m <= FUSED_MAX_LOGN:
        return ntt_cols(mat, col_twiddles(log_m, inverse, mat.device))
    la = min(FUSED_MAX_LOGN, (log_m + 1) // 2)
    lb = log_m - la
    a, b = 1 << la, 1 << lb
    x = _axis0_ntt_rec(mat.reshape(a, b * batch, FR.L), la, inverse)   # A[k1, i2·batch]
    tw = _full_twiddles(log_m, la, inverse, mat.device)[:, :, None, :]
    x = FR.mul(x.view(a, b, batch, FR.L), tw)
    # rows: NTT_b over i2; out[k2, k1] flattens row-major to k1 + a·k2
    x = x.permute(1, 0, 2, 3).contiguous().view(b, a * batch, FR.L)
    x = _axis0_ntt_rec(x, lb, inverse)
    return x.view(m, batch, FR.L)


def ntt_fused(x: torch.Tensor, log_n: int, inverse: bool = False) -> torch.Tensor:
    """The n-point NTT of x int32[n, 16] (Montgomery), natural order in and
    out, through K7 (the port of `ntt_pallas`).  The caller handles the 1/n
    scaling of the inverse."""
    n = 1 << log_n
    if x.shape != (n, FR.L):
        raise ValueError(f"expected int32[{n}, {FR.L}], got {list(x.shape)}")
    if log_n == 0:
        return x.clone()
    return _axis0_ntt_rec(x.reshape(n, 1, FR.L), log_n, inverse).reshape(n, FR.L)
