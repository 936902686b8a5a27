"""Fixed-base windowed scalar multiplication (Groth16 setup's points, the
BabyJubJub base point of EdDSA).

host (once per base):  T[w][d] = d · 2^(c·w) · G for every window w and
                       digit d < 2^c, from host oracle adds;
card (per batch):      k·G = Σ_w T[w][digit_w(k)] — one row gather and
                       W − 1 wide complete adds (K2 over G1, the G2
                       kernel over G2, K1-composed Edwards adds for
                       BabyJubJub).
"""

from __future__ import annotations

import functools

import torch

from ..ops.msm import _flat_rows, _unflat_rows, sum_scan, window_digits


class FixedBase:
    """Window tables for one (curve, generator) pair.

    curve: curve ops (Weierstrass, babyjubjub.JUB_OPS); oracle: host curve
    with identity None; encode: host points -> projective tensors (e.g.
    bn254.g1_encode); gen: affine generator."""

    def __init__(self, curve, oracle, encode, gen, c: int = 8, n_bits: int = 256):
        self.curve = curve
        self.c = c
        self.n_bits = n_bits
        self.n_windows = (n_bits + c - 1) // c
        pts = []
        base = gen
        for _ in range(self.n_windows):
            acc = None
            pts.append(None)
            for _ in range(1, 1 << c):
                acc = oracle.add(acc, base)
                pts.append(acc)
            for _ in range(c):
                base = oracle.add(base, base)
        self.rows, self.widths, self.shapes = _flat_rows(encode(pts))  # host
        self._on_device: dict = {}

    def rows_on(self, device: torch.device) -> torch.Tensor:
        rows = self._on_device.get(device)
        if rows is None:
            rows = self.rows.to(device)
            self._on_device[device] = rows
        return rows

    def mul(self, scalars: torch.Tensor):
        """scalars: canonical int32[n, 16] -> projective points [n, ...]."""
        digits = window_digits(scalars, self.c, self.n_bits)   # (W, n)
        wi = torch.arange(self.n_windows, device=scalars.device)[:, None]
        idx = (wi * (1 << self.c) + digits).reshape(-1)
        g = self.rows_on(scalars.device).index_select(0, idx)
        pts = _unflat_rows(g, self.widths, self.shapes)
        n = scalars.shape[0]
        pts = tuple(a.reshape((self.n_windows, n) + a.shape[1:]) for a in pts)
        return sum_scan(self.curve, pts, axis=0)


@functools.lru_cache(maxsize=None)
def g1_fixed_base(c: int = 8) -> FixedBase:
    from ..oracle import curve as ocurve
    from . import bn254
    return FixedBase(bn254.G1, ocurve.G1, bn254.g1_encode, ocurve.G1_GEN, c)


@functools.lru_cache(maxsize=None)
def g2_fixed_base(c: int = 8) -> FixedBase:
    from ..oracle import curve as ocurve
    from . import bn254
    return FixedBase(bn254.G2, ocurve.G2, bn254.g2_encode, ocurve.G2_GEN, c)


@functools.lru_cache(maxsize=None)
def jub_fixed_base(c: int = 8) -> FixedBase:
    """Window tables of the BabyJubJub base point: EdDSA's s·B, r·B and a·B
    as one gather and 31 batched complete adds instead of a 254-step ladder.
    All 256 bits are kept (32 windows at c = 8), as an EdDSA s may exceed p."""
    from . import babyjubjub as jub
    return FixedBase(jub.JUB_OPS, jub._JubOracle(), jub.jub_encode, jub.BASE, c)
