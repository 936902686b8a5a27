"""Fixed-point MSM with precomputed window tables (the Groth16 prover's
commitment engine), after owshen_tpu/ops/msm_fixed.py.

  table[w, d, i] = d · 2^(c·w) · P_i      (signed digits: d = |digit|)

so  Σ_i s_i·P_i = Σ_{w,i} sgn_{w,i} · table[w, |digit_{w,i}|, i]: one row
gather of W·n points, a conditional y-negation and a halving tree of wide
complete adds.  Over G1 every add and double is one K2 / K3 launch.

Tables are stored as one row matrix (W, D, N, F): F int32 values per point
(x | y | z), N the points of every set side by side, so one build and one
gather serve all the prover's G1 point sets.  At c = 4 (W = 64, D = 9) a set
of n points takes 64·9·n rows.
"""

from __future__ import annotations

import torch

from .msm import _flat_rows, _signed_digits, _unflat_rows, pad_points


def _pad_points_pow2(curve, points, n_min: int = 1):
    """Pad a projective tuple with identities so n is a power of two
    (at least n_min)."""
    n = points[0].shape[0]
    return pad_points(curve, points, 1 << max((n - 1).bit_length(), (n_min - 1).bit_length()))


def build_table(curve, points, c: int = 4):
    """Rows (W, D, n, F) with rows[w, d] = d · 2^(c·w) · points, and the
    (widths, shapes) that split a row back into (x, y, z)."""
    if c not in (2, 4):
        raise ValueError("fixed tables use c = 2 or 4")
    D = (1 << (c - 1)) + 1  # magnitudes 0 .. 2^(c−1)
    W = 256 // c
    first, widths, shapes = _flat_rows(points)
    n, F = first.shape
    rows = torch.empty((W, D, n, F), dtype=first.dtype, device=first.device)
    rows[:, 0] = _flat_rows(curve.identity_like(points[0]))[0]
    base = points
    for w in range(W):
        rows[w, 1] = _flat_rows(base)[0]
        acc = base
        for d in range(2, D):
            acc = curve.add(acc, base)
            rows[w, d] = _flat_rows(acc)[0]
        base = curve.double(acc)        # 2·(D − 1)·B = 2^c·B
    return rows, widths, shapes


def fold_sum_batched(curve, pts):
    """Per-set Σ over axis 1 of an (S, n, ...) point tuple, n a power of
    two: a halving tree, each level one (S, n/2)-wide add of the lower half
    and the upper half.  (The JAX package folds through lax.scans of
    fixed-width adds to keep one add in its compiled graph; eager PyTorch
    has no such cost, and log₂n wide launches beat ~180 narrow ones.)"""
    n = pts[0].shape[1]
    while n > 1:
        n //= 2
        pts = curve.add(tuple(a[:, :n] for a in pts), tuple(a[:, n:] for a in pts))
    return tuple(a[:, 0] for a in pts)


def fold_sum(curve, pts):
    """Σ of an (n, ...) point tuple, n a power of two."""
    return tuple(a[0] for a in fold_sum_batched(curve, tuple(a[None] for a in pts)))


def msm_fixed_multi(curve, rows, widths, shapes, scalars, n: int, slots,
                    c: int = 4):
    """S fixed-table MSMs in one pass.

    rows: (W, D, T·n, F) table of T point sets of n points; scalars:
    canonical int32[S, n, 16]; slots: set -> table index (sets may share a
    table).  Returns a projective tuple of (S, ...) per-set sums."""
    K = curve.K
    W, D, N, F = rows.shape
    S = scalars.shape[0]
    if len(slots) != S:
        raise ValueError("one slot per scalar set")
    dev = rows.device
    mag, sgn = _signed_digits(scalars.reshape(S * n, 16), c)   # (W, S·n)
    wi = torch.arange(W, device=dev)[:, None, None]
    ti = torch.as_tensor(slots, device=dev)[None, :, None]
    ii = torch.arange(n, device=dev)[None, None, :]
    idx = (wi * D + mag.reshape(W, S, n)) * N + ti * n + ii
    g = rows.reshape(-1, F).index_select(0, idx.reshape(-1))   # (W·S·n, F)
    x, y, z = _unflat_rows(g, widths, shapes)
    y = K.select(sgn.reshape(-1), K.neg(y), y)

    def to_sets(a):
        a = a.reshape((W, S, n) + a.shape[1:])
        return a.transpose(0, 1).reshape((S, W * n) + a.shape[3:])

    return fold_sum_batched(curve, tuple(to_sets(a) for a in (x, y, z)))


def msm_fixed(curve, rows, widths, shapes, scalars, c: int = 4):
    """One MSM against a single-set table (rows (W, D, n, F)); scalars:
    canonical int32[n, 16]."""
    n = rows.shape[2]
    out = msm_fixed_multi(curve, rows, widths, shapes, scalars[None], n, (0,), c)
    return tuple(a[0] for a in out)


class FixedMsmGroup:
    """Same-size fixed point sets sharing one table and one fused compute
    path.  Build from point sets (one table build over all of them side by
    side) or restore from rows (`from_rows`)."""

    def __init__(self, curve, point_sets, c: int = 4, n_min: int = 1,
                 _rows=None, _meta=None):
        self.curve = curve
        self.c = c
        if _rows is not None:
            self.rows = _rows
            self.n, self.n_tables, self.widths, self.shapes = _meta
            return
        padded = [_pad_points_pow2(curve, pts, n_min) for pts in point_sets]
        self.n = padded[0][0].shape[0]
        if any(p[0].shape[0] != self.n for p in padded):
            raise ValueError("point sets pad to different sizes")
        self.n_tables = len(padded)
        side_by_side = curve.cat(padded, dim=0) if len(padded) > 1 else padded[0]
        self.rows, self.widths, self.shapes = build_table(curve, side_by_side, c)

    @property
    def meta(self):
        return (self.n, self.n_tables, self.widths, self.shapes)

    @classmethod
    def from_rows(cls, curve, rows, meta, c: int = 4):
        return cls(curve, None, c=c, _rows=rows, _meta=meta)

    def mul_multi(self, scalars, slots):
        """scalars: canonical int32[S, n, 16]; slots: tuple set -> table."""
        return msm_fixed_multi(self.curve, self.rows, self.widths, self.shapes,
                               scalars, self.n, tuple(slots), self.c)


class FixedMsm(FixedMsmGroup):
    """Precomputed fixed-point MSM over one point set."""

    def __init__(self, curve, points, c: int = 4, n_min: int = 1, _rows=None,
                 _meta=None):
        super().__init__(curve, None if points is None else [points], c, n_min,
                         _rows, _meta)

    def mul(self, scalars):
        """scalars: canonical int32[k, 16] with k <= n (zero-padded here)."""
        k = scalars.shape[0]
        if k != self.n:
            pad = torch.zeros((self.n - k, scalars.shape[1]), dtype=scalars.dtype,
                              device=scalars.device)
            scalars = torch.cat([scalars, pad])
        return msm_fixed(self.curve, self.rows, self.widths, self.shapes, scalars, self.c)
