"""Pippenger multi-scalar multiplication, after owshen_tpu/ops/msm.py.

Two engines compute Σ s_i·P_i, and `msm` routes between them by n as the
reference does (n < 2^17: the lane engine; n ≥ 2^17: `msm_sorted`):

  * the lane engine (`msm`): all 256/c windows' digits at once; the points
    are folded row by row into lane-private buckets (W, lanes, 2^c), each
    row one (W·lanes)-wide add with a gather and a scatter at unique
    indices; the lanes are combined by a loop of (W, 2^c)-wide adds, each
    window's Σ j·B_j is a suffix sum (`_weighted_sum`) and the windows meet
    in a Horner of c doublings;
  * the window-serial sorted engine (`msm_sorted`, the 2^22 path): signed
    c-bit digits (magnitudes ≤ 2^(c−1), a negation is a y flip); per
    window, MSB first: sort by magnitude, gather the points into sorted
    order, chunked prefix sums over the sorted sequence, and the window sum
    read off the prefixes at the bucket boundaries,
      Σ_j j·B_j = m·S_n − Σ_{j<m} S_{e_j},   e_j = #digits ≤ j, m = 2^(c−1),
    folded into the Horner carry.  The reference loops over the windows;
    here `msm_sorted_many` takes the windows of several MSMs on one curve
    side by side in each launch, and their Horner steps in one.

Each `lax.scan` of the reference is a Python loop of whole-batch kernel
launches here: every add and double is one K2 / K3 launch over G1 and one
`g2_add` / `g2_double` over G2, a negation one K1 subtraction.  The sort,
the gathers and the boundary search are PyTorch library calls
(`torch.sort`, `index_select`, `torch.searchsorted`), as they were XLA
work, not Pallas kernels, in the reference.  Buckets are updated in place
where the reference rebuilds them.

The segmented and plain prefix scans are the reference's building blocks
for its distributed reducers, kept and tested here."""

from __future__ import annotations

import torch

from ..config import settings
from ..runtime.metrics import metrics

GATHER_BUDGET = 4 << 30   # bytes of gathered point rows `msm_sorted_many` takes a pass


def _bcast(ident, shape):
    """Single-point leaves `ident` broadcast to the leading shape `shape`."""
    return tuple(iz.expand(tuple(shape) + iz.shape) for iz in ident)


# ---------------------------------------------------------------------------
# Digits and point rows
# ---------------------------------------------------------------------------

def window_digits(scalars: torch.Tensor, c: int, n_bits: int = 256) -> torch.Tensor:
    """Canonical 16-bit-limb scalars int32[n, 16] -> int32[n_windows, n]
    with digits[w] = (s >> w·c) & (2^c − 1).  c must divide 16."""
    if 16 % c:
        raise ValueError(f"window width {c} must divide 16")
    n_windows = (n_bits + c - 1) // c
    per_limb = 16 // c
    w = torch.arange(n_windows, dtype=torch.int32, device=scalars.device)
    limbs = scalars.to(torch.int32)[:, (w // per_limb).long()]      # (n, W)
    digits = (limbs >> ((w % per_limb) * c)) & ((1 << c) - 1)
    return digits.T.contiguous()


def _signed_digits(scalars: torch.Tensor, c: int):
    """Canonical int32[n, 16] -> signed base-2^c digits: (mag int32[W, n]
    in [0, 2^(c−1)], sgn bool[W, n]), W = 256 // c.  Scalars below 2^254
    leave the top window room for the final carry, which is dropped: `msm`
    checks the top limb before it routes a batch here."""
    digits = window_digits(scalars, c)
    carry = torch.zeros(digits.shape[1], dtype=torch.int32, device=digits.device)
    mags, sgns = [], []
    for d in digits:
        t = d + carry
        big = t >= (1 << (c - 1))
        signed = t - big.to(torch.int32) * (1 << c)
        carry = big.to(torch.int32)
        mags.append(signed.abs())
        sgns.append(signed < 0)
    return torch.stack(mags), torch.stack(sgns)


def _flat_rows(pt):
    """Projective point tuple with (n, ...) leaves -> (n, F) row matrix and
    split metadata, so one row gather moves a whole point."""
    n = pt[0].shape[0]
    flats = [leaf.reshape(n, -1) for leaf in pt]
    return (torch.cat(flats, dim=1), [f.shape[1] for f in flats],
            [tuple(leaf.shape[1:]) for leaf in pt])


def _point_rows(points, gather_pad: int | None):
    """`_flat_rows`, each row zero-padded to `gather_pad` int32 words when
    that is wider (the reference's 128-word TPU vreg rows; the gather
    reads the row's own width back out)."""
    rows, widths, shapes = _flat_rows(points)
    if gather_pad is not None and rows.shape[1] < gather_pad:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], gather_pad - rows.shape[1]))],
                         dim=1)
    return rows, widths, shapes


def _unflat_rows(rows: torch.Tensor, widths, shapes):
    out, off = [], 0
    for w, s in zip(widths, shapes):
        out.append(rows[:, off:off + w].reshape((rows.shape[0],) + tuple(s)))
        off += w
    return tuple(out)


def pad_points(curve, points, n_to: int):
    """Pad a projective tuple of (n, ...) leaves with identities to n_to rows."""
    n = points[0].shape[0]
    if n_to == n:
        return points
    ident = curve.identity_like(points[0][0])
    return tuple(torch.cat([a, iz.expand((n_to - n,) + iz.shape)]) for a, iz in zip(points, ident))


def _pad_identity(curve, points, scalars, n_to: int):
    """Pad points with identities and scalars with zeros to n_to rows."""
    pad = scalars.new_zeros((n_to - scalars.shape[0],) + scalars.shape[1:])
    return pad_points(curve, points, n_to), torch.cat([scalars, pad])


def pad_to_pow2(points, scalars, curve):
    """Pad (points, scalars) so n is a power of two (the engines pad
    internally; kept for callers that want the shapes fixed)."""
    n = scalars.shape[0]
    return _pad_identity(curve, points, scalars, 1 << max(0, (n - 1).bit_length()))


# ---------------------------------------------------------------------------
# Prefix scans
# ---------------------------------------------------------------------------

def _seg_combine(curve, a, b):
    """The segmented scan's combiner over (points, start flags)."""
    (pa, fa), (pb, fb) = a, b
    return curve.select(fb, pb, curve.add(pa, pb)), fa | fb


def _scan_steps(curve, carry, points, flags):
    """Inclusive segmented scan along axis 0 from `carry`, one combine (one
    add) per step: (stacked points, stacked flags, last carry)."""
    outs, outf = [], []
    for i in range(flags.shape[0]):
        carry = _seg_combine(curve, carry, (tuple(a[i] for a in points), flags[i]))
        outs.append(carry[0])
        outf.append(carry[1])
    return tuple(torch.stack(leaves) for leaves in zip(*outs)), torch.stack(outf), carry


def segmented_scan(curve, points, flags, chunk: int = 512):
    """Inclusive segmented prefix EC sum along axis 0.

    points: tuple of [n, ...] leaves; flags: bool[n] (True = segment
    start).  Returns (scan points, seen-start flags).  n must be a power of
    two; above `chunk`, the n/chunk lanes scan their slices side by side
    and a recursion over the lanes' totals supplies each lane's prefix."""
    n = flags.shape[0]
    ident = curve.identity_like(points[0][0])
    if n <= chunk:
        init = (ident, torch.zeros((), dtype=torch.bool, device=flags.device))
        outs, outf, _ = _scan_steps(curve, init, points, flags)
        return outs, outf
    lanes = n // chunk
    # lane k owns [k·chunk, (k+1)·chunk): step t adds element t of every lane
    pts_t = tuple(a.reshape((lanes, chunk) + a.shape[1:]).transpose(0, 1) for a in points)
    init = (_bcast(ident, (lanes,)), torch.zeros(lanes, dtype=torch.bool, device=flags.device))
    outs, outf, (last_p, last_f) = _scan_steps(curve, init, pts_t,
                                               flags.reshape(lanes, chunk).T)
    inc_p, inc_f = segmented_scan(curve, last_p, last_f, chunk)
    exc_p = tuple(torch.cat([iz[None], a[:-1]]) for a, iz in zip(inc_p, ident))
    exc_f = torch.cat([inc_f.new_zeros(1), inc_f[:-1]])
    # out[t, k] = combine(exc[k], out[t, k]): a start inside the lane wins
    fixed = curve.select(outf, outs, curve.add(tuple(a[None] for a in exc_p), outs))
    outf = outf | exc_f[None, :]
    return (tuple(a.transpose(0, 1).reshape((n,) + a.shape[2:]) for a in fixed),
            outf.T.reshape(n))


def plain_scan(curve, points, chunk: int = 512):
    """Inclusive (non-segmented) EC prefix scan along axis 0."""
    flags = torch.zeros(points[0].shape[0], dtype=torch.bool, device=points[0].device)
    return segmented_scan(curve, points, flags, chunk)[0]


def sum_scan(curve, pts, axis: int = 0):
    """EC sum along `axis` as a loop of wide adds (N − 1 adds)."""
    pts_t = tuple(torch.movedim(a, axis, 0) for a in pts)
    acc = tuple(a[0] for a in pts_t)
    for k in range(1, pts_t[0].shape[0]):
        acc = curve.add(acc, tuple(a[k] for a in pts_t))
    return acc


def _weighted_sum(curve, buckets):
    """Σ_{j≥1} j·B_j along axis 1 of (W, m, ...) buckets, as a suffix sum
    with the running total beside it: two (W)-wide adds per bucket.
    Returns (W, ...)."""
    n_windows, m = buckets[0].shape[:2]
    suf = tot = _bcast(curve.identity_like(buckets[0][0, 0]), (n_windows,))
    for j in range(m - 1, 0, -1):
        suf = curve.add(suf, tuple(a[:, j] for a in buckets))
        tot = curve.add(tot, suf)
    return tot


def _shift_down_ident(pts, k: int, ident):
    """pts rows shifted down k along axis 0, identity-filled at the top."""
    return tuple(torch.cat([iz.expand((k,) + iz.shape), a[:-k]]) for a, iz in zip(pts, ident))


def _hs_exclusive_prefix(curve, pts):
    """Exclusive EC prefix along axis 0 in log₂C full-width adds
    (Hillis–Steele; the identity fill needs no mask under complete
    formulas)."""
    C = pts[0].shape[0]
    ident = curve.identity_like(pts[0][0])
    cur = _shift_down_ident(pts, 1, ident)
    k = 1
    while k < C:
        cur = curve.add(cur, _shift_down_ident(cur, k, ident))
        k *= 2
    return cur


def total_sum_wide(curve, pts, wide: int = 1 << 14):
    """Σ of an (n, ...) point tuple in n/wide − 1 + log₂wide steps of
    `wide`-wide adds: fold n down to `wide`, then an inclusive
    Hillis–Steele prefix whose last row is the total."""
    n = pts[0].shape[0]
    wide = min(wide, n)
    if n > wide:
        pts = sum_scan(curve, tuple(a.reshape((n // wide, wide) + a.shape[1:]) for a in pts))
    ident = curve.identity_like(pts[0][0])
    k = 1
    while k < wide:
        pts = curve.add(pts, _shift_down_ident(pts, k, ident))
        k *= 2
    return tuple(a[wide - 1] for a in pts)


def _prefix_chunk_scan(curve, seq):
    """Inclusive prefix sums of chunks of Q elements laid side by side.

    seq: tuple of (Q, C, ...) leaves, column c holding chunk c's elements
    in order (the reference takes the sequence itself and moves the axes;
    the port's caller gathers straight into this layout, so every step's
    operand is contiguous; `msm_sorted_many` lays the chunks of G windows
    side by side).  Q steps of one C-wide add.  Returns
      P   — (Q, C, ...): P[q, c] = sum of chunk c's elements 0..q
      totals — (C, ...): each chunk's sum
    so, with EXC[c] the sum of all chunks before c of one sequence,
    prefix(e) = EXC[e // Q] + (e % Q > 0 ? P[e % Q − 1, e // Q] : 0)."""
    acc = curve.identity_like(seq[0][0])
    steps = []
    for q in range(seq[0].shape[0]):
        acc = curve.add(acc, tuple(a[q] for a in seq))
        steps.append(acc)
    P = tuple(torch.stack(leaves) for leaves in zip(*steps))
    return P, acc


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

def _gather_window(rows, widths, shapes, mag_w, sgn_w, C: int, Q: int, offs=None):
    """Windows' points in sorted order: a stable sort by |digit| per window
    and one row gather straight into the prefix scan's (Q, G, C) layout
    (element c·Q + q of window g's sorted sequence goes to row
    (q·G + g)·C + c).  mag_w / sgn_w: (n,) for one window or (G, n) for G
    windows, whose point rows start at `offs` (G,) in `rows` (0 without
    it).  Returns the gathered (x, y, z) leaves of (Q·G·C, ...), their
    negate flags and the sorted keys, shaped as mag_w."""
    one = mag_w.dim() == 1
    mag_g, sgn_g = (mag_w[None], sgn_w[None]) if one else (mag_w, sgn_w)
    G = mag_g.shape[0]
    skeys, perm = torch.sort(mag_g, dim=1, stable=True)
    to_qgc = lambda t: t.view(G, C, Q).permute(2, 0, 1).reshape(-1)  # noqa: E731
    at = perm if offs is None else perm + offs[:, None]
    g = rows.index_select(0, to_qgc(at))                 # the big gather
    fwidth = sum(widths)
    xyz = tuple(a.contiguous() for a in _unflat_rows(g[:, :fwidth], widths, shapes))
    return xyz, to_qgc(sgn_g.gather(1, perm)), skeys[0] if one else skeys


def _window_prefixes(curve, xyz, skeys, C: int, Q: int, m: int):
    """G windows' totals and their boundary prefixes S_{e_j} for all m
    buckets, from the chunked prefix sums of the signed, gathered points
    `xyz` ((Q·G·C, ...) leaves in the (Q, G, C) layout) and the sorted keys
    (G, n).  Returns (total, s_j): total of (G, ...) leaves, s_j of
    (m, G, ...)."""
    G = skeys.shape[0]
    P, totals = _prefix_chunk_scan(curve, tuple(a.view((Q, G * C) + a.shape[1:]) for a in xyz))
    by_c = tuple(a.view((G, C) + a.shape[1:]).transpose(0, 1).contiguous() for a in totals)
    EXC = _hs_exclusive_prefix(curve, by_c)                        # (C, G, ...)
    total = curve.add(tuple(a[C - 1] for a in EXC), tuple(a[C - 1] for a in by_c))
    # S_{e_j} = EXC[e // Q] + (e % Q > 0 ? P[e % Q − 1, e // Q] : identity),
    # gathered in (m, G) order so that the sum over j runs along axis 0
    keys = torch.arange(m, dtype=skeys.dtype, device=skeys.device).expand(G, m).contiguous()
    e = torch.searchsorted(skeys, keys, right=True).T               # (m, G)
    g = torch.arange(G, device=e.device)
    c_idx = torch.clamp(e // Q, 0, C - 1)
    r_idx = e - c_idx * Q
    exc_j = tuple(a.reshape((C * G,) + a.shape[2:]).index_select(0, (c_idx * G + g).reshape(-1))
                  for a in EXC)
    p_idx = (torch.clamp(r_idx - 1, 0, Q - 1) * G + g) * C + c_idx
    p_j = tuple(a.reshape((Q * G * C,) + a.shape[2:]).index_select(0, p_idx.reshape(-1))
                for a in P)
    s_j = curve.select(r_idx.reshape(-1) > 0, curve.add(exc_j, p_j), exc_j)
    return total, tuple(a.view((m, G) + a.shape[1:]) for a in s_j)


def msm_sorted(curve, points, scalars, c: int | None = None,
               gather_pad: int | None = None):
    """Σ scalars[i]·points[i], the window-serial sorted engine (BASELINE
    config 4): `msm_sorted_many` of one job.

    curve: a Weierstrass; points: projective tuple of [n, ...] leaves;
    scalars: canonical int32[n, 16] below 2^254.  c: window bits
    (OWSHEN_MSM_C, 16; the CPU tests use 8).  gather_pad: int32 words a
    point row is padded to for the per-window gather (OWSHEN_MSM_GATHER_PAD;
    none by default, the reference's 128 was the TPU's vreg width).  n is
    padded to a power of two ≥ 128.  Returns one projective point."""
    return msm_sorted_many(curve, [(points, scalars)], c, gather_pad)[0]


def msm_sorted_many(curve, jobs, c: int | None = None, gather_pad: int | None = None):
    """[Σ scalars[i]·points[i] for (points, scalars) in jobs] on one curve,
    the sorted engine over all jobs' windows together.

    Every job is padded to the same power of two n ≥ 128 (identity points,
    zero scalars); c and gather_pad as in `msm_sorted`.  The (window, job)
    pairs are taken in groups whose gathered rows fit GATHER_BUDGET bytes,
    each group one pass of whole-group launches: a stable sort by |digit|,
    one row gather into the prefix scan's (Q, G, C) layout
    (`_gather_window`), one negation of the gathered y (the reference
    fuses it into each scan step for XLA's sake), the chunked prefix sums
    and the boundary prefixes S_{e_j} for all m buckets
    (`_window_prefixes`) and their sums.  The windows then meet, MSB first,
    in one Horner over all jobs at once:
    2^c·acc + m·total − Σ S_{e_j} = 2^(c−1)·(2·acc + total) − Σ.

    Spans (host time launching; none waits for the card): `msm.gather`
    (the digits, the sort, the gather, the negation) and `msm.prefix` (the
    prefixes and their sums) a group, `msm.horner` the Horner."""
    cfg = settings()
    if c is None:
        c = cfg.msm_window_bits
    if gather_pad is None:
        gather_pad = cfg.msm_gather_pad
    K = curve.K
    J = len(jobs)
    n = 1 << max(7, (max(sc.shape[0] for _, sc in jobs) - 1).bit_length())
    m = 1 << (c - 1)
    C = min(cfg.msm_chunk_c, max(n // 4, 1))
    Q = n // C
    with metrics.timer("msm.gather"):
        padded = [_pad_identity(curve, pts, sc, n) for pts, sc in jobs]
        flat = [_point_rows(pts, gather_pad) for pts, _ in padded]
        rows = torch.cat([f[0] for f in flat]) if J > 1 else flat[0][0]
        widths, shapes = flat[0][1], flat[0][2]
        mag, sgn = _signed_digits(torch.cat([sc for _, sc in padded]), c)    # (W, J·n)
        W = mag.shape[0]
        # pair b = w·J + j: window w of job j, whose rows start at j·n
        mag, sgn = mag.reshape(W * J, n), sgn.reshape(W * J, n)
        offs = (torch.arange(J, device=mag.device) * n).repeat(W)
    G = max(1, min(W * J, GATHER_BUDGET // (n * rows.shape[1] * rows.element_size())))
    totals, sums = [], []
    for b0 in range(0, W * J, G):
        b1 = min(b0 + G, W * J)
        with metrics.timer("msm.gather"):
            (x, y, z), neg, skeys = _gather_window(rows, widths, shapes, mag[b0:b1],
                                                   sgn[b0:b1], C, Q, offs[b0:b1])
            y = K.select(neg, K.neg(y), y)
        with metrics.timer("msm.prefix"):
            total, s_j = _window_prefixes(curve, (x, y, z), skeys, C, Q, m)
            totals.append(total)
            sums.append(total_sum_wide(curve, s_j, wide=min(1 << 14, m)))
    with metrics.timer("msm.horner"):
        total, s_sum = (tuple(torch.cat(leaves).view((W, J) + leaves[0].shape[1:])
                              for leaves in zip(*parts)) for parts in (totals, sums))
        acc = curve.identity_like(total[0][0])
        for w in reversed(range(W)):
            t = curve.add(curve.double(acc), tuple(a[w] for a in total))
            for _ in range(c - 1):
                t = curve.double(t)
            acc = curve.add(t, curve.neg(tuple(a[w] for a in s_sum)))
    return [tuple(a[j] for a in acc) for j in range(J)]


def msm(curve, points, scalars, c: int = 8, n_bits: int = 256, lanes: int = 1024):
    """Σ scalars[i]·points[i].

    curve: a Weierstrass; points: projective tuple of [n, ...] leaves;
    scalars: canonical int32[n, 16].  Any n (padded to a multiple of
    `lanes` with identities).  Returns one projective point.

    n ≥ 2^17 goes to `msm_sorted` at its own window width, which needs
    scalars below 2^254 + slack (all reduced BN254 Fr scalars are): its
    signed recoding drops the final carry out of the top window, so a
    scalar whose top limb is ≥ 2^15 raises ValueError there.  Below, the
    lane engine: `lanes` trades bucket memory (W·lanes·2^c points) against
    n/lanes sequential row steps, c the window count (256/c) against the
    bucket work (lanes·2^c adds)."""
    if c not in (2, 4, 8, 16):
        raise ValueError(f"window width {c}: expected 2, 4, 8 or 16")
    n = scalars.shape[0]
    if n >= (1 << 17) and scalars.shape[-1] == 16:
        top = int(scalars[..., 15].max()) if n else 0
        if top >= 1 << 15:
            raise ValueError(
                "msm at n >= 2^17 requires canonical scalars (< 2^254 + slack); "
                f"top limb {top:#x} overflows the sorted engine's top window")
        return msm_sorted(curve, points, scalars)
    lanes = max(1, min(lanes, n))
    n_rows = (n + lanes - 1) // lanes
    points, scalars = _pad_identity(curve, points, scalars, n_rows * lanes)
    n_windows = (n_bits + c - 1) // c
    dev = scalars.device
    digits = window_digits(scalars, c, n_bits).reshape(n_windows, n_rows, lanes).long()
    pts_rows = tuple(a.reshape((n_rows, lanes) + a.shape[1:]) for a in points)

    # lane-private buckets: row r adds point (r, l) into bucket
    # (w, l, digit) of every window at once, unique indices, in place
    wi = torch.arange(n_windows, device=dev)[:, None]
    li = torch.arange(lanes, device=dev)[None, :]
    ident = curve.identity_like(points[0][0])
    buckets = tuple(b.clone() for b in _bcast(ident, (n_windows, lanes, 1 << c)))
    for r in range(n_rows):
        d = digits[:, r]
        cur = tuple(b[wi, li, d] for b in buckets)
        new = curve.add(cur, tuple(a[r][None].expand((n_windows,) + a[r].shape)
                                   for a in pts_rows))
        for b, v in zip(buckets, new):
            b[wi, li, d] = v

    buckets = sum_scan(curve, buckets, axis=1)                     # (W, 2^c, ...)
    if (1 << c) <= 512:
        wsum = _weighted_sum(curve, buckets)
    else:
        # j = hi·2^cl + lo, so the suffix sums run 2^(c/2) steps, not 2^c
        ch = c // 2
        cl = c - ch
        split = tuple(a.reshape((n_windows, 1 << ch, 1 << cl) + a.shape[2:]) for a in buckets)
        whi = _weighted_sum(curve, sum_scan(curve, split, axis=2))   # Σ hi·Σ_lo B
        wlo = _weighted_sum(curve, sum_scan(curve, split, axis=1))   # Σ lo·Σ_hi B
        for _ in range(cl):
            whi = curve.double(whi)
        wsum = curve.add(whi, wlo)

    acc = ident
    for w in reversed(range(n_windows)):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, tuple(a[w] for a in wsum))
    return acc
