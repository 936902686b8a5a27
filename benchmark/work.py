"""The least work of the port's kernels and the card's peaks, frozen from
`chip_smoke.py` at commit c2af7b2 (`bound`, `PER_ITEM`, `G1_DOUBLE_WORK`,
`JUB_*_WORK`, `jub_ops`, `ladder_work`), so that a change to the program
cannot move the roofline it is held to.

The bound of a launch is the larger of its bytes over the HBM rate (each
input row read once, each output row written once) and its operations over
the 32-bit integer rate (the least the function needs for these inputs)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12
# No data-sheet figure: 64 32-bit multiply-add results per clock per SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) × 132 SMs × 1.98 GHz (clocks.max.sm of an H100 80GB HBM3) × 2
# operations each = 33.4e12, at the 700 W power limit.
INT32_OPS_PER_S = 64 * 132 * 1.98e9 * 2

MUL_OPS = 128 * 2 * 2       # a Montgomery product: 128 32×32→64 products, 2 ops each, twice
SQR_OPS = 100 * 2 * 2       # a square: 36 word products + 64 to reduce
SMALL_MUL_OPS = 16 * 2 * 2  # a product by a one-word constant: 8 word products + 8 to reduce
ADD_OPS = 3 * 8             # add/sub with carry, subtract p, select: 8 words each
ROW = 64                    # bytes of one int32[16] field element

# per item: (bytes, operations)
G1_ADD = (9 * ROW, 12 * MUL_OPS + 27 * ADD_OPS)
# (Fr products, squares, adds and subtracts, products by a one-word constant)
JUB_ADD_WORK = (10, 1, 7, 2)
JUB_DOUBLE_WORK = (3, 4, 7, 1)


def jub_ops(work: tuple) -> int:
    return sum(n * ops for n, ops in zip(work, (MUL_OPS, SQR_OPS, ADD_OPS, SMALL_MUL_OPS)))


JUB_ADD_OPS = jub_ops(JUB_ADD_WORK)
JUB_DOUBLE_OPS = jub_ops(JUB_DOUBLE_WORK)


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def g1_add_s(items: int) -> float:
    """The least seconds of `g1_add` over `items` point pairs (bytes and
    operations are both linear in the items, so launches sum)."""
    return bound_s(items * G1_ADD[0], items * G1_ADD[1])


def ladder_work(scalars, n_bits: int = 254) -> tuple[int, int]:
    """(doubles, adds) a double-and-add over these scalars needs at the
    least: from the top set bit below n_bits down, a double a bit and an add
    a further set bit."""
    doubles = adds = 0
    for v in scalars:
        v &= (1 << n_bits) - 1
        doubles += max(v.bit_length() - 1, 0)
        adds += max(bin(v).count("1") - 1, 0)
    return doubles, adds


def jub_ladder_s(scalars) -> float:
    """The least seconds of one `jub_scalar_mul` launch over these lanes:
    the point (3 rows) and scalar (1 row) in, the point out."""
    doubles, adds = ladder_work(scalars)
    return bound_s(len(scalars) * 7 * ROW, doubles * JUB_DOUBLE_OPS + adds * JUB_ADD_OPS)


def ntt_stage_s(log_n: int, stage: int) -> float:
    """The least seconds of K5's stage `stage` (1-based, m = 2^stage) of a
    2^log_n transform: the array read and written once and the m/2 distinct
    twiddles read; every butterfly adds and subtracts, and all but the n/m
    whose twiddle is 1 multiply."""
    n, m = 1 << log_n, 1 << stage
    ops = (n // 2 - n // m) * MUL_OPS + n * ADD_OPS
    return bound_s((2 * n + m // 2) * ROW, ops)


def ntt_transform_s(log_n: int) -> float:
    return sum(ntt_stage_s(log_n, s) for s in range(1, log_n + 1))
