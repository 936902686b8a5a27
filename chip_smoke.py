#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (owshen_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card and its power limit (nvidia-smi).
2. Builds the hand-written kernels (one nvcc per source, in parallel) and
   holds each one against its plain PyTorch twin on the card, at the shape
   its path gives it, including the edge values 0, 1, p − 1, the identity,
   P + P and P + (−P); equality is exact.  K1–K4 at the depth-16 shapes
   (K2 also at widths 1, 127, 129 and 81,919, K4 at 1, 31, 4095 and 4097,
   K1's G2 add and double at 1, 2, 63, 64, 65, 8192 and 2^18 points),
   K3 at N = 1, 2, 3, 4, 5, 63, 65, 8191, 8192 and 2^18 (edge points
   first), K5 on the last stage of the 2^20 NTT, K6 at 2^16 hashes (and at
   N = 1, 33, 1000 and on edge rows), K7 at log_n1 = 1, 2, 3, 5, 10 and 12,
   forward and inverse, on 1, 3, 1023 and 1024 columns with 0, 1 and p − 1
   in every column, and on the first level of the 2^20 fused NTT.
   Times kernel and twin (profiler device time, CUDA events), computes each
   kernel's bound from its inputs, times K1 at one element (the card's
   floor per launch) and K4 at one hash (its chain's latency), prints each
   kernel's registers, spills and shared memory (ptxas), counts the IMAD
   instructions of K2, K4, K6 and the G2 add and the shared-memory loads and
   stores of K7 in the built libraries' SASS (cuobjdump).  The G2 kernels
   are timed at 8192 points (the fixed-table build) and 2^18 (the top level
   of the prover's G2 fold); K3 at 8192 points, 2^18 and one point (its
   launch floor).  K1's BabyJubJub add and ladder (kernels/jub.py) at 1,
   63, 64, 65, 4096 and 2^16 lanes on edge rows (the identity, P + P,
   P + (−P), the 8-torsion; the scalars 0, 1, 2^253, 2^254 − 1, p − 1), 36
   to 64 of them decoded against the host oracle; timed at the verify's
   4096 lanes (the add also at one) and the sign's 8192, the ladder's bound
   from this run's scalars (the doubles and adds their bits need).  The G1
   and G2 ladders (g1_scalar_mul, g2_scalar_mul) at 1, 4, 5, 63, 65 and
   8192 lanes on edge rows (a multiple with a seeded scalar, the identity,
   the scalars 0, 1, r − 1, 2^254 − 1 on a point and on its negation, 2,
   r, 2^253), 16 decoded against the host oracle; timed at the proofs'
   widths (4 and 5 G1 lanes, one G2 point) and at 8192, bound by a double
   and an add a step.
3. Drives the depth-16 pool round trip through the entry points a user
   calls: PrivacyPool(depth=16) with a real setup of the 4431-constraint
   withdraw circuit, a deposit of 4096 commitments, the root against the
   host oracle, prove_withdraw, withdraw (pairing verify), the voucher,
   redeem, and the rejection of a second redeem and of a tampered public
   input.  Every kernel's launch count is zeroed just before and read just
   after; K1–K5, the G2 add and double and the two ladders must each be
   > 0, and the warm prove must make one launch of each ladder.  The launches
   of K1, K2 and the G2 add are counted by width, and each kernel is timed
   at each width the path used, so that its loss (launches × (device ms −
   bound)) is summed width by width.
   The warm prove's device-busy time is read from the profiler's timeline.
   Then the same withdraw statement through engine="sorted" (the path a
   key whose fixed tables exceed the budget takes) must give the fixed
   engine's proof, with one launch of each ladder.
4. Vouchers and the sequencer, on the depth-16 pool of phase 3: 4096
   distinct seeded messages signed with the pool's sequencer key in one
   eddsa_sign_batch (64 seeded picks equal to oracle.eddsa.sign), all 4096
   accepted by eddsa_verify (three warm batches timed, one profiled for its
   device-busy share), and a seeded eighth tampered (message, s + 1, R off
   the curve) rejected on exactly those lanes; the verify must make one
   jub_scalar_mul and 32 jub_add launches and a warm sign 31 jub_add; then
   withdraw_batch of two
   fresh proofs after an in-batch duplicate nullifier is rejected with no
   state change, verify_vouchers_batch, each voucher through encode_voucher
   -> verify_voucher_bytes -> redeem, a deposit batch popped (the root back
   to the earlier one and the host oracle's) and deposited again, and
   save_pool / load_pool through a temporary directory (bytes and seconds;
   the loaded pool on the card with an equal root, a prove from it with no
   table build that verifies, a pop after the load); the launches of the
   verify, the sign, withdraw_batch and verify_vouchers_batch by kernel.
   Launch counts zeroed before; K1, K4 and the two Edwards kernels must be
   > 0.  Every (kernel, width) the phase launched is held against its
   plain twin on its own operands (kernels.capture_operands), after the
   last profiled measurement.  Then K1 and K4 are held against their
   plain twins on the verify batch's operands at every width the EdDSA
   batch launched them (K1 on 1 to 36 stacked batches of 4096 rows and
   with a broadcast constant operand, K4 at 4096); a width launched and
   not held fails the phase.
5. Proves the depth-2 withdraw statement below with fixed seeds and holds
   the proof's digest against DEPTH2_DIGEST, which tests/test_torch_pool.py
   computes from the JAX package and asserts.
6. The deposit proof (301 constraints): setup on the card, a first prove
   and WARM_PROVES warm proves through the fixed engine (latency and
   proofs/s), verify accepts and a tampered commitment, amount or token is
   rejected, the proof's digest equals DEPOSIT_DIGEST (asserted from the JAX
   package by tests/test_torch_deposit.py) through the fixed, lane and
   sorted engines; launches per kernel and the device-busy time of a warm
   prove.  The setup and first prove must launch K1–K3, the G2 kernels and
   K5.
7. The G1 MSM at 2^22 through `ops.msm.msm` (which routes to msm_sorted at
   c = 16): 1024 multiples k·G tiled, seeded scalars below r; the result
   after to_affine must equal (Σ s_i·k_i mod r)·G; timed twice after the
   first run (host clock), with its device-busy time, peak memory and
   launches by kernel and width (K1's subtraction, K2 and K3 must be > 0);
   K1, K2 and K3 held against their twins on the MSM's own operands at
   every width it launched them.  Then the lane
   engine at 2^16, msm_sorted at c = 8 on 2^16 points, G2 msm_sorted at 2^12
   and the G2 lane engine at 2^10 against the same host sums, and the
   loss of K1, K2 and K3 at each width the 2^22 MSM used.
8. The NTT at 2^20 (NttDomain(20), seeded input): the K5 stage ladder and
   the fused K7 path give equal transforms, the inverse of each returns the
   input, both equal the host oracle at 2^10, and the 2^12 transform of a
   seeded input matches NTT_DIGEST; launch counts zeroed before, K5 and K7
   must be > 0; the fused transform's device-busy time must be > 0, and it
   is split by kernel (K7, the K1 correction multiply, the transpose copy).
9. The dense MiMC tree over 2^20 seeded leaves: build_levels (one K6 launch
   per level), every level against the plain twins applied to the level
   below (one twin call over all nodes, so the root is the twins' root), 1024
   authentication paths accepted and a tampered leaf rejected, and the root
   over 2^10 seeded leaves against MIMC_DIGEST; K6 must be > 0.  Then each
   level's K6 launch is timed alone (CUDA events) beside its bound, and the
   device-busy time of one tree (profiler timeline) must agree with the sum
   of the levels' times within 5 %.
10. The mesh layer (owshen_tpu_torch/parallel/) on make_mesh(d) over the
   one card, its shards sharing it (correctness runs: their times say
   nothing of scaling).  Right after phase 3, the depth-16 withdraw
   statement proved with prove(mesh=...) at d = 2 and 4 must equal the
   fixed engine's proof point for point and verify.  After phase 9:
   DistNtt at 2^20 (d = 4) forward and inverse equal to NttDomain(20)'s,
   msm_dist on the 2^22 MSM's inputs (d = 4) equal to ops.msm.msm's
   point, merkle_root_dist over the 2^20 MiMC leaves (d = 4) equal to
   phase 9's root with "mimc" and to merkle_root with "poseidon", the
   depth-16 deposit batch inserted into DistSparseMerkleTree(16) at d = 8
   in two batches to the pool's root (a duplicate index rejected), and
   dryrun.run at d = 2 and 4 and, in a clean interpreter,
   dryrun.run_subprocess(8).  Each stage's seconds, launches zeroed
   before and read after (K1–K6 and the G2 kernels must be > 0), and the
   device-busy share of the d = 2 prove and of DistNtt, msm_dist and the
   MiMC root at d = 4.
11. The rest of the fields and curves surface at the widths the main path
   gives it, each op a stage of its own (seconds, launches by op): every
   Fq2 op at 2^18 elements (the prover's G2 fold's top level); G2
   to_affine, is_identity and eq over 8192 points (the fixed-table build's
   width) with identities and scaled copies (λX, λY, λZ); G1
   on_curve_affine over the 2^22 affine points of phase 7 with a seeded
   eighth tampered (y + 1), false on exactly those rows; batch_inv over
   2^20 Fr with seeded zeros (whole against Field.inv on 4096 rows); and
   NttDomain(13, device).coset_pows against the prover's coset table.
   Each result is held on 64 seeded rows against the host oracle.  Its
   K1 launches are held against the plain twins with the mesh stages'.
12. Prints the `kernels` JSON line, then the result line.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any check fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time

# ---------------------------------------------------------------------------
# The depth-2 reference statement (shared with tests/test_torch_pool.py)
# ---------------------------------------------------------------------------

DEPTH2_SETUP_SEED = b"owshen-tpu-pool"
DEPTH2_PROVE_SEED = b"chip-smoke-depth2"
DEPTH2_NOTE = {"secret": 0x5EC12E7, "salt": 0x5A17, "amount": 1000, "token": 0}
DEPTH2_RECIPIENT = 0xC0FFEE
DEPTH2_FILLERS = (0x1111, 0x2222)   # commitments at leaves 0 and 2; the note sits at 1
DEPTH2_DIGEST = "c355570b1ad272bbb33b2180b525939f41e1d7bb549283fad6e8313176128aff"


def depth2_deposits(commitment_of):
    """(commitments, L1 tx hashes, amounts) of the depth-2 statement."""
    com = commitment_of(DEPTH2_NOTE["secret"], DEPTH2_NOTE["salt"],
                        DEPTH2_NOTE["amount"], DEPTH2_NOTE["token"])
    coms = [DEPTH2_FILLERS[0], com, DEPTH2_FILLERS[1]]
    return coms, [0xD2_0000 + i for i in range(3)], [0, DEPTH2_NOTE["amount"], 0]


# The deposit statement (shared with tests/test_torch_deposit.py, which
# computes DEPOSIT_DIGEST from the JAX package and asserts it)
DEPOSIT_SETUP_SEED = b"owshen-tpu-deposit"
DEPOSIT_PROVE_SEED = b"chip-smoke-deposit"
DEPOSIT_NOTE = {"secret": 0xDE9051, "salt": 0x5A17D, "amount": 7 * 10 ** 17, "token": 0xA11CE}
DEPOSIT_DIGEST = "c19d2ae2a59b2c36fd324be5615050fd3dcbcd296dfddc48296e891655e9c9f7"


def deposit_publics(commitment_of) -> list[int]:
    """[commitment, amount, token] of the deposit statement."""
    n = DEPOSIT_NOTE
    return [commitment_of(n["secret"], n["salt"], n["amount"], n["token"]), n["amount"],
            n["token"]]


# The NTT and dense-MiMC references (shared with tests/test_torch_ntt_kernels.py,
# which computes both digests from the JAX package and asserts them)
NTT_DIGEST_LOGN = 12
NTT_DIGEST_SEED = 0x4E7712
NTT_DIGEST = "178bdf8ae60e0342345dee85be08858ea4a9d8124d1bec73d912bc371a924651"
MIMC_DIGEST_LEAVES = 1 << 10
MIMC_DIGEST_SEED = 0x313C
MIMC_DIGEST = "9ec25380566ca9420949bbc40247541422b1d90e5ba88bee173105de07af4a77"


def seeded_ints(seed: int, n: int, p: int) -> list[int]:
    """n field elements (canonical ints) drawn from a seeded host generator."""
    rng = random.Random(seed)
    return [rng.randrange(p) for _ in range(n)]


def values_digest(values) -> str:
    """SHA-256 over canonical field values, 32 bytes big-endian each."""
    return hashlib.sha256(b"".join(int(v).to_bytes(32, "big") for v in values)).hexdigest()


def proof_digest(proof) -> str:
    """SHA-256 over the proof's affine coordinates, 32 bytes big-endian each:
    A.x, A.y, B.x0, B.x1, B.y0, B.y1, C.x, C.y."""
    (ax, ay), ((bx0, bx1), (by0, by1)), (cx, cy) = proof.a, proof.b, proof.c
    raw = b"".join(v.to_bytes(32, "big") for v in (ax, ay, bx0, bx1, by0, by1, cx, cy))
    return hashlib.sha256(raw).hexdigest()


# ---------------------------------------------------------------------------
# Card rates for the bounds (H100 SXM data sheet)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-add: 64 results per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput; half the FP32 rate, which the 67e12 of the data sheet is),
# × 132 SMs × 1.98 GHz (clocks.max.sm of an H100 80GB HBM3), two
# operations each.  A microbenchmark of independent chains sustained 63.9
# IMAD results per clock per SM on that card at 700 W (PERF.md §6)
INT32_OPS_PER_S = 64 * 132 * 1.98e9 * 2
MUL_OPS = 128 * 2 * 2       # 128 32×32→64 products = 256 multiply-adds = 512 ops
SQR_OPS = 100 * 2 * 2       # a square: 36 word products + 64 to reduce
# a product by a constant below 2^32: 8 word products, and 8 to take the one
# word above 2^256 back below p
SMALL_MUL_OPS = 16 * 2 * 2
ADD_OPS = 3 * 8             # add/sub with carry, subtract p, select: 8 words each
ROW = 64                    # bytes of one int32[16] field element
BFLY_OPS = MUL_OPS + 2 * ADD_OPS
MIMC_OPS = 364 * SQR_OPS + 364 * MUL_OPS + 368 * ADD_OPS    # x^7: 2 squares, 2 products
# (Fq products, Fq adds and subtracts) per G2 point, the least work, which
# the plain twins do (kernels/g2.py; tests/test_torch_g2.py checks the
# counts): an Fq2 product is Karatsuba's 3 products and 5 adds, a square
# (a0 + a1)(a0 − a1) and 2·a0a1, 2 products and 3 adds, the product by b3
# 3 and 4, an Fq2 add 2 adds.  The add: 12 products, 2 by b3 and 19 Fq2
# adds; the double: 6 products, 2 squares (Y², Z²), 1 by b3 and 9 Fq2 adds
G2_ADD_WORK = (12 * 3 + 2 * 3, 12 * 5 + 2 * 4 + 19 * 2)
G2_DOUBLE_WORK = (6 * 3 + 2 * 2 + 3, 6 * 5 + 2 * 3 + 4 + 9 * 2)
# (Fq products, squares, adds and subtracts) of a G1 double, the least
# work, which the plain twin does (kernels/g1.py double_lm_pts;
# tests/test_torch_k3_k7.py checks the counts): X·Y, Y·Z and 4 products of
# the second half, Y² and Z², and 13 adds (8·Y² 3, 9·Z² 4, Y3 1, 3·t2 2,
# t0 1, X3 and Y3 2)
G1_DOUBLE_WORK = (6, 2, 13)
# (Fr products, squares, adds and subtracts, products by a constant) of a
# BabyJubJub add and double, the reference's formulas (mod.rs:118-163), the
# least work: A·c and D·cd are products by a one-word constant (A, D < 2^18),
# as the JAX package's `mul_const` takes them (kernels/jub.py;
# tests/test_torch_jub_kernels.py checks the counts)
JUB_ADD_WORK = (10, 1, 7, 2)
JUB_DOUBLE_WORK = (3, 4, 7, 1)


def jub_ops(work: tuple) -> int:
    return sum(n * ops for n, ops in zip(work, (MUL_OPS, SQR_OPS, ADD_OPS, SMALL_MUL_OPS)))


JUB_ADD_OPS = jub_ops(JUB_ADD_WORK)
JUB_DOUBLE_OPS = jub_ops(JUB_DOUBLE_WORK)


def ntt_cols_work(log_n1: int) -> tuple[int, int]:
    """(Fr products, Fr adds and subtracts) of one column's radix-2
    transform of 2^log_n1 points, the least work: every butterfly adds and
    subtracts, and all but the n1 − 1 whose twiddle is ω^0 = 1 (stage s has
    n1/2^s of them) multiply."""
    n1 = 1 << log_n1
    flies = n1 // 2 * log_n1
    return flies - (n1 - 1), 2 * flies


KERNELS = {
    # name: (source, replaced TPU kernel)
    "mont_mul": ("owshen_tpu_torch/kernels/csrc/field_ops.cu",
                 "owshen_tpu/pallas/field_kernels.py:504"),
    "mod_add": ("owshen_tpu_torch/kernels/csrc/field_ops.cu",
                "owshen_tpu/pallas/field_kernels.py:315"),
    "mod_sub": ("owshen_tpu_torch/kernels/csrc/field_ops.cu",
                "owshen_tpu/pallas/field_kernels.py:149"),
    "g1_add": ("owshen_tpu_torch/kernels/csrc/g1.cu",
               "owshen_tpu/pallas/field_kernels.py:641"),
    "g1_double": ("owshen_tpu_torch/kernels/csrc/g1.cu",
                  "owshen_tpu/pallas/field_kernels.py:655"),
    # K1's G2 point operations: they replace the Fq2 arithmetic of the JAX
    # package's G2 add and double, which XLA fuses
    "g2_add": ("owshen_tpu_torch/kernels/csrc/g2.cu",
               "owshen_tpu/curves/weierstrass.py:110"),
    "g2_double": ("owshen_tpu_torch/kernels/csrc/g2.cu",
                  "owshen_tpu/curves/weierstrass.py:152"),
    # the G1 and G2 ladders: no Pallas kernel, the JAX package's
    # scalar_mul is a loop of add and double steps
    "g1_scalar_mul": ("owshen_tpu_torch/kernels/csrc/g1.cu",
                      "owshen_tpu/curves/weierstrass.py:195"),
    "g2_scalar_mul": ("owshen_tpu_torch/kernels/csrc/g2.cu",
                      "owshen_tpu/curves/weierstrass.py:195"),
    # K1's BabyJubJub point operations: they replace the JAX package's
    # K1-composed Edwards add and its lax.scan ladder, which XLA fuses
    "jub_add": ("owshen_tpu_torch/kernels/csrc/jub.cu",
                "owshen_tpu/curves/babyjubjub.py:63"),
    "jub_scalar_mul": ("owshen_tpu_torch/kernels/csrc/jub.cu",
                       "owshen_tpu/curves/babyjubjub.py:151"),
    "poseidon_hash2": ("owshen_tpu_torch/kernels/csrc/poseidon.cu",
                       "owshen_tpu/pallas/field_kernels.py:388"),
    "ntt_butterfly": ("owshen_tpu_torch/kernels/csrc/ntt.cu",
                      "owshen_tpu/pallas/ntt_kernels.py:182"),
    "mimc_hash2": ("owshen_tpu_torch/kernels/csrc/mimc.cu",
                   "owshen_tpu/pallas/field_kernels.py:468"),
    "ntt_cols": ("owshen_tpu_torch/kernels/csrc/ntt.cu",
                 "owshen_tpu/pallas/ntt_kernels.py:158"),
}
# (bytes, operations) per item of the elementwise kernels: each input row
# read once, each output row written once
PER_ITEM = {
    "mont_mul": (3 * ROW, MUL_OPS + ADD_OPS),
    "mod_add": (3 * ROW, ADD_OPS),
    "mod_sub": (3 * ROW, ADD_OPS),
    "g1_add": (9 * ROW, 12 * MUL_OPS + 27 * ADD_OPS),
    "g1_double": (6 * ROW, G1_DOUBLE_WORK[0] * MUL_OPS + G1_DOUBLE_WORK[1] * SQR_OPS
                  + G1_DOUBLE_WORK[2] * ADD_OPS),
    "g2_add": (18 * ROW, G2_ADD_WORK[0] * MUL_OPS + G2_ADD_WORK[1] * ADD_OPS),
    "g2_double": (12 * ROW, G2_DOUBLE_WORK[0] * MUL_OPS + G2_DOUBLE_WORK[1] * ADD_OPS),
    "jub_add": (9 * ROW, JUB_ADD_OPS),
    "poseidon_hash2": (3 * ROW, 162 * SQR_OPS + 666 * MUL_OPS + 585 * ADD_OPS),
    "mimc_hash2": (3 * ROW, MIMC_OPS),
}
# the kernels whose loss on the depth-16 path is summed width by width
LOSS_KERNELS = ("mont_mul", "mod_add", "mod_sub", "g1_add", "g2_add")
WIDTH_KERNELS = LOSS_KERNELS + ("g2_double",)   # launches printed by width
# the kernels the depth-16 round trip must launch (K6 and K7 run only in
# their own phases)
DEPTH16_KERNELS = ("mont_mul", "mod_add", "mod_sub", "g1_add", "g1_double", "g2_add",
                   "g2_double", "g1_scalar_mul", "g2_scalar_mul", "poseidon_hash2",
                   "ntt_butterfly")

# device symbol of each kernel, as the profiler names it
KERNEL_SYMBOLS = {"mont_mul": "field_op_kernel<0>", "mod_add": "field_op_kernel<1>",
                  "mod_sub": "field_op_kernel<2>", "g1_add": "g1_add_kernel",
                  "g1_double": "g1_dbl_kernel", "g2_add": "g2_add_kernel",
                  "g2_double": "g2_dbl_kernel", "g1_scalar_mul": "g1_ladder_kernel",
                  "g2_scalar_mul": "g2_ladder_kernel", "jub_add": "jub_add_kernel",
                  "jub_scalar_mul": "jub_ladder_kernel", "poseidon_hash2": "poseidon2_kernel",
                  "ntt_butterfly": "ntt_stage_kernel", "mimc_hash2": "mimc2_kernel",
                  "ntt_cols": "ntt_cols_kernel"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for this work, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    """Largest |kernel − plain| over every limb of every output tensor
    (field elements compare limb for limb; 0 means identical)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def time_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of fn, CUDA events around `reps` calls after a
    warm-up; includes the host's launch overhead when that dominates."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


DEVICE_SPANS = ("kernel", "gpu_memcpy", "gpu_memset")   # Chrome trace categories
SETTLE_S = 0.05     # idle host time around the profiled calls, inside the session
SPINS = 64          # spin kernels that open and close each session (see traced)
TRIES = 3           # profiler sessions before a timeline that lost launches fails
SPIN_LOSS = {"sessions": 0, "leading_max": 0, "trailing_max": 0}   # over the run


def traced(torch, fn, reps: int = 1) -> tuple[float, list]:
    """(wall seconds, device spans) of `reps` calls of fn under the
    profiler: the kernel, copy and memset events of the card's timeline,
    read from the profiler's Chrome trace.  Late in a run, the first few
    kernel records of a session can be missing from its trace (up to 8 of
    them, on an H100 with torch 2.11; in PR 11 the calls' own records
    after 16 leading spins, and later 1 to all 64 of the spins, never the
    trailing ones), so each session opens and closes with SPINS tiny spin
    kernels that take that loss and are left out of the spans; the losses
    go in SPIN_LOSS, and one that takes every spin of a side is printed.
    The
    session stays open SETTLE_S before and after the calls, so that
    device events near its ends fall inside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        t = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.time() - t
        for _ in range(SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_SPANS]
    spans = [e for e in device if "spin_kernel" not in e["name"]]
    first = min((e["ts"] for e in spans), default=float("inf"))
    spins = [e["ts"] < first for e in device if "spin_kernel" in e["name"]]
    lost = (SPINS - sum(spins), SPINS - (len(spins) - sum(spins)))
    if spans:
        SPIN_LOSS["sessions"] += 1
        SPIN_LOSS["leading_max"] = max(SPIN_LOSS["leading_max"], lost[0])
        SPIN_LOSS["trailing_max"] = max(SPIN_LOSS["trailing_max"], lost[1])
        if SPINS in lost:
            print(f"traced: {lost[0]} leading and {lost[1]} trailing spin kernels missing from "
                  "the timeline", flush=True)
    return wall, spans


def device_ms(torch, fn, reps: int, kernel: str) -> float:
    """Device milliseconds per launch of the kernel whose name contains
    `kernel` (fn launches it once), the mean over the `reps` launches on the
    profiler's timeline.  A session whose timeline lost some of them is
    taken again; after TRIES the run fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRIES):
        _, events = traced(torch, fn, reps)
        durs = [e["dur"] for e in events if kernel in e["name"]]
        if len(durs) == reps:
            return sum(durs) / reps / 1e3
        print(f"device_ms: {len(durs)} of {reps} launches of {kernel} on the timeline; "
              f"profiling again", flush=True)
    fail(f"the profiler's timeline lost launches of {kernel} in {TRIES} tries")


def device_busy(torch, fn) -> tuple[float, float, list]:
    """(wall seconds, device-busy seconds, device spans) of one call of fn:
    the busy time is the union of the device spans on the profiler's
    timeline.  Every
    launch the port's wrappers count during fn must be among them: a
    session that lost some is taken again; after TRIES the run fails."""
    from owshen_tpu_torch import kernels

    for _ in range(TRIES):
        before = kernels.launch_counts()
        wall, events = traced(torch, fn)
        launched = {k: n - before[k] for k, n in kernels.launch_counts().items() if n > before[k]}
        seen = {k: sum(KERNEL_SYMBOLS[k] in e["name"] for e in events) for k in launched}
        if all(seen[k] >= n for k, n in launched.items()):
            busy_us, end = 0.0, float("-inf")
            for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
                busy_us += max(0.0, hi - max(lo, end))
                end = max(end, hi)
            return wall, busy_us / 1e6, events
        print(f"device_busy: the timeline holds {seen} of the launches {launched}; "
              f"profiling again", flush=True)
    fail(f"the profiler's timeline lost kernel launches in {TRIES} tries")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------

def spans_by_kernel(events) -> dict:
    """{kernel: [spans, device ms]} over device spans: the port's kernels
    by their KERNEL_SYMBOLS name, any other span by its name."""
    out = {}
    for e in events:
        key = next((name for name, sym in KERNEL_SYMBOLS.items() if sym in e["name"]),
                   e["name"].split("(")[0][:80])
        row = out.setdefault(key, [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e3
    return out


def rand_field(torch, gen, p: int, n: int, dev):
    """n random canonical elements (top limb below p's) with 0, 1, p − 1
    and p − 2 in the first rows, as int32 limbs on `dev`."""
    x = torch.randint(0, 1 << 16, (n, 16), generator=gen, dtype=torch.int32)
    x[:, 15] = torch.randint(0, p >> 240, (n,), generator=gen, dtype=torch.int32)
    for i, v in enumerate((0, 1, p - 1, p - 2)):
        x[i] = torch.tensor([(v >> (16 * k)) & 0xFFFF for k in range(16)], dtype=torch.int32)
    return x.to(dev)


def edge_pairs(curve, gen, ks):
    """(p, q) pairs of points of the host oracle's `curve`: O + O, P + O,
    O + Q, P + P and P + (−P) in the first five rows, the multiples ks·gen
    paired with their neighbours in the others."""
    ps = [curve.mul(gen, k) for k in ks]
    qs = ps[1:] + ps[:1]
    ps[0] = qs[0] = None                        # O + O
    qs[1] = None                                # P + O
    ps[2] = None                                # O + Q
    qs[3] = ps[3]                               # P + P
    qs[4] = (ps[4][0], curve.K.neg(ps[4][1]))   # P + (−P)
    return ps, qs


def edge_points(torch, gen, n: int, dev, group: str = "g1"):
    """n inputs (p, q) of the G1 or G2 kernels: edge_pairs of the multiples
    1 … 64 of the generator in the first 64 rows, random canonical
    coordinates after; with the oracle's sums and doublings of the first 64."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.oracle import curve as ocurve
    from owshen_tpu_torch.oracle.field import P_FQ

    curve, point, encode, comps = {
        "g1": (ocurve.G1, ocurve.G1_GEN, bn254.g1_encode, 1),
        "g2": (ocurve.G2, ocurve.G2_GEN, bn254.g2_encode, 2)}[group]
    real, qs = edge_pairs(curve, point, range(1, 65))
    head_p, head_q = encode(real), encode(qs)
    tail = [rand_field(torch, gen, P_FQ, comps * (n - 64), "cpu").view(n - 64, *head_p[0].shape[1:])
            for _ in range(6)]
    p = tuple(torch.cat([h, t]).to(dev) for h, t in zip(head_p, tail[:3]))
    q = tuple(torch.cat([h, t]).to(dev) for h, t in zip(head_q, tail[3:]))
    want = [curve.add(a, b) for a, b in zip(real, qs)]
    want_dbl = [curve.add(a, a) for a in real]
    return p, q, want, want_dbl


# The G1 and G2 ladders (g1_scalar_mul, g2_scalar_mul): the widths the
# proofs launch (a withdraw proof's tails: 4 G1 lanes and one G2 point; the
# legacy prover's: 5 and one), and LADDER_N lanes for throughput
LADDER_BITS = 254
LADDER_N = 8192
LADDER_PATH_NS = {"g1_scalar_mul": (4, 5), "g2_scalar_mul": (1,)}
LADDER_HEAD = 16            # edge rows, held against the host oracle


def ladder_edge_inputs(torch, gen, n: int, dev, group: str):
    """n ≥ LADDER_HEAD inputs (p, k) of the G1 or G2 ladder: on the first
    rows a multiple of the generator with a seeded 254-bit scalar, the
    identity, then the scalars 0, 1, r − 1, 2^254 − 1 (all ones), the same on
    the next row's point, its negation, and 2, r, 2^253 (raw limbs, none
    reduced); seeded multiples and scalars up to LADDER_HEAD, random
    canonical coordinates and raw 256-bit scalars after.  With the host
    oracle's (k mod 2^254)·p of the head rows."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.fields.field import ints_to_tensor
    from owshen_tpu_torch.oracle import curve as ocurve
    from owshen_tpu_torch.oracle.field import P_FQ, P_FR

    curve, point, encode, comps = {
        "g1": (ocurve.G1, ocurve.G1_GEN, bn254.g1_encode, 1),
        "g2": (ocurve.G2, ocurve.G2_GEN, bn254.g2_encode, 2)}[group]
    rng = random.Random(0x1ADD)
    pts = [curve.mul(point, rng.randrange(1, P_FR)) for _ in range(LADDER_HEAD)]
    ks = [rng.randrange(1 << LADDER_BITS) for _ in range(LADDER_HEAD)]
    pts[1] = None                                           # the identity
    ks[2:10] = [0, 1, P_FR - 1, (1 << 254) - 1, (1 << 254) - 1, 2, P_FR, 1 << 253]
    pts[6] = (pts[5][0], curve.K.neg(pts[5][1]))            # beside its negation
    head_p = encode(pts)
    tail = [rand_field(torch, gen, P_FQ, comps * (n - LADDER_HEAD), "cpu").view(
        n - LADDER_HEAD, *head_p[0].shape[1:]) if n > LADDER_HEAD
        else head_p[0][:0] for _ in range(3)]
    p = tuple(torch.cat([h, t]).to(dev) for h, t in zip(head_p, tail))
    k = torch.randint(0, 1 << 16, (n, 16), generator=gen, dtype=torch.int32)
    k[:LADDER_HEAD] = ints_to_tensor(ks)
    want = [curve.mul(a, v % (1 << LADDER_BITS)) if a else None for a, v in zip(pts, ks)]
    return p, k.to(dev), want


def point_ladder_checks(torch, dev, gen, record) -> dict:
    """The G1 and G2 ladders against their plain twins on
    ladder_edge_inputs: the twin once over LADDER_N lanes (its head rows
    held against the host oracle), the kernel at every width the proofs
    launch, at ragged widths and at LADDER_N against it; each timed at its
    first proof width (`record`, with the twin there) and at LADDER_N.  The
    bound charges every step a double and an add, as the kernels run."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.kernels import g1, g2

    out = {}
    for name, group, kernel, plain, decode, in_rows, step_ops in (
            ("g1_scalar_mul", "g1", g1.g1_scalar_mul, g1.g1_scalar_mul_plain,
             bn254.g1_decode_many, 4, PER_ITEM["g1_double"][1] + PER_ITEM["g1_add"][1]),
            ("g2_scalar_mul", "g2", g2.g2_scalar_mul, g2.g2_scalar_mul_plain,
             bn254.g2_decode_many, 7, PER_ITEM["g2_double"][1] + PER_ITEM["g2_add"][1])):
        p, k, want = ladder_edge_inputs(torch, gen, LADDER_N, dev, group)
        cut = lambda m: (tuple(c[:m] for c in p), k[:m], LADDER_BITS)  # noqa: E731
        t = time.time()
        twin = plain(*cut(LADDER_N))
        torch.cuda.synchronize()
        twin_s = time.time() - t
        if decode(tuple(c[:LADDER_HEAD] for c in twin)) != want:
            fail(f"{name}: the plain twin differs from the host oracle on the edge rows")
        cases = {f"n={m}": max_abs_err(torch, kernel(*cut(m)), tuple(c[:m] for c in twin))
                 for m in (*LADDER_PATH_NS[name], 1, 63, 65, LADDER_N)}
        print(f"{name} max |diff| by case: " + json.dumps(cases), flush=True)
        for case, err in cases.items():
            if err != 0:
                fail(f"{name} ({case}): kernel disagrees with its plain version")
        lane_work = lambda m: (m * (in_rows + comps_out(group)) * ROW,  # noqa: E731
                               m * LADDER_BITS * step_ops)
        n = LADDER_PATH_NS[name][0]
        record(name, n, lambda: kernel(*cut(n)), lambda: plain(*cut(n)), cases[f"n={n}"], 10,
               work=lane_work(n))
        sym = KERNEL_SYMBOLS[name]
        ms_by_n = {f"n={m}": device_ms(torch, lambda: kernel(*cut(m)), 10, sym)
                   for m in (*LADDER_PATH_NS[name], LADDER_N)}
        bound_by_n = {f"n={m}": bound(*lane_work(m)) for m in (*LADDER_PATH_NS[name], LADDER_N)}
        print(f"{name} device ms: " + json.dumps(ms_by_n) + "; bound ms: "
              + json.dumps(bound_by_n) + f"; the twin over {LADDER_N} lanes {twin_s:.2f} s",
              flush=True)
        out[name] = {"cases": cases, "ms_by_n": ms_by_n, "bound_by_n": bound_by_n,
                     "twin_wide_s": twin_s}
    return out


def comps_out(group: str) -> int:
    """Rows of 64 B a ladder writes a lane: three coordinates of one or two
    Fq components."""
    return 3 if group == "g1" else 6


# K1's BabyJubJub kernels (kernels/jub.py): the verify's 4096 lanes, the
# sign's 8192, and 2^16 where a ladder of that many lanes fills the card
JUB_N = 4096
JUB_SIGN_N = 2 * JUB_N
JUB_WIDE = 1 << 16
JUB_CHECK_NS = (1, 63, 64, 65, JUB_N, JUB_WIDE)
JUB_BITS = 254              # the verify's scalar_mul_int
JUB_HEAD = 64               # edge rows, their sums held against the host oracle
JUB_ORACLE = 36             # edge rows whose ladder is held against it (~1 s of host)


def jub_small_order() -> list:
    """BabyJubJub's eight points of order dividing 8 as (x, y) ints, k·T for
    k = 0 … 7: the identity, (0, −1) of order 2 (4T), two of order 4 (2T,
    6T) and four of order 8, where T = SUBORDER·(x, y) for the first x ≥ 2
    on the curve whose multiple has order 8."""
    from owshen_tpu_torch.oracle import curve as oc
    from owshen_tpu_torch.oracle.field import FR as HFR

    p = HFR.p
    for x in range(2, 1000):
        y = HFR.sqrt((1 - oc.JUB_A * x * x) * pow(1 - oc.JUB_D * x * x, -1, p))
        if y is None:
            continue
        t = oc.jub_mul((x, y), oc.JUB_SUBORDER)
        if oc.jub_mul(t, 4) != (0, 1):
            return [oc.jub_mul(t, k) for k in range(8)]
    fail("no point of order 8 among the first x")


def jub_edge_inputs(torch, gen, n: int, dev):
    """n ≥ JUB_HEAD inputs (p, q, k) of the BabyJubJub kernels: in the first JUB_HEAD
    rows points of the curve — O + O, P + O, O + Q, P + P, P + (−P), the
    8-torsion against itself and against multiples of the base point, those
    multiples paired with their neighbours, rows 32 on scaled (λX : λY : λZ)
    — and the scalars 0, 1, 2, 3, 2^253, 2^254 − 1, p − 1, p − 2, the
    suborder and its neighbours and 2^128 on rows 1 and 24 on, seeded ones
    below p on the others (raw limbs, none reduced); random canonical
    coordinates and scalars after.  With the host oracle's p + q of the
    JUB_HEAD rows and (k mod 2^JUB_BITS)·p of the first JUB_ORACLE."""
    from owshen_tpu_torch.fields.field import FR, ints_to_tensor
    from owshen_tpu_torch.oracle import curve as oc
    from owshen_tpu_torch.oracle.field import P_FR

    rng = random.Random(0x10B)
    small = jub_small_order()
    neg = lambda pt: ((-pt[0]) % P_FR, pt[1])  # noqa: E731
    step = oc.jub_mul(oc.JUB_BASE, rng.randrange(1, oc.JUB_SUBORDER))
    mults = [oc.jub_mul(oc.JUB_BASE, rng.randrange(1, oc.JUB_SUBORDER))]
    for _ in range(JUB_HEAD - 1):
        mults.append(oc.jub_add(mults[-1], step))
    ps, qs = list(mults), mults[1:] + mults[:1]
    ps[0] = qs[0] = qs[1] = ps[2] = small[0]                 # O + O, P + O, O + Q
    qs[3], qs[4] = ps[3], neg(ps[4])                         # P + P, P + (−P)
    for i in range(8):                                       # the torsion
        ps[5 + i], qs[5 + i] = small[i], small[(3 * i + 1) % 8]
        ps[13 + i], qs[13 + i] = small[i], neg(small[i])
        ps[21 + i], qs[21 + i] = mults[21 + i], small[i]
    special = [0, 1, 2, 3, 1 << 253, (1 << 254) - 1, P_FR - 1, P_FR - 2, oc.JUB_SUBORDER,
               oc.JUB_SUBORDER - 1, oc.JUB_SUBORDER + 1, 1 << 128]
    ks = [rng.randrange(P_FR) for _ in range(JUB_HEAD)]
    ks[1:13] = ks[24:36] = special                           # on the edge rows, on multiples

    def encode(pts):
        lam = [1] * 32 + [rng.randrange(1, P_FR) for _ in range(JUB_HEAD - 32)]
        return tuple(FR.encode([v * m % P_FR for v, m in zip(vals, lam)])
                     for vals in ([pt[0] for pt in pts], [pt[1] for pt in pts], [1] * len(pts)))

    head = encode(ps) + encode(qs)
    tail = [rand_field(torch, gen, P_FR, n - JUB_HEAD, "cpu") if n > JUB_HEAD
            else torch.zeros((0, 16), dtype=torch.int32) for _ in range(7)]
    cols = [torch.cat([h, t]).to(dev) for h, t in zip(head, tail)]
    k = torch.cat([ints_to_tensor(ks), tail[6]]).to(dev)
    want_add = [oc.jub_add(a, b) for a, b in zip(ps, qs)]
    want_mul = [oc.jub_mul(a, v % (1 << JUB_BITS)) for a, v in zip(ps[:JUB_ORACLE], ks)]
    return tuple(cols[:3]), tuple(cols[3:6]), k, want_add, want_mul


def ladder_work(torch, k, n_bits: int) -> tuple[int, int]:
    """(doubles, adds) the double-and-add of these scalars needs at the
    least, over every lane: from the top set bit below n_bits down, a
    double a bit and an add a further set bit."""
    from owshen_tpu_torch.fields.field import tensor_to_ints

    doubles = adds = 0
    for v in tensor_to_ints(k):
        v &= (1 << n_bits) - 1
        doubles += max(v.bit_length() - 1, 0)
        adds += max(bin(v).count("1") - 1, 0)
    return doubles, adds


def jub_affine(pt) -> list:
    """Projective Fr coordinates -> [(x, y)], divided on the host."""
    from owshen_tpu_torch.fields.field import FR

    X, Y, Z = (FR.decode(c) for c in pt)
    return [(x * pow(z, -1, FR.p) % FR.p, y * pow(z, -1, FR.p) % FR.p) for x, y, z in zip(X, Y, Z)]


def jub_kernel_checks(torch, dev, gen, record) -> dict:
    """K1's Edwards add and ladder against their plain twins at
    JUB_CHECK_NS lanes on jub_edge_inputs (the twin once at the widest, the
    kernel at each width against its head), the head rows against the host
    oracle; each timed at JUB_N lanes (`record`), the add also at one lane
    and both also at JUB_SIGN_N."""
    from owshen_tpu_torch.kernels import jub

    head = lambda pt, m: tuple(c[:m] for c in pt)  # noqa: E731
    p, q, k, want_add, want_mul = jub_edge_inputs(torch, gen, JUB_WIDE, dev)
    out = {}
    for name, kernel, plain, args, want in (
            ("jub_add", jub.jub_add, jub.jub_add_plain, (p, q), want_add),
            ("jub_scalar_mul", jub.jub_scalar_mul, jub.jub_scalar_mul_plain, (p, k, JUB_BITS),
             want_mul)):
        cut = lambda m: tuple(head(a, m) if isinstance(a, tuple) else  # noqa: E731
                              a[:m] if isinstance(a, torch.Tensor) else a for a in args)
        t = time.time()
        twin = plain(*args)
        torch.cuda.synchronize()
        twin_s = time.time() - t
        if jub_affine(head(twin, len(want))) != want:
            fail(f"{name}: the plain twin differs from the host oracle on the edge rows")
        got = kernel(*args)
        if jub_affine(head(got, len(want))) != want:
            fail(f"{name}: wrong results on the edge rows")
        cases = {f"n={m}": max_abs_err(torch, kernel(*cut(m)), head(twin, m))
                 for m in JUB_CHECK_NS}
        sign_ms = device_ms(torch, lambda: kernel(*cut(JUB_SIGN_N)), 20, KERNEL_SYMBOLS[name])
        print(f"{name} max |diff| by case: " + json.dumps(cases), flush=True)
        print(f"{name}: n={JUB_SIGN_N} {sign_ms:.5f} ms on the device; the twin over "
              f"{JUB_WIDE} lanes {twin_s:.2f} s", flush=True)
        for case, err in cases.items():
            if err != 0:
                fail(f"{name} ({case}): kernel disagrees with its plain version")
        sub = cut(JUB_N)
        if name == "jub_add":
            work = None
        else:
            doubles, adds = ladder_work(torch, k[:JUB_N], JUB_BITS)
            work = (JUB_N * 7 * ROW, doubles * JUB_DOUBLE_OPS + adds * JUB_ADD_OPS)
        record(name, JUB_N, lambda: kernel(*sub), lambda: plain(*sub), cases[f"n={JUB_N}"],
               20 if name == "jub_add" else 10, work=work)
        out[name] = {"cases": cases, "sign_n_ms": sign_ms, "twin_wide_s": twin_s}
    out["jub_add"]["n1_ms"] = device_ms(torch, lambda: jub.jub_add(head(p, 1), head(q, 1)), 50,
                                        KERNEL_SYMBOLS["jub_add"])
    print(f"jub_add: n=1 {out['jub_add']['n1_ms']:.5f} ms on the device", flush=True)
    return out


def kernel_of(mangled: str) -> str:
    """The KERNEL_SYMBOLS name of a mangled kernel symbol (itself if none)."""
    for sym in KERNEL_SYMBOLS.values():
        base, _, arg = sym.partition("<")
        if base in mangled and (not arg or f"ILi{arg.rstrip('>')}E" in mangled):
            return sym
    return mangled


def ptxas_usage(logs: dict) -> dict:
    """Registers, spill bytes and static shared memory of each kernel, from
    the `-Xptxas -v` logs of the build."""
    usage, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = kernel_of(m.group(1))
                arg = re.search(r"ILi(\d+)E", m.group(1))
                if arg and "<" not in name:     # a template's instances apart
                    name += f"<{arg[1]}>"
                usage[name] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                usage[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                usage[name]["registers"] = int(m[1])
                smem = re.search(r"(\d+) bytes smem", line)
                usage[name]["smem_bytes"] = int(smem[1]) if smem else 0
    return usage


def sass_opcodes(path, symbol: str) -> dict:
    """Instructions of the kernels whose symbol contains `symbol` in the
    SASS of the library at `path`, by opcode (guard predicates dropped).
    The count is static: a loop body counts once."""
    import shutil
    from pathlib import Path

    from owshen_tpu_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    if tool is None:
        fail("cuobjdump not found beside nvcc")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            counts[m[1]] = counts.get(m[1], 0) + 1
    return counts


def sass_imad(build, lib: str, symbol: str) -> dict:
    """IMAD-family instructions of one kernel in the built library's SASS,
    by opcode, and the multiply-add results they give (an IMAD.WIDE gives
    two: the low and the high word).  The count is static: a loop body
    counts once."""
    counts = {op: n for op, n in sass_opcodes(build.library_path(lib), symbol).items()
              if op.startswith("IMAD")}
    total = sum(counts.values())
    results = sum(n * (2 if ".WIDE" in op else 1) for op, n in counts.items())
    print(f"{symbol} SASS: {total} IMAD {json.dumps(counts)}, {results} multiply-add results",
          flush=True)
    return {"imad": total, "multiply_adds": results, "by_opcode": counts}


def shared_ops(path, symbol: str) -> dict:
    """The shared-memory loads and stores of a kernel's SASS by opcode: LDS
    reads 32 bits a lane, LDS.64 / LDS.128 two or four words"""
    return {op: n for op, n in sass_opcodes(path, symbol).items()
            if op.split(".")[0] in ("LDS", "STS")}


def check_kernels(torch, dev) -> dict:
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.kernels import build, field_ops, g1, g2, mimc, ntt, poseidon
    from owshen_tpu_torch.ops.ntt import col_twiddles
    from owshen_tpu_torch.oracle.field import P_FQ, P_FR

    t0 = time.time()
    build.library("field_ops")          # builds every source, in parallel
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    usage = ptxas_usage(build.LIBRARIES.logs)
    for name, use in usage.items():
        print(f"ptxas {name}: {json.dumps(use)}", flush=True)

    gen = torch.Generator().manual_seed(7)
    results = {"ptxas": usage}

    def record(name, n, kernel, plain, err, reps, work=None):
        """Times kernel and twin; `work` is (bytes, operations) of one call,
        by default n items of PER_ITEM[name]."""
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version (max |diff| {err})")
        call_ms = time_ms(torch, kernel, reps)
        ms = device_ms(torch, kernel, reps, KERNEL_SYMBOLS[name])
        plain_ms = time_ms(torch, plain, max(1, reps // 20))
        if work is None:
            work = (n * PER_ITEM[name][0], n * PER_ITEM[name][1])
        b_ms, b_by = bound(*work)
        results[name] = {"n": n, "ms": ms, "call_ms": call_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": err}
        print(f"{name}: n={n} ok, {ms:.4f} ms on the device (profiler), "
              f"{call_ms:.4f} ms per call; plain {plain_ms:.3f} ms; "
              f"bound {b_ms:.4f} ms by {b_by}", flush=True)

    n1 = 8192
    for field, p in (("fr", P_FR), ("fq", P_FQ)):
        a, b = rand_field(torch, gen, p, n1, dev), rand_field(torch, gen, p, n1, dev)
        b[4:8] = a[:4]                  # 0·0, 1·1, (p−1)², (p−2)² rows too
        for name, k, pl in (("mont_mul", field_ops.mont_mul, field_ops.mont_mul_plain),
                            ("mod_add", field_ops.mod_add, field_ops.mod_add_plain),
                            ("mod_sub", field_ops.mod_sub, field_ops.mod_sub_plain)):
            err = max_abs_err(torch, k(a, b, field), pl(a, b, field))
            if field == "fr":
                record(name, n1, lambda: k(a, b, field), lambda: pl(a, b, field), err, 200)
            elif err != 0:
                fail(f"{name}[{field}]: kernel disagrees with its plain version")
        print(f"K1 over {field}: equal", flush=True)
    # one element: the card's fixed cost of a launch, K1's floor
    a1, b1 = a[8:9], b[8:9]
    for name, k in (("mont_mul", field_ops.mont_mul), ("mod_add", field_ops.mod_add)):
        results[name]["n1_ms"] = device_ms(torch, lambda: k(a1, b1, "fq"), 200,
                                           KERNEL_SYMBOLS[name])
        print(f"{name}: n=1 {results[name]['n1_ms']:.5f} ms on the device", flush=True)

    n2 = 81920                          # a fold level at depth 16: 5 sets × 16,384
    p, q, want, want_dbl = edge_points(torch, gen, n2, dev)
    got = g1.g1_add(p, q)
    twin = g1.g1_add_plain(p, q)
    err = max_abs_err(torch, got, twin)
    if bn254.g1_decode_many(tuple(c[:64] for c in got)) != want:
        fail("g1_add: wrong sums on real points")
    cases = {}
    for n in (1, 127, 129, n2 - 1):     # partial blocks; the edge rows lead each
        cases[f"n={n}"] = max_abs_err(torch, g1.g1_add(tuple(c[:n] for c in p),
                                                       tuple(c[:n] for c in q)),
                                      tuple(c[:n] for c in twin))
    print("g1_add max |diff| by case: " + json.dumps(cases), flush=True)
    for case, case_err in cases.items():
        if case_err != 0:
            fail(f"g1_add ({case}): kernel disagrees with its plain version")
    record("g1_add", n2, lambda: g1.g1_add(p, q), lambda: g1.g1_add_plain(p, q), err, 50)
    results["g1_add"]["cases"] = cases
    results["g1_add"]["sass"] = sass_imad(build, "g1", "g1_add_kernel")

    # K3: the doublings of edge_points' first rows (the identity and
    # multiples of G) lead random coordinates; checked at ragged N and at
    # 2^18, timed at the fixed-table build's 8192 points, at 2^18 and at one
    # point (its launch floor)
    n3, n3_big = 8192, 1 << 18
    head = lambda pt, n: tuple(c[:n] for c in pt)  # noqa: E731
    p3, _, _, want_dbl = edge_points(torch, torch.Generator().manual_seed(3), n3_big, dev)
    twin3 = g1.g1_double_plain(p3)
    if bn254.g1_decode_many(head(g1.g1_double(p3), 64)) != want_dbl:
        fail("g1_double: wrong doublings on real points")
    cases = {}
    for n in (1, 2, 3, 4, 5, 63, 65, 8191, n3, n3_big):
        cases[f"n={n}"] = max_abs_err(torch, g1.g1_double(head(p3, n)), head(twin3, n))
    print("g1_double max |diff| by case: " + json.dumps(cases), flush=True)
    for case, case_err in cases.items():
        if case_err != 0:
            fail(f"g1_double ({case}): a kernel disagrees with its plain version")
    sub3 = head(p3, n3)
    record("g1_double", n3, lambda: g1.g1_double(sub3), lambda: g1.g1_double_plain(sub3),
           cases[f"n={n3}"], 100)
    dbl = results["g1_double"]
    dbl["cases"] = cases
    sym = KERNEL_SYMBOLS["g1_double"]
    dbl["ms_by_n"] = {f"n={n}": device_ms(torch, lambda: g1.g1_double(head(p3, n)), reps, sym)
                      for n, reps in ((1, 100), (n3, 100), (n3_big, 20))}
    print("g1_double device ms: " + json.dumps(dbl["ms_by_n"]), flush=True)
    b_ms, b_by = bound(n3_big * PER_ITEM["g1_double"][0], n3_big * PER_ITEM["g1_double"][1])
    dbl["n2_18"] = {"bound_ms": b_ms, "bound_by": b_by}
    print(f"g1_double: n={n3_big} bound {b_ms:.5f} ms by {b_by}", flush=True)

    # K1's G2 add and double: the edge pairs lead; checked at small N, at
    # the fixed-table build's 8192 points (where they are timed beside the
    # twin) and at 2^18, the top level of the prover's G2 fold (timed too)
    n7, n8 = 8192, 1 << 18
    p, q, want, want_dbl = edge_points(torch, gen, n8, dev, "g2")
    for name, kernel, plain, args, real in (
            ("g2_add", g2.g2_add, g2.g2_add_plain, (p, q), want),
            ("g2_double", g2.g2_double, g2.g2_double_plain, (p,), want_dbl)):
        twin = plain(*args)
        if bn254.g2_decode_many(head(kernel(*args), 64)) != real:
            fail(f"{name}: wrong results on real points")
        cases = {f"n={n}": max_abs_err(torch, kernel(*(head(a, n) for a in args)),
                                       head(twin, n))
                 for n in (1, 2, 63, 64, 65, n7, n8)}
        print(f"{name} max |diff| by case: " + json.dumps(cases), flush=True)
        for case, case_err in cases.items():
            if case_err != 0:
                fail(f"{name} ({case}): kernel disagrees with its plain version")
        sub = tuple(head(a, n7) for a in args)
        record(name, n7, lambda: kernel(*sub), lambda: plain(*sub), cases[f"n={n7}"], 100)
        results[name]["cases"] = cases
        ms8 = device_ms(torch, lambda: kernel(*args), 20, KERNEL_SYMBOLS[name])
        b_ms, b_by = bound(n8 * PER_ITEM[name][0], n8 * PER_ITEM[name][1])
        results[name]["n2_18"] = {"ms": ms8, "bound_ms": b_ms, "bound_by": b_by}
        print(f"{name}: n={n8} {ms8:.4f} ms on the device (profiler); bound {b_ms:.4f} ms "
              f"by {b_by}", flush=True)
    results["g2_add"]["sass"] = sass_imad(build, "g2", "g2_add_kernel")

    # the G1 and G2 ladders at the proofs' widths, ragged widths and 8192
    for name, extra in point_ladder_checks(torch, dev, gen, record).items():
        results[name].update(extra)

    # K1's BabyJubJub add and ladder on edge rows and the 8-torsion at 1 to
    # 2^16 lanes; timed at the verify's 4096 and the sign's 8192
    for name, extra in jub_kernel_checks(torch, dev, gen, record).items():
        results[name].update(extra)

    # K4 at the deposit's 4096 hashes; first rows: every pair of 0, 1, p − 1,
    # p − 2; twin over 4097 rows once, the kernel at each width against it
    n4 = 4096
    left, right = (rand_field(torch, gen, P_FR, n4 + 1, dev),
                   rand_field(torch, gen, P_FR, n4 + 1, dev))
    pick = torch.arange(16, device=dev)
    left[:16], right[:16] = left[pick // 4], left[pick % 4]
    twin = poseidon.poseidon_hash2_plain(left, right)
    cases = {f"n={n}": max_abs_err(torch, poseidon.poseidon_hash2(left[:n], right[:n]), twin[:n])
             for n in (1, 31, n4 - 1, n4 + 1)}
    print("poseidon_hash2 max |diff| by case: " + json.dumps(cases), flush=True)
    for case, case_err in cases.items():
        if case_err != 0:
            fail(f"poseidon_hash2 ({case}): kernel disagrees with its plain version")
    left, right = left[:n4], right[:n4]
    err = max_abs_err(torch, poseidon.poseidon_hash2(left, right), twin[:n4])
    record("poseidon_hash2", n4, lambda: poseidon.poseidon_hash2(left, right),
           lambda: poseidon.poseidon_hash2_plain(left, right), err, 20)
    results["poseidon_hash2"]["cases"] = cases
    # one hash: the latency of the kernel's chain, alone on the card
    results["poseidon_hash2"]["n1_ms"] = device_ms(
        torch, lambda: poseidon.poseidon_hash2(left[:1], right[:1]), 20,
        KERNEL_SYMBOLS["poseidon_hash2"])
    print(f"poseidon_hash2: n=1 {results['poseidon_hash2']['n1_ms']:.4f} ms on the device",
          flush=True)
    results["poseidon_hash2"]["sass"] = sass_imad(build, "poseidon", "poseidon2_kernel")

    # K5: the last stage of the 2^20 NTT (2^19 butterflies), where twiddle j
    # is table row j, so the edge rows meet in a, b and w; in place, so the
    # kernel and the twin each get a copy (timing keeps transforming it)
    log5 = 20
    x5 = rand_field(torch, gen, P_FR, 1 << log5, dev)
    x5[1 << (log5 - 1):(1 << (log5 - 1)) + 4] = x5[:4]
    tab5 = rand_field(torch, gen, P_FR, 1 << (log5 - 1), dev)
    xk, xp = x5.clone(), x5.clone()
    err = max_abs_err(torch, ntt.butterfly_stage(xk, tab5, log5),
                      ntt.butterfly_stage_plain(xp, tab5, log5))
    half5 = 1 << (log5 - 1)
    record("ntt_butterfly", half5, lambda: ntt.butterfly_stage(xk, tab5, log5),
           lambda: ntt.butterfly_stage_plain(xp, tab5, log5), err, 50,
           work=(2 * (1 << log5) * ROW + half5 * ROW, half5 * BFLY_OPS))

    # K6 at 2^16 hashes, then at a few small N and on the edge rows: every
    # pair of 0, 1, p − 1, p − 2, and left == right
    n6 = 1 << 16
    left, right = rand_field(torch, gen, P_FR, n6, dev), rand_field(torch, gen, P_FR, n6, dev)
    right[4:8] = left[:4]
    err = max_abs_err(torch, mimc.mimc_hash2(left, right), mimc.mimc_hash2_plain(left, right))
    cases = {}
    for n in (1, 33, 1000):
        cases[f"n={n}"] = max_abs_err(torch, mimc.mimc_hash2(left[-n:], right[:n]),
                                      mimc.mimc_hash2_plain(left[-n:], right[:n]))
    pick = torch.arange(16, device=dev)
    edge_l = torch.cat([left[pick // 4], left[8:12]])
    edge_r = torch.cat([left[pick % 4], left[8:12]])
    cases["edges"] = max_abs_err(torch, mimc.mimc_hash2(edge_l, edge_r),
                                 mimc.mimc_hash2_plain(edge_l, edge_r))
    print("mimc_hash2 max |diff| by case: " + json.dumps(cases), flush=True)
    for case, case_err in cases.items():
        if case_err != 0:
            fail(f"mimc_hash2 ({case}): kernel disagrees with its plain version")
    record("mimc_hash2", n6, lambda: mimc.mimc_hash2(left, right),
           lambda: mimc.mimc_hash2_plain(left, right), err, 20)
    results["mimc_hash2"]["cases"] = cases
    results["mimc_hash2"]["sass"] = sass_imad(build, "mimc", "mimc2_kernel")
    print(f"  (mimc2_kernel holds one round in its loop; the bound counts "
          f"{(2 * SQR_OPS + 2 * MUL_OPS) // 2} multiply-adds a round)", flush=True)

    # K7 at every log_n1 the fused route's recursion can give it and at the
    # limits, forward and inverse, on 1, 3, 1023 and 1024 columns, with 0, 1
    # and p − 1 in every column (rotating over the columns).  Columns are
    # independent, so the twin runs once on 1024 and its first c columns
    # are the twin of the first c
    edge = rand_field(torch, gen, P_FR, 4, dev)[:3]           # 0, 1, p − 1
    cases = {}
    for lg in (1, 2, 3, 5, 10, 12):
        n1 = 1 << lg
        xs = rand_field(torch, gen, P_FR, n1 * 1024, dev).view(n1, 1024, 16)
        cidx = torch.arange(1024, device=dev)
        for k in range(3):
            xs[(cidx + k) % n1, cidx] = edge[(cidx + k) % 3]
        for inverse in (False, True):
            tw = col_twiddles(lg, inverse, dev)
            twin = ntt.ntt_cols_plain(xs, tw)
            for c in (1, 3, 1023, 1024):
                key = f"log_n1={lg} {'inverse' if inverse else 'forward'} cols={c}"
                cases[key] = max_abs_err(torch, ntt.ntt_cols(xs[:, :c], tw), twin[:, :c])
    print("ntt_cols max |diff| by case: " + json.dumps(cases), flush=True)
    for case, case_err in cases.items():
        if case_err != 0:
            fail(f"ntt_cols ({case}): a kernel disagrees with its plain version")

    # K7 timed at the first level of the 2^20 fused NTT, 2^10 columns of
    # 2^10 points
    la = 10
    x7 = rand_field(torch, gen, P_FR, 1 << 20, dev).view(1 << la, -1, 16)
    tw7 = col_twiddles(la, False, dev)
    err = max_abs_err(torch, ntt.ntt_cols(x7, tw7), ntt.ntt_cols_plain(x7, tw7))
    cols = x7.shape[1]
    muls7, adds7 = ntt_cols_work(la)
    record("ntt_cols", cols, lambda: ntt.ntt_cols(x7, tw7), lambda: ntt.ntt_cols_plain(x7, tw7),
           err, 50, work=(2 * (1 << 20) * ROW + tw7.shape[0] * ROW,
                          cols * (muls7 * MUL_OPS + adds7 * ADD_OPS)))
    results["ntt_cols"]["cases"] = cases
    results["ntt_cols"]["shared_ops"] = shared_ops(build.library_path("ntt"),
                                                   "ntt_cols_kernelILi3E")
    print("ntt_cols_kernel<3> SASS shared-memory ops: "
          + json.dumps(results["ntt_cols"]["shared_ops"]), flush=True)
    return results


# ---------------------------------------------------------------------------
# Phase 3: the depth-16 round trip
# ---------------------------------------------------------------------------

def round_trip_depth16(torch, dev) -> dict:
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.circuits.pool import commitment_of
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.groth16 import groth16
    from owshen_tpu_torch.ops.merkle import oracle_sparse_root
    from owshen_tpu_torch.protocol.pool import PoolError, PrivacyPool

    stages = {}
    rng = random.Random(16)
    note = {"secret": rng.randrange(FR.p), "salt": rng.randrange(FR.p),
            "amount": 5 * 10 ** 18, "token": 0}
    recipient = rng.randrange(1 << 160)
    n_dep = 4096
    real_at = 1234
    coms = [rng.randrange(FR.p) for _ in range(n_dep)]
    coms[real_at] = commitment_of(note["secret"], note["salt"], note["amount"], note["token"])
    txs = [rng.randrange(1 << 256) for _ in range(n_dep)]
    amounts = [0] * n_dep
    amounts[real_at] = note["amount"]

    kernels.reset_launches()
    t = time.time()
    pool = PrivacyPool(depth=16, device=dev)
    torch.cuda.synchronize()
    stages["setup_s"] = time.time() - t
    marks = {"setup": kernels.launch_counts()}
    print(f"d16 setup: {stages['setup_s']:.2f} s (n_domain {pool.pk.n_domain})", flush=True)

    t = time.time()
    idxs = pool.deposit(coms, txs, amounts)
    root = pool.tree.root_int()
    stages["deposit_s"] = time.time() - t
    marks["deposit"] = kernels.launch_counts()
    print(f"d16 deposit of {n_dep}: {stages['deposit_s']:.2f} s", flush=True)

    t = time.time()
    want_root = oracle_sparse_root(dict(zip(idxs, coms)), 16)
    stages["oracle_root_s"] = time.time() - t
    if root != want_root:
        fail("depth-16 root differs from the host oracle")
    print("d16 root == oracle_sparse_root", flush=True)

    t = time.time()
    proof, proot, nullifier = pool.prove_withdraw(
        note["secret"], note["salt"], note["amount"], real_at, recipient)
    stages["prove_withdraw_s"] = time.time() - t
    marks["first_prove"] = kernels.launch_counts()
    print(f"d16 prove_withdraw (first, builds tables): {stages['prove_withdraw_s']:.2f} s",
          flush=True)

    t = time.time()
    voucher = pool.withdraw(proof, proot, nullifier, recipient, note["amount"])
    stages["withdraw_verify_s"] = time.time() - t
    t = time.time()
    pool.redeem(voucher)
    stages["redeem_s"] = time.time() - t
    print(f"d16 withdraw: {stages['withdraw_verify_s']:.2f} s, redeem: "
          f"{stages['redeem_s']:.2f} s", flush=True)
    try:
        pool.redeem(voucher)
    except PoolError as err:
        print(f"d16 second redeem rejected: {err}", flush=True)
    else:
        fail("a voucher was redeemed twice")
    if groth16.verify(pool.vk, [proot, nullifier, recipient + 1, note["amount"], 0], proof):
        fail("a tampered public input verified")
    print("d16 tampered public input rejected", flush=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    widths = kernels.launch_widths()

    builder = pool_builder(pool, note, real_at, recipient)
    t = time.time()
    groth16.prove(pool.pk, builder, device=dev)
    torch.cuda.synchronize()
    stages["prove_warm_s"] = time.time() - t
    marks["warm_prove"] = kernels.launch_counts()
    print(f"d16 warm prove: {stages['prove_warm_s']:.2f} s", flush=True)
    wall, busy, _ = device_busy(torch, lambda: groth16.prove(pool.pk, builder, device=dev))
    stages["prove_profiled_s"], stages["prove_device_busy_s"] = wall, busy
    print(f"d16 warm prove under the profiler: {wall:.2f} s, device busy {busy:.3f} s "
          f"(idle {100 * (1 - busy / wall):.1f} %)", flush=True)
    print("d16 launches: " + json.dumps(counts), flush=True)
    per_stage = {}
    before = {name: 0 for name in counts}
    for stage, after in (("setup", marks["setup"]), ("deposit", marks["deposit"]),
                         ("first_prove", marks["first_prove"]),
                         ("warm_prove", marks["warm_prove"])):
        per_stage[stage] = {k: after[k] - before[k] for k in after}
        before = counts if stage == "first_prove" else after
    print("d16 launches by stage: " + json.dumps(per_stage), flush=True)
    for name in DEPTH16_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the depth-16 path")
    ladders = {k: per_stage["warm_prove"][k] for k in LADDER_PATH_NS}
    if ladders != {k: 1 for k in LADDER_PATH_NS}:
        fail(f"the warm prove's tails made {ladders} ladder launches, not one of each")
    print("d16 launches by width, {width: [launches, items]}: "
          + json.dumps({k: widths[k] for k in WIDTH_KERNELS}), flush=True)
    return {"stages": stages, "launches": counts, "launches_by_stage": per_stage,
            "widths": widths, "pool": pool, "builder": builder,
            "entries": dict(zip(idxs, coms)), "root": root}


def sorted_withdraw(torch, dev, pool, builder) -> dict:
    """The depth-16 withdraw proof through engine="sorted" (the path a key
    whose fixed tables exceed the budget takes) against the fixed engine's
    proof under the same seed: the proofs are affine points, so they must
    be equal."""
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.groth16 import groth16

    seed = b"chip-smoke-d16-sorted"
    out = {}
    t = time.time()
    fixed = groth16.prove(pool.pk, builder, seed=seed, device=dev)
    torch.cuda.synchronize()
    out["fixed_s"] = time.time() - t
    kernels.reset_launches()
    t = time.time()
    srt = groth16.prove(pool.pk, builder, seed=seed, engine="sorted", device=dev)
    torch.cuda.synchronize()
    out["sorted_s"] = time.time() - t
    out["launches"] = nonzero(kernels.launch_counts())
    if (srt.a, srt.b, srt.c) != (fixed.a, fixed.b, fixed.c):
        fail("depth-16: the sorted engine's proof differs from the fixed engine's")
    ladders = {k: out["launches"].get(k, 0) for k in LADDER_PATH_NS}
    if ladders != {k: 1 for k in LADDER_PATH_NS}:
        fail(f"the sorted engine made {ladders} ladder launches, not one of each")
    print(f"d16 prove through engine='sorted' == fixed ({out['sorted_s']:.2f} s, fixed "
          f"{out['fixed_s']:.2f} s); launches " + json.dumps(out["launches"]), flush=True)
    return out, fixed


def width_losses(torch, dev, widths, names=LOSS_KERNELS, label="depth-16") -> dict:
    """The loss of the kernels `names` on a path, width by width: each width
    bucket's kernel timed on the card (profiler) at the bucket's mean width,
    beside its bound; loss = launches × (device ms − bound)."""
    from owshen_tpu_torch.kernels import field_ops, g1, g2
    from owshen_tpu_torch.oracle.field import P_FQ

    names = [name for name in names if widths[name]]
    gen = torch.Generator().manual_seed(16)
    g1_names = [name for name in names if name != "g2_add"]
    widest = max([4] + [w for name in g1_names for w in widths[name]])
    a, b = (rand_field(torch, gen, P_FQ, widest, dev) for _ in range(2))
    p, q = (tuple(rand_field(torch, gen, P_FQ, widest, dev) for _ in range(3)) for _ in range(2))
    w2 = max([4] + list(widths["g2_add"]))
    p2, q2 = (tuple(rand_field(torch, gen, P_FQ, 2 * w2, dev).view(w2, 2, 16) for _ in range(3))
              for _ in range(2))
    calls = {
        "mont_mul": lambda n: field_ops.mont_mul(a[:n], b[:n], "fq"),
        "mod_add": lambda n: field_ops.mod_add(a[:n], b[:n], "fq"),
        "mod_sub": lambda n: field_ops.mod_sub(a[:n], b[:n], "fq"),
        "g1_add": lambda n: g1.g1_add(tuple(c[:n] for c in p), tuple(c[:n] for c in q)),
        "g1_double": lambda n: g1.g1_double(tuple(c[:n] for c in p)),
        "g2_add": lambda n: g2.g2_add(tuple(c[:n] for c in p2), tuple(c[:n] for c in q2)),
    }
    out = {}
    for name in names:
        rows = []
        for width, (count, items) in widths[name].items():
            n = max(1, round(items / count))
            ms = device_ms(torch, lambda: calls[name](n), 20, KERNEL_SYMBOLS[name])
            b_ms, _ = bound(n * PER_ITEM[name][0], n * PER_ITEM[name][1])
            rows.append({"width": width, "launches": count, "n": n, "ms": ms, "bound_ms": b_ms,
                         "loss_ms": count * max(0.0, ms - b_ms)})
        out[name] = {"loss_ms": sum(r["loss_ms"] for r in rows), "by_width": rows}
        print(f"{name} on the {label} path: loss {out[name]['loss_ms']:.3f} ms; [width, "
              f"launches, mean n, device ms, bound ms]: "
              + json.dumps([[r["width"], r["launches"], r["n"], round(r["ms"], 5),
                             round(r["bound_ms"], 5)] for r in rows]), flush=True)
    return out


def pool_builder(pool, note, index, recipient):
    from owshen_tpu_torch.circuits import pool as circuits
    from owshen_tpu_torch.fields.field import FR

    sibs = FR.decode(pool.tree.path([index])[0][0])
    w = circuits.WithdrawWitness(secret=note["secret"], salt=note["salt"],
                                 amount=note["amount"], index=index, siblings=sibs,
                                 token=note["token"])
    return circuits.withdraw_circuit(pool.depth, w, root=pool.tree.root_int(),
                                     recipient=recipient)


# ---------------------------------------------------------------------------
# Phase 4: vouchers and the sequencer (BabyJubJub EdDSA at 4096, the pool's
# batched withdraw, wire, rollback and checkpoint)
# ---------------------------------------------------------------------------

VOUCHER_BATCH = 4096        # the sequencer's EdDSA batch (bench.py verifies 2^12)
VOUCHER_CHECKED = 64        # signatures held against the host oracle
VERIFY_REPS = 3
VOUCHER_K1_K4 = ("mont_mul", "mod_add", "mod_sub", "poseidon_hash2")
VOUCHER_KERNELS = VOUCHER_K1_K4 + ("jub_add", "jub_scalar_mul")
K1 = ("mont_mul", "mod_add", "mod_sub")
VOUCHER_STACKS = (1, 2, 3, 4, 6, 8, 36)    # K1 operands of the EdDSA batch, in batches


def eddsa_batch(torch, dev, priv: int, pub) -> tuple[dict, tuple]:
    """4096 distinct seeded messages signed by the sequencer key in one
    eddsa_sign_batch, 64 seeded picks against the host oracle, all verified
    by eddsa_verify; then a seeded eighth tampered (message, s + 1, R off
    the curve) must be rejected on exactly those lanes.  Returns the
    readings and the valid batch's verify operands."""
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.curves import babyjubjub as jub
    from owshen_tpu_torch.fields.field import FR, ints_to_tensor
    from owshen_tpu_torch.oracle import eddsa as oeddsa

    n = VOUCHER_BATCH
    rng = random.Random(n)
    msgs = [rng.randrange(FR.p) for _ in range(n)]
    rand = [rng.randrange(FR.p) for _ in range(n)]
    if len(set(msgs)) != n:
        fail("the seeded voucher messages are not distinct")
    out = {}
    t = time.time()
    sigs = jub.eddsa_sign_batch([priv] * n, rand, msgs, device=dev)
    out["sign_first_s"] = time.time() - t             # builds the base point's tables
    before = kernels.launch_counts()
    t = time.time()
    again = jub.eddsa_sign_batch([priv] * n, rand, msgs, device=dev)
    out["sign_s"] = time.time() - t
    out["sign_launches"] = {k: v - before[k] for k, v in kernels.launch_counts().items()
                            if v > before[k]}
    if again != sigs:
        fail("eddsa_sign_batch gave different signatures for the same inputs")
    if out["sign_launches"].get("jub_add") != 31:
        fail(f"a warm eddsa_sign_batch made {out['sign_launches'].get('jub_add')} jub_add "
             "launches, not the fixed-base sum's 31")
    for i in rng.sample(range(n), VOUCHER_CHECKED):
        if sigs[i] != oeddsa.sign(priv, rand[i], msgs[i]):
            fail(f"eddsa_sign_batch lane {i} differs from oracle.eddsa.sign")
    print(f"eddsa_sign_batch of {n}: {VOUCHER_CHECKED} seeded picks == oracle.eddsa.sign; "
          f"first {out['sign_first_s']:.3f} s (base-point tables), then "
          f"{out['sign_s']:.4f} s; launches per batch " + json.dumps(out["sign_launches"]),
          flush=True)

    def encode(ms, rs, ss):
        return ((FR.encode([pub[0]] * n, device=dev), FR.encode([pub[1]] * n, device=dev)),
                FR.encode(ms, device=dev),
                (FR.encode([r[0] for r in rs], device=dev),
                 FR.encode([r[1] for r in rs], device=dev)),
                ints_to_tensor(ss, dev))

    rs, ss = [r for r, _ in sigs], [s for _, s in sigs]
    args = encode(msgs, rs, ss)
    before = kernels.launch_counts()
    ok = jub.eddsa_verify(*args)
    torch.cuda.synchronize()
    out["verify_launches"] = {k: v - before[k] for k, v in kernels.launch_counts().items()
                              if v > before[k]}
    if not bool(ok.all()):
        fail(f"eddsa_verify rejected {int((~ok).sum())} of {n} valid signatures")
    got = tuple(out["verify_launches"].get(k, 0) for k in ("jub_scalar_mul", "jub_add"))
    if got != (1, 32):
        fail(f"eddsa_verify made {got} (jub_scalar_mul, jub_add) launches, not (1, 32)")
    out["verify_k1"] = {k: out["verify_launches"].get(k, 0) for k in K1}
    out["sign_k1"] = {k: out["sign_launches"].get(k, 0) for k in K1}
    print(f"eddsa K1 launches by kernel: verify {json.dumps(out['verify_k1'])} "
          f"({sum(out['verify_k1'].values())}), warm sign {json.dumps(out['sign_k1'])} "
          f"({sum(out['sign_k1'].values())})", flush=True)
    out["verify_s"] = []
    for _ in range(VERIFY_REPS):
        t = time.time()
        jub.eddsa_verify(*args)
        torch.cuda.synchronize()
        out["verify_s"].append(time.time() - t)
    out["verifies_per_s"] = n * len(out["verify_s"]) / sum(out["verify_s"])
    wall, busy, events = device_busy(torch, lambda: jub.eddsa_verify(*args))
    out["verify_profiled_s"], out["verify_busy_s"] = wall, busy
    split = spans_by_kernel(events)
    out["verify_split"] = {k: [c, round(ms, 4)] for k, (c, ms) in
                           sorted(split.items(), key=lambda kv: -kv[1][1])[:8]}
    print(f"eddsa_verify of {n}: all accepted; {json.dumps([round(x, 4) for x in out['verify_s']])}"
          f" s, {out['verifies_per_s']:.0f} verifies/s; under the profiler {wall:.4f} s, device "
          f"busy {busy:.4f} s (idle {100 * (1 - busy / wall):.1f} %); launches per batch "
          + json.dumps(out["verify_launches"]) + "; device ms by kernel [spans, ms] "
          + json.dumps(out["verify_split"]), flush=True)


    bad = sorted(rng.sample(range(n), n // 8))
    ms_t, rs_t, ss_t = list(msgs), list(rs), list(ss)
    for j, i in enumerate(bad):
        if j % 3 == 0:
            ms_t[i] = (ms_t[i] + 1) % FR.p
        elif j % 3 == 1:
            ss_t[i] += 1
        else:
            rs_t[i] = (rs_t[i][0], (rs_t[i][1] + 1) % FR.p)
    ok = jub.eddsa_verify(*encode(ms_t, rs_t, ss_t)).cpu()
    want = torch.ones(n, dtype=torch.bool)
    want[bad] = False
    if not torch.equal(ok, want):
        fail(f"eddsa_verify on the tampered batch: {int((ok != want).sum())} lanes differ "
             f"from the {len(bad)} tampered ones")
    print(f"eddsa_verify rejects exactly the {len(bad)} tampered lanes (message, s + 1, R off "
          f"the curve)", flush=True)
    return out, args


def sequencer_ops(torch, dev, pool, entries: dict) -> dict:
    """On the depth-16 pool of phase 3: withdraw_batch of two fresh proofs
    (after an in-batch duplicate nullifier is rejected with no state
    change), verify_vouchers_batch, each voucher through the wire codec to
    redeem; a deposit batch popped (the root back to the earlier one and
    the host oracle's) and deposited again; save_pool / load_pool into a
    temporary directory, and a warm prove from the loaded pool."""
    import shutil

    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.circuits.pool import commitment_of
    from owshen_tpu_torch.config import settings
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.groth16 import groth16
    from owshen_tpu_torch.ops.merkle import oracle_sparse_root
    from owshen_tpu_torch.protocol import wire
    from owshen_tpu_torch.protocol.pool import PoolError
    from owshen_tpu_torch.runtime import checkpoint

    rng = random.Random(9)
    out = {}
    notes = [{"secret": rng.randrange(FR.p), "salt": rng.randrange(FR.p),
              "amount": (i + 2) * 10 ** 18, "token": 0} for i in range(2)]
    coms = [commitment_of(nt["secret"], nt["salt"], nt["amount"], nt["token"]) for nt in notes]
    idxs = pool.deposit(coms, [rng.randrange(1 << 256) for _ in notes],
                        [nt["amount"] for nt in notes])
    entries.update(zip(idxs, coms))
    reqs = []
    for nt, idx in zip(notes, idxs):
        recipient = rng.randrange(1 << 160)
        proof, root, nullifier = pool.prove_withdraw(nt["secret"], nt["salt"], nt["amount"],
                                                     idx, recipient)
        reqs.append((proof, root, nullifier, recipient, nt["amount"]))
    spent, balances = set(pool.nullifiers), dict(pool.balances)
    try:
        pool.withdraw_batch([reqs[0], reqs[0]])
    except PoolError as err:
        if "nullifier already spent" not in str(err):
            fail(f"withdraw_batch: an in-batch duplicate nullifier failed as {err!r}")
    else:
        fail("withdraw_batch accepted a nullifier twice in one batch")
    if (pool.nullifiers, pool.balances) != (spent, balances):
        fail("withdraw_batch changed the pool's state on a rejected batch")
    before = kernels.launch_counts()
    t = time.time()
    vouchers = pool.withdraw_batch(reqs)
    out["withdraw_batch_s"] = time.time() - t
    mid = kernels.launch_counts()
    t = time.time()
    ok = pool.verify_vouchers_batch(vouchers)
    torch.cuda.synchronize()
    out["verify_vouchers_s"] = time.time() - t
    after = kernels.launch_counts()
    out["withdraw_batch_launches"] = {k: v - before[k] for k, v in mid.items() if v > before[k]}
    out["verify_vouchers_launches"] = {k: v - mid[k] for k, v in after.items() if v > mid[k]}
    print("pool: launches of withdraw_batch " + json.dumps(out["withdraw_batch_launches"])
          + ", of verify_vouchers_batch " + json.dumps(out["verify_vouchers_launches"]),
          flush=True)
    for name, counts in (("withdraw_batch", out["withdraw_batch_launches"]),
                         ("verify_vouchers_batch", out["verify_vouchers_launches"])):
        if not counts.get("jub_add"):
            fail(f"{name} launched no jub_add")
    if not out["verify_vouchers_launches"].get("jub_scalar_mul"):
        fail("verify_vouchers_batch launched no jub_scalar_mul")
    if not ok.all():
        fail("verify_vouchers_batch rejected a voucher of withdraw_batch")
    chain = settings().chain_id
    for v in vouchers:
        pool.redeem(wire.verify_voucher_bytes(wire.encode_voucher(v, chain), pool.seq_pub, chain))
    print(f"pool: an in-batch duplicate nullifier rejected, state unchanged; withdraw_batch of 2 "
          f"proofs {out['withdraw_batch_s']:.3f} s (two pairing verifies, one batched sign); "
          f"verify_vouchers_batch true on both ({out['verify_vouchers_s']:.3f} s); each voucher "
          f"encode_voucher -> verify_voucher_bytes -> redeem", flush=True)

    root_before = pool.tree.root_int()
    coms_b = [rng.randrange(FR.p) for _ in range(64)]
    txs_b = [rng.randrange(1 << 256) for _ in coms_b]
    pool.deposit(coms_b, txs_b)
    root_b = pool.tree.root_int()
    t = time.time()
    pool.pop_batch()
    out["pop_batch_s"] = time.time() - t
    if pool.tree.root_int() != root_before:
        fail("pop_batch did not restore the earlier root")
    if root_before != oracle_sparse_root(entries, pool.depth):
        fail("the root after pop_batch differs from the host oracle's")
    pool.deposit(coms_b, txs_b)
    if pool.tree.root_int() != root_b:
        fail("the re-deposit after pop_batch gave another root")
    print(f"pool: pop_batch of 64 ({out['pop_batch_s']:.4f} s) restored the earlier root == "
          f"oracle_sparse_root; the same L1 transactions deposited again", flush=True)

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "pool.db")
        out["disk_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        t = time.time()
        checkpoint.save_pool(pool, path)
        out["save_s"] = time.time() - t
        out["checkpoint_bytes"] = os.path.getsize(path)
        t = time.time()
        loaded = checkpoint.load_pool(path)
        torch.cuda.synchronize()
        out["load_s"] = time.time() - t
    finally:
        shutil.rmtree(tmp)
    if loaded.device.type != "cuda" or loaded.tree.nodes.device.type != "cuda" \
            or loaded.pk.device.type != "cuda":
        fail(f"load_pool resumed on {loaded.device}, not on the card")
    if loaded.tree.root_int() != pool.tree.root_int() or loaded.roots != pool.roots:
        fail("load_pool: the loaded root differs")
    builder = pool_builder(loaded, notes[0], idxs[0], reqs[0][3])
    before = kernels.launch_counts()
    t = time.time()
    proof = groth16.prove(loaded.pk, builder, device=dev)
    torch.cuda.synchronize()
    out["loaded_prove_s"] = time.time() - t
    out["loaded_prove_launches"] = {k: v - before[k] for k, v in kernels.launch_counts().items()
                                    if v > before[k]}
    if out["loaded_prove_launches"].get("g1_double") or out["loaded_prove_launches"].get("g2_double"):
        fail("the prove from the loaded pool rebuilt its fixed tables")
    if not groth16.verify(loaded.vk, builder.witness()[1:1 + builder.n_pub], proof):
        fail("the proof from the loaded pool did not verify")
    loaded.pop_batch()
    if loaded.tree.root_int() != root_before:
        fail("pop_batch after load_pool did not restore the earlier root")
    print(f"checkpoint: save_pool {out['save_s']:.2f} s, {out['checkpoint_bytes']} bytes "
          f"({out['disk_free_gb']:.0f} GB free); load_pool {out['load_s']:.2f} s, on cuda, root "
          f"equal; a prove from it {out['loaded_prove_s']:.3f} s with no table build (launches "
          + json.dumps(out["loaded_prove_launches"]) + "), verified; pop_batch after the load "
          "restores the earlier root", flush=True)
    return out


def voucher_path_checks(torch, args) -> tuple[dict, set]:
    """K1 and K4 against their plain versions at every width the EdDSA
    batch launches them, on the verify batch's own operands (A, M, R: 4096
    Montgomery Fr rows each): K1's product, add and subtract on k stacked
    batches for each k in VOUCHER_STACKS (`to_affine`'s and `eq`'s stacked
    operands, the sign's 2n lanes, the t = 6 Poseidon's state and MDS
    products), and on one 16-limb constant broadcast over 4096 and 8192 rows
    (the kernels' step-0 operand: every mul_const and to_mont); K4 on
    (M, R.x) at 4096.  Fails on any difference; returns the errors and the
    (kernel, width) pairs held, widths bucketed as the launch counters do."""
    from owshen_tpu_torch.curves.babyjubjub import D
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.kernels import field_ops, poseidon

    (ax, ay), msg, (rx, ry), _ = args
    vals = (rx, ry, msg, ax, ay)
    n = msg.shape[0]
    k1 = {"mont_mul": (field_ops.mont_mul, field_ops.mont_mul_plain),
          "mod_add": (field_ops.mod_add, field_ops.mod_add_plain),
          "mod_sub": (field_ops.mod_sub, field_ops.mod_sub_plain)}
    const = FR.const(D, device=msg.device)
    errs, held = {}, set()

    def check(name, rows, note, got, want):
        errs[f"{name} n={rows}{note}"] = max_abs_err(torch, got, want)
        held.add((name, 1 << max(0, rows - 1).bit_length()))

    for k in VOUCHER_STACKS:
        a = torch.stack([vals[i % len(vals)] for i in range(k)])
        b = torch.stack([vals[(i + 1 + i // len(vals)) % len(vals)] for i in range(k)])
        for name, (kernel, plain) in k1.items():
            check(name, k * n, f" ({k} stacked)", kernel(a, b, "fr"), plain(a, b, "fr"))
    for k in (1, 2):
        a = torch.cat(vals[:k])
        for name, (kernel, plain) in k1.items():
            check(name, k * n, " (constant operand)", kernel(a, const, "fr"),
                  plain(a, const, "fr"))
    check("poseidon_hash2", n, "", poseidon.poseidon_hash2(msg, rx),
          poseidon.poseidon_hash2_plain(msg, rx))
    print("voucher path kernels against their plain versions on the verify batch's operands, "
          "max |diff|: " + json.dumps(errs), flush=True)
    for case, err in errs.items():
        if err != 0:
            fail(f"voucher path ({case}): kernel disagrees with its plain version")
    return errs, held


def voucher_phase(torch, dev, pool, entries: dict) -> dict:
    from owshen_tpu_torch import kernels

    kernels.reset_launches()
    out = {}
    with kernels.capture_operands() as kept:
        out["eddsa"], args = eddsa_batch(torch, dev, pool._seq_priv, pool.seq_pub)
        widths = kernels.launch_widths()
        out["eddsa_widths"] = {k: widths[k] for k in VOUCHER_KERNELS}
        out["pool"] = sequencer_ops(torch, dev, pool, entries)
    out["launches"] = kernels.launch_counts()
    # every (kernel, width) of the phase, held against its plain version
    # on its own operands after the last profiled measurement (mesh_checks)
    out["capture"] = {"phase": "vouchers", "path_checks": {}, "kept": {"voucher phase": (
        {k: copies(torch, a, torch.device("cpu")) for k, a in kept.items()},
        kernels.launch_widths())}}
    print("vouchers and the sequencer: launches " + json.dumps(nonzero(out["launches"]))
          + "; the EdDSA batch's by width {width: [launches, items]}: "
          + json.dumps(out["eddsa_widths"]), flush=True)
    for name in VOUCHER_KERNELS:
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched on the voucher path")
    out["path_checks"], held = voucher_path_checks(torch, args)
    unheld = sorted({(k, int(w)) for k, ws in out["eddsa_widths"].items() for w in ws
                     if k in VOUCHER_K1_K4} - held)
    if unheld:
        fail(f"EdDSA batch: kernel widths not held against their plain versions: {unheld}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the depth-2 proof against the JAX-recorded digest
# ---------------------------------------------------------------------------

def depth2_digest(dev) -> str:
    from owshen_tpu_torch.circuits.pool import commitment_of
    from owshen_tpu_torch.protocol.pool import PrivacyPool

    pool = PrivacyPool(depth=2, setup_seed=DEPTH2_SETUP_SEED, device=dev)
    coms, txs, amounts = depth2_deposits(commitment_of)
    pool.deposit(coms, txs, amounts)
    proof, _, _ = pool.prove_withdraw(DEPTH2_NOTE["secret"], DEPTH2_NOTE["salt"],
                                      DEPTH2_NOTE["amount"], 1, DEPTH2_RECIPIENT,
                                      token=DEPTH2_NOTE["token"], seed=DEPTH2_PROVE_SEED)
    return proof_digest(proof)


# ---------------------------------------------------------------------------
# Phase 6: the deposit proof through the fixed, lane and sorted engines
# ---------------------------------------------------------------------------

# the kernels the deposit prove must launch (setup and first prove)
DEPOSIT_KERNELS = ("mont_mul", "mod_add", "mod_sub", "g1_add", "g1_double", "g2_add",
                   "g2_double", "ntt_butterfly")
WARM_PROVES = 8


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def deposit_digest(dev) -> str:
    """The digest of the deposit proof under the fixed seeds (fixed engine)."""
    from owshen_tpu_torch.circuits import pool as circuits
    from owshen_tpu_torch.groth16 import groth16

    pk, _ = groth16.setup(circuits.deposit_circuit(), seed=DEPOSIT_SETUP_SEED, device=dev)
    builder = circuits.deposit_circuit(circuits.DepositWitness(**DEPOSIT_NOTE))
    return proof_digest(groth16.prove(pk, builder, seed=DEPOSIT_PROVE_SEED, device=dev))


def deposit_phase(torch, dev) -> dict:
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.circuits import pool as circuits
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.groth16 import groth16

    out = {}
    builder = circuits.deposit_circuit(circuits.DepositWitness(**DEPOSIT_NOTE))
    pub = deposit_publics(circuits.commitment_of)
    kernels.reset_launches()
    t = time.time()
    pk, vk = groth16.setup(circuits.deposit_circuit(), seed=DEPOSIT_SETUP_SEED, device=dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.time() - t
    t = time.time()
    proof = groth16.prove(pk, builder, seed=DEPOSIT_PROVE_SEED, device=dev)
    torch.cuda.synchronize()
    out["first_prove_s"] = time.time() - t
    out["launches"] = kernels.launch_counts()
    for name in DEPOSIT_KERNELS:
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched by the deposit setup and prove")
    print(f"deposit ({len(builder.constraints)} constraints, n_domain {pk.n_domain}): setup "
          f"{out['setup_s']:.2f} s, first prove (builds tables) {out['first_prove_s']:.2f} s; "
          f"launches " + json.dumps(nonzero(out["launches"])), flush=True)
    digest = proof_digest(proof)
    if digest != DEPOSIT_DIGEST:
        fail(f"deposit proof digest {digest} != JAX reference {DEPOSIT_DIGEST}")
    if not groth16.verify(vk, pub, proof):
        fail("the deposit proof did not verify")
    for i, what in enumerate(("commitment", "amount", "token")):
        bad = list(pub)
        bad[i] = (bad[i] + 1) % FR.p
        if groth16.verify(vk, bad, proof):
            fail(f"the deposit proof verified with a tampered {what}")
    print("deposit digest matches; verify accepts, a tampered commitment, amount and token "
          "are rejected", flush=True)

    warm = []
    for _ in range(WARM_PROVES):
        t = time.time()
        groth16.prove(pk, builder, device=dev)
        torch.cuda.synchronize()
        warm.append(time.time() - t)
    out["warm_prove_s"] = warm
    out["warm_proofs_per_s"] = len(warm) / sum(warm)
    kernels.reset_launches()
    groth16.prove(pk, builder, device=dev)
    torch.cuda.synchronize()
    out["warm_launches"] = nonzero(kernels.launch_counts())
    out["warm_widths"] = {k: v for k, v in kernels.launch_widths().items() if v}
    wall, busy, events = device_busy(torch, lambda: groth16.prove(pk, builder, device=dev))
    out["warm_profiled_s"], out["warm_busy_s"] = wall, busy
    out["warm_split"] = spans_by_kernel(events)
    print(f"deposit warm prove: {json.dumps([round(x, 4) for x in warm])} s, "
          f"{out['warm_proofs_per_s']:.2f} proofs/s; under the profiler {wall:.3f} s, device "
          f"busy {busy:.4f} s (idle {100 * (1 - busy / wall):.1f} %); launches "
          + json.dumps(out["warm_launches"]), flush=True)

    for engine in ("lane", "sorted"):
        kernels.reset_launches()
        t = time.time()
        other = groth16.prove(pk, builder, seed=DEPOSIT_PROVE_SEED, engine=engine, device=dev)
        torch.cuda.synchronize()
        out[f"{engine}_prove_s"] = [time.time() - t]
        out[f"{engine}_launches"] = nonzero(kernels.launch_counts())
        if proof_digest(other) != DEPOSIT_DIGEST:
            fail(f"the deposit proof through engine={engine!r} differs from the reference")
        t = time.time()
        groth16.prove(pk, builder, seed=DEPOSIT_PROVE_SEED, engine=engine, device=dev)
        torch.cuda.synchronize()
        out[f"{engine}_prove_s"].append(time.time() - t)
        print(f"deposit through engine={engine!r}: digest matches; "
              f"{json.dumps([round(x, 3) for x in out[f'{engine}_prove_s']])} s; launches "
              + json.dumps(out[f"{engine}_launches"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the Pippenger MSMs (2^22 G1 through msm_sorted, the lane engine)
# ---------------------------------------------------------------------------

MSM_LOG_N = 22
MSM_BASES = 1024            # bench.py: multiples k·G, k = 1 … 1024, tiled
MSM_KERNELS = ("mod_sub", "g1_add", "g1_double")


def msm_inputs(torch, dev, group: str, n: int, seed: int):
    """(points, scalars, want): MSM_BASES multiples k·gen tiled to n points,
    seeded canonical scalars below r (0, 1, r − 1, r − 2 first), and the
    host's (Σ s_i·k_i mod r)·gen, from limb sums on the card (each < 2^48)."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.oracle import curve as ocurve
    from owshen_tpu_torch.oracle.field import P_FR

    curve, gen, encode = {"g1": (ocurve.G1, ocurve.G1_GEN, bn254.g1_encode),
                          "g2": (ocurve.G2, ocurve.G2_GEN, bn254.g2_encode)}[group]
    mults = [gen]
    for _ in range(MSM_BASES - 1):
        mults.append(curve.add(mults[-1], gen))
    base = encode(mults, device=dev)
    points = tuple(a.repeat((n // MSM_BASES,) + (1,) * (a.dim() - 1)) for a in base)
    scalars = rand_field(torch, torch.Generator().manual_seed(seed), P_FR, n, dev)
    k = torch.arange(n, device=dev) % MSM_BASES + 1
    sums = (scalars.to(torch.int64) * k[:, None]).sum(0).tolist()
    return points, scalars, curve.mul(gen, sum(v << (16 * j) for j, v in enumerate(sums)) % P_FR)


def msm_affine(group: str, pt):
    """One projective result in affine form: over G1 through to_affine on
    the card (the identity as (0, 0)), over G2 decoded on the host."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.fields.field import FQ

    if group == "g2":
        return bn254.g2_decode_host(tuple(a[None] for a in pt))
    x, y = bn254.G1.to_affine(pt)
    xy = (FQ.decode(x[None])[0], FQ.decode(y[None])[0])
    return None if xy == (0, 0) else xy


def timed(torch, fn):
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def msm_path_checks(torch, pts, scalars) -> tuple[dict, set]:
    """K1, K2 and K3 against their plain versions at every width the 2^22
    MSM launches them, on its own operands: one window's gathered y
    (mod_sub, 2^22 elements), a chunk step's (running sum, row q) (g1_add,
    C = 2^15 points), the two halves of the boundary prefixes that
    total_sum_wide folds (g1_add, 2^14), and the Horner's single points
    (g1_double, g1_add, the closing negation's mod_sub).  Fails on any
    difference; returns the errors and the (kernel, width) pairs held."""
    from owshen_tpu_torch.config import settings
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.kernels import field_ops, g1
    from owshen_tpu_torch.ops import msm as pmsm

    G1, K = bn254.G1, bn254.G1.K
    c, n = settings().msm_window_bits, scalars.shape[0]
    m, C = 1 << (c - 1), min(settings().msm_chunk_c, n // 4)
    Q = n // C
    errs, held = {}, set()

    def check(name, width, note, got, want):
        errs[f"{name} n={width}{note}"] = max_abs_err(torch, got, want)
        held.add((name, width))

    mag, sgn = pmsm._signed_digits(scalars, c)
    rows, widths, shapes = pmsm._point_rows(pts, settings().msm_gather_pad)
    w = mag.shape[0] - 2                 # the second window, with digits of both signs
    (x, y, z), neg, skeys = pmsm._gather_window(rows, widths, shapes, mag[w], sgn[w], C, Q)
    del rows
    zero = torch.zeros_like(y)
    check("mod_sub", y.shape[0], " (a window's y)", field_ops.mod_sub(zero, y, "fq"),
          field_ops.mod_sub_plain(zero, y, "fq"))
    xyz = (x, K.select(neg, K.neg(y), y), z)
    del zero, y
    seq = tuple(a.view((Q, C) + a.shape[1:]) for a in xyz)
    q = 3
    acc = tuple(a[0] for a in seq)
    for i in range(1, q):
        acc = G1.add(acc, tuple(a[i] for a in seq))
    row = tuple(a[q] for a in seq)
    check("g1_add", C, f" (chunk step {q})", g1.g1_add(acc, row), g1.g1_add_plain(acc, row))
    total, s_j = pmsm._window_prefixes(G1, xyz, skeys[None], C, Q, m)    # one window
    total, s_j = tuple(a[0] for a in total), tuple(a[:, 0] for a in s_j)
    del xyz, seq
    h = m // 2
    lo, hi = tuple(a[:h] for a in s_j), tuple(a[h:] for a in s_j)
    check("g1_add", h, " (total_sum_wide fold)", g1.g1_add(lo, hi), g1.g1_add_plain(lo, hi))
    one = tuple(a[None] for a in total)
    check("g1_double", 1, "", g1.g1_double(one), g1.g1_double_plain(one))
    dbl = G1.double(one)
    check("g1_add", 1, "", g1.g1_add(dbl, one), g1.g1_add_plain(dbl, one))
    y1 = one[1].reshape(-1, 16)
    check("mod_sub", 1, "", field_ops.mod_sub(torch.zeros_like(y1), y1, "fq"),
          field_ops.mod_sub_plain(torch.zeros_like(y1), y1, "fq"))
    print("msm 2^22 kernels against their plain versions on the path's operands, max |diff|: "
          + json.dumps(errs), flush=True)
    for case, err in errs.items():
        if err != 0:
            fail(f"msm 2^22 path ({case}): kernel disagrees with its plain version")
    return errs, held


def msm_phase(torch, dev) -> dict:
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.ops import msm as pmsm

    G1, G2 = bn254.G1, bn254.G2
    n = 1 << MSM_LOG_N
    out = {"n": n}
    (pts, scalars, want), out["inputs_s"] = timed(
        torch, lambda: msm_inputs(torch, dev, "g1", n, MSM_LOG_N))
    run = lambda: pmsm.msm(G1, pts, scalars)  # noqa: E731  (routes to msm_sorted, c = 16)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    got, out["first_s"] = timed(torch, run)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = kernels.launch_counts()
    out["widths"] = kernels.launch_widths()
    for name in MSM_KERNELS:
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched by the 2^22 MSM")
    out["affine"] = msm_affine("g1", got)
    if out["affine"] != want:
        fail("MSM 2^22: msm differs from (Σ s_i·k_i mod r)·G")
    out["path_checks"], held = msm_path_checks(torch, pts, scalars)
    # the widths of msm_sorted_many's batched windows (the gather of all
    # windows' y, the batched prefix scan, the Horner), held on the
    # operands the run gave them
    unheld = sorted({(k, int(wd)) for k in MSM_KERNELS for wd in out["widths"][k]} - held)
    with kernels.capture_operands() as kept:
        run()
    torch.cuda.synchronize()
    out["path_checks"].update(mesh_path_checks(
        torch, "2^22", {pair: kept[pair] for pair in unheld},
        {k: [wd for name, wd in unheld if name == k] for k in MSM_KERNELS}, held, phase="msm"))
    del kept
    out["s"] = [timed(torch, run)[1] for _ in range(2)]
    out["mpoints_per_s"] = [n / t / 1e6 for t in out["s"]]
    wall, busy, events = device_busy(torch, run)
    out["profiled_s"], out["busy_s"] = wall, busy
    out["split"] = spans_by_kernel(events)
    print(f"msm 2^22 (G1, msm_sorted c=16): == (Σ s_i·k_i mod r)·G; first {out['first_s']:.3f} "
          f"s, then {json.dumps([round(t, 4) for t in out['s']])} s = "
          f"{json.dumps([round(r, 2) for r in out['mpoints_per_s']])} Mpoints/s; peak "
          f"{out['peak_bytes'] / 2 ** 30:.2f} GiB; under the profiler {wall:.3f} s, device "
          f"busy {busy:.4f} s (idle {100 * (1 - busy / wall):.1f} %)", flush=True)
    print("msm 2^22 launches: " + json.dumps(nonzero(out["launches"])) + "; by width "
          "{width: [launches, items]}: "
          + json.dumps({k: out["widths"][k] for k in MSM_KERNELS}), flush=True)
    print("msm 2^22 [spans, device ms] by kernel: " + json.dumps(out["split"]), flush=True)
    del pts, scalars

    checks = {}
    for label, group, log_n, call in (
            ("g1 msm 2^16 (lane)", "g1", 16, lambda p, s: pmsm.msm(G1, p, s)),
            ("g1 msm_sorted c=8 2^16", "g1", 16, lambda p, s: pmsm.msm_sorted(G1, p, s, c=8)),
            ("g2 msm_sorted 2^12", "g2", 12, lambda p, s: pmsm.msm_sorted(G2, p, s)),
            ("g2 msm 2^10 (lane)", "g2", 10, lambda p, s: pmsm.msm(G2, p, s))):
        p, s, want = msm_inputs(torch, dev, group, 1 << log_n, log_n)
        got, first = timed(torch, lambda: call(p, s))
        if msm_affine(group, got) != want:
            fail(f"{label}: differs from (Σ s_i·k_i mod r)·gen")
        checks[label] = {"first_s": first, "s": timed(torch, lambda: call(p, s))[1]}
    out["checks"] = checks
    print("msm checks == (Σ s_i·k_i mod r)·gen, seconds: " + json.dumps(checks), flush=True)
    out["losses"] = width_losses(torch, dev, out["widths"], MSM_KERNELS, "2^22 MSM")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the NTT at 2^20 (K5 ladder and K7 fused)
# ---------------------------------------------------------------------------

def ntt_phase(torch, dev) -> dict:
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.ops.ntt import NttDomain, ntt_fused
    from owshen_tpu_torch.oracle import ntt as ontt

    log_n = 20
    gen = torch.Generator().manual_seed(20)
    x = rand_field(torch, gen, FR.p, 1 << log_n, dev)
    dom = NttDomain(log_n)
    n_inv = FR.const(dom.n_inv, device=dev)
    out = {}

    kernels.reset_launches()
    t = time.time()
    ladder = dom.ntt(x)
    torch.cuda.synchronize()
    out["ladder_first_s"] = time.time() - t
    t = time.time()
    fused = ntt_fused(x, log_n)
    torch.cuda.synchronize()
    out["fused_first_s"] = time.time() - t
    if not torch.equal(ladder, fused):
        fail("NTT 2^20: the K5 ladder and the fused K7 path differ")
    if not torch.equal(dom.intt(ladder), x):
        fail("NTT 2^20: intt(ntt(x)) != x on the K5 ladder")
    if not torch.equal(FR.mul(ntt_fused(fused, log_n, inverse=True), n_inv), x):
        fail("NTT 2^20: the fused inverse does not return the input")
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    for name in ("ntt_butterfly", "ntt_cols"):
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched on the 2^20 NTT path")
    print("ntt 2^20: ladder == fused, both inverses return the input; launches "
          + json.dumps({k: v for k, v in out["launches"].items() if v}), flush=True)

    reps = 5
    for route, fn in (("ladder", lambda: dom.ntt(x)), ("fused", lambda: ntt_fused(x, log_n))):
        fn()
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[f"{route}_s"] = (time.time() - t) / reps
        wall, busy, events = device_busy(torch, fn)
        out[f"{route}_profiled_s"], out[f"{route}_busy_s"] = wall, busy
        if busy <= 0:
            fail(f"NTT 2^20 ({route}): the profiler's timeline shows no device time")
        out[f"{route}_split"] = spans_by_kernel(events)
        print(f"ntt 2^20 {route}: {out[f'{route}_s']:.5f} s per transform; under the "
              f"profiler {wall:.5f} s, device busy {busy:.5f} s; [spans, device ms] by "
              f"kernel: " + json.dumps(out[f"{route}_split"]), flush=True)

    rng = random.Random(10)
    xs = [rng.randrange(FR.p) for _ in range(1 << 10)]
    xs[:3] = [0, 1, FR.p - 1]
    want = ontt.ntt(xs)
    small = NttDomain(10)
    if FR.decode(small.ntt(FR.encode(xs, device=dev))) != want \
            or FR.decode(ntt_fused(FR.encode(xs, device=dev), 10)) != want:
        fail("NTT 2^10: a route differs from the host oracle")
    xs = seeded_ints(NTT_DIGEST_SEED, 1 << NTT_DIGEST_LOGN, FR.p)
    dom12 = NttDomain(NTT_DIGEST_LOGN)
    for route, y in (("ladder", dom12.ntt(FR.encode(xs, device=dev))),
                     ("fused", ntt_fused(FR.encode(xs, device=dev), NTT_DIGEST_LOGN))):
        digest = values_digest(FR.decode(y))
        if digest != NTT_DIGEST:
            fail(f"NTT 2^12 ({route}): digest {digest} != JAX reference {NTT_DIGEST}")
    print("ntt 2^10 == host oracle on both routes; 2^12 digest matches", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the dense MiMC tree over 2^20 leaves (K6)
# ---------------------------------------------------------------------------

def level_times(torch, levels, reps: int) -> list[dict]:
    """Device ms of each level's K6 launch of a dense tree (CUDA events
    around the launch alone, its operands made contiguous before), the mean
    of `reps` trees, beside the level's bound."""
    from owshen_tpu_torch.kernels.mimc import mimc_hash2

    pairs = [(lvl[0::2].contiguous(), lvl[1::2].contiguous()) for lvl in levels[:-1]]
    total = [0.0] * len(pairs)
    for _ in range(reps):
        marks = []
        for left, right in pairs:
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            mimc_hash2(left, right)
            stop.record()
            marks.append((start, stop))
        torch.cuda.synchronize()
        for i, (start, stop) in enumerate(marks):
            total[i] += start.elapsed_time(stop)
    out = []
    for (left, _), t in zip(pairs, total):
        n = left.shape[0]
        b_ms, b_by = bound(n * PER_ITEM["mimc_hash2"][0], n * PER_ITEM["mimc_hash2"][1])
        out.append({"n": n, "ms": t / reps, "bound_ms": b_ms, "bound_by": b_by})
    return out


def mimc_phase(torch, dev) -> dict:
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.kernels.mimc import mimc_hash2_plain
    from owshen_tpu_torch.ops.merkle import build_levels, merkle_path, merkle_root, verify_path

    depth = 20
    gen = torch.Generator().manual_seed(21)
    leaves = rand_field(torch, gen, FR.p, 1 << depth, dev)
    out = {}

    kernels.reset_launches()
    t = time.time()
    levels = build_levels(leaves, "mimc")
    torch.cuda.synchronize()
    out["build_first_s"] = time.time() - t
    if kernels.launch_counts()["mimc_hash2"] != depth:
        fail(f"MiMC 2^20: build_levels made {kernels.launch_counts()['mimc_hash2']} K6 "
             f"launches, not one per level ({depth})")
    root = levels[-1][0]
    out["leaves"], out["root"] = leaves, FR.decode(root[None])
    idx = torch.randint(0, 1 << depth, (1024,), generator=gen).tolist()
    t = time.time()
    sibs, bits = merkle_path(levels, idx)
    ok = verify_path(leaves[idx], sibs, bits, root, "mimc")
    bad_leaf = leaves[idx].clone()
    bad_leaf[0, 0] ^= 1
    bad = verify_path(bad_leaf, sibs, bits, root, "mimc")
    torch.cuda.synchronize()
    out["paths_s"] = time.time() - t
    if not bool(ok.all()):
        fail("MiMC 2^20: a valid authentication path was rejected")
    if bool(bad[0]) or not bool(bad[1:].all()):
        fail("MiMC 2^20: the tampered leaf was accepted")
    out["launches"] = kernels.launch_counts()
    if out["launches"]["mimc_hash2"] <= 0:
        fail("kernel mimc_hash2 was not launched on the dense MiMC path")
    print(f"mimc 2^20: built in {out['build_first_s']:.4f} s, 1024 paths accepted and the "
          f"tampered leaf rejected in {out['paths_s']:.4f} s; launches "
          + json.dumps({k: v for k, v in out["launches"].items() if v}), flush=True)

    reps = 5
    t = time.time()
    for _ in range(reps):
        build_levels(leaves, "mimc")
    torch.cuda.synchronize()
    out["build_s"] = (time.time() - t) / reps
    wall, busy, _ = device_busy(torch, lambda: build_levels(leaves, "mimc"))
    out["build_profiled_s"], out["build_busy_s"] = wall, busy
    out["levels"] = level_times(torch, levels, reps)
    print("mimc 2^20 by level, [hashes, device ms, bound ms]: "
          + json.dumps([[lv["n"], round(lv["ms"], 5), round(lv["bound_ms"], 5)]
                        for lv in out["levels"]]), flush=True)
    events_ms = sum(lv["ms"] for lv in out["levels"])
    print(f"mimc 2^20 levels: {events_ms:.4f} ms in all, bound "
          f"{sum(lv['bound_ms'] for lv in out['levels']):.4f} ms; device busy in one profiled "
          f"tree {busy * 1e3:.4f} ms", flush=True)
    if abs(busy * 1e3 - events_ms) > 0.05 * events_ms:
        fail(f"MiMC 2^20: device-busy time {busy * 1e3:.4f} ms is not within 5 % of the "
             f"levels' CUDA-event times ({events_ms:.4f} ms)")

    # every level against the twins applied to the level below, in one twin
    # call over all 2^20 − 1 nodes: by induction from the leaves, the
    # kernel's root is the root the twins compute
    t = time.time()
    twin = mimc_hash2_plain(torch.cat([lvl[0::2] for lvl in levels[:-1]]),
                            torch.cat([lvl[1::2] for lvl in levels[:-1]]))
    torch.cuda.synchronize()
    out["twin_s"] = time.time() - t
    if not torch.equal(twin, torch.cat(levels[1:])):
        fail("MiMC 2^20: a level of the kernel's tree differs from the plain twins'")
    print(f"mimc 2^20: {out['build_s']:.4f} s per tree (profiled {wall:.4f} s, device busy "
          f"{busy:.4f} s); every level == the plain twins' over the level below, so the "
          f"root is theirs ({out['twin_s']:.1f} s)", flush=True)

    vals = seeded_ints(MIMC_DIGEST_SEED, MIMC_DIGEST_LEAVES, FR.p)
    digest = values_digest(FR.decode(merkle_root(FR.encode(vals, device=dev), "mimc")))
    if digest != MIMC_DIGEST:
        fail(f"MiMC 2^10 root digest {digest} != JAX reference {MIMC_DIGEST}")
    print("mimc 2^10 root digest matches", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 10: the mesh layer (parallel/), shards sharing the one card
# ---------------------------------------------------------------------------

# the kernels each mesh stage must launch: K1 (the DistNtt twiddle, the h
# pipeline, the 1/n scaling), K2, K3 and the G2 kernels (each shard's
# MSM, the partials' sum), K4 (the Poseidon trees), K5 (every shard's
# column and row transforms), K6 (the MiMC tree)
MESH_STAGE_KERNELS = {
    "prove": ("mont_mul", "mod_add", "mod_sub", "g1_add", "g1_double", "g2_add", "g2_double",
              "g1_scalar_mul", "g2_scalar_mul", "ntt_butterfly"),
    "DistNtt": ("mont_mul", "ntt_butterfly"),
    "msm_dist": MSM_KERNELS,
    "mimc root": ("mimc_hash2",),
    "poseidon root": ("poseidon_hash2",),
    "sparse tree": ("poseidon_hash2",),
    "dryrun": ("mont_mul", "g1_add", "g1_double", "g2_add", "g2_double", "poseidon_hash2",
               "ntt_butterfly"),
}
MESH_KERNELS = tuple(sorted({k for ks in MESH_STAGE_KERNELS.values() for k in ks}))
CHECK_S = {}                # seconds of each mesh (kernel, width) twin check, by pair
MESH_D = 4                  # shards of the 2^20 NTT, the 2^22 MSM and the 2^20-leaf roots
MESH_TREE_D = 8             # shards of the depth-16 sparse tree
MESH_PROVE_D = (2, 4)
DRYRUN_D = (2, 4, 8)


def copies(torch, args, dev):
    """A fresh copy of kept operands on `dev` (K5 works in place)."""
    return tuple(copies(torch, a, dev) if isinstance(a, tuple)
                 else a.to(dev, copy=True) if isinstance(a, torch.Tensor) else a for a in args)


# kernels whose every output row is a function of the same row of each
# operand, so one plain call over several launches' rows checks them all
ROW_KERNELS = ("mont_mul", "mod_add", "mod_sub", "g1_add", "g1_double", "g2_add", "g2_double",
               "jub_add", "jub_scalar_mul", "poseidon_hash2", "mimc_hash2")


def tensors_of(torch, x) -> list:
    """The tensors of a kept call's arguments (or of an output), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for a in x for t in tensors_of(torch, a)] if isinstance(x, tuple) else []


def with_tensors(torch, x, it):
    """x with its tensors replaced, in order, by those `it` yields."""
    if isinstance(x, torch.Tensor):
        return next(it)
    return tuple(with_tensors(torch, a, it) for a in x) if isinstance(x, tuple) else x


def as_rows(torch, x, tail: int):
    """x's tensors broadcast to one shape and flattened to rows of their
    last `tail` axes (2 for G2 coordinates, else the 16 limbs)."""
    ts = tensors_of(torch, x)
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return with_tensors(torch, x, iter([t.expand(shape).reshape((-1,) + shape[-tail:])
                                        for t in ts]))


def mesh_path_checks(torch, stage: str, kept: dict, widths: dict, held: set,
                     phase: str = "mesh") -> dict:
    """Every (kernel, width) that a mesh stage launched and no earlier stage
    held, held against its plain version on the operands of its first
    launch at that width in the stage (kernels.capture_operands: the shard
    blocks, the twiddle block, the lane rows, the tree levels, as the path
    gave them), and added to `held`.  Each kernel runs at its own width on
    its own operands; for a ROW_KERNELS kernel the plain version runs once
    over the rows of all its widths (with the same non-tensor arguments),
    its output split back by width (a plain call costs about the same at
    any width: PR 11 call 8, ~2.5 s a MiMC call).  Fails on any difference,
    and on a launched (kernel, width) whose operands were not kept;
    returns the errors."""
    from owshen_tpu_torch import kernels

    launched = {(k, int(w)) for k, ws in widths.items() for w in ws}
    if launched != set(kept):
        fail(f"{phase} {stage}: launched widths {sorted(launched - set(kept))} not held against "
             f"their plain versions (kept but not counted: {sorted(set(kept) - launched)})")
    dev, errs, groups = torch.device("cuda", torch.cuda.current_device()), {}, {}
    for (name, w), args in sorted(kept.items()):
        if (name, w) in held:
            continue
        t = time.time()
        got = kernels.WRAPPERS[name](*copies(torch, args, dev))
        if name in ROW_KERNELS:
            tail = 2 if name.startswith("g2") else 1
            key = (name,) + tuple(a for a in args if not isinstance(a, (tuple, torch.Tensor)))
            groups.setdefault(key, []).append(
                (f"{name} n={w}", as_rows(torch, copies(torch, args, dev), tail),
                 as_rows(torch, got, tail)))
        else:
            errs[f"{name} n={w}"] = max_abs_err(
                torch, got, kernels.PLAIN[name](*copies(torch, args, dev)))
        held.add((name, w))
        torch.cuda.synchronize()
        CHECK_S[f"{name} n={w}"] = time.time() - t
    for key, items in groups.items():
        name, t = key[0], time.time()
        n_rows = [tensors_of(torch, ops)[0].shape[0] for _, ops, _ in items]
        ops = with_tensors(torch, items[0][1], iter([
            torch.cat(col) for col in zip(*(tensors_of(torch, ops) for _, ops, _ in items))]))
        want = [t.split(n_rows) for t in tensors_of(torch, kernels.PLAIN[name](*ops))]
        for i, (case, _, got) in enumerate(items):
            errs[case] = max_abs_err(torch, tuple(tensors_of(torch, got)),
                                     tuple(w[i] for w in want))
        torch.cuda.synchronize()
        CHECK_S[f"{' '.join(map(str, key))} plain, {len(items)} widths"] = time.time() - t
    print(f"{phase} {stage}: {len(errs)} (kernel, width) pairs against their plain versions on "
          f"the stage's operands ({len(kept) - len(errs)} held by an earlier stage), max |diff|: "
          + json.dumps(dict(sorted(errs.items()))), flush=True)
    bad = sorted(case for case, err in errs.items() if err != 0)
    if bad:
        fail(f"{phase} {stage}: kernel disagrees with its plain version at {bad}")
    return errs


def mesh_stage(torch, out: dict, name: str, kind: str, fn):
    """Run one stage of the mesh path with the launch counts zeroed just
    before it and read just after, each kernel's operands kept at each
    width: its seconds (the copies of the kept operands included) and
    launches go in out, the kept operands (moved to the host, so that they
    count in no later phase's peak memory) and widths in out["kept"] for
    `mesh_checks`.  Fails if a kernel that a stage of this kind runs was
    launched no time.  The surface phase (phase 11) runs its stages here
    too, with its own kinds (`SURFACE_STAGE_KERNELS`) and label."""
    from owshen_tpu_torch import kernels

    phase = out.get("phase", "mesh")

    torch.cuda.synchronize()
    kernels.reset_launches()
    with kernels.capture_operands() as kept:
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        secs = time.time() - t
    counts, widths = kernels.launch_counts(), kernels.launch_widths()
    out["stages_s"][name] = secs
    out["launches"][name] = nonzero(counts)
    print(f"{phase} {name}: {secs:.3f} s, launches {json.dumps(out['launches'][name])}",
          flush=True)
    for k in {**MESH_STAGE_KERNELS, **SURFACE_STAGE_KERNELS}[kind]:
        if counts[k] <= 0:
            fail(f"{phase} {name}: kernel {k} was not launched")
    cpu = torch.device("cpu")
    out["kept"][name] = ({k: copies(torch, args, cpu) for k, args in kept.items()}, widths)
    return res


def mesh_checks(torch, *outs) -> None:
    """The twin checks of the mesh stages (`mesh_path_checks`), each
    launched (kernel, width) once, on the operands of the first stage that
    launched it, run after the script's last profiled measurement: their
    many small PyTorch launches made later profiler sessions lose kernel
    records (PR 11 call 4: the 2^22 MSM's and the MiMC root's
    timelines)."""
    t, held = time.time(), set()
    for out in outs:
        for name, (kept, widths) in out.pop("kept").items():
            out["path_checks"][name] = mesh_path_checks(torch, name, kept, widths, held,
                                                        out.get("phase", "mesh"))
    torch.cuda.synchronize()
    outs[0]["checks_s"] = time.time() - t
    print(f"{outs[0].get('phase', 'mesh')} twin checks: {outs[0]['checks_s']:.1f} s", flush=True)


def mesh_busy(torch, out: dict, name: str, fn) -> None:
    """The device-busy share of one more call of a mesh stage."""
    wall, busy, _ = device_busy(torch, fn)
    out["busy"][name] = {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall}
    print(f"mesh {name} under the profiler: {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} %)", flush=True)


def mesh_out() -> dict:
    return {"stages_s": {}, "launches": {}, "path_checks": {}, "busy": {}, "kept": {}}


def mesh_prove_phase(torch, dev, pool, builder, fixed) -> dict:
    """The depth-16 withdraw statement proved over make_mesh(d) on the card
    at d = 2 and 4 (the h pipeline's NTTs across the shards, every MSM
    sharded), with the seed of sorted_withdraw: each proof must equal the
    fixed engine's `fixed` point for point and verify."""
    from owshen_tpu_torch.groth16 import groth16
    from owshen_tpu_torch.parallel.mesh import make_mesh

    out = mesh_out()
    pub = builder.witness()[1:pool.pk.n_pub]
    for d in MESH_PROVE_D:
        mesh = make_mesh(d)
        proof = mesh_stage(torch, out, f"prove d={d}", "prove", lambda: groth16.prove(
            pool.pk, builder, seed=b"chip-smoke-d16-sorted", mesh=mesh, device=dev))
        if (proof.a, proof.b, proof.c) != (fixed.a, fixed.b, fixed.c):
            fail(f"mesh prove at d={d}: the proof differs from the fixed engine's")
        if not groth16.verify(pool.vk, pub, proof):
            fail(f"mesh prove at d={d}: the proof does not verify")
    print(f"mesh prove (depth 16) at d={list(MESH_PROVE_D)} == the fixed engine's proof, "
          "verified", flush=True)
    mesh_busy(torch, out, f"prove d={MESH_PROVE_D[0]}", lambda: groth16.prove(
        pool.pk, builder, seed=b"chip-smoke-d16-sorted", mesh=make_mesh(MESH_PROVE_D[0]),
        device=dev))
    return out


def mesh_phase(torch, dev, msm_affine_want, mimc_leaves, mimc_root, entries, d16_root,
               smi: str) -> dict:
    """DistNtt 2^20, msm_dist 2^22, the MiMC and Poseidon roots over 2^20
    leaves at d = 4, the depth-16 sparse tree at d = 8 and the dry run at
    d = 2, 4 and 8, each bit for bit against the single-device result."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.fields.field import FR
    from owshen_tpu_torch.ops.merkle import merkle_root
    from owshen_tpu_torch.ops.ntt import NttDomain
    from owshen_tpu_torch.parallel.merkle_dist import DistSparseMerkleTree, merkle_root_dist
    from owshen_tpu_torch.parallel.mesh import make_mesh
    from owshen_tpu_torch.parallel.msm_dist import msm_dist
    from owshen_tpu_torch.parallel.ntt_dist import DistNtt
    from owshen_tpu_torch.runtime import dryrun

    out = mesh_out()
    # the single-device results
    x = rand_field(torch, torch.Generator().manual_seed(20), FR.p, 1 << 20, dev)
    dom = NttDomain(20)
    want_fwd = dom.ntt(x)
    want_inv = dom.intt(x)
    pts, scalars, _ = msm_inputs(torch, dev, "g1", 1 << MSM_LOG_N, MSM_LOG_N)
    want_pos = merkle_root(mimc_leaves, "poseidon")
    idx = sorted(entries)
    half = len(idx) // 2

    mesh = make_mesh(MESH_D)
    dn = DistNtt(mesh, 20)
    fwd = mesh_stage(torch, out, f"DistNtt 2^20 forward d={MESH_D}", "DistNtt",
                     lambda: dn.ntt(x))
    inv = mesh_stage(torch, out, f"DistNtt 2^20 inverse d={MESH_D}", "DistNtt",
                     lambda: dn.intt(x))
    if not (torch.equal(fwd, want_fwd) and torch.equal(inv, want_inv)):
        fail(f"DistNtt 2^20 at d={MESH_D} differs from NttDomain(20).ntt / intt")
    got = mesh_stage(torch, out, f"msm_dist 2^22 d={MESH_D}", "msm_dist",
                     lambda: msm_dist(mesh, bn254.G1, pts, scalars))
    if msm_affine("g1", got) != msm_affine_want:
        fail(f"msm_dist 2^22 at d={MESH_D} differs from ops.msm.msm's point")
    mimc = mesh_stage(torch, out, f"merkle_root_dist mimc 2^20 d={MESH_D}", "mimc root",
                      lambda: merkle_root_dist(mesh, mimc_leaves, "mimc"))
    pos = mesh_stage(torch, out, f"merkle_root_dist poseidon 2^20 d={MESH_D}", "poseidon root",
                     lambda: merkle_root_dist(mesh, mimc_leaves, "poseidon"))
    if FR.decode(mimc[None]) != mimc_root or not torch.equal(pos, want_pos):
        fail(f"merkle_root_dist over 2^20 leaves at d={MESH_D} differs from the single-device root")
    tree = DistSparseMerkleTree(make_mesh(MESH_TREE_D), 16)
    for i, part in enumerate((idx[:half], idx[half:])):
        root = mesh_stage(torch, out, f"DistSparseMerkleTree d16 d={MESH_TREE_D} batch {i + 1}",
                          "sparse tree",
                          lambda: tree.insert_ints(part, [entries[j] for j in part]))
    if FR.decode(root[None])[0] != d16_root or tree.root_int() != d16_root:
        fail(f"DistSparseMerkleTree(16) at d={MESH_TREE_D} differs from the depth-16 pool's root")
    try:
        tree.insert_ints([idx[0], idx[0]], [1, 2])
    except ValueError as err:
        print(f"mesh DistSparseMerkleTree: duplicate index rejected ({err})", flush=True)
    else:
        fail("DistSparseMerkleTree accepted a duplicate index")
    for d in DRYRUN_D[:-1]:
        mesh_stage(torch, out, f"dryrun.run({d})", "dryrun", lambda: dryrun.run(d))
    # the last in a clean interpreter, as __graft_entry__.py runs the reference's:
    # its launches are the child's, not counted here, and its checks its own
    t = time.time()
    dryrun.run_subprocess(DRYRUN_D[-1])
    out["stages_s"][f"dryrun.run_subprocess({DRYRUN_D[-1]})"] = time.time() - t
    print("mesh: DistNtt, msm_dist, both dist roots, the sharded tree and the dry runs equal "
          "their single-device results", flush=True)
    mesh_busy(torch, out, f"DistNtt 2^20 forward d={MESH_D}", lambda: dn.ntt(x))
    mesh_busy(torch, out, f"msm_dist 2^22 d={MESH_D}", lambda: msm_dist(mesh, bn254.G1, pts, scalars))
    mesh_busy(torch, out, f"merkle_root_dist mimc 2^20 d={MESH_D}",
              lambda: merkle_root_dist(mesh, mimc_leaves, "mimc"))
    print(f"mesh stages on {smi}, seconds (shards share the one card: correctness runs, no "
          "scaling): " + json.dumps({k: round(v, 4) for k, v in out["stages_s"].items()}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the rest of the fields and curves surface, at the main path's widths
# ---------------------------------------------------------------------------

SURFACE_FQ2_N = 1 << 18     # the prover's G2 fold's top level
SURFACE_G2_N = 8192         # the fixed-table build's width
SURFACE_INV_N = 1 << 20
SURFACE_INV_SLICE = 4096    # rows of batch_inv held whole against Field.inv
SURFACE_CHECKED = 64        # seeded rows held against the host oracle
SURFACE_COSET_LOGN = 13     # the depth-16 withdraw circuit's domain
# the K1 wrappers each stage must launch
SURFACE_STAGE_KERNELS = {
    "add": ("mod_add",), "sub": ("mod_sub",), "neg": ("mod_sub",),
    "mul": ("mont_mul", "mod_add", "mod_sub"), "sqr": ("mont_mul", "mod_add", "mod_sub"),
    "mul_const": ("mont_mul", "mod_add", "mod_sub"), "mul_base": ("mont_mul",),
    "inv": ("mont_mul", "mod_add", "mod_sub"), "to_affine": ("mont_mul", "mod_add", "mod_sub"),
    "eq": ("mont_mul",), "on_curve": ("mont_mul", "mod_add"), "batch_inv": ("mont_mul",),
    "tables": ("mont_mul",),
}


def seeded_rows(n: int, seed: int) -> list[int]:
    """SURFACE_CHECKED row indices below n: the first eight and seeded others."""
    rng = random.Random(seed)
    return sorted(set(range(8)) | set(rng.sample(range(8, n), SURFACE_CHECKED - 8)))


def seeded_mask(torch, n: int, seed: int, one_in: int, dev):
    """bool[n], about one row in `one_in` true (seeded)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, one_in, (n,), generator=gen) == 0).to(dev)


def surface_phase(torch, dev, smi: str) -> dict:
    """Every Fq2 op at 2^18 elements; G2 to_affine, is_identity and eq over
    8192 points (identities and scaled copies (λX, λY, λZ) among them); G1
    on_curve_affine over the 2^22 affine points of the MSM phase with a
    seeded eighth tampered (y + 1); batch_inv over 2^20 Fr with seeded
    zeros; NttDomain(13, device).coset_pows against the prover's table.
    Each op is a stage of its own (launch counts zeroed before, read
    after, every K1 operand kept at each width for `mesh_checks`); each
    result is held on SURFACE_CHECKED seeded rows against the host oracle,
    batch_inv whole against Field.inv on a SURFACE_INV_SLICE-row slice."""
    from owshen_tpu_torch.curves import bn254
    from owshen_tpu_torch.fields.field import FQ, FR
    from owshen_tpu_torch.fields.fq2 import FQ2
    from owshen_tpu_torch.groth16 import groth16
    from owshen_tpu_torch.ops.ntt import NttDomain
    from owshen_tpu_torch.oracle import curve as ocurve

    out = {**mesh_out(), "phase": "surface"}
    f2 = ocurve.FQ2I
    q = FQ.p

    def stage(name, kind, fn):
        return mesh_stage(torch, out, name, kind, fn)

    def host_fq2(t, rows):
        return FQ2.decode(t[rows])

    # --- Fq2 at 2^18 -----------------------------------------------------
    n = SURFACE_FQ2_N
    gen = torch.Generator().manual_seed(0x5F2)
    a = rand_field(torch, gen, q, 2 * n, dev).view(n, 2, 16)
    b = rand_field(torch, gen, q, 2 * n, dev).view(n, 2, 16).flip(0).contiguous()
    a[2] = 0                                     # inv(0) = 0
    base = rand_field(torch, gen, q, n, dev)
    rng = random.Random(0x5F2)
    const = (rng.randrange(q), rng.randrange(q))
    rows = seeded_rows(n, 0x5F2)
    ha, hb = host_fq2(a, rows), host_fq2(b, rows)
    hbase = FQ.decode(base[rows])
    fq2_ops = {
        "add": (lambda: FQ2.add(a, b), lambda x, y, _: f2.add(x, y)),
        "sub": (lambda: FQ2.sub(a, b), lambda x, y, _: f2.sub(x, y)),
        "neg": (lambda: FQ2.neg(a), lambda x, y, _: f2.neg(x)),
        "mul": (lambda: FQ2.mul(a, b), lambda x, y, _: f2.mul(x, y)),
        "sqr": (lambda: FQ2.sqr(a), lambda x, y, _: f2.mul(x, x)),
        "mul_const": (lambda: FQ2.mul_const(a, const), lambda x, y, _: f2.mul(x, const)),
        "mul_base": (lambda: FQ2.mul_base(a, base), lambda x, y, c: f2.mul(x, (c, 0))),
        "inv": (lambda: FQ2.inv(a), lambda x, y, _: (0, 0) if x == (0, 0) else f2.inv(x)),
    }
    for op, (run, want) in fq2_ops.items():
        got = host_fq2(stage(f"Fq2 {op} {n}", op, run), rows)
        if got != [want(x, y, c) for x, y, c in zip(ha, hb, hbase)]:
            fail(f"surface: Fq2 {op} over {n} elements differs from the host oracle")
    del a, b, base

    # --- G2 over 8192 points -----------------------------------------------
    n = SURFACE_G2_N
    pts, _, _ = msm_inputs(torch, dev, "g2", n, 0x6A2)          # k·G2, Z = 1, tiled
    host = [ocurve.G2_GEN]
    for _ in range(MSM_BASES - 1):
        host.append(ocurve.G2.add(host[-1], ocurve.G2_GEN))
    gen = torch.Generator().manual_seed(0x6A2)
    lam, mu = (FQ.encode([int(v) for v in torch.randint(1, 1 << 62, (n,), generator=gen)],
                         device=dev) for _ in range(2))
    id_p, id_q = (seeded_mask(torch, n, s, 16, dev) for s in (0x6A3, 0x6A4))
    differ = seeded_mask(torch, n, 0x6A5, 8, dev)
    zero = torch.zeros_like(pts[0])

    def scaled(coords, by, ident):
        """(λX, λY, λZ), with (0 : λY : 0) on the identity rows"""
        x, y, z = (FQ2.mul_base(c, by) for c in coords)
        return (FQ2.select(ident, zero, x), y, FQ2.select(ident, zero, z))

    p = scaled(pts, lam, id_p)
    other = tuple(c.roll(1, 0) for c in pts)                     # (k − 1)·G2 beside k·G2
    q2 = scaled(tuple(FQ2.select(differ, o, c) for o, c in zip(other, pts)), mu, id_q)
    ident = bn254.G2.is_identity(p)             # a compare: no launch
    if not torch.equal(ident, id_p):
        fail("surface: G2 is_identity differs from the identity rows")
    eq = stage(f"G2 eq {n}", "eq", lambda: bn254.G2.eq(p, q2))
    if not torch.equal(eq, (id_p & id_q) | (~id_p & ~id_q & ~differ)):
        fail("surface: G2 eq differs from the scaled copies' pattern")
    ax, ay = stage(f"G2 to_affine {n}", "to_affine", lambda: bn254.G2.to_affine(p))
    keep = ~id_p[:, None, None]
    if not (torch.equal(ax, torch.where(keep, pts[0], zero))
            and torch.equal(ay, torch.where(keep, pts[1], zero))):
        fail("surface: G2 to_affine differs from the points' affine coordinates")
    rows = seeded_rows(n, 0x6A2)
    got = list(zip(host_fq2(ax, rows), host_fq2(ay, rows)))
    idh = id_p.cpu()
    if got != [((0, 0), (0, 0)) if idh[i] else host[i % MSM_BASES] for i in rows]:
        fail("surface: G2 to_affine differs from the host oracle")
    del p, q2, other, pts, zero, ax, ay

    # --- G1 on_curve_affine over the 2^22 points of the MSM phase ------------
    n = 1 << MSM_LOG_N
    pts, _, _ = msm_inputs(torch, dev, "g1", n, MSM_LOG_N)
    bad = seeded_mask(torch, n, 0x0C1, 8, dev)
    x = pts[0]
    y = torch.where(bad[:, None], FQ.add(pts[1], FQ.one_like(pts[1])), pts[1])
    del pts
    on = stage(f"G1 on_curve_affine {n}", "on_curve", lambda: bn254.G1.on_curve_affine(x, y))
    if not torch.equal(on, ~bad):
        fail("surface: G1 on_curve_affine is not false on exactly the tampered rows")
    rows = seeded_rows(n, 0x0C1)
    hx, hy = FQ.decode(x[rows]), FQ.decode(y[rows])
    if on[rows].tolist() != [ocurve.G1.on_curve((u, v)) for u, v in zip(hx, hy)]:
        fail("surface: G1 on_curve_affine differs from the host oracle")
    out["on_curve_false"] = int((~on).sum())
    del x, y, on, bad

    # --- batch_inv over 2^20 Fr --------------------------------------------
    n = SURFACE_INV_N
    x = rand_field(torch, torch.Generator().manual_seed(0x1B7), FR.p, n, dev)
    zeros = seeded_mask(torch, n, 0x1B8, 16, dev)
    x[zeros] = 0
    inv = stage(f"batch_inv {n}", "batch_inv", lambda: FR.batch_inv(x))
    rows = seeded_rows(n, 0x1B7)
    if FR.decode(inv[rows]) != [pow(v, -1, FR.p) if v else 0 for v in FR.decode(x[rows])]:
        fail("surface: batch_inv differs from the host oracle")
    whole = FR.inv(x[:SURFACE_INV_SLICE])
    if not torch.equal(inv[:SURFACE_INV_SLICE], whole):
        fail(f"surface: batch_inv differs from Field.inv on {SURFACE_INV_SLICE} rows")
    if not bool((inv[zeros] == 0).all()):
        fail("surface: batch_inv of a zero is not zero")
    del x, inv, whole

    # --- the NTT domain's tables ---------------------------------------------
    dom = NttDomain(SURFACE_COSET_LOGN, device=dev)
    coset = stage(f"NttDomain({SURFACE_COSET_LOGN}).coset_pows", "tables", lambda: dom.coset_pows)
    if not torch.equal(coset, groth16._domain(SURFACE_COSET_LOGN)._table("coset", dev)):
        fail("surface: NttDomain.coset_pows differs from the prover's coset table")
    hc = FR.decode(coset[seeded_rows(1 << SURFACE_COSET_LOGN, 0x7AB)])
    if hc != [pow(dom.coset_gen, i, FR.p) for i in seeded_rows(1 << SURFACE_COSET_LOGN, 0x7AB)]:
        fail("surface: NttDomain.coset_pows differs from the host powers")

    print(f"surface on {smi}: every result equal to the host oracle on its seeded rows; seconds "
          + json.dumps({k: round(v, 4) for k, v in out["stages_s"].items()}), flush=True)
    return out


def main() -> int:
    # keep CUPTI set up between profiler sessions (Kineto tears it down
    # after each by default): the timeline checks were verified this way
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 1
    import owshen_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    kern = check_kernels(torch, dev)
    trip = round_trip_depth16(torch, dev)
    losses = width_losses(torch, dev, trip["widths"])
    pool, builder, entries = trip.pop("pool"), trip.pop("builder"), trip.pop("entries")
    withdraw_sorted, fixed = sorted_withdraw(torch, dev, pool, builder)
    mesh_prove = mesh_prove_phase(torch, dev, pool, builder, fixed)
    vouchers = voucher_phase(torch, dev, pool, dict(entries))   # it adds its deposits
    del pool, builder           # its 5.4 GB of tables would count in the MSM's peak

    t = time.time()
    digest = depth2_digest(dev)
    print(f"d2 digest {digest} ({time.time() - t:.2f} s)", flush=True)
    if digest != DEPTH2_DIGEST:
        fail(f"depth-2 proof digest {digest} != JAX reference {DEPTH2_DIGEST}")
    deposit = deposit_phase(torch, dev)
    msmp = msm_phase(torch, dev)
    nttp = ntt_phase(torch, dev)
    mimcp = mimc_phase(torch, dev)
    meshp = mesh_phase(torch, dev, msmp.pop("affine"), mimcp.pop("leaves"), mimcp.pop("root"),
                       entries, trip.pop("root"), smi)
    t = time.time()
    surface = surface_phase(torch, dev, smi)
    surface["s"] = time.time() - t
    mesh_checks(torch, mesh_prove, meshp)
    mesh_checks(torch, surface)         # its own (kernel, width) pairs, on its operands
    voucher_capture = vouchers.pop("capture")
    mesh_checks(torch, voucher_capture)     # the voucher phase's, on its operands
    surface_launches = {k: sum(c.get(k, 0) for c in surface["launches"].values())
                        for k in KERNELS}
    print(f"surface: {surface['s']:.1f} s before its twin checks; launches by op "
          + json.dumps(surface["launches"]) + f" on {smi}", flush=True)
    mesh_by_stage = {**mesh_prove["launches"], **meshp["launches"]}
    mesh_launches = {k: sum(c.get(k, 0) for c in mesh_by_stage.values()) for k in KERNELS}
    for name in MESH_KERNELS:
        if mesh_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the mesh path")

    # each kernel's launches on the path it belongs to: K1–K5 (and K1's G2
    # add and double) on the depth-16 round trip, K7 on the 2^20 NTT, K6 on
    # the 2^20-leaf tree, K1's BabyJubJub add and ladder on the voucher phase
    launches = dict(trip["launches"])
    launches["ntt_cols"] = nttp["launches"]["ntt_cols"]
    launches["mimc_hash2"] = mimcp["launches"]["mimc_hash2"]
    for name in ("jub_add", "jub_scalar_mul"):      # their path: the voucher phase
        launches[name] = vouchers["launches"][name]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern[name]["max_abs_err"],
         "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
         "library_ms": None, "n": kern[name]["n"], "call_ms": kern[name]["call_ms"]}
        for name, (src, rep) in KERNELS.items()],
        "stages_s": trip["stages"], "launches_by_stage": trip["launches_by_stage"],
        "launch_widths_depth16": {k: trip["widths"][k] for k in WIDTH_KERNELS},
        "width_losses": losses, "ptxas": kern["ptxas"],
        "k1_n1_ms": {k: kern[k]["n1_ms"] for k in ("mont_mul", "mod_add")},
        "poseidon_hash2_n1_ms": kern["poseidon_hash2"]["n1_ms"],
        "kernel_checks": {k: {f: kern[k][f] for f in ("cases", "sass")}
                          for k in ("g1_add", "g2_add", "poseidon_hash2")},
        "g2_double_cases": kern["g2_double"]["cases"],
        "ladder_checks": {k: {f: kern[k][f] for f in ("cases", "ms_by_n", "bound_by_n",
                                                      "twin_wide_s")}
                          for k in LADDER_PATH_NS},
        "jub_checks": {k: {f: kern[k][f] for f in ("cases", "sign_n_ms", "twin_wide_s")}
                       for k in ("jub_add", "jub_scalar_mul")},
        "jub_add_n1_ms": kern["jub_add"]["n1_ms"],
        "voucher_twin_checks": voucher_capture["path_checks"],
        "g1_double_checks": {k: kern["g1_double"][k]
                             for k in ("cases", "ms_by_n", "n2_18")},
        "ntt_cols_checks": {k: kern["ntt_cols"][k] for k in ("cases", "shared_ops")},
        "g2_2_18": {k: kern[k]["n2_18"] for k in ("g2_add", "g2_double")},
        "ntt_2_20": {k: v for k, v in nttp.items() if k != "launches"},
        "mimc_hash2_checks": {k: kern["mimc_hash2"][k] for k in ("cases", "sass")},
        "mimc_2_20": {k: v for k, v in mimcp.items() if k != "launches"},
        "deposit": {k: v for k, v in deposit.items() if k != "launches"},
        "msm_2_22": {k: v for k, v in msmp.items() if k not in ("launches", "widths")},
        "msm_2_22_widths": {k: msmp["widths"][k] for k in MSM_KERNELS},
        "withdraw_d16_sorted": withdraw_sorted,
        "vouchers": {k: v for k, v in vouchers.items() if k != "launches"},
        "mesh": {**{k: {**mesh_prove[k], **meshp[k]} for k in mesh_out() if k != "kept"},
                 "checks_s": mesh_prove["checks_s"], "checks_s_by_pair": CHECK_S},
        "surface": {k: surface[k] for k in ("s", "stages_s", "launches", "path_checks",
                                            "checks_s", "on_curve_false")},
        "profiler_spin_loss": SPIN_LOSS,
        "launches_by_phase": {"depth16": trip["launches"], "deposit": deposit["launches"],
                              "msm_2_22": msmp["launches"], "ntt_2_20": nttp["launches"],
                              "mimc_2_20": mimcp["launches"], "vouchers": vouchers["launches"],
                              "mesh": mesh_launches, "surface": surface_launches},
        "card": smi, "total_s": time.time() - t_start}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
