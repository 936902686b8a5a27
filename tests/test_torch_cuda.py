"""The port's kernels on the card: each against its plain twin on the same
inputs; msm_sorted over G1 and G2 at 2^12 points against the host's linear
combination; the depth-2 and deposit proofs against the digests the JAX
package gives (chip_smoke.DEPTH2_DIGEST and DEPOSIT_DIGEST, asserted in
tests/test_torch_pool.py and tests/test_torch_deposit.py).

Every test needs a CUDA device and skips without one: a CUDA kernel has no
CPU mode.  This file imports no JAX, so it runs on a GPU machine that has
none:  python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.fields.field import FQ, FR
from owshen_tpu_torch.kernels import field_ops, g1, g2, mimc, ntt, poseidon
from owshen_tpu_torch.ops.msm import msm_sorted
from owshen_tpu_torch.ops.ntt import NttDomain, col_twiddles, ntt_fused
from owshen_tpu_torch.oracle import curve as ocurve

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def rand_ints(rng, p, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


def test_k1_matches_plain(card):
    rng = np.random.default_rng(61)
    for F in (FR, FQ):
        a = F.encode(rand_ints(rng, F.p, 1000), device=card)
        b = F.encode(rand_ints(rng, F.p, 1000)[::-1], device=card)
        for kernel, plain in ((field_ops.mont_mul, field_ops.mont_mul_plain),
                              (field_ops.mod_add, field_ops.mod_add_plain),
                              (field_ops.mod_sub, field_ops.mod_sub_plain)):
            assert torch.equal(kernel(a, b, F.name), plain(a, b, F.name))
            assert torch.equal(kernel(a, b[7], F.name), plain(a, b[7], F.name))


def check_msm_sorted(card, group, curve):
    """msm_sorted (c = 16) over 2^12 tiled multiples of the generator ==
    (Σ s_i·k_i mod r)·gen, compared in affine form."""
    pts, scalars, want = chip_smoke.msm_inputs(torch, card, group, 1 << 12, 12)
    assert chip_smoke.msm_affine(group, msm_sorted(curve, pts, scalars)) == want


def test_g2_kernels_match_plain(card):
    """K1's G2 add and double against their twins at 1, 65 and 8192 points,
    chip_smoke.edge_pairs (O + O, P + O, O + Q, P + P, P + (−P)) first; and
    the G2 msm_sorted that runs on them."""
    n = 8192
    tp, tq, want, want_dbl = chip_smoke.edge_points(torch, torch.Generator().manual_seed(65),
                                                    n, card, "g2")
    assert bn254.g2_decode_many(tuple(c[:64] for c in g2.g2_add(tp, tq))) == want
    assert bn254.g2_decode_many(tuple(c[:64] for c in g2.g2_double(tp))) == want_dbl
    for m in (1, 65, n):
        p, q = tuple(c[:m] for c in tp), tuple(c[:m] for c in tq)
        for x, y in zip(g2.g2_add(p, q), g2.g2_add_plain(p, q)):
            assert torch.equal(x, y)
        for x, y in zip(g2.g2_double(p), g2.g2_double_plain(p)):
            assert torch.equal(x, y)
    check_msm_sorted(card, "g2", bn254.G2)


def test_k2_k3_match_plain(card):
    rng = np.random.default_rng(62)
    ps = [ocurve.G1.mul(ocurve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 300)]
    qs = ps[1:] + ps[:1]
    ps[0] = qs[0] = None                         # O + O
    qs[1] = ps[1]                                # P + P
    qs[2] = (ps[2][0], (-ps[2][1]) % FQ.p)       # P + (−P)
    tp, tq = bn254.g1_encode(ps, device=card), bn254.g1_encode(qs, device=card)
    got = g1.g1_add(tp, tq)
    twin = g1.g1_add_plain(tp, tq)
    for x, y in zip(got, twin):
        assert torch.equal(x, y)
    assert bn254.g1_decode_many(got) == [ocurve.G1.add(p, q) for p, q in zip(ps, qs)]
    for n in (1, 31, 129):                       # partial blocks
        head = lambda pt: tuple(c[:n] for c in pt)  # noqa: E731
        for x, y in zip(g1.g1_add(head(tp), head(tq)), head(twin)):
            assert torch.equal(x, y)
    dbl = g1.g1_double_plain(tp)
    for x, y in zip(g1.g1_double(tp), dbl):
        assert torch.equal(x, y)
    for n in (1, 3, 5, 65):                      # K3's four lanes: ragged N
        head = lambda pt: tuple(c[:n] for c in pt)  # noqa: E731
        for x, y in zip(g1.g1_double(head(tp)), head(dbl)):
            assert torch.equal(x, y)
    check_msm_sorted(card, "g1", bn254.G1)


def test_k4_matches_plain(card):
    rng = np.random.default_rng(63)
    a = FR.encode(rand_ints(rng, FR.p, 4097), device=card)
    b = FR.encode(rand_ints(rng, FR.p, 4097)[::-1], device=card)
    b[:4] = a[:4]                                # (0, 0), (1, 1), (p − 1, p − 1), ...
    twin = poseidon.poseidon_hash2_plain(a, b)
    for n in (1, 31, 4095, 4096, 4097):          # the kernel's tails and the deposit's width
        assert torch.equal(poseidon.poseidon_hash2(a[:n], b[:n]), twin[:n])


def test_k5_k6_k7_match_plain(card):
    rng = np.random.default_rng(64)
    x = FR.encode(rand_ints(rng, FR.p, 1024), device=card).view(256, 4, 16)
    pows = NttDomain(8)._table("pows", card)
    for s in range(1, 9):                        # every stage, batch of 4 columns
        assert torch.equal(ntt.butterfly_stage(x.clone(), pows, s),
                           ntt.butterfly_stage_plain(x.clone(), pows, s))
    a = FR.encode(rand_ints(rng, FR.p, 300), device=card)
    b = FR.encode(rand_ints(rng, FR.p, 300)[::-1], device=card)
    assert torch.equal(mimc.mimc_hash2(a, b), mimc.mimc_hash2_plain(a, b))
    for n in (1, 33):                            # a partial block, a single hash
        assert torch.equal(mimc.mimc_hash2(a[:n], b[-n:]), mimc.mimc_hash2_plain(a[:n], b[-n:]))
    edges = [0, 1, FR.p - 1]                     # every pair, and left == right
    same = rand_ints(rng, FR.p, 8)[2:]           # p − 1, p − 2 and four random
    el = FR.encode([x for x in edges for _ in edges] + same, device=card)
    er = FR.encode(edges * 3 + same, device=card)
    assert torch.equal(mimc.mimc_hash2(el, er), mimc.mimc_hash2_plain(el, er))
    for inverse in (False, True):
        tw = col_twiddles(8, inverse, card)
        assert torch.equal(ntt.ntt_cols(x, tw), ntt.ntt_cols_plain(x, tw))
    for log_n1 in (1, 2, 12):                    # one pass at R = n1; the largest column
        z = FR.encode(rand_ints(rng, FR.p, 3 << log_n1), device=card).view(1 << log_n1, 3, 16)
        for inverse in (False, True):
            tw = col_twiddles(log_n1, inverse, card)
            for cols in (1, 3):
                assert torch.equal(ntt.ntt_cols(z[:, :cols], tw),
                                   ntt.ntt_cols_plain(z[:, :cols], tw))
    y = FR.encode(rand_ints(rng, FR.p, 1 << 12), device=card)
    assert torch.equal(ntt_fused(y, 12), NttDomain(12).ntt(y))


def test_depth2_proof_on_card_matches_reference(card):
    assert chip_smoke.depth2_digest(card) == chip_smoke.DEPTH2_DIGEST
    assert chip_smoke.deposit_digest(card) == chip_smoke.DEPOSIT_DIGEST
