"""Port vs reference: K5 (one DIT stage of the NTT), K7 (the fused column
NTT, with its Bailey recursion and the NttDomain route to it), the K5 stage
ladder at 2^16, and the NTT and dense-MiMC digests that chip_smoke.py
checks on the card (the card has no JAX, so the constants are tied to the
JAX package here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.ops.merkle import HASH2_ORACLE
from owshen_tpu.oracle import ntt as jontt
from owshen_tpu.pallas import ntt_kernels
from owshen_tpu_torch import config
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.kernels import ntt as kntt
from owshen_tpu_torch.ops import ntt as pntt
from owshen_tpu_torch.oracle import ntt as ontt

torch.set_num_threads(1)

P = FR.p


def rand_ints(rng, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[:3] = [0, 1, P - 1]
    return vals


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def test_butterfly_stage_matches_pallas():
    """The last stage of a 256-point transform is 128 butterflies whose
    twiddle j is table row j: K5's twin meets butterfly_pallas row for row,
    edge values in a, b and w included."""
    rng = np.random.default_rng(50)
    a, b, w = rand_ints(rng, 128), rand_ints(rng, 128)[::-1], rand_ints(rng, 128)
    b[:3] = [P - 1, 0, P - 1]
    x = FR.encode(a + b)
    assert kntt.butterfly_stage(x, FR.encode(w), 8) is x
    lo, hi = ntt_kernels.butterfly_pallas(*(jnp.asarray(JFR.encode(v)) for v in (a, b, w)),
                                          block_t=128)
    assert same(x[:128], lo)
    assert same(x[128:], hi)


@pytest.mark.parametrize("log_n,max_logn", [(6, pntt.FUSED_MAX_LOGN), (9, 3)],
                         ids=["one-level", "two-levels"])
def test_ntt_fused_matches_pallas(monkeypatch, log_n, max_logn):
    """ntt_fused on the K7 and K1 twins against ntt_pallas in interpret
    mode; at 2^9 both cap the fused column at 2^3, so both recurse two
    levels.  At 2^6 also the inverse, and NttDomain's route to the fused
    path when OWSHEN_NTT_PALLAS_MIN_LOGN asks for it."""
    rng = np.random.default_rng(51 + log_n)
    xs = rand_ints(rng, 1 << log_n)
    monkeypatch.setattr(pntt, "FUSED_MAX_LOGN", max_logn)
    monkeypatch.setattr(ntt_kernels, "MAX_FUSED_LOGN", min(max_logn, ntt_kernels.MAX_FUSED_LOGN))
    got = pntt.ntt_fused(FR.encode(xs), log_n)
    assert same(got, ntt_kernels.ntt_pallas(jnp.asarray(JFR.encode(xs)), log_n))
    if log_n != 6:
        return
    back = pntt.ntt_fused(got, log_n, inverse=True)
    jgot = jnp.asarray(got.numpy().astype(np.uint32))
    assert same(back, ntt_kernels.ntt_pallas(jgot, log_n, inverse=True))
    monkeypatch.setenv("OWSHEN_NTT_PALLAS_MIN_LOGN", str(log_n))
    config.settings.cache_clear()
    try:
        dom = pntt.NttDomain(log_n)
        assert dom._fused_ok(got)
        assert torch.equal(dom.ntt(FR.encode(xs)), got)
        assert FR.decode(dom.intt(got)) == xs
    finally:
        config.settings.cache_clear()


def test_ntt_ladder_matches_oracle():
    """NttDomain at 2^16, one K5 stage after another, against the port's
    copy of the NTT oracle, forward and inverse."""
    rng = np.random.default_rng(52)
    xs = rand_ints(rng, 1 << 16)
    dom = pntt.NttDomain(16)
    evals = dom.ntt(FR.encode(xs))
    assert FR.decode(evals) == ontt.ntt(xs)
    assert FR.decode(dom.intt(evals)) == xs


def test_chip_smoke_digests():
    """The constants chip_smoke.py holds the card's 2^12 NTT and 2^10-leaf
    MiMC root against, from the JAX package's oracles, and the port's
    stage ladder on the same input."""
    xs = chip_smoke.seeded_ints(chip_smoke.NTT_DIGEST_SEED, 1 << chip_smoke.NTT_DIGEST_LOGN, P)
    want = jontt.ntt(xs)
    assert chip_smoke.values_digest(want) == chip_smoke.NTT_DIGEST
    assert FR.decode(pntt.NttDomain(chip_smoke.NTT_DIGEST_LOGN).ntt(FR.encode(xs))) == want
    level = chip_smoke.seeded_ints(chip_smoke.MIMC_DIGEST_SEED, chip_smoke.MIMC_DIGEST_LEAVES, P)
    while len(level) > 1:
        level = [HASH2_ORACLE["mimc"](level[i], level[i + 1]) for i in range(0, len(level), 2)]
    assert chip_smoke.values_digest(level) == chip_smoke.MIMC_DIGEST
