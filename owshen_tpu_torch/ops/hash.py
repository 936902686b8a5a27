"""MiMC7 and Poseidon over BN254 Fr on tensors (Montgomery int32[..., 16]).

The Merkle node hashes are one kernel launch each: `poseidon_hash2`
(circomlib Poseidon t = 3) is K4 (kernels/poseidon.py), `mimc_hash2`
(circomlib MultiMiMC7 with key 0) is K6 (kernels/mimc.py).  `poseidon`
takes 1..16 inputs; the t = 3 case rides K4, other widths compose the
permutation from K1 launches.  `mimc7` and `mimc7_multi` take any key and
compose their rounds from K1 launches."""

from __future__ import annotations

import functools

import torch

from ..fields.field import FR
from ..kernels.mimc import mimc_hash2 as _mimc_hash2_kernel
from ..kernels.poseidon import poseidon_hash2 as _poseidon_hash2_kernel
from .constants import POSEIDON_RF, POSEIDON_RP, mimc7_constants, poseidon_params


# ---------------------------------------------------------------------------
# MiMC7
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mimc_consts_mont() -> torch.Tensor:
    """The 91 round constants as int32[91, 16] Montgomery limbs."""
    return FR.encode(list(mimc7_constants()))


def _pow7(x):
    x2 = FR.sqr(x)
    x4 = FR.sqr(x2)
    return FR.mul(FR.mul(x4, x2), x)


def mimc7(x, k):
    """circomlib MiMC7(x_in, k), batched; x and k broadcast."""
    F = FR
    cts = _mimc_consts_mont().to(x.device)
    r = _pow7(F.add(x, k))
    for i in range(1, cts.shape[0]):
        r = _pow7(F.add(F.add(r, k), cts[i]))
    return F.add(r, k)


def mimc7_multi(inputs, key=None):
    """circomlib MultiMiMC7: r = k; for x in inputs: r += x + MiMC7(x, r)."""
    F = FR
    r = key if key is not None else torch.zeros_like(inputs[0])
    for x in inputs:
        r = F.add(F.add(r, x), mimc7(x, r))
    return r


def mimc_hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node hash of the MiMC tree: MultiMiMC7([left, right], key 0),
    one K6 launch."""
    return _mimc_hash2_kernel(left, right)


# ---------------------------------------------------------------------------
# Poseidon
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _poseidon_consts_mont(t: int):
    """(C int32[n_rounds, t, 16], M int32[t, t, 16]) in Montgomery form."""
    C, M = poseidon_params(t)
    n_rounds = POSEIDON_RF + POSEIDON_RP[t - 2]
    c = FR.encode(C).reshape(n_rounds, t, FR.L)
    m = FR.encode([M[i][j] for i in range(t) for j in range(t)]).reshape(t, t, FR.L)
    return c, m


def poseidon_permute(state):
    """Poseidon permutation on a list of t batched elements, composed from
    field ops: all t state words ride each add and multiply together."""
    F = FR
    t = len(state)
    C, M = _poseidon_consts_mont(t)
    dev = state[0].device
    C, M = C.to(dev), M.to(dev)
    s = torch.stack(state)                       # (t, ..., 16)
    batch = (1,) * (s.ndim - 2)
    half, r_p = POSEIDON_RF // 2, POSEIDON_RP[t - 2]

    def pow5(x):
        x2 = F.sqr(x)
        return F.mul(F.sqr(x2), x)

    for r in range(C.shape[0]):
        s = F.add(s, C[r].reshape((t,) + batch + (F.L,)))
        if r < half or r >= half + r_p:
            s = pow5(s)
        else:
            s = torch.cat([pow5(s[:1]), s[1:]])
        prod = F.mul(M.reshape((t, t) + batch + (F.L,)), s[None])   # M[i, j]·s_j
        acc = prod[:, 0]
        for j in range(1, t):
            acc = F.add(acc, prod[:, j])
        s = acc
    return [s[i] for i in range(t)]


def poseidon_hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node hash: circomlib Poseidon(left, right), one K4 launch."""
    return _poseidon_hash2_kernel(left, right)


def poseidon(inputs):
    """circomlib Poseidon: state = [0, *inputs] -> state[0]."""
    if len(inputs) == 2:
        return poseidon_hash2(inputs[0], inputs[1])
    zero = torch.zeros_like(inputs[0])
    return poseidon_permute([zero] + list(inputs))[0]
