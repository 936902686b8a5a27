"""Hand-written CUDA kernels of the port (K1–K7, with K1's G2 point
operations) and their wrappers.

Every wrapper launches its kernel on CUDA tensors (or raises) and runs its
plain PyTorch twin on CPU tensors; `launch_counts()` reads how often each
kernel was launched, `launch_widths()` how often and over how many items
at each width (bucketed by the power of two at or above it), and
`reset_launches()` sets both to zero."""

from __future__ import annotations

from . import field_ops, g1, g2, mimc, ntt, poseidon

WRAPPERS = {
    "mont_mul": field_ops.mont_mul,
    "mod_add": field_ops.mod_add,
    "mod_sub": field_ops.mod_sub,
    "g1_add": g1.g1_add,
    "g1_double": g1.g1_double,
    "g2_add": g2.g2_add,
    "g2_double": g2.g2_double,
    "poseidon_hash2": poseidon.poseidon_hash2,
    "ntt_butterfly": ntt.butterfly_stage,
    "mimc_hash2": mimc.mimc_hash2,
    "ntt_cols": ntt.ntt_cols,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches, fn.widths = 0, {}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_widths() -> dict[str, dict[int, list[int]]]:
    return {name: {w: list(v) for w, v in sorted(fn.widths.items())}
            for name, fn in WRAPPERS.items()}
