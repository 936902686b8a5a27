"""Hand-written CUDA kernels of the port (K1–K7) and their wrappers.

Every wrapper launches its kernel on CUDA tensors (or raises) and runs its
plain PyTorch twin on CPU tensors; `launch_counts()` reads how often each
kernel was launched and `reset_launches()` sets the counts to zero."""

from __future__ import annotations

from . import field_ops, g1, mimc, ntt, poseidon

WRAPPERS = {
    "mont_mul": field_ops.mont_mul,
    "mod_add": field_ops.mod_add,
    "mod_sub": field_ops.mod_sub,
    "g1_add": g1.g1_add,
    "g1_double": g1.g1_double,
    "poseidon_hash2": poseidon.poseidon_hash2,
    "ntt_butterfly": ntt.butterfly_stage,
    "mimc_hash2": mimc.mimc_hash2,
    "ntt_cols": ntt.ntt_cols,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
