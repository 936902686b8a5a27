"""Hand-written CUDA kernels of the port (K1–K7, with K1's G2 point
operations) and their wrappers.

Every wrapper launches its kernel on CUDA tensors (or raises) and runs its
plain PyTorch twin on CPU tensors; `launch_counts()` reads how often each
kernel was launched, `launch_widths()` how often and over how many items
at each width (bucketed by the power of two at or above it), and
`reset_launches()` sets both to zero.  Within `capture_operands()` each
wrapper also keeps a copy of its first operands at each width, which
`PLAIN[name]` takes as the wrapper does: a path's kernels can then be held
against their plain twins on the path's own operands."""

from __future__ import annotations

import contextlib

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

PLAIN = {
    "mont_mul": field_ops.mont_mul_plain,
    "mod_add": field_ops.mod_add_plain,
    "mod_sub": field_ops.mod_sub_plain,
    "g1_add": g1.g1_add_plain,
    "g1_double": g1.g1_double_plain,
    "g2_add": g2.g2_add_plain,
    "g2_double": g2.g2_double_plain,
    "poseidon_hash2": poseidon.poseidon_hash2_plain,
    "ntt_butterfly": ntt.butterfly_stage_plain,
    "mimc_hash2": mimc.mimc_hash2_plain,
    "ntt_cols": ntt.ntt_cols_plain,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches, fn.widths = 0, {}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_widths() -> dict[str, dict[int, list[int]]]:
    return {name: {w: list(v) for w, v in sorted(fn.widths.items())}
            for name, fn in WRAPPERS.items()}


@contextlib.contextmanager
def capture_operands():
    """Yields a dict that, on exit, maps (name, width) to a copy of the
    operands of that kernel's first launch at that width inside the block
    (widths bucketed as in `launch_widths`).  Counts nothing."""
    names = {fn: name for name, fn in WRAPPERS.items()}
    out: dict = {}
    field_ops.CAPTURED = store = {}
    try:
        yield out
    finally:
        field_ops.CAPTURED = None
        out.update({(names[fn], w): args for (fn, w), args in store.items()})
