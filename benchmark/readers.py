"""Readers that several per-layer metrics share; each metric's own file
under metrics/ names which it reads."""


def kernels_per_op(r):
    """Device kernels on the profiler's timeline over the traced window (the
    port's and PyTorch's), per op the window completed."""
    if "kernels" not in r or not r["ops"]:
        return None
    return r["kernels"] / r["ops"]


def device_idle_pct(r):
    """100 − the card's busy share of the traced window: busy is the union
    of the device spans on the profiler's timeline (profiling.py)."""
    if "busy_s" not in r or r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
