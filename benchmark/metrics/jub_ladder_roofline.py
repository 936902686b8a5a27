"""The least time of the window's `jub_scalar_mul` launches (the doubles and
adds the challenge scalars of each verified batch need, benchmark/work.py;
the scalars come from the reference) over their device time on the
profiler's timeline, in %."""

KERNEL = "jub_ladder_kernel"


def read(r):
    if "by_name" not in r or "ladder_least_s" not in r:
        return None
    device_s = sum(s for name, (_, s) in r["by_name"].items() if KERNEL in name)
    if device_s <= 0:
        return None
    return 100.0 * r["ladder_least_s"] / device_s
