"""The least time of the window's K5 launches (benchmark/work.py: each
2^log_n transform is log_n stage launches of 2^(log_n − 1) butterflies)
over their device time on the profiler's timeline, in %."""

from benchmark import work

KERNEL = "ntt_stage_kernel"


def read(r):
    if "by_name" not in r:
        return None
    device_s = sum(s for name, (_, s) in r["by_name"].items() if KERNEL in name)
    least = 0.0
    for width, (launches, _) in r["widths"].get("ntt_butterfly", {}).items():
        log_n = int(width).bit_length()          # width = 2^(log_n − 1) butterflies
        least += launches / log_n * work.ntt_transform_s(log_n)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
