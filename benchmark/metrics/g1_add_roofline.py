"""The least time of the window's `g1_add` launches (benchmark/work.py, the
items the port's counter saw) over their device time on the profiler's
timeline, in %."""

from benchmark import work

KERNEL = "g1_add_kernel"


def read(r):
    if "by_name" not in r:
        return None
    device_s = sum(s for name, (_, s) in r["by_name"].items() if KERNEL in name)
    items = sum(v[1] for v in r["widths"].get("g1_add", {}).values())
    if device_s <= 0 or items <= 0:
        return None
    return 100.0 * work.g1_add_s(items) / device_s
