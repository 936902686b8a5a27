"""The host time of the port's kernel launches (each wrapper's CUDA branch,
entry to return, `kernels.launch_host_ns()`, which the registry reports as
the timer `kernels.launch_host`) over the window, per proof: the host's
cost of launching the port's own kernels, not PyTorch's ops.  Read in a
traced run, so it includes the profiler's cost a launch."""


def read(r):
    _, total = r.get("timers", {}).get("kernels.launch_host", (0, 0.0))
    if not total or not r["calls"]:
        return None
    return 1e3 * total / r["calls"]
