"""The card's timeline over a traced window, after `chip_smoke.py`'s
`traced` / `device_busy` at commit c2af7b2: the busy time is the union of
the device spans (kernels, copies, memsets) on `torch.profiler`'s timeline.

Late in a process the first few records of a profiler session can be
missing from its timeline, so the session opens and closes with SPINS tiny
spin kernels that take that loss and are left out of the spans; it stays
open SETTLE_S around the window, so that device events near its ends fall
inside it.  The events are read from the profiler's results in memory (the
copy exported a Chrome trace to a file and parsed it back)."""

from __future__ import annotations

import time

SPINS = 64
SETTLE_S = 0.05
TOP = 10
# the port's kernels by the name the profiler gives them (chip_smoke.py's
# KERNEL_SYMBOLS at c2af7b2), keyed as `kernels.launch_counts()` keys them
KERNEL_SYMBOLS = {"mont_mul": "field_op_kernel<0>", "mod_add": "field_op_kernel<1>",
                  "mod_sub": "field_op_kernel<2>", "g1_add": "g1_add_kernel",
                  "g1_double": "g1_dbl_kernel", "g2_add": "g2_add_kernel",
                  "g2_double": "g2_dbl_kernel", "jub_add": "jub_add_kernel",
                  "jub_scalar_mul": "jub_ladder_kernel", "poseidon_hash2": "poseidon2_kernel",
                  "ntt_butterfly": "ntt_stage_kernel", "mimc_hash2": "mimc2_kernel",
                  "ntt_cols": "ntt_cols_kernel"}


class Span:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: int, end: int):
        self.name, self.start, self.end = name, start, end


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    """`with Trace(torch) as tr:` profiles the card over the block; after it
    `tr.spans` holds the device spans (ns, the host's epoch clock, as
    `time.time_ns()` reads it) and `tr.spins_lost` the spin kernels that
    went missing at the session's start and end."""

    def __init__(self, torch):
        self.torch = torch
        self.spans: list[Span] = []
        self.spins_lost = (0, 0)

    def _spin(self):
        for _ in range(SPINS):
            self.torch.cuda._sleep(1)
        self.torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._spin()
        time.sleep(SETTLE_S)
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._spin()
        time.sleep(SETTLE_S)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        device = self.torch._C._autograd.DeviceType.CUDA
        spans, spins = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != device:
                continue
            name = e.name()
            start = e.start_ns()
            if "spin_kernel" in name:
                spins.append(start)
            else:
                spans.append(Span(name, start, start + e.duration_ns()))
        del self._prof
        first = min((s.start for s in spans), default=float("inf"))
        lead = sum(t < first for t in spins)
        self.spins_lost = (SPINS - lead, SPINS - (len(spins) - lead))
        self.spans = spans
        return False


def union(spans) -> list[tuple[int, int]]:
    """The busy intervals: the spans' union, in order."""
    out: list[list[int]] = []
    for lo, hi in sorted((s.start, s.end) for s in spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def short(name: str) -> str:
    """A kernel's name without `void`, anonymous namespaces and its argument
    list, cut to 120 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


def summary(spans, t0: int, t1: int, host_spans) -> dict:
    """Busy seconds, kernel count, device seconds by name and the idle gaps
    of [t0, t1] (ns), each gap named by the benchmark's host span that holds
    its midpoint and the device op that ends it."""
    inside = [s for s in spans if s.end > t0 and s.start < t1]
    busy = union(inside)
    busy_ns = sum(min(hi, t1) - max(lo, t0) for lo, hi in busy)
    by_name: dict[str, list] = {}
    for s in inside:
        row = by_name.setdefault(short(s.name), [0, 0.0])
        row[0] += 1
        row[1] += (s.end - s.start) / 1e9
    starts = sorted((s.start, short(s.name)) for s in inside)
    host = sorted((h.start, h.end, h.name) for h in host_spans)
    gaps: dict[str, float] = {}
    edge = t0
    k = j = 0
    for lo, hi in busy + [(t1, t1)]:
        if lo > edge:
            mid = (edge + lo) // 2
            while j < len(host) and host[j][1] < mid:
                j += 1
            doing = host[j][2] if j < len(host) and host[j][0] <= mid else "between calls"
            while k < len(starts) and starts[k][0] < lo:
                k += 1
            nxt = starts[k][1] if k < len(starts) and lo < t1 else "window end"
            label = f"{doing} before {nxt}"
            gaps[label] = gaps.get(label, 0.0) + (min(lo, t1) - edge) / 1e9
        edge = max(edge, hi)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": sum(1 for s in inside if is_kernel(s.name)),
        "by_name": by_name,
        "breakdown": {
            "device_ops": [[name, row[1]] for name, row in ops[:TOP]],
            "idle_gaps": [[label, s] for label, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def lost_launches(by_name: dict, launches: dict) -> dict:
    """{kernel: (launched, on the timeline)} for each of the port's kernels
    whose launches, as its counters saw them, the timeline lacks."""
    out = {}
    for kernel, n in launches.items():
        sym = KERNEL_SYMBOLS.get(kernel)
        seen = sum(c for name, (c, _) in by_name.items() if sym and sym in name)
        if sym and seen < n:
            out[kernel] = (n, seen)
    return out
