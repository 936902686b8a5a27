"""The port's own spans (`owshen_tpu_torch.runtime.metrics`, kept while
`metrics.recording()` is on) beside the card's timeline.  Both are on the
host's epoch clock (`time.time_ns()`), so an idle gap of the card can be
named by the innermost port span that holds it: `profiling.summary` names
each gap by the host span that holds its midpoint, and `innermost` turns
nested spans into the disjoint pieces it reads; `idle_by_span` shares
each gap among all the pieces it overlaps."""

from __future__ import annotations

import itertools

from . import profiling
from .profiling import Span


def port_spans(records) -> list[Span]:
    return [Span(r.name, r.start_ns, r.end_ns) for r in records]


def innermost(spans) -> list[Span]:
    """Nested spans (each pair disjoint or one inside the other, as the
    spans of one thread are) cut into disjoint pieces in order, each named
    by the innermost span that holds it; time no span holds is left out."""
    out: list[Span] = []
    stack: list[Span] = []
    edge = 0

    def close_until(t):
        nonlocal edge
        while stack and stack[-1].end <= t:
            top = stack.pop()
            if top.end > edge:
                out.append(Span(top.name, edge, top.end))
            edge = max(edge, top.end)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(s.start)
        if stack and s.start > edge:
            out.append(Span(stack[-1].name, edge, s.start))
        stack.append(s)
        edge = max(edge, s.start)
    close_until(float("inf"))
    return out


def named_share(idle_gaps, names, idle_s: float) -> float:
    """The share of `idle_s` idle seconds that `idle_gaps` ([["<doing>
    before <op>", seconds], ...], a breakdown's list) puts down to a
    <doing> among `names`: a lower bound where the list is cut short."""
    named = sum(s for label, s in idle_gaps if label.split(" before ")[0] in names)
    return named / idle_s if idle_s > 0 else 0.0


def idle_by_span(device, t0: int, t1: int, pieces) -> dict:
    """The card's idle seconds in [t0, t1] (ns) split by the pieces
    (`innermost`'s, disjoint and in order) they overlap, "between calls"
    for idle time no piece holds.  Unlike a gap's label, which names only
    the span at its midpoint, a gap that runs across several spans is
    shared among them."""
    idle, edge = [], t0
    for lo, hi in profiling.union([s for s in device if s.end > t0 and s.start < t1]) + [(t1, t1)]:
        if lo > edge:
            idle.append((edge, min(lo, t1)))
        edge = max(edge, hi)
    out: dict[str, float] = {}
    j = 0
    for lo, hi in idle:
        while j < len(pieces) and pieces[j].end <= lo:
            j += 1
        covered = 0
        for p in itertools.islice(pieces, j, None):
            if p.start >= hi:
                break
            overlap = min(hi, p.end) - max(lo, p.start)
            out[p.name] = out.get(p.name, 0.0) + overlap / 1e9
            covered += overlap
        if hi - lo > covered:
            out["between calls"] = out.get("between calls", 0.0) + (hi - lo - covered) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def self_times(records) -> dict:
    """{name: [count, total seconds, self seconds]} of the recorded spans:
    a span's self time is its duration less its children's."""
    child = {}
    for r in records:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    out: dict[str, list] = {}
    for r in records:
        row = out.setdefault(r.name, [0, 0.0, 0.0])
        dur = r.end_ns - r.start_ns
        row[0] += 1
        row[1] += dur / 1e9
        row[2] += (dur - child.get(r.span_id, 0)) / 1e9
    return out
