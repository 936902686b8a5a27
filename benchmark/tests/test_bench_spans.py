"""The port's spans beside the card's timeline (`benchmark/spans.py`,
`benchmark/span_gaps.py`): nested spans cut into innermost pieces, idle
gaps named by them through `profiling.summary`, self times, a CPU window
of the withdraw cell with the recorder on, and on the card the clock
check: a port span around one kernel holds that kernel's device span."""

import pytest

from benchmark import harness, profiling, span_gaps, spans

from . import fakes
from .test_bench_cells import CELLS


def test_innermost_cuts_nested_spans_into_named_pieces():
    S = profiling.Span
    got = spans.innermost([S("call", 0, 100), S("req", 10, 90), S("a", 20, 40),
                           S("a.in", 25, 30), S("b", 40, 60), S("call", 120, 130)])
    assert [(p.name, p.start, p.end) for p in got] == [
        ("call", 0, 10), ("req", 10, 20), ("a", 20, 25), ("a.in", 25, 30), ("a", 30, 40),
        ("b", 40, 60), ("req", 60, 90), ("call", 90, 100), ("call", 120, 130)]


def test_idle_gaps_are_named_by_the_innermost_port_span():
    """Synthetic device spans over [0, 1000] ns: each gap goes to the
    innermost port span holding its midpoint, else the harness's call
    span, else "between calls"; busy time and kernels are as without
    port spans.  Shared by overlap, a gap's seconds go to every piece it
    runs across."""
    S = profiling.Span
    device = [S("Memcpy HtoD", 100, 200), S("g1_add_kernel", 600, 700),
              S("g2_add_kernel", 960, 980)]
    calls = [S("prove_withdraw", 40, 900)]
    records = [S("pool.prove_request", 60, 880), S("groth16.r1cs", 210, 590)]
    plain = profiling.summary(device, 0, 1000, calls)
    named = profiling.summary(device, 0, 1000, spans.innermost(calls + records))
    assert dict(plain["breakdown"]["idle_gaps"]) == pytest.approx({
        "prove_withdraw before Memcpy HtoD": 100e-9,
        "prove_withdraw before g1_add_kernel": 400e-9,
        "prove_withdraw before g2_add_kernel": 260e-9,
        "between calls before window end": 20e-9})
    assert dict(named["breakdown"]["idle_gaps"]) == pytest.approx({
        "prove_withdraw before Memcpy HtoD": 100e-9,
        "groth16.r1cs before g1_add_kernel": 400e-9,
        "pool.prove_request before g2_add_kernel": 260e-9,
        "between calls before window end": 20e-9})
    assert {k: named[k] for k in ("busy_s", "window_s", "kernels")} == \
        {k: plain[k] for k in ("busy_s", "window_s", "kernels")}
    idle = named["window_s"] - named["busy_s"]
    port = {"groth16.r1cs", "pool.prove_request"}
    assert spans.named_share(named["breakdown"]["idle_gaps"], port, idle) == \
        pytest.approx(660 / 780)
    split = spans.idle_by_span(device, 0, 1000, spans.innermost(calls + records))
    assert split == pytest.approx({"groth16.r1cs": 380e-9, "pool.prove_request": 240e-9,
                                   "between calls": 120e-9, "prove_withdraw": 40e-9})
    assert list(split) == ["groth16.r1cs", "pool.prove_request", "between calls",
                           "prove_withdraw"]


class TimedPool(fakes.SimulatedPool):
    """The simulated pool with the port's root span and one child."""

    def prove_withdraw(self, *args, **kw):
        from owshen_tpu_torch.runtime.metrics import metrics

        with metrics.timer("pool.prove_request"):
            with metrics.timer("pool.synthesize"):
                return super().prove_withdraw(*args, **kw)


def test_window_on_cpu_reads_the_recorded_spans():
    from types import SimpleNamespace

    out = span_gaps.window(harness.bench_spec(), "owshen_pool_d16.withdraw_prove",
                           2 ** 31 + 17, 0.05, False, True, device="cpu",
                           program=SimpleNamespace(PrivacyPool=TimedPool),
                           sizes=CELLS["owshen_pool_d16.withdraw_prove"][1])
    n = out["calls"]
    assert n >= 1 and out["ops"] == n and out["dropped"] == 0
    assert {k: v["count"] for k, v in out["spans"].items()} == {"pool.prove_request": n,
                                                               "pool.synthesize": n}
    root, child = out["spans"]["pool.prove_request"], out["spans"]["pool.synthesize"]
    assert child["self_s"] == child["total_s"]
    assert root["self_s"] == pytest.approx(root["total_s"] - child["total_s"])
    assert 0.9 < out["root_covered"] <= 1
    assert out["launches"] == 0 and out["launch_host_s"] == 0
    assert out["proofs_per_s"] > 0 and "breakdown" not in out


@pytest.mark.cuda
def test_port_span_holds_its_kernel_on_the_trace_clock():
    """A port span around one float32 4096² product and a synchronize
    holds the product's device span on `profiling.Trace`'s timeline,
    within 50 µs at each end (`torch.cuda._sleep`'s `spin_kernel` is the
    marker `Trace` leaves out of its spans, so a product stands in)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device timeline")
    from owshen_tpu_torch.runtime.metrics import metrics

    a = torch.randn(4096, 4096, device="cuda")
    torch.mm(a, a)
    torch.cuda.synchronize()
    with profiling.Trace(torch) as tr, metrics.recording() as rec:
        with metrics.timer("clock.mm"):
            torch.mm(a, a)
            torch.cuda.synchronize()
    (span,) = rec.spans
    assert tr.spans, "the profiler saw no device span"
    first = min(s.start for s in tr.spans)
    last = max(s.end for s in tr.spans)
    lead, tail = first - span.start_ns, span.end_ns - last
    print(f"clock check: device work {(last - first) / 1e3:.1f} us starts {lead / 1e3:.1f} us "
          f"after the span opens and ends {tail / 1e3:.1f} us before it closes "
          f"({[profiling.short(s.name) for s in tr.spans]})")
    assert lead >= -50_000 and tail >= -50_000
