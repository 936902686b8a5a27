"""One cell's window with the port's span recorder on, on the CUDA card:

    python3 benchmark/span_gaps.py --workload <cell> --seed <n> --seconds <s>
        [--trace 0|1] [--record 0|1]

Set-up and the closed loop are the harness's (`harness.py`); the window
runs inside `metrics.recording()` (with --record 1) and the profiler (with
--trace 1).  Prints one JSON line: the rate, the port's spans over the
window by name (count, total and self seconds), the share of
`pool.prove_request` its children cover, the launches' host time, and,
traced, the idle gaps named by the innermost port span that holds each
gap's midpoint (`spans.innermost`, falling back to the harness's call
span, then to "between calls"), the idle seconds shared among all the
spans each gap overlaps (`spans.idle_by_span`), and the share of the idle
seconds that port spans name, both ways.  `--record 0` gives the same
window without the recorder, to read its cost; `run.py` is what the
benchmark runs."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, profiling, spans  # noqa: E402

ROOT_SPAN = "pool.prove_request"


def launch_totals() -> tuple[int, float]:
    """The port's launches so far and their host seconds."""
    from owshen_tpu_torch import kernels

    return sum(kernels.launch_counts().values()), sum(kernels.launch_host_ns().values()) / 1e9


def window(spec: dict, name: str, seed: int, seconds: float, trace: bool, record: bool,
           device: str = "cuda", program=None, sizes: dict | None = None) -> dict:
    import torch

    from owshen_tpu_torch.runtime.metrics import metrics

    parts = harness.cell_spec(spec, name)
    for key, value in (sizes or {}).items():
        parts["config" if key in parts["config"] else "traffic"][key] = value
    traffic = parts["traffic"]
    entry = harness.entry_module(traffic["entry"])
    ctx = SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
        config=parts["config"], traffic=traffic, rng=random.Random(seed),
        program=program, fault=None, reading={})
    state = entry.setup(ctx)
    harness.sync(torch, device)
    gc.collect()
    gc.freeze()

    on_card = ctx.device.type == "cuda"
    tracer = profiling.Trace(torch) if trace and on_card else None
    host_spans = []
    launch0 = launch_totals()
    ops = i = 0
    with tracer or contextlib.nullcontext(), \
            metrics.recording() if record else contextlib.nullcontext() as rec:
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        while True:
            s_ns = time.time_ns()
            ops += entry.step(state, i)
            host_spans.append(profiling.Span(traffic["entry"], s_ns, time.time_ns()))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(torch, device)
        elapsed = time.perf_counter() - t0
        t1_ns = time.time_ns()
    found = harness.jax_modules()
    if found:
        raise RuntimeError("JAX or the JAX package is loaded: " + ", ".join(found))
    units = ops * state["units_per_op"] * traffic.get("unit_scale", 1)
    out = {"workload": name, "seed": seed, "trace": int(trace), "record": int(record),
           "ops": ops, "calls": i, "seconds": elapsed, traffic["rate_metric"]: units / elapsed}
    launch1 = launch_totals()
    out["launches"], out["launch_host_s"] = launch1[0] - launch0[0], launch1[1] - launch0[1]
    records = rec.spans if record else []
    if record:
        out["dropped"] = rec.dropped
        table = spans.self_times(records)
        out["spans"] = {k: {"count": c, "total_s": t, "self_s": s}
                        for k, (c, t, s) in sorted(table.items())}
        roots = {r.span_id for r in records if r.name == ROOT_SPAN}
        covered = sum(r.end_ns - r.start_ns for r in records if r.parent in roots)
        whole = sum(r.end_ns - r.start_ns for r in records if r.span_id in roots)
        out["root_covered"] = covered / whole if whole else None
        out["groth16_self_s"] = sum(row["self_s"] for k, row in out["spans"].items()
                                    if k.startswith("groth16."))
    if tracer:
        pieces = spans.innermost(host_spans + spans.port_spans(records))
        reading = profiling.summary(tracer.spans, t0_ns, t1_ns, pieces)
        idle_s = reading["window_s"] - reading["busy_s"]
        names = {r.name for r in records}
        by_span = spans.idle_by_span(tracer.spans, t0_ns, t1_ns, pieces)
        out.update(busy_s=reading["busy_s"], window_s=reading["window_s"],
                   kernels=reading["kernels"], breakdown=reading["breakdown"],
                   port_named_share=spans.named_share(reading["breakdown"]["idle_gaps"],
                                                      names, idle_s),
                   idle_by_span=by_span,
                   port_idle_share=sum(v for k, v in by_span.items() if k in names) / idle_s)
    entry.release(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cache = harness.ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    import torch

    if not torch.cuda.is_available():
        print("span_gaps.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = window(harness.bench_spec(), args.workload, args.seed, args.seconds,
                 bool(args.trace), bool(args.record))
    out["card"] = harness.card_power()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
