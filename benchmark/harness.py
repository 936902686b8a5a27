"""The general run of one cell: set-up, a closed loop for `--seconds`, the
per-layer readings of a traced run, the comparison with the plain reference,
and the result line.

A cell of BENCHMARK.json names a configuration (configs/<name>.json) and a
traffic mix (traffic/<name>.json); the mix names the entry point that it
drives (entries/<entry>.py).  An entry module provides

    setup(ctx) -> state           inputs from ctx.seed, the program's objects,
                                  every shape of the window warmed; the
                                  work units of one op in state["units_per_op"]
    step(state, i) -> int         one call of the entry; the ops it completed
                                  (launched, where the entry does not sync)
    release(state) -> outputs     drop the program's state, keep what the
                                  reference judges
    check(outputs, ctx, workers) -> [(name, value, limit)]

and may add entries to ctx.reading for its per-layer metrics.  A per-layer
metric is metrics/<name>.py with read(reading) -> float | None."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "owshen_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def bench_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(spec: dict, name: str) -> dict:
    """The cell `name` with its configuration and traffic files read."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {"cell": cell,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json")}


def end_to_end_names(spec: dict, cell: str) -> list[str]:
    return [m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_names(spec: dict, cell: str) -> list[str]:
    e2e = set(end_to_end_names(spec, cell))
    return [m["name"] for m in spec["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in e2e]


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def jax_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in JAX_NAMES})


def workers(n: int | None = None):
    """A pool of spawned processes for the reference (it is pure Python)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from .reference import poseidon

    n = n or min(8, os.cpu_count() or 1)
    derived = {t: poseidon.params(t) for t in (3, 5, 6)}
    return ProcessPoolExecutor(max_workers=n, mp_context=multiprocessing.get_context("spawn"),
                               initializer=poseidon.preset, initargs=(derived,))


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def program_timers() -> dict:
    from owshen_tpu_torch.runtime.metrics import metrics

    return {k: (v["count"], v["total_s"]) for k, v in metrics.dump()["timers"].items()}


def launch_state():
    from owshen_tpu_torch import kernels

    return kernels.launch_counts(), kernels.launch_widths()


def diff_launches(before, after) -> tuple[dict, dict]:
    (c0, w0), (c1, w1) = before, after
    counts = {k: c1[k] - c0.get(k, 0) for k in c1}
    widths = {k: {w: [v[0] - w0.get(k, {}).get(w, [0, 0])[0],
                      v[1] - w0.get(k, {}).get(w, [0, 0])[1]]
                  for w, v in w1[k].items()} for k in w1}
    return counts, widths


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program=None, fault: str | None = None,
             t_start: float | None = None, n_workers: int | None = None,
             sizes: dict | None = None) -> dict:
    """One run of cell `name`; returns the result dict (the printed line's
    keys, and `checks` as [(name, value, limit)]).  `program` stands in for
    the port's entry (tests), `fault` plants a fault (control.py), `sizes`
    overrides configuration and traffic keys (tests at CPU sizes)."""
    import torch

    from . import profiling

    t_start = time.perf_counter() if t_start is None else t_start
    parts = cell_spec(spec, name)
    for key, value in (sizes or {}).items():
        parts["config" if key in parts["config"] else "traffic"][key] = value
    traffic = parts["traffic"]
    entry = entry_module(traffic["entry"])
    ctx = SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
        config=parts["config"], traffic=traffic, rng=random.Random(seed),
        program=program, fault=fault, reading={})
    state = entry.setup(ctx)
    units_per_op = state["units_per_op"] * traffic.get("unit_scale", 1)
    sync(torch, device)
    # the inputs and keys made in set-up stay alive all run: keep the
    # collector's full passes from walking them in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    on_card = ctx.device.type == "cuda"
    before = launch_state() if program is None else None
    timers0 = program_timers() if program is None else {}
    host_spans = []
    tracer = profiling.Trace(torch) if trace and on_card else None
    ops = attempted = failed = 0
    errors = []
    with tracer or contextlib.nullcontext():
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        i = 0
        while True:
            attempted += 1
            s_ns = time.time_ns()
            try:
                ops += entry.step(state, i)
            except Exception as err:   # a failed request counts, and the run goes on
                failed += 1
                errors.append(repr(err))
            host_spans.append(profiling.Span(traffic["entry"], s_ns, time.time_ns()))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(torch, device)
        elapsed = time.perf_counter() - t0
        t1_ns = time.time_ns()
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    found = jax_modules()
    if found:
        raise RuntimeError("JAX or the JAX package is loaded: " + ", ".join(found))

    reading = ctx.reading
    reading.update(ops=ops, calls=attempted - failed, seconds=elapsed,
                   host_s=sum(h.end - h.start for h in host_spans) / 1e9)
    if program is None:
        reading["launches"], reading["widths"] = diff_launches(before, launch_state())
        t1 = program_timers()
        reading["timers"] = {k: (v[0] - timers0.get(k, (0, 0.0))[0],
                                 v[1] - timers0.get(k, (0, 0.0))[1]) for k, v in t1.items()}
    breakdown = None
    if tracer:
        reading.update(profiling.summary(tracer.spans, t0_ns, t1_ns, host_spans))
        lost = profiling.lost_launches(reading["by_name"], reading.get("launches", {}))
        if lost:
            print(f"profiler: the timeline lacks launches (launched, seen): {lost}",
                  file=sys.stderr)
        if any(tracer.spins_lost):
            print(f"profiler: {tracer.spins_lost[0]} leading and {tracer.spins_lost[1]} trailing "
                  "spin kernels missing from the timeline", file=sys.stderr)
        breakdown = reading["breakdown"]

    outputs = entry.release(state)
    del state
    if on_card:
        torch.cuda.empty_cache()
    with workers(n_workers) as pool:
        checks = entry.check(outputs, ctx, pool)
    checks.append(("failed_calls", failed, 0))
    correct = all(value <= limit for _, value, limit in checks)

    if trace:
        names = per_layer_names(spec, name)
        metrics = {}
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
        for metric in names:
            value = load_file(HERE / "metrics" / f"{metric}.py").read(reading)
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        rate = traffic["rate_metric"]
        metrics = {rate: {"value": ops * units_per_op / elapsed, "unit": units[rate]},
                   "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    durs = sorted((h.end - h.start) / 1e9 for h in host_spans)
    calls = {"n": len(durs), "quartiles_s": quartiles(durs), "slowest_s": durs[-3:][::-1]}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
                      "count": parts["cell"]["chips"], "memory_peak_bytes": memory_peak},
           "checks": checks, "errors": errors[:5], "calls": calls}
    if tracer:
        out["device"].update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        out["breakdown"] = breakdown
    return out


def result_line(out: dict) -> dict:
    """The printed result: the contract's keys, the compared numbers last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out["checks"]}
    return line


def quartiles(values: list) -> list:
    import statistics

    return statistics.quantiles(values, n=4) if len(values) > 1 else list(values)


def card_power() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    spec = bench_spec()
    chips = cell_spec(spec, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    print(f"card: {card_power()}", file=sys.stderr)
    print(f"calls: {json.dumps(out['calls'])}", file=sys.stderr)
    for err in out["errors"]:
        print(f"failed call: {err}", file=sys.stderr)
    for n, v, lim in out["checks"]:
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(out)), flush=True)
    return 0
