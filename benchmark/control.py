"""Readings of a cell's compared numbers over many seeds in one process, for
the sound program, the control and the planted faults:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 --modes sound,control,answer_altered

`sound` runs the program as the benchmark does; `control` runs its path in
the precision below the one the configuration states (or with one of the
configuration's guarantees broken), and each other mode plants one fault
(entries/<entry>.py CONTROL_FAULTS).  One JSON line per run: the mode, the
seed, `correct` and each compared number.  The benchmark's own runs never
take this path."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--modes", default="sound,control")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.bench_spec()
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            out = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                                   fault=None if mode == "sound" else mode)
            print(json.dumps({"mode": mode, "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "checks": {n: v for n, v, _ in out["checks"]},
                              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                              "errors": out["errors"][:2],
                              "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
