"""Run one cell of BENCHMARK.json on the CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
