"""The benchmark of the PyTorch / CUDA port (`owshen_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json on the CUDA card.  Everything that belongs
to one configuration, traffic mix or per-layer metric sits in a file of its
own, found by the name BENCHMARK.json gives it:

  configs/<config>.json     a deployment's sizes and guarantees
  traffic/<traffic>.json    a traffic mix: its entry and parameters
  entries/<entry>.py        how one entry point of the port is driven
  metrics/<metric>.py       a per-layer metric's reader
  reference/                the plain reference (Python ints, NumPy, plain
                            torch) that decides `correct`; it imports
                            nothing of the port

The yardstick (generators, the profiler's busy union, the least-work counts
and peaks, the references) lives here so that a change to the port cannot
move it.
"""
