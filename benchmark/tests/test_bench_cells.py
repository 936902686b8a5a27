"""Each cell driven on the CPU at a tiny size through the harness, sound and
with the timed path broken underneath (the control and each fault the cell
can have): `correct` has to come out true, then false every time."""

import importlib

import pytest

from benchmark import harness

from . import fakes

CELLS = {
    "bn254_bulk.ntt_2p20": (None, {"ntt_log_n": 6, "vectors": 2, "sample_from": 2,
                                   "sampled": 1}),
    "bn254_bulk.msm_2p22": (fakes.msm_program, {"msm_log_n": 8, "distinct_points": 16,
                                                "scalar_sets": 2, "warm_calls": 0}),
    "owshen_pool_d16.voucher_verify": (None, {"tree_depth": 2, "voucher_batch": 8, "batches": 2,
                                              "tampered": 5, "warm_calls": 1}),
    "owshen_pool_d16.withdraw_prove": (fakes.withdraw_program, {"deposit_batch": 16,
                                                                "own_notes": 4, "warm_calls": 1,
                                                                "verified": 2}),
}


# cells measured and left out of BENCHMARK.json for their spread (PERF.md
# section 7): their files stay, and run here as a later PR would add them
LEFT_OUT = {
    "bn254_bulk.msm_2p22": ("bn254_bulk", "msm_2p22", "bulk_melem_per_s", "Melem/s"),
    "owshen_pool_d16.voucher_verify": ("owshen_pool_d16", "voucher_verify", "vouchers_per_s",
                                       "vouchers/s"),
}


def spec_for(cell: str) -> dict:
    spec = harness.bench_spec()
    if cell in LEFT_OUT:
        config, traffic, metric, unit = LEFT_OUT[cell]
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "left out"})
        spec["end_to_end"].append({"name": metric, "unit": unit, "better": "higher",
                                   "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    return spec


def faults(cell: str) -> list:
    entry = harness.cell_spec(spec_for(cell), cell)["traffic"]["entry"]
    return list(importlib.import_module(f"benchmark.entries.{entry}").CONTROL_FAULTS)


@pytest.mark.parametrize("cell,mode", [(c, m) for c in CELLS for m in ["sound"] + faults(c)])
def test_cell_on_cpu(cell, mode):
    make, sizes = CELLS[cell]
    out = harness.run_cell(spec_for(cell), cell, 2 ** 31 + 11, 0.05, False, device="cpu",
                           program=make() if make else None,
                           fault=None if mode == "sound" else mode, n_workers=2, sizes=sizes)
    assert out["attempted"] >= 1 and out["failed"] == 0, out["errors"]
    compared = {name: value for name, value, _ in out["checks"]}
    assert out["correct"] == (mode == "sound"), compared
    rate = harness.cell_spec(spec_for(cell), cell)["traffic"]["rate_metric"]
    assert out["metrics"][rate]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    res = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "bn254_bulk.ntt_2p20", "--seed", str(2 ** 31 + 13), "--seconds", "2"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
