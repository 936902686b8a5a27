"""BENCHMARK.json against the contract, and the harness finding a cell,
configuration, traffic mix and per-layer metric by name."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return harness.bench_spec()


def test_top_level_keys_and_limits():
    s = spec()
    assert list(s) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert s["paths"] == ["benchmark"] and s["command"][1] == "benchmark/run.py"
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    items = s["configs"] + s["workloads"] + s["end_to_end"] + s["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in s[kind]]
        assert len(names) == len(set(names)), kind
    assert all(NAME.match(x["name"]) for x in items)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\t" not in w["why"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in s["end_to_end"])
    layers = {m["layer"] for m in s["per_layer"]}
    assert layers <= {"protocol", "groth16", "ops", "curves and fields", "kernels", "device"}


def test_every_cell_names_what_exists():
    s = spec()
    configs = {c["name"] for c in s["configs"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    for w in s["workloads"]:
        assert w["config"] in configs
        parts = harness.cell_spec(s, w["name"])
        assert (BENCH / "entries" / f"{parts['traffic']['entry']}.py").is_file()
        reported = harness.end_to_end_names(s, w["name"])
        assert "setup_s" in reported and parts["traffic"]["rate_metric"] in reported
        assert len(reported) == 2
        assert harness.per_layer_names(s, w["name"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert m["moves"] in harness.end_to_end_names(s, cell)
    for m in s["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in s["workloads"]}


def test_a_cell_is_added_by_adding_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric without an edit to any file it had."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "benchmark/configs/tiny_ntt.json").write_text(json.dumps({"ntt_log_n": 5}))
    (tmp_path / "benchmark/traffic/ntt_tiny.json").write_text(json.dumps(
        {"entry": "ntt", "rate_metric": "ntt_melem_per_s", "unit_scale": 1e-6, "vectors": 2,
         "warm_calls": 1, "sample_from": 2, "sampled": 1}))
    (tmp_path / "benchmark/metrics/calls_per_s.tiny.py").write_text(
        "def read(r):\n    return r['calls'] / r['seconds']\n")
    s["configs"].append({"name": "tiny_ntt", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/tiny_ntt.json", "reduced": [], "why": "test"})
    s["workloads"].append({"name": "tiny_ntt.ntt_tiny", "config": "tiny_ntt",
                           "traffic": "ntt_tiny", "chips": 1, "why": "test"})
    for m in s["end_to_end"]:
        if m["name"] == "ntt_melem_per_s":
            m["workloads"].append("tiny_ntt.ntt_tiny")
    s["per_layer"].append({"name": "calls_per_s.tiny", "unit": "calls/s", "better": "higher",
                           "source": "host_clock", "layer": "ops", "moves": "ntt_melem_per_s",
                           "workloads": ["tiny_ntt.ntt_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.insert(1, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "assert harness.ROOT == __import__('pathlib').Path(sys.path[0])\n"
        "if __name__ == '__main__':\n"
        "    s = harness.bench_spec()\n"
        "    for trace in (False, True):\n"
        "        out = harness.run_cell(s, 'tiny_ntt.ntt_tiny', 2**31 + 9, 0.2, trace,\n"
        "                               device='cpu', n_workers=1)\n"
        "        print(json.dumps(harness.result_line(out)))\n")
    (tmp_path / "drive.py").write_text(script)
    res = subprocess.run([sys.executable, str(tmp_path / "drive.py")], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = (json.loads(line) for line in res.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and set(plain["metrics"]) == {"ntt_melem_per_s", "setup_s"}
    assert traced["correct"] and set(traced["metrics"]) == {"calls_per_s.tiny"}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_the_result_line_carries_the_contract_keys():
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"x": {"value": 1.0, "unit": "s"}},
           "device": {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1},
           "checks": [("a_wrong", 0, 0)], "calls": {}, "errors": []}
    line = harness.result_line(out)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    line = harness.result_line({**out, "breakdown": {"device_ops": [], "idle_gaps": []}})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["checks"] == {"a_wrong": {"value": 0, "limit": 0}}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module `path` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "owshen_tpu"}
        assert not found, f"{path}: {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "owshen_tpu_torch" not in _imports(path), path


def test_a_loaded_jax_module_fails_the_run(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell(spec(), "bn254_bulk.ntt_2p20", 5, 0.05, False, device="cpu",
                         n_workers=1, sizes={"ntt_log_n": 4, "sampled": 1, "sample_from": 1})
    assert harness.jax_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    assert "owshen_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert harness.jax_modules() == []


def test_without_a_card_the_run_prints_no_result():
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "bn254_bulk.ntt_2p20", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout.strip() == ""
