"""The port's spans and its launch-time counter (`runtime/metrics.py`,
`kernels/`): the recorder behind `metrics.timer`, and the span tree of one
withdraw proof on the CPU twins.

The proof runs on a one-constraint circuit (x·y = 12) with fixed tables
computed on the host (`host_msm.host_table`; the port's own table build
takes ~40 s on the twins); `groth16.prove` inside `prove_withdraw` proves
that circuit in place of the depth-2 withdraw circuit, whose setup takes
minutes here.  Alone on one core: ~10 s."""

import time

import pytest

from host_msm import restore_host_tables, tiny_circuit
from owshen_tpu_torch import kernels
from owshen_tpu_torch.circuits import pool as circuits
from owshen_tpu_torch.fields.field import FR
from owshen_tpu_torch.groth16 import groth16
from owshen_tpu_torch.kernels import field_ops
from owshen_tpu_torch.protocol.pool import PrivacyPool
from owshen_tpu_torch.runtime import metrics as metrics_mod
from owshen_tpu_torch.runtime.metrics import MetricsRegistry, metrics

POOL_SPANS = ("pool.tree_path", "pool.synthesize", "pool.check", "pool.prove_withdraw",
              "pool.nullifier")
GROTH16_SPANS = ("groth16.witness", "groth16.r1cs", "groth16.h", "groth16.msm",
                 "groth16.tails", "groth16.to_host")


def by_id(rec):
    return {s.span_id: s for s in rec.spans}


def test_recorder_keeps_the_tree_of_each_request():
    """Parents and request ids from the thread's stack, children closed
    before their parents, a span closed by an exception kept and
    aggregated, and a second root starting a request of its own."""
    reg = MetricsRegistry()
    with reg.recording() as rec:
        with reg.timer("req"):
            with reg.timer("a"):
                with reg.timer("a.inner"):
                    pass
            with pytest.raises(KeyError):
                with reg.timer("b"):
                    raise KeyError("b fails")
        with reg.timer("req"):
            with reg.timer("a"):
                pass
    spans = by_id(rec)
    r1, r2 = rec.spans[3].span_id, rec.spans[5].span_id
    assert r1 != r2
    assert [(s.name, s.parent and spans[s.parent].name, s.request) for s in rec.spans] == [
        ("a.inner", "a", r1), ("a", "req", r1), ("b", "req", r1), ("req", None, r1),
        ("a", "req", r2), ("req", None, r2)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            assert spans[s.parent].start_ns <= s.start_ns <= s.end_ns <= spans[s.parent].end_ns
    timers = reg.dump()["timers"]
    assert {k: v["count"] for k, v in timers.items()} == {"req": 2, "a": 2, "a.inner": 1, "b": 1}
    assert rec.dropped == 0


def test_recorder_is_bounded_and_off_outside_its_block(monkeypatch):
    """Past MAX_SPANS spans are counted, not kept, while every timer still
    aggregates; outside `recording()` nothing is kept and the aggregates
    are as before; one recording at a time."""
    monkeypatch.setattr(metrics_mod, "MAX_SPANS", 3)
    reg = MetricsRegistry()
    with reg.timer("before"):
        pass
    with reg.recording() as rec:
        with pytest.raises(RuntimeError):
            with reg.recording():
                pass
        for _ in range(5):
            with reg.timer("t"):
                pass
    with reg.timer("after"):
        with reg.timer("after.inner"):
            pass
    assert [s.name for s in rec.spans] == ["t"] * 3 and rec.dropped == 2
    assert reg._local.stack == []
    timers = reg.dump()["timers"]
    assert {k: v["count"] for k, v in timers.items()} == {"before": 1, "t": 5, "after": 1,
                                                         "after.inner": 1}
    for v in timers.values():
        assert set(v) == {"count", "total_s", "min_s", "max_s", "mean_s"}
        assert 0 <= v["min_s"] <= v["mean_s"] <= v["max_s"] <= v["total_s"]


def test_launch_host_time_is_counted_and_reported(monkeypatch):
    """A CPU twin counts nothing; a counted launch adds its host ns since
    the wrapper's entry, which `launch_host_ns()` and the registry's
    `kernels.launch_host` timer read and `reset_launches()` zeroes."""
    fn = field_ops.mont_mul
    for attr, value in (("launches", 0), ("widths", {}), ("host_ns", 0)):
        monkeypatch.setattr(fn, attr, value)
    before = metrics.dump()["timers"]["kernels.launch_host"]
    x = FR.encode([5, 6], device="cpu")
    field_ops.mont_mul(x, x, "fr")
    assert kernels.launch_host_ns()["mont_mul"] == 0 and fn.launches == 0
    field_ops.count_launch(fn, 3, time.perf_counter_ns() - 5000)
    assert fn.launches == 1 and fn.widths == {4: [1, 3]}
    assert kernels.launch_host_ns()["mont_mul"] >= 5000
    after = metrics.dump()["timers"]["kernels.launch_host"]
    assert after["count"] == before["count"] + 1
    assert after["total_s"] - before["total_s"] >= 5e-6
    kernels.reset_launches()
    assert kernels.launch_host_ns()["mont_mul"] == 0 == fn.launches


def test_withdraw_proof_span_tree(monkeypatch):
    """One `prove_withdraw` on the CPU: `pool.prove_request` is the root
    and the request of every span, the pool's stages its children in
    order, `groth16.prove`'s stages (fixed engine) the children of
    `pool.prove_withdraw`, each inside its parent; the proof verifies."""
    pk, vk = groth16.setup(tiny_circuit(), seed=b"trace", device="cpu")
    restore_host_tables(pk)
    pool = PrivacyPool(depth=2, keys=(pk, vk), device="cpu")
    secret, salt, amount = 5, 6, 7
    pool.deposit([1, circuits.commitment_of(secret, salt, amount)], [11, 12], [0, amount])
    prove = groth16.prove
    monkeypatch.setattr(groth16, "prove", lambda _pk, _b, **kw: prove(pk, tiny_circuit(), **kw))
    count0 = metrics.dump()["timers"].get("pool.prove_withdraw", {"count": 0})["count"]
    with metrics.recording() as rec:
        proof, _root, nullifier = pool.prove_withdraw(secret, salt, amount, 1, 99, seed=b"s")
    assert groth16.verify(vk, [12], proof)
    assert nullifier == circuits.nullifier_of(secret, 1)
    assert metrics.dump()["timers"]["pool.prove_withdraw"]["count"] == count0 + 1

    spans = by_id(rec)
    root = rec.spans[-1]
    assert root.name == "pool.prove_request" and root.parent is None
    assert all(s.request == root.span_id for s in rec.spans)
    order = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]
    assert order == ["pool.prove_request", *POOL_SPANS[:4], *GROTH16_SPANS, POOL_SPANS[4]]
    parent = {s.name: spans[s.parent].name for s in rec.spans if s.parent}
    assert parent == {**{n: "pool.prove_request" for n in POOL_SPANS},
                      **{n: "pool.prove_withdraw" for n in GROTH16_SPANS}}
    for s in rec.spans:
        if s.parent:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
