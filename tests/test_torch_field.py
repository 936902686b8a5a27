"""Port vs reference: K1 (Montgomery multiply, modular add and subtract)
and the Fr / Fq layers built on it, and the Fq2 arithmetic of the G2 twins.

Inputs come from numpy.random.default_rng and go through both packages;
field arithmetic is exact, so every comparison is integer equality.  The
JAX side runs its Pallas kernel in interpret mode, as tests/test_pallas.py
does, and its composed field ops."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.fields.field import FQ as JFQ
from owshen_tpu.fields.field import FR as JFR
from owshen_tpu.fields.fq2 import FQ2 as JFQ2
from owshen_tpu.pallas.field_kernels import mont_mul_pallas
from owshen_tpu_torch.config import resolve_device
from owshen_tpu_torch.fields.field import FQ, FR
from owshen_tpu_torch.fields.fq2 import FQ2
from owshen_tpu_torch.kernels import field_ops, g2

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIELDS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}


def rand_ints(rng, p, n, edges=True):
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    if edges:
        vals[:4] = [0, 1, p - 1, p - 2]
    return vals


def both(F, JF, ints):
    """Montgomery limbs of `ints` as (torch int32, jnp uint32)."""
    j = JF.encode(ints)
    return torch.from_numpy(np.asarray(j).astype(np.int32)), jnp.asarray(j)


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def test_mont_mul_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    xs, ys = rand_ints(rng, FR.p, 128), rand_ints(rng, FR.p, 128)[::-1]
    ta, ja = both(FR, JFR, xs)
    tb, jb = both(FR, JFR, ys)
    got = field_ops.mont_mul(ta, tb, "fr")
    assert same(got, mont_mul_pallas(ja, jb, block_t=128))
    assert same(got, JFR.mul(ja, jb))
    assert FR.decode(got) == [x * y % FR.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_ops_match_jax(name):
    F, JF = FIELDS[name]
    rng = np.random.default_rng(12 if name == "fr" else 13)
    xs, ys = rand_ints(rng, F.p, 96), rand_ints(rng, F.p, 96)[::-1]
    ta, ja = both(F, JF, xs)
    tb, jb = both(F, JF, ys)
    assert same(F.mul(ta, tb), JF.mul(ja, jb))
    assert same(F.add(ta, tb), JF.add(ja, jb))
    assert same(F.sub(ta, tb), JF.sub(ja, jb))
    assert same(F.neg(ta), JF.neg(ja))
    assert same(F.sqr(ta), JF.sqr(ja))
    assert same(F.mul_const(ta, 9), JF.mul_const(ja, 9))
    assert same(F.from_mont(ta), JF.from_mont(ja))
    assert same(F.to_mont(F.from_mont(ta)), ja)
    # a single row broadcasts against the batch, as the twiddles do
    assert same(F.mul(ta, tb[5]), JF.mul(ja, jb[5][None]))
    # the twins' carry propagation (every row at once, pass by pass) gives
    # the row-by-row ripple's limbs and carry out, on long carry and borrow
    # chains too
    cols = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (17, 64)))
    cols[:, :8] = 0xFFFF
    cols[0, :8] += torch.arange(1, 9)
    cols[:, 8:16] = 0
    cols[0, 8:16] -= torch.arange(1, 9)
    want = cols.clone()
    for k in range(16):
        want[k + 1] += want[k] >> 16
        want[k] &= 0xFFFF
    carry = want[16] >> 16
    want[16] &= 0xFFFF
    assert torch.equal(field_ops.ripple(cols), carry) and torch.equal(cols, want)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_encode_decode_layout(name):
    F, JF = FIELDS[name]
    rng = np.random.default_rng(14)
    xs = rand_ints(rng, F.p, 20)
    for mont in (True, False):
        enc = F.encode(xs, mont=mont)
        assert enc.dtype == torch.int32
        assert np.array_equal(enc.numpy(), np.asarray(JF.encode(xs, mont=mont)).astype(np.int32))
        assert F.decode(enc, mont=mont) == xs
    assert np.array_equal(F.one_like(F.encode(xs)).numpy()[0],
                          np.asarray(JF.one_mont).astype(np.int32))


def test_fq2_ops_match_jax():
    """The port's Fq2 encoding, and the Fq2 arithmetic of the G2 twins
    (kernels/g2.py Fq2Ops: product, square, product by b3, add, subtract),
    against the JAX package's Fq2."""
    rng = np.random.default_rng(15)
    pairs = list(zip(rand_ints(rng, FQ.p, 40), rand_ints(rng, FQ.p, 40)[::-1]))
    pairs2 = pairs[7:] + pairs[:7]
    ja, jb = jnp.asarray(JFQ2.encode(pairs)), jnp.asarray(JFQ2.encode(pairs2))
    ta, tb = FQ2.encode(pairs), FQ2.encode(pairs2)
    assert same(ta, ja)
    assert FQ2.decode(ta) == pairs

    ops = g2.Fq2Ops(ta.device)

    def lm(t):
        return field_ops.to_lm(t[:, 0]), field_ops.to_lm(t[:, 1])

    def rows(x):
        return torch.stack([field_ops.from_lm(c, (-1, FQ.L)) for c in x], dim=1)

    a, b = lm(ta), lm(tb)
    assert same(rows(ops.mul(a, b)), JFQ2.mul(ja, jb))
    assert same(rows(ops.sqr(a)), JFQ2.sqr(ja))
    assert same(rows(ops.mul_b3(a)), JFQ2.mul_const(ja, g2.B3))
    assert same(rows(ops.add(a, b)), JFQ2.add(ja, jb))
    assert same(rows(ops.sub(a, b)), JFQ2.sub(ja, jb))


def test_operands_on_two_devices_are_refused():
    a = FR.encode([1, 2])
    with pytest.raises(ValueError):
        field_ops.on_cpu(a, a.to("meta"))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with jax and owshen_tpu blocked and
    without nvcc on the path."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['owshen_tpu'] = None\n"
        "import owshen_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(owshen_tpu_torch.__path__,"
        " 'owshen_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'owshen_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
