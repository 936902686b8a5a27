"""The last of the fields and curves surface against the JAX package: the
Fq2 arithmetic, `batch_inv`, `mont_reduce` and the host limb helpers, the
curve predicates and `to_affine` over G1 and G2, the BN254 constants, the
NTT domain's tables and the host oracle's `sqrt` / `on_curve`; and a walk
of both packages' public names.

Inputs are 4–8 seeded rows made with numpy; both packages compute on the
CPU and are compared integer for integer.  The JAX side runs one jit per
test at the smallest shape (its `NttDomain` tables are eager, as the
package builds them), and nothing of its setup or prove."""

import ast
import contextlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owshen_tpu.curves import bn254 as jbn
from owshen_tpu.fields import field as jfield
from owshen_tpu.fields.fq2 import FQ2 as JFQ2
from owshen_tpu.ops.ntt import NttDomain as JNttDomain
from owshen_tpu.oracle import curve as jocurve
from owshen_tpu.oracle import field as jofield
from owshen_tpu_torch.curves import bn254
from owshen_tpu_torch.curves.weierstrass import Weierstrass
from owshen_tpu_torch.fields import field
from owshen_tpu_torch.fields.field import FQ, FR
from owshen_tpu_torch.fields.fq2 import FQ2
from owshen_tpu_torch.ops.ntt import NttDomain
from owshen_tpu_torch.oracle import curve as ocurve
from owshen_tpu_torch.oracle import field as ofield

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
Q = FQ.p


def rand_ints(rng, p, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def test_fq2_ops_and_batch_inv_match_jax():
    """Fq2 add, sub, mul, sqr, neg, mul_const, mul_base and inv (zero
    included) as tests/test_middle.py holds the JAX package's against host
    ints, and Fq's batch_inv with zeros on [N, 16] and [N, 2, 16] as
    tests/test_field.py does, limb for limb against the JAX package."""
    rng = np.random.default_rng(61)
    a = list(zip(rand_ints(rng, Q, 6), rand_ints(rng, Q, 6)[::-1]))
    b = a[2:] + a[:2]
    a[1] = (0, 0)
    c = (123456789, 987654321)
    ta, tb = FQ2.encode(a), FQ2.encode(b)
    base = FQ.encode(rand_ints(rng, Q, 6))
    zs = rand_ints(rng, Q, 8)
    zs[3] = 0
    t1, t2 = FQ.encode(zs[:5]), FQ.encode(zs).reshape(4, 2, 16)
    t1[1] = 0                                                  # zeros in both shapes

    def ref(a, b, base, t1, t2):
        return (JFQ2.add(a, b), JFQ2.sub(a, b), JFQ2.mul(a, b), JFQ2.sqr(a), JFQ2.neg(a),
                JFQ2.mul_const(a, c), JFQ2.mul_base(a, base), JFQ2.inv(a),
                jfield.FQ.batch_inv(t1), jfield.FQ.batch_inv(t2))

    want = jax.jit(ref)(*(to_jax(t) for t in (ta, tb, base, t1, t2)))
    got = (FQ2.add(ta, tb), FQ2.sub(ta, tb), FQ2.mul(ta, tb), FQ2.sqr(ta), FQ2.neg(ta),
           FQ2.mul_const(ta, c), FQ2.mul_base(ta, base), FQ2.inv(ta),
           FQ.batch_inv(t1), FQ.batch_inv(t2))
    for i, (g, w) in enumerate(zip(got, want)):
        assert same(g, w), i
    f = ocurve.FQ2I
    assert FQ2.decode(got[2]) == [f.mul(x, y) for x, y in zip(a, b)]
    assert FQ2.decode(got[7]) == [(0, 0) if x == (0, 0) else f.inv(x) for x in a]
    assert FQ.decode(got[9]) == [pow(z, -1, Q) if z else 0 for z in zs]
    assert np.array_equal(FQ2.one_mont, np.asarray(JFQ2.one_mont))


def test_mont_reduce_host_helpers_and_field_attributes_match_jax():
    """mont_reduce of 2L-limb t < R·p (0 and R·p − 1 included), the host
    limb helpers with the reference's dtypes, get_field, and the Field
    attributes; a Field of another limb count is refused."""
    rng = np.random.default_rng(62)
    tees = {}
    for F in (FR, FQ):
        tees[F.name] = [int.from_bytes(rng.bytes(64), "little") % ((1 << 256) * F.p)
                        for _ in range(6)]
        tees[F.name][:2] = [0, (1 << 256) * F.p - 1]
    arrs = {name: field.ints_to_array(ts, 32) for name, ts in tees.items()}
    want = jax.jit(lambda r, q: (jfield.FR.mont_reduce(r), jfield.FQ.mont_reduce(q)))(
        jnp.asarray(arrs["fr"]), jnp.asarray(arrs["fq"]))
    for F, JF, w in ((FR, jfield.FR, want[0]), (FQ, jfield.FQ, want[1])):
        ts, arr = tees[F.name], arrs[F.name]
        assert arr.dtype == np.uint32 and np.array_equal(arr, jfield.ints_to_array(ts, 32))
        got = F.mont_reduce(torch.from_numpy(arr.astype(np.int32)))
        assert same(got, w)
        assert field.array_to_ints(got) == [t * F.R_inv % F.p for t in ts]
        assert field.array_to_ints(got.numpy()) == jfield.array_to_ints(np.asarray(got.numpy()))
        for name in ("n0", "nprime", "R", "R2", "two_adicity", "generator", "L"):
            assert getattr(F, name) == getattr(JF, name), name
        for name in ("nprime_limbs", "p_limbs", "zero", "one_mont"):
            mine, theirs = getattr(F, name), getattr(JF, name)
            assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs), name
        assert field.get_field(F.name) is F
    x = int.from_bytes(rng.bytes(32), "little")
    assert np.array_equal(field.int_to_limbs(x), jfield.int_to_limbs(x))
    assert field.limbs_to_int(field.int_to_limbs(x)) == x
    assert jfield.limbs_to_int(jfield.int_to_limbs(x)) == x
    assert field.MASK == jfield.MASK
    with pytest.raises(KeyError):
        field.get_field("fp")
    with pytest.raises(ValueError, match="16 limbs"):
        field.Field("fr", FR.p, L=8)


def scaled(rng, pts, group):
    """Projective copies (λX, λY, λZ) of affine points (None: (0, λ, 0))."""
    lam = FQ.encode([int(k) for k in rng.integers(2, 1 << 62, len(pts))])
    if group == "g1":
        return tuple(FQ.mul(c, lam) for c in bn254.g1_encode(pts))
    return tuple(FQ2.mul_base(c, lam) for c in bn254.g2_encode(pts))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_predicates_and_affine_match_jax(group):
    """is_identity, eq (scaled copies, identities, other points),
    on_curve_affine (a tampered y fails) and to_affine (the identity at
    (0, 0)) against the JAX package's curve, limb for limb; the BN254
    constants and the curves' b3; a b3 the kernels do not carry is
    refused."""
    rng = np.random.default_rng(63 if group == "g1" else 64)
    o, gen = (ocurve.G1, ocurve.G1_GEN) if group == "g1" else (ocurve.G2, ocurve.G2_GEN)
    C, JC = (bn254.G1, jbn.G1) if group == "g1" else (bn254.G2, jbn.G2)
    enc = bn254.g1_encode if group == "g1" else bn254.g2_encode
    pts = [o.mul(gen, int(k)) for k in rng.integers(1, 1 << 40, 6)]
    pts[2] = None
    p = enc(pts)
    q = scaled(rng, pts[:4] + [pts[5], pts[4]], group)      # rows 4, 5 differ from p's
    K = FQ if group == "g1" else FQ2
    x, y = enc([pt for pt in pts if pt is not None])[:2]
    y = y.clone()
    y[1] = K.add(y[1], K.one_like(y[1]))

    def ref(p, q, x, y):
        return (JC.is_identity(p), JC.eq(p, q), JC.on_curve_affine(x, y), JC.to_affine(q))

    j = jax.jit(ref)(tuple(map(to_jax, p)), tuple(map(to_jax, q)), to_jax(x), to_jax(y))
    ident, eq, on, aff = C.is_identity(p), C.eq(p, q), C.on_curve_affine(x, y), C.to_affine(q)
    assert ident.tolist() == np.asarray(j[0]).tolist() == [pt is None for pt in pts]
    assert eq.tolist() == np.asarray(j[1]).tolist() == [True] * 4 + [False] * 2
    assert on.tolist() == np.asarray(j[2]).tolist() == [True, False, True, True, True]
    assert same(aff[0], j[3][0]) and same(aff[1], j[3][1])
    want = pts[:4] + [pts[5], pts[4]]
    xys = zip(K.decode(aff[0]), K.decode(aff[1]))
    assert [None if w is None else xy for w, xy in zip(want, xys)] == want
    assert not aff[0][2].any() and not aff[1][2].any()           # the identity at (0, 0)

    for name in ("BN_X", "B_G1", "XI", "B_G2", "G1_GEN", "G2_GEN", "Q", "R"):
        assert getattr(bn254, name) == getattr(jbn, name), name
    assert C.b3_int == JC.b3_int and same(C.b3, JC.b3)
    bn254._check_generators()
    with pytest.raises(ValueError, match="kernels are built"):
        Weierstrass(K, 3 * 4 if group == "g1" else (3, 0))


TABLES = ("pows", "pows_inv", "coset_pows", "coset_pows_inv")


def test_ntt_tables_and_oracle_match_reference(monkeypatch):
    """NttDomain(4, device="cpu")'s pows, pows_inv, coset_pows and
    coset_pows_inv equal the JAX package's; without a card the domain's
    default device raises.  The host oracle's Fp.sqrt (None for a
    non-residue), WCurve.on_curve and JUB_SUBORDER equal the reference
    oracle's.

    The JAX package builds its tables eagerly (`powers_device` under
    jax.ensure_compile_time_eval), about 4 s of op-by-op compiles a table
    size on one core; here its four properties are traced into one jit
    instead, the same integer ops."""
    dom, jdom = NttDomain(4, device="cpu"), JNttDomain(4)
    with monkeypatch.context() as m:
        m.setattr(jax, "ensure_compile_time_eval", contextlib.nullcontext)
        want = jax.jit(lambda: tuple(getattr(jdom, name) for name in TABLES))()
    for name, w in zip(TABLES, want):
        got = getattr(dom, name)
        assert got.device.type == "cpu" and same(got, w), name
    assert dom.coset_gen == jdom.coset_gen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NttDomain(4).pows

    rng = np.random.default_rng(65)
    for F, JF in ((ofield.FR, jofield.FR), (ofield.FQ, jofield.FQ)):
        xs = [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(8)]
        xs += [0, 1, 4, 7, F.p - 1]
        roots = [F.sqrt(v) for v in xs]
        assert roots == [JF.sqrt(v) for v in xs]
        assert any(r is None for r in roots) and any(r is not None for r in roots)
        assert all(r is None or r * r % F.p == v for r, v in zip(roots, xs))
    for o, jo, gen in ((ocurve.G1, jocurve.G1, ocurve.G1_GEN),
                       (ocurve.G2, jocurve.G2, ocurve.G2_GEN)):
        pts = [None, gen, o.mul(gen, 5)]
        bad = (gen[0], ocurve.FQ1.add(gen[1], 1)) if o is ocurve.G1 else \
            (gen[0], ocurve.FQ2I.add(gen[1], (1, 0)))
        assert [o.on_curve(pt) for pt in pts + [bad]] == \
            [jo.on_curve(pt) for pt in pts + [bad]] == [True, True, True, False]
    assert ocurve.JUB_SUBORDER == jocurve.JUB_SUBORDER


# ---------------------------------------------------------------------------
# the public names of both packages
# ---------------------------------------------------------------------------

# names of the reference that are JAX- or Pallas-specific, with the reason
EXEMPT = {
    "*_jit": "a jax.jit wrapper; the port's functions run eagerly, each op a launch",
    "_pallas_*": "routing to a Pallas kernel; the port's ops are each one kernel",
    "pallas_min_rows": "the Pallas routing threshold of weierstrass.py",
    "_PALLAS_MIN_ROWS": "the Pallas routing threshold of weierstrass.py",
    "to_affine_jit": "the jit-cached to_affine (the port's to_affine is eager)",
    "Settings.no_pallas": "switches the Pallas kernels off; the port has none",
    "Settings.prover_pallas": "allows Pallas kernels inside the prover",
    "Settings.msm_pallas_min": "the least width msm_sorted routes to Pallas",
    "Settings.hash_block": "the lane block of the Pallas Poseidon / MiMC kernels",
}
# parameters the port takes beyond the reference's, with the reason
EXTRA_PARAMS = {
    "*": ("device",),       # where an entry point runs: the card unless asked
    "parallel/mesh.py:make_mesh": ("devices",),             # a torch.device a shard
    "runtime/dryrun.py:run": ("devices",),
    "protocol/pool.py:PrivacyPool.prove_withdraw": ("seed",),   # the proof's seed
}


def _params(fn):
    """Public parameter names of an AST function (self and _private left out)."""
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.arg not in ("self", "cls") and not a.arg.startswith("_")]


def surface(path):
    """({name: parameter names, or None for a class or constant} of a
    module's top level and its classes' members (Class.member; a
    property's name maps to None; a class has the members it inherits from
    a class of the same module), the names it imports, the attributes its
    classes set on self (Class.attr))."""
    names, imported, attrs = {}, set(), set()
    bases = {}
    for node in ast.parse(path.read_text()).body:
        targets = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            names[node.name] = None
            bases[node.name] = [b.id for b in node.bases if isinstance(b, ast.Name)]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    prop = any(getattr(d, "attr", getattr(d, "id", "")) in
                               ("property", "cached_property") for d in sub.decorator_list)
                    names[f"{node.name}.{sub.name}"] = None if prop else _params(sub)
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    names[f"{node.name}.{sub.target.id}"] = None
                elif isinstance(sub, ast.Assign):
                    names.update({f"{node.name}.{t.id}": None for t in sub.targets
                                  if isinstance(t, ast.Name)})
            attrs |= {f"{node.name}.{t.attr}" for sub in ast.walk(node)
                      if isinstance(sub, (ast.Assign, ast.AnnAssign))
                      for t in (sub.targets if isinstance(sub, ast.Assign) else [sub.target])
                      if isinstance(t, ast.Attribute) and getattr(t.value, "id", "") == "self"}
        elif isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        elif isinstance(node, ast.ImportFrom):
            imported |= {a.asname or a.name for a in node.names}
        for t in targets:
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(e, ast.Name):
                    names[e.id] = None
    for cls, parents in bases.items():
        for parent in parents:
            for name, params in list(names.items()):
                if name.startswith(parent + "."):
                    names.setdefault(cls + name[len(parent):], params)
            attrs |= {cls + a[len(parent):] for a in attrs if a.startswith(parent + ".")}
    return names, imported, attrs


def test_public_names_match_reference():
    """Every public function, class, method and module constant of
    owshen_tpu/ (pallas/ left out) has a counterpart of the same name in the
    port's module of the same path, taking the reference's parameters in
    its order (then only `device`, or the few extras listed with their
    reason); the reference's JAX- and Pallas-specific names are exempt, each
    with its reason, and each exemption matches a name of the reference.
    Read from the source: nothing is imported."""
    ref_root, port_root = REPO / "owshen_tpu", REPO / "owshen_tpu_torch"
    exempt = [re.compile(re.escape(k).replace(r"\*", ".*") + "$") for k in EXEMPT]
    used, missing, differ = set(), [], []
    files = sorted(p for p in ref_root.rglob("*.py")
                   if p.relative_to(ref_root).parts[0] != "pallas")
    assert len(files) > 30
    for path in files:
        rel = path.relative_to(ref_root).as_posix()
        ref = surface(path)[0]
        port_path = port_root / rel
        port, port_imported, port_attrs = (surface(port_path) if port_path.exists()
                                           else ({}, set(), set()))
        for name, params in ref.items():
            hits = [k for k, rx in zip(EXEMPT, exempt) if any(rx.match(part) for part in
                                                              (name, name.split(".")[-1]))]
            used.update(hits)
            if hits or any(part.startswith("_") and part != "__init__" for part in name.split(".")):
                continue
            if name not in port and name not in port_imported and name not in port_attrs:
                missing.append(f"{rel}:{name}")
                continue
            got = port.get(name)
            if params is not None and got is not None:
                extras = EXTRA_PARAMS["*"] + EXTRA_PARAMS.get(f"{rel}:{name}", ())
                if got[:len(params)] != params or not set(got[len(params):]) <= set(extras):
                    differ.append(f"{rel}:{name} {params} vs {got}")
    assert not missing, missing
    assert not differ, differ
    assert used == set(EXEMPT), set(EXEMPT) - used
