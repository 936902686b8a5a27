"""R1CS constraint systems: the structure, fixed by the circuit, and the
witness, assigned for each proof.

A minimal circuit DSL (the role circom plays for the original Owshen wallet,
absent from the reference snapshot — SURVEY.md §0): variables are indices
into the witness vector [1, publics..., privates...]; constraints are
(A·w)·(B·w) = (C·w) rows with sparse linear combinations.

A circuit is one function over a builder, and either of two builders with
one interface runs it:

  * `Builder` records the structure: each linear combination is a sparse
    `LC`, each constraint an (A, B, C) triple, with the values carried
    alongside when they are given.  `groth16.setup` walks its constraints,
    and `compiled` turns them into the bucketed matrices that the proving
    key keeps on its device: the structure is built once per key.
  * `WitnessBuilder` records the values only: each linear combination is
    one integer, congruent to its value mod p, `enforce` records nothing,
    and `witness()` is the vector a full synthesis of the same inputs
    gives, element for element.  This is the pass a proof runs.

The gadgets take their constants and linear combinations from the builder
(`const`, `lincomb`), so one gadget text yields both, and the two cannot
drift.  `satisfied` checks a values-only witness against a kept structure
on host integers.  Witness generation stays on host (SURVEY.md §7.4.5).
"""

from __future__ import annotations

import operator

from ..oracle.field import P_FR

P = P_FR


class LC(dict):
    """Sparse linear combination {var_index: coeff}."""

    def __add__(self, other):
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) + v) % P
        return out

    def __sub__(self, other):
        out = LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) - v) % P
        return out

    def scale(self, c: int):
        c %= P
        return LC({k: v * c % P for k, v in self.items()})

    @staticmethod
    def const(c: int):
        return LC({0: c % P})

    @staticmethod
    def var(i: int):
        return LC({i: 1})

    def eval(self, values):
        return sum(values[k] * v for k, v in self.items()) % P


def satisfied(constraints, w: list[int]) -> bool:
    """Every (A, B, C) row holds on the witness w: (A·w)·(B·w) = C·w mod p."""
    return all(a.eval(w) * b.eval(w) % P == c.eval(w) for a, b, c in constraints)


class Builder:
    """The structure: sparse LCs and the (A, B, C) constraint list, with
    values carried alongside where they are given (None where not).  The
    gadget-facing operations are written once here, over the primitives
    that `WitnessBuilder` replaces (`_alloc`, `_val`, `const`, `lincomb`,
    `enforce`, `mul`)."""

    def __init__(self):
        self.values: list[int | None] = [1]
        self.n_pub = 0
        self._pub_done = False
        self.constraints: list[tuple[LC, LC, LC]] = []

    # ---------- allocation ----------

    def pub(self, value=None) -> LC:
        assert not self._pub_done, "allocate all public inputs first"
        self.n_pub += 1
        return self._alloc(value)

    def priv(self, value=None) -> LC:
        self._pub_done = True
        return self._alloc(value)

    def _alloc(self, value) -> LC:
        self.values.append(None if value is None else value % P)
        return LC.var(len(self.values) - 1)

    @property
    def num_vars(self):
        return len(self.values)

    def _val(self, lc: LC):
        if any(self.values[k] is None for k in lc):
            return None
        return lc.eval(self.values)

    const = staticmethod(LC.const)

    @staticmethod
    def lincomb(coeffs, lcs) -> LC:
        """Σ coeffs[i]·lcs[i]."""
        return sum((x.scale(c) for c, x in zip(coeffs, lcs)), LC())

    # ---------- constraints ----------

    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((a, b, c))

    def enforce_eq(self, a: LC, b: LC):
        self.enforce(a - b, self.const(1), self.const(0))

    def mul(self, a: LC, b: LC) -> LC:
        va, vb = self._val(a), self._val(b)
        out = self.priv(None if va is None or vb is None else va * vb % P)
        self.enforce(a, b, out)
        return out

    def square(self, a: LC) -> LC:
        return self.mul(a, a)

    def assert_bool(self, a: LC):
        self.enforce(a, a - self.const(1), self.const(0))

    def bits(self, a: LC, n: int) -> list[LC]:
        """Decompose into n little-endian bits (allocated + constrained)."""
        va = self._val(a)
        bs = []
        for i in range(n):
            b = self.priv(None if va is None else (va >> i) & 1)
            self.assert_bool(b)
            bs.append(b)
        self.enforce_eq(self.lincomb([pow(2, i, P) for i in range(n)], bs), a)
        return bs

    def hint(self, fn, *lcs) -> LC:
        """A private wire holding fn(values of `lcs`), with no constraint:
        the gadget that allocates it constrains it (circom's `<--`), as
        `gadgets.is_zero` does its inverse."""
        vals = [self._val(x) for x in lcs]
        return self.priv(None if None in vals else fn(*vals))

    def mux(self, bit: LC, a: LC, b: LC) -> tuple[LC, LC]:
        """Returns (bit ? b : a, bit ? a : b) with one multiplication."""
        t = self.mul(bit, b - a)
        return a + t, b - t

    # ---------- export ----------

    def compiled(self, n_rows: int):
        """The constraint matrices as nnz-BUCKETED index/coefficient arrays
        for the sparse matvec on the card.  They depend on the circuit
        alone: `groth16.setup` compiles them once and keeps them with the
        proving key on its device, and every proof on that key reuses them.

        Padding every row to K = max nnz is quadratic waste when a few rows
        are wide (Poseidon partial-round LCs reach 61 nonzeros at depth 16
        while the mean is ~9): rows are grouped by next-power-of-two nnz, so
        memory and gather traffic stay proportional to total nnz.  For each
        of A, B, C returns a list of buckets
        (row_ids int64[r], idx int64[r, k], coeff int32[r, k, 16] Montgomery,
        CPU tensors)
        padded with var 0 / coeff 0 within each bucket; rows absent from all
        buckets evaluate to 0.  n_rows >= len(constraints)."""
        import numpy as np
        import torch

        from ..fields.field import FR

        out = []
        for which in range(3):
            buckets: dict[int, list] = {}
            for j, c in enumerate(self.constraints):
                r = list(c[which].items())
                if not r:
                    continue
                k = 1 << max(0, (len(r) - 1).bit_length())
                buckets.setdefault(k, []).append((j, r))
            mats = []
            for k, items in sorted(buckets.items()):
                rids = torch.as_tensor([j for j, _ in items], dtype=torch.int64)
                idx = np.zeros((len(items), k), np.int64)
                coeff = [0] * (len(items) * k)
                for t_row, (_, r) in enumerate(items):
                    for t, (i, v) in enumerate(r):
                        idx[t_row, t] = i
                        coeff[t_row * k + t] = v
                cf = FR.encode(coeff).reshape(len(items), k, FR.L)
                mats.append((rids, torch.from_numpy(idx), cf))
            out.append(mats)
        return out

    def witness(self) -> list[int]:
        assert all(v is not None for v in self.values), "missing assignments"
        return list(self.values)

    def check(self) -> bool:
        return satisfied(self.constraints, self.witness())


class WitnessBuilder(Builder):
    """The values only, for a circuit whose structure is kept elsewhere
    (with the proving key): a linear combination is one integer, congruent
    to its value mod p, and a constraint records nothing (`constraints` is
    None).  Every value is required."""

    def __init__(self):
        super().__init__()
        self.constraints = None

    def _alloc(self, value) -> int:
        v = value % P
        self.values.append(v)
        return v

    @staticmethod
    def _val(a: int) -> int:
        return a % P

    @staticmethod
    def const(c: int) -> int:
        return c % P

    @staticmethod
    def lincomb(coeffs, xs) -> int:
        return sum(map(operator.mul, coeffs, xs)) % P

    def enforce(self, a, b, c):
        pass

    def mul(self, a: int, b: int) -> int:
        return self.priv(a * b)
