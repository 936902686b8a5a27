"""BN254 optimal-ate pairing on Python integers: a frozen copy of
`owshen_tpu_torch/groth16/pairing.py` at commit c2af7b2.  Tower: Fq2 =
Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with ξ = 9+u, Fq12 = Fq6[w]/(w²−v); G2
points untwist into E(Fq12) via (x, y) -> (x·w², y·w³); affine Miller loop,
naive final exponentiation."""

from __future__ import annotations

from .field import P_FQ as Q, P_FR as R

BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2


class Fq2:
    __slots__ = ("c",)

    def __init__(self, c0, c1=0):
        self.c = (c0 % Q, c1 % Q)

    def __add__(self, o):
        return Fq2(self.c[0] + o.c[0], self.c[1] + o.c[1])

    def __sub__(self, o):
        return Fq2(self.c[0] - o.c[0], self.c[1] - o.c[1])

    def __mul__(self, o):
        a0, a1 = self.c
        b0, b1 = o.c
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def __neg__(self):
        return Fq2(-self.c[0], -self.c[1])

    def inv(self):
        a0, a1 = self.c
        n = pow((a0 * a0 + a1 * a1) % Q, -1, Q)
        return Fq2(a0 * n, -a1 * n)

    def conj(self):
        return Fq2(self.c[0], -self.c[1])

    def __eq__(self, o):
        return self.c == o.c

    @staticmethod
    def zero():
        return Fq2(0, 0)

    @staticmethod
    def one():
        return Fq2(1, 0)


XI = Fq2(9, 1)


class Fq6:
    """c0 + c1·v + c2·v², v³ = ξ."""
    __slots__ = ("c",)

    def __init__(self, c0, c1, c2):
        self.c = (c0, c1, c2)

    def __add__(self, o):
        return Fq6(*(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return Fq6(*(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return Fq6(*(-a for a in self.c))

    def __mul__(self, o):
        a0, a1, a2 = self.c
        b0, b1, b2 = o.c
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + XI * ((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + XI * t2
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_v(self):
        a0, a1, a2 = self.c
        return Fq6(XI * a2, a0, a1)

    def inv(self):
        a0, a1, a2 = self.c
        t0 = a0 * a0 - XI * (a1 * a2)
        t1 = XI * (a2 * a2) - a0 * a1
        t2 = a1 * a1 - a0 * a2
        denom = (a0 * t0 + XI * (a2 * t1) + XI * (a1 * t2)).inv()
        return Fq6(t0 * denom, t1 * denom, t2 * denom)

    def __eq__(self, o):
        return self.c == o.c

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())


class Fq12:
    """a0 + a1·w, w² = v."""
    __slots__ = ("c",)

    def __init__(self, a0, a1):
        self.c = (a0, a1)

    def __add__(self, o):
        return Fq12(self.c[0] + o.c[0], self.c[1] + o.c[1])

    def __sub__(self, o):
        return Fq12(self.c[0] - o.c[0], self.c[1] - o.c[1])

    def __neg__(self):
        return Fq12(-self.c[0], -self.c[1])

    def __mul__(self, o):
        a0, a1 = self.c
        b0, b1 = o.c
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def sqr(self):
        return self * self

    def inv(self):
        a0, a1 = self.c
        denom = (a0 * a0 - (a1 * a1).mul_by_v()).inv()
        return Fq12(a0 * denom, -(a1 * denom))

    def __eq__(self, o):
        return self.c == o.c

    def pow(self, e: int):
        acc = Fq12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())


def _embed_fq(x: int) -> Fq12:
    return Fq12(Fq6(Fq2(x), Fq2.zero(), Fq2.zero()), Fq6.zero())


def _untwist(q):
    """G2 affine ((x0,x1),(y0,y1)) -> E(Fq12) affine (x·w², y·w³).

    w² = v, w³ = v·w."""
    (x0, x1), (y0, y1) = q
    x = Fq12(Fq6(Fq2.zero(), Fq2(x0, x1), Fq2.zero()), Fq6.zero())
    y = Fq12(Fq6.zero(), Fq6(Fq2.zero(), Fq2(y0, y1), Fq2.zero()))
    return (x, y)


def _double_step(t, p):
    """Returns (line value at p, 2t) for t on E(Fq12), p embedded."""
    xt, yt = t
    xp, yp = p
    lam = (xt * xt + xt * xt + xt * xt) * (yt + yt).inv()
    line = lam * (xp - xt) - (yp - yt)
    x3 = lam * lam - xt - xt
    y3 = lam * (xt - x3) - yt
    return line, (x3, y3)


def _add_step(t, q, p):
    xt, yt = t
    xq, yq = q
    xp, yp = p
    if xt == xq:
        if yt == yq:
            return _double_step(t, p)
        # vertical line
        return (xp - xt), None
    lam = (yq - yt) * (xq - xt).inv()
    line = lam * (xp - xt) - (yp - yt)
    x3 = lam * lam - xt - xq
    y3 = lam * (xt - x3) - yt
    return line, (x3, y3)


def _frobenius_g2_untwisted(q12):
    """π(x, y) = (x^q, y^q) computed directly in Fq12."""
    return (_fq12_frob(q12[0]), _fq12_frob(q12[1]))


# Frobenius on Fq12 via coefficient conjugation and multiplication by
# constants γ_i = ξ^((q-1)·i/6) for the w^i basis elements.
_GAMMA = []


def _init_gammas():
    global _GAMMA
    e = (Q - 1) // 6
    xi_pow = Fq2.one()
    # ξ^e computed by square-and-multiply in Fq2
    base, k = XI, e
    acc = Fq2.one()
    while k:
        if k & 1:
            acc = acc * base
        base = base * base
        k >>= 1
    g1 = acc
    gs = [Fq2.one()]
    for i in range(1, 6):
        gs.append(gs[-1] * g1)
    _GAMMA = gs


_init_gammas()


def _fq12_frob(a: Fq12) -> Fq12:
    """Frobenius x -> x^q on Fq12 in the (1, w, v, vw, v², v²w)-ish basis.

    Basis ordering here: a = (c00 + c01 v + c02 v²) + (c10 + c11 v + c12 v²) w,
    i.e. coefficient of w^j v^i is c_{j,i}; w^(6i+... ) exponents: v = w²,
    so c_{j,i} multiplies w^(2i+j).  π(c · w^k) = c^q · γ_k · w^k with
    γ_k = ξ^(k(q-1)/6)."""
    c0, c1 = a.c
    out0 = []
    out1 = []
    for i, coef in enumerate(c0.c):  # w^(2i)
        out0.append(coef.conj() * _GAMMA[(2 * i) % 6])
    for i, coef in enumerate(c1.c):  # w^(2i+1)
        out1.append(coef.conj() * _GAMMA[(2 * i + 1) % 6])
    return Fq12(Fq6(*out0), Fq6(*out1))


def miller_loop(p, q) -> Fq12:
    """p: G1 affine (x, y) ints; q: G2 affine pair of Fq2 int-pairs."""
    if p is None or q is None:
        return Fq12.one()
    pe = (_embed_fq(p[0]), _embed_fq(p[1]))
    t = _untwist(q)
    qe = t
    f = Fq12.one()
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
    for b in bits:
        line, t = _double_step(t, pe)
        f = f * f * line
        if b == "1":
            line, t2 = _add_step(t, qe, pe)
            f = f * line
            t = t2 if t2 is not None else t
    # Frobenius endpoints: Q1 = π(Q), Q2 = π²(Q)
    q1 = _frobenius_g2_untwisted(qe)
    q2 = _frobenius_g2_untwisted(q1)
    nq2 = (q2[0], -q2[1])
    line, t = _add_step(t, q1, pe)
    f = f * line
    line, _ = _add_step(t, nq2, pe)
    f = f * line
    return f


_FINAL_EXP = (Q**12 - 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    return f.pow(_FINAL_EXP)


def pairing(p, q) -> Fq12:
    """e(P, Q) for P in G1 (affine ints / None), Q in G2."""
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs) -> bool:
    """∏ e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f) == Fq12.one()
