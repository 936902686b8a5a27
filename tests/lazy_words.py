"""A Python-integer model of the lazy arithmetic in
owshen_tpu_torch/kernels/csrc/field.cuh, word for word: the word-serial
CIOS product on 32-bit words with its even and odd rows, the squaring from
its cross products, the lazy add, subtract and multiplication by 9, and
the one canonicalisation.  Every carry that a kernel chain drops is
asserted to be 0 (the subtract's wrap excepted, which is asserted to be the
borrow it undoes), and every result to stay below 2p.  `LazyField(p)`
models one modulus: Fr for K4 and K6, Fq for K2."""

from owshen_tpu_torch.kernels import build

MASK = 0xFFFFFFFF
R = 1 << 256


def words(x):
    return build.words_le(x)


def value(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


def chain(acc, pos, pairs, carry=0):
    """acc[pos..] += the lo/hi words of each product in `pairs`, as one
    carry chain (mad.lo.cc / madc.hi.cc); returns the carry out."""
    for a, b in pairs:
        prod = a * b
        for half in (prod & MASK, prod >> 32):
            v = acc[pos] + half + carry
            acc[pos], carry = v & MASK, v >> 32
            pos += 1
    return carry


def row(a, off, b):
    """(a[off]·b, a[off + 2]·b, ...) over four words of a, as 8 words."""
    return [(a[off + j] * b) >> (32 * h) & MASK for j in range(0, 8, 2) for h in (0, 1)]


class LazyField:
    """field.cuh's lazy arithmetic modulo p on 8-word little-endian values."""

    def __init__(self, p: int):
        self.p = p
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.pw = words(p)
        self.p2w = words(2 * p)

    def _mad_redc_step(self, even, odd, a, bi, first):
        pw = self.pw
        if first:
            odd[:] = row(a, 1, bi)
            even[:] = row(a, 0, bi)
        else:
            v = even[0] + odd[1]
            even[0], carry = v & MASK, v >> 32
            odd[:] = odd[2:] + [0, 0]
            assert chain(odd, 0, [(a[j], bi) for j in range(1, 8, 2)], carry) == 0
            odd[7] += chain(even, 0, [(a[j], bi) for j in range(0, 8, 2)])
        m = even[0] * self.n0 & MASK
        assert chain(odd, 0, [(pw[j], m) for j in range(1, 8, 2)]) == 0
        odd[7] += chain(even, 0, [(pw[j], m) for j in range(0, 8, 2)])
        assert even[0] == 0 and odd[7] <= MASK

    def mul(self, a, b):
        """fmul_lazy"""
        even, odd = [0] * 8, [0] * 8
        for i in range(0, 8, 2):
            self._mad_redc_step(even, odd, a, b[i], i == 0)
            self._mad_redc_step(odd, even, a, b[i + 1], False)
        r = [0] * 8
        carry = 0
        for j in range(8):
            v = even[j] + (odd[j + 1] if j < 7 else 0) + carry
            r[j], carry = v & MASK, v >> 32
        assert carry == 0
        return r

    def sqr(self, a):
        """fsqr_lazy"""
        ev, od = [0] * 16, [0] * 16
        for i in range(7):
            for acc, j0 in ((od, i + 1), (ev, i + 2)):
                if j0 < 8:
                    top = i + max(range(j0, 8, 2)) + 2
                    carry = chain(acc, i + j0, [(a[i], a[j]) for j in range(j0, 8, 2)])
                    acc[top] += carry
                    assert acc[top] <= MASK
        s = value(ev) + value(od)
        s = 2 * s + sum(a[i] * a[i] << (64 * i) for i in range(8))
        assert s < 1 << 512
        t, hi = words(s & (R - 1)), words(s >> 256)
        for _ in range(8):                       # REDC of the low half
            m = t[0] * self.n0 & MASK
            o = row(self.pw, 1, m)
            o[7] += chain(t, 0, [(self.pw[j], m) for j in range(0, 8, 2)])
            assert t[0] == 0
            t = words(value(t) // (1 << 32) + value(o))
            assert value(t) < R
        assert value(t) <= self.p and value(hi) < self.p
        return words(value(t) + value(hi))

    def add(self, a, b):
        """fadd_lazy"""
        s = value(a) + value(b)
        assert s < R
        return words(s - 2 * self.p if s >= 2 * self.p else s)

    def sub(self, a, b):
        """fsub_lazy: a − b, plus 2p where it wrapped"""
        borrow = value(a) < value(b)
        s = (value(a) - value(b)) % R + (value(words(2 * self.p)) if borrow else 0)
        assert s >> 256 == borrow           # the dropped carry undoes the wrap
        r = s % R
        assert r < 2 * self.p
        return words(r)

    def mul9(self, x):
        """fmul9_lazy: three doublings and an add"""
        t = self.add(x, x)
        t = self.add(t, t)
        t = self.add(t, t)
        return self.add(t, x)

    def canon(self, a):
        """fcanon"""
        return words(value(a) - self.p if value(a) >= self.p else value(a))

    def mont(self, x: int):
        """x in Montgomery form, as words"""
        return words(x * R % self.p)

    def unmont(self, w) -> int:
        return value(w) * pow(R, -1, self.p) % self.p
