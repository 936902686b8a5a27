// BN254 Fr / Fq Montgomery arithmetic for one thread per element (sm_90a).
//
// Replaces the in-kernel field core of owshen_tpu/pallas/field_kernels.py:
// `_mul_lm_pend` / `_mul_lm` (Montgomery product), `_add_lm`, `_submod_lm`
// and `_canon_lm`.  The TPU kernels keep 16 limbs of 16 bits on sublanes
// because its vector unit has no add-with-carry; a CUDA thread has 64-bit
// products and carries, so here an element is 8 little-endian 32-bit words
// in registers and the product is word-serial CIOS (coarsely integrated
// operand scanning): 8 outer steps, each 8 multiply-adds for a_i·b and 8 for
// m·p, carried in `unsigned long long`.
//
// Storage stays the package's layout: int32[..., 16] 16-bit limbs, R = 2^256.
// load_elem packs two limbs into each word, store_elem unpacks.
//
// Every result is canonical (< p) when the inputs are, so the values equal
// the TPU kernels' and the plain PyTorch twins' bit for bit.
//
// Constants: kField[0] = Fr, kField[1] = Fq, uploaded once per library by
// field_consts_upload() from the Python side (one source of truth for p).
//
// The second half of this file is a lazy arithmetic for the hash kernels,
// the G1 and G2 point operations and the fused column NTT (fmul_lazy,
// fsqr_lazy, fadd_lazy, fsub_lazy, fmul9_lazy, fcanon): values stay in
// [0, 2p) and are made canonical once, where a result is stored.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FieldConsts {
  uint32_t p[8];  // modulus, little-endian words
  uint32_t n0;    // -p^-1 mod 2^32
  uint32_t p2[8]; // 2p, for the lazy arithmetic below
};

__constant__ FieldConsts kField[2];

extern "C" int field_consts_upload(const uint32_t* words) {
  // words: 2 × (8 modulus words, n0, 8 words of 2p), Fr then Fq
  cudaMemcpyToSymbol(kField, words, sizeof(FieldConsts) * 2);
  return static_cast<int>(cudaGetLastError());
}

// 16 int32 limbs (64 bytes, 16-byte aligned) -> 8 words
__device__ __forceinline__ void load_elem(const int32_t* src, uint32_t x[8]) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = s[q];
    x[2 * q] = static_cast<uint32_t>(v.x) | (static_cast<uint32_t>(v.y) << 16);
    x[2 * q + 1] = static_cast<uint32_t>(v.z) | (static_cast<uint32_t>(v.w) << 16);
  }
}

__device__ __forceinline__ void store_elem(int32_t* dst, const uint32_t x[8]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 v;
    v.x = static_cast<int32_t>(x[2 * q] & 0xFFFFu);
    v.y = static_cast<int32_t>(x[2 * q] >> 16);
    v.z = static_cast<int32_t>(x[2 * q + 1] & 0xFFFFu);
    v.w = static_cast<int32_t>(x[2 * q + 1] >> 16);
    d[q] = v;
  }
}

// The three coordinates of a projective point, 8 words each, in one
// thread's registers: a G1 point (K2, K3), or one lane's Fq2 component of
// each coordinate of a G2 point (g2.cu).  Row i of each coordinate array.
struct Pt {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void load_pt(Pt& p, const int32_t* x, const int32_t* y,
                                        const int32_t* z, long long i) {
  load_elem(x + i * 16, p.x);
  load_elem(y + i * 16, p.y);
  load_elem(z + i * 16, p.z);
}

__device__ __forceinline__ void store_pt(const Pt& p, int32_t* x, int32_t* y,
                                         int32_t* z, long long i) {
  store_elem(x + i * 16, p.x);
  store_elem(y + i * 16, p.y);
  store_elem(z + i * 16, p.z);
}

// r = t - p if (hi != 0 or t >= p) else t;  t < 2p
__device__ __forceinline__ void final_sub(uint32_t r[8], const uint32_t t[8],
                                          uint32_t hi, const FieldConsts& F) {
  uint32_t d[8];
  unsigned long long borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned long long s =
        static_cast<unsigned long long>(t[j]) - F.p[j] - borrow;
    d[j] = static_cast<uint32_t>(s);
    borrow = s >> 63;
  }
  const bool take = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = take ? d[j] : t[j];
}

// r = a·b·2^-256 mod p
__device__ __forceinline__ void fmul(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8], const FieldConsts& F) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned long long c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (2^32-1)^2 + 2·(2^32-1) = 2^64 - 1: never overflows
      const unsigned long long s =
          static_cast<unsigned long long>(a[i]) * b[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    unsigned long long s = static_cast<unsigned long long>(t[8]) + c;
    t[8] = static_cast<uint32_t>(s);
    t[9] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * F.n0;
    s = static_cast<unsigned long long>(m) * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = static_cast<unsigned long long>(m) * F.p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<unsigned long long>(t[8]) + c;
    t[7] = static_cast<uint32_t>(s);
    t[8] = t[9] + static_cast<uint32_t>(s >> 32);
  }
  final_sub(r, t, t[8], F);  // t < 2p
}

__device__ __forceinline__ void fadd(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8], const FieldConsts& F) {
  uint32_t s[8];
  unsigned long long c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned long long v = static_cast<unsigned long long>(a[j]) + b[j] + c;
    s[j] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  final_sub(r, s, static_cast<uint32_t>(c), F);
}

__device__ __forceinline__ void fsub(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8], const FieldConsts& F) {
  uint32_t d[8];
  unsigned long long borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned long long v =
        static_cast<unsigned long long>(a[j]) - b[j] - borrow;
    d[j] = static_cast<uint32_t>(v);
    borrow = v >> 63;
  }
  // a < b: add p back (mod 2^256)
  const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  unsigned long long c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned long long v =
        static_cast<unsigned long long>(d[j]) + (F.p[j] & mask) + c;
    r[j] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
}

// ---------------------------------------------------------------------------
// Lazy Montgomery arithmetic on carry chains (K2, K3, K4, K6, K7, g2.cu)
//
// BN254's Fr and Fq moduli are both below 2^254, so 4p < R = 2^256.  For a, b < 2p, Montgomery's
// (ab + mp)/R with m < R is < 4p²/R + p < 2p: a product of two values in
// [0, 2p) lands in [0, 2p) without a final subtraction.  fadd_lazy keeps a
// sum in [0, 2p) by one conditional subtraction of 2p, and fcanon maps
// [0, 2p) to [0, p) once, where a result is stored.
//
// The word loop runs on PTX carry chains (mad.lo.cc / madc.hi.cc /
// addc.cc): each 32×32 product's low word and high word are added into the
// accumulator by two instructions linked through the hardware carry flag,
// so no 64-bit sum and no separate carry word is formed.  Products of
// even-indexed words go into one row and of odd-indexed words into another
// row offset by one word, so the low and high halves of neighbouring
// products never meet in one chain.  This even/odd-row technique is that
// of supranational's sppark `mont_t` (Apache-2.0); the code here is
// written for this package.  Each helper below is one instruction, and the
// helpers are `asm volatile` so that the compiler keeps a chain's
// instructions in order; where a chain drops its last carry, the comment
// says why that carry is 0.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc = (a[0]·b, a[2]·b, a[4]·b, a[6]·b) as lo/hi word pairs
__device__ __forceinline__ void mul_row(uint32_t acc[8], const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    acc[j] = mul_lo(a[j], b);
    acc[j + 1] = mul_hi(a[j], b);
  }
}

// acc += (a[0]·b, a[2]·b, a[4]·b, a[6]·b); the carry out is left in the flag
__device__ __forceinline__ void cmad_row(uint32_t acc[8], const uint32_t* a, uint32_t b) {
  acc[0] = mad_lo_cc(a[0], b, acc[0]);
  acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
  }
}

// odd = (odd >> 2 words) + (a[0]·b, a[2]·b, a[4]·b, a[6]·b) + the carry in
// the flag; the carry out is 0 (see mad_redc_step)
__device__ __forceinline__ void madc_row_rshift(uint32_t odd[8], const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < 6; j += 2) {
    odd[j] = madc_lo_cc(a[j], b, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(a[j], b, odd[j + 3]);
  }
  odd[6] = madc_lo_cc(a[6], b, 0);
  odd[7] = madc_hi(a[6], b, 0);
}

// One CIOS step on the split accumulator T = even + 2^32·odd, where `even`
// holds words 0..7 and `odd` words 1..8.  On entry (after the previous
// step) T is a multiple of 2^32 with the roles of the two rows swapped, so
// T/2^32 is the old row `odd` shifted down two words plus the old word
// even[1]; this step forms T/2^32 + a·b_i + m·p with m = T[0]·n0, leaving
// even[0] = 0.  Every partial value of the odd row is at most T/2^32 <
// a + p < 2^256 (the usual CIOS invariant, T < 2^32·(a + p)), so the
// chains over it never carry out of word 8.
__device__ __forceinline__ void mad_redc_step(uint32_t even[8], uint32_t odd[8],
                                              const uint32_t a[8], uint32_t bi,
                                              bool first, const FieldConsts& F) {
  if (first) {
    mul_row(odd, a + 1, bi);
    mul_row(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    madc_row_rshift(odd, a + 1, bi);
    cmad_row(even, a, bi);
    odd[7] = addc(odd[7], 0);
  }
  const uint32_t m = even[0] * F.n0;
  cmad_row(odd, F.p + 1, m);   // carry out 0, as above
  cmad_row(even, F.p, m);
  odd[7] = addc(odd[7], 0);
}

// r = a·b·2^-256 mod p, lazy: a, b < 2p -> r < 2p (r may alias a or b)
__device__ __forceinline__ void fmul_lazy(uint32_t r[8], const uint32_t a[8],
                                          const uint32_t b[8], const FieldConsts& F) {
  uint32_t even[8], odd[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mad_redc_step(even, odd, a, b[i], i == 0, F);
    mad_redc_step(odd, even, a, b[i + 1], false, F);
  }
  // T = odd + 2^32·even with odd[0] = 0: T/2^32 = even + (odd >> 1 word)
  r[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc(even[j], odd[j + 1]);
  r[7] = addc(even[7], 0);
}

// acc[pos..] += a[i]·a[j] for j = j0, j0 + 2, ... <= 7, lo at word i + j;
// the carry lands in the word above the run, which holds at most the carry
// bits of earlier runs, so it carries no further
__device__ __forceinline__ void sqr_run(uint32_t acc[16], const uint32_t a[8], int i, int j0) {
  int pos = i + j0;
  acc[pos] = mad_lo_cc(a[i], a[j0], acc[pos]);
  acc[pos + 1] = madc_hi_cc(a[i], a[j0], acc[pos + 1]);
#pragma unroll
  for (int j = j0 + 2; j < 8; j += 2) {
    pos = i + j;
    acc[pos] = madc_lo_cc(a[i], a[j], acc[pos]);
    acc[pos + 1] = madc_hi_cc(a[i], a[j], acc[pos + 1]);
  }
  acc[pos + 2] = addc(acc[pos + 2], 0);
}

// r = a²·2^-256 mod p, lazy: a < 2p -> r < 2p (r may alias a).
// The 512-bit square S is formed from its 28 cross products (once, in an
// even-position and an odd-position row), doubled, plus the 8 squares:
// 36 word products instead of 64.  Then r = REDC(S mod R) + S / R:
// REDC(S mod R) = (S mod R + m·p)/R <= p and S / R < 4p²/R < p, so r < 2p.
__device__ __forceinline__ void fsqr_lazy(uint32_t r[8], const uint32_t a[8],
                                          const FieldConsts& F) {
  uint32_t ev[16], od[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) ev[k] = od[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    sqr_run(od, a, i, i + 1);                 // i + j odd
    if (i + 2 < 8) sqr_run(ev, a, i, i + 2);  // i + j even
  }
  // S = 2·(ev + od) + squares; od[0] = ev[0] = 0, and S < 2^512
  ev[1] = add_cc(ev[1], od[1]);
#pragma unroll
  for (int k = 2; k < 16; ++k) ev[k] = addc_cc(ev[k], od[k]);
  ev[1] = add_cc(ev[1], ev[1]);
#pragma unroll
  for (int k = 2; k < 16; ++k) ev[k] = addc_cc(ev[k], ev[k]);
  ev[0] = mad_lo_cc(a[0], a[0], 0);
  ev[1] = madc_hi_cc(a[0], a[0], ev[1]);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    ev[2 * i] = madc_lo_cc(a[i], a[i], ev[2 * i]);
    ev[2 * i + 1] = madc_hi_cc(a[i], a[i], ev[2 * i + 1]);
  }
  ev[14] = madc_lo_cc(a[7], a[7], ev[14]);
  ev[15] = madc_hi(a[7], a[7], ev[15]);
  // REDC of the low half: 8 steps of t = (t + m·p)/2^32, t < 2^256 throughout
  uint32_t* t = ev;
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = t[0] * F.n0;
    mul_row(o, F.p + 1, m);
    cmad_row(t, F.p, m);
    o[7] = addc(o[7], 0);
    t[0] = add_cc(t[1], o[0]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j] = addc_cc(t[j + 1], o[j]);
    t[7] = addc(o[7], 0);
  }
  r[0] = add_cc(t[0], ev[8]);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc(t[j], ev[8 + j]);
  r[7] = addc(t[7], ev[15]);
}

// r = a + b, lazy: a, b < 2p -> r < 2p (a + b < 4p < 2^256 never carries out)
__device__ __forceinline__ void fadd_lazy(uint32_t r[8], const uint32_t a[8],
                                          const uint32_t b[8], const FieldConsts& F) {
  uint32_t s[8], d[8];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j) s[j] = addc_cc(a[j], b[j]);
  s[7] = addc(a[7], b[7]);
  d[0] = sub_cc(s[0], F.p2[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(s[j], F.p2[j]);
  const uint32_t borrow = subc(0, 0);   // 0xFFFFFFFF when s < 2p
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = borrow ? s[j] : d[j];
}

// r = a − b, lazy: a, b < 2p -> r < 2p.  When a < b the difference wraps
// below 0 and 2p is added back: a − b + 2p lies in (0, 2p), and the carry
// out of 2^256 that the wrap borrowed is dropped.
__device__ __forceinline__ void fsub_lazy(uint32_t r[8], const uint32_t a[8],
                                          const uint32_t b[8], const FieldConsts& F) {
  uint32_t d[8];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t borrow = subc(0, 0);   // 0xFFFFFFFF when a < b
  r[0] = add_cc(d[0], F.p2[0] & borrow);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc(d[j], F.p2[j] & borrow);
  r[7] = addc(d[7], F.p2[7] & borrow);
}

// r = 9·x, lazy: x < 2p -> r < 2p.  9·2p exceeds 2^256, so it is three
// doublings and an add, each brought back below 2p (b3 = 9 on BN254 G1)
__device__ __forceinline__ void fmul9_lazy(uint32_t r[8], const uint32_t x[8],
                                           const FieldConsts& F) {
  uint32_t t[8];
  fadd_lazy(t, x, x, F);
  fadd_lazy(t, t, t, F);
  fadd_lazy(t, t, t, F);
  fadd_lazy(r, t, x, F);
}

// r = a mod p for a < 2p: the canonical value
__device__ __forceinline__ void fcanon(uint32_t r[8], const uint32_t a[8], const FieldConsts& F) {
  uint32_t d[8];
  d[0] = sub_cc(a[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], F.p[j]);
  const uint32_t borrow = subc(0, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = borrow ? a[j] : d[j];
}
