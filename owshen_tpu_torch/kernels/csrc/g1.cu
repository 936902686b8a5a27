// K2 / K3: complete projective addition and doubling on BN254 G1
// (y² = x³ + 3 over Fq): one thread per point for the add, four for the
// double.
//
// Replaces owshen_tpu/pallas/field_kernels.py `g1_add_pallas`
// (`_g1_add_kernel` → `_wadd_lm`) and `g1_double_pallas`
// (`_g1_dbl_kernel` → `_wdbl_lm`): Renes–Costello–Batina 2015 algorithms 7
// and 9 for a = 0, with b3 = 3·b = 9.  The formulas are complete, so the
// identity (0 : 1 : 0), P + P and P + (−P) need no branch.
//
// What bounds it on an H100: an add reads 6 × 64 B and writes 3 × 64 B and
// does 12 Montgomery products (3072 32-bit multiply-adds), 19 modular
// adds/subtracts and two multiplications by 9; a double does 8 products
// for 6 × 64 B.  About five multiply-adds per byte, near the card's balance
// point for 32-bit integer work: at the fold's 81,920 rows the operations
// bound it, just above the bytes.  chip_smoke.py computes both bounds and
// prints the larger.
//
// K2's design spends as few instructions as it can on that rate: the add
// runs on field.cuh's lazy arithmetic (fmul_lazy, fadd_lazy, fsub_lazy,
// fmul9_lazy on carry chains), so every value stays in [0, 2q) with no
// final subtraction per operation (Fq's 4q < 2^256, as for Fr), and each
// output coordinate is made canonical once, at the store (fcanon): the
// stored point equals the canonical twin's bit for bit.  The whole point
// and every temporary live in one thread's registers (no shared memory,
// no synchronisation), the tail is masked so any N works, and the
// multiplication by b3 is three doublings and an add.  __launch_bounds__
// caps the registers at 128 (ptxas uses 126, no spills), so four blocks of
// kThreads share an SM and 81,920 rows take two waves; a cap of 96 (five
// blocks, one wave) made ptxas spill 28 bytes and ran no faster at 81,920
// rows.  There the loads, the arithmetic and the stores of a wave hardly
// overlap, so the time is near the bytes' bound plus the operations'.
//
// K3, the double, runs RCB15 algorithm 9 on the same lazy arithmetic with
// four threads (lanes) per point, so that its 8 products form a chain of 2:
// one thread per point ran all 8 back to back, and at the fixed-table
// build's 8192 points its 64 blocks left most of the 132 SMs idle with one
// warp a scheduler, so one thread's latency set the time.  Lane l of a
// point (l = threadIdx.x & 3):
//  - round 1: lane 0 forms Y², lane 1 Z², lane 2 t1 = Y·Z, lane 3 X·Y;
//  - exchange: Y² and Z² go to every lane of the point (__shfl_sync, 16
//    words); lanes 2 and 3 keep their own product;
//  - every lane forms the cheap adds z3 = 8·Y², t2 = 9·Z², y3 = Y² + t2
//    and t0 = Y² − 3·t2 (the same values in all four);
//  - round 2: lane 0 forms t2·z3, lane 1 t0·y3, lane 2 Z3 = t1·z3, lane 3
//    t0·XY;
//  - lane 1 takes lane 0's product (__shfl_up_sync, 8 words) and stores
//    Y3 = t2·z3 + t0·y3, lane 2 stores Z3 and lane 3 X3 = 2·(t0·XY), each
//    made canonical once (fcanon).
// All four lanes run fmul_lazy on operands they select, so the warp runs
// one instruction stream: a lane that squared with fsqr_lazy while the
// others multiplied would make the warp run both.  A thread past the end
// runs row 0 and stores nothing, so every shuffle sees a full warp (any N).
// A two-lane form (lane 0: Y², Z², then t2·z3 and t0·y3; lane 1: Y·Z, X·Y,
// then Z3 and t0·XY) was slower at the fixed-table build's 8192 points on
// the H100 (PERF.md §6) and was not kept.
//
// g1_scalar_mul, the ladder: k·P for a scalar k per lane, all n_bits steps
// of the double-and-add ladder in one launch, MSB first.  It replaces no
// Pallas kernel: the reference's ladder (owshen_tpu/curves/weierstrass.py
// scalar_mul) is a loop of K2 and K3 steps, and so was the port's, 2·254
// launches a ladder, each moving the accumulator through device memory.
// Here the accumulator and the base stay in registers for every step.
// Every step does the double and the add, the addend selected as
// bit ? P : identity (0 : 1 : 0) with no branch, so the kernel's time does
// not depend on the scalars (the Groth16 randomizers r and s).
//
// What bounds it: the proofs launch it over 4 or 5 lanes, too few threads
// for the card, and a lane's 254 steps are a chain of 20 products each,
// so the chain's latency sets the time, not the rate.  So four threads run
// a point (K3's layout), holding the same values: each group of
// independent products is spread over them, one product a thread, and the
// results are broadcast to the four with __shfl_sync.  The double is K3's
// two rounds of four (dbl_adds between them); the add, RCB15 algorithm 7 as
// K2 forms it, takes its 12 products in three rounds of four:
//  - X1X2, Y1Y2, Z1Z2, (X1 + Y1)(X2 + Y2);
//  - (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2), t1b·z3, 3t0·t3 (the last two
//    need only the first round);
//  - t3·t1b, t4·y3, y3·3t0, z3·t4.
// A step is then a chain of 5 products where one thread a point waits on
// 20.  The identity's Y, Montgomery 1, is formed from 2p (mont_one_lazy).
#include "field.cuh"

namespace {

// RCB15 algorithm 7 (a = 0), the operation order of
// owshen_tpu/curves/weierstrass.py Weierstrass.add, on the lazy arithmetic:
// inputs and every value below 2q; the caller makes the result canonical
__device__ __forceinline__ void g1_add_lazy(Pt& r, const Pt& p, const Pt& q,
                                            const FieldConsts& F) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], u[8], v[8];
  fmul_lazy(t0, p.x, q.x, F);
  fmul_lazy(t1, p.y, q.y, F);
  fmul_lazy(t2, p.z, q.z, F);
  fadd_lazy(u, p.x, p.y, F);
  fadd_lazy(v, q.x, q.y, F);
  fmul_lazy(t3, u, v, F);
  fadd_lazy(u, t0, t1, F);
  fsub_lazy(t3, t3, u, F);  // X1Y2 + X2Y1
  fadd_lazy(u, p.y, p.z, F);
  fadd_lazy(v, q.y, q.z, F);
  fmul_lazy(t4, u, v, F);
  fadd_lazy(u, t1, t2, F);
  fsub_lazy(t4, t4, u, F);  // Y1Z2 + Y2Z1
  fadd_lazy(u, p.x, p.z, F);
  fadd_lazy(v, q.x, q.z, F);
  fmul_lazy(t5, u, v, F);
  fadd_lazy(u, t0, t2, F);
  fsub_lazy(t5, t5, u, F);  // X1Z2 + X2Z1
  uint32_t three_t0[8], t2b[8], z3[8], t1b[8], y3[8];
  fadd_lazy(three_t0, t0, t0, F);
  fadd_lazy(three_t0, three_t0, t0, F);
  fmul9_lazy(t2b, t2, F);
  fadd_lazy(z3, t1, t2b, F);
  fsub_lazy(t1b, t1, t2b, F);
  fmul9_lazy(y3, t5, F);
  fmul_lazy(u, t3, t1b, F);
  fmul_lazy(v, t4, y3, F);
  fsub_lazy(r.x, u, v, F);
  fmul_lazy(u, y3, three_t0, F);
  fmul_lazy(v, t1b, z3, F);
  fadd_lazy(r.y, u, v, F);
  fmul_lazy(u, z3, t4, F);
  fmul_lazy(v, three_t0, t3, F);
  fadd_lazy(r.z, u, v, F);
}

constexpr int kThreads = 128;
constexpr int kAddMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kAddMinBlocks)
g1_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
              const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const FieldConsts& F = kField[1];
  Pt p, q, r;
  load_pt(p, x1, y1, z1, i);
  load_pt(q, x2, y2, z2, i);
  g1_add_lazy(r, p, q, F);
  fcanon(r.x, r.x, F);
  fcanon(r.y, r.y, F);
  fcanon(r.z, r.z, F);
  store_pt(r, ox, oy, oz, i);
}

constexpr int kDblLanes = 4;
constexpr unsigned kWarp = 0xFFFFFFFFu;  // every lane of the warp takes part

// r = v of lane `src` of this thread's point (its kDblLanes adjacent lanes)
__device__ __forceinline__ void from_lane(uint32_t r[8], const uint32_t v[8], int src) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = __shfl_sync(kWarp, v[j], src, kDblLanes);
}

// r = (lane ? b : a), word by word
__device__ __forceinline__ void pick(uint32_t r[8], bool lane, const uint32_t a[8],
                                     const uint32_t b[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = lane ? b[j] : a[j];
}

// RCB15 algorithm 9 (a = 0) between the two rounds of products, the
// operation order of Weierstrass.double: from t0 = Y² and zz = Z², z3 =
// 8·Y², t2 = b3·Z², y3 = Y² + t2 and t0 <- Y² − 3·t2
__device__ __forceinline__ void dbl_adds(uint32_t t0[8], const uint32_t zz[8], uint32_t z3[8],
                                         uint32_t t2[8], uint32_t y3[8], const FieldConsts& F) {
  uint32_t t3[8];
  fadd_lazy(z3, t0, t0, F);
  fadd_lazy(z3, z3, z3, F);
  fadd_lazy(z3, z3, z3, F);
  fmul9_lazy(t2, zz, F);
  fadd_lazy(y3, t0, t2, F);
  fadd_lazy(t3, t2, t2, F);
  fadd_lazy(t3, t3, t2, F);
  fsub_lazy(t0, t0, t3, F);
}

__global__ void __launch_bounds__(kThreads)
g1_dbl_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kDblLanes;
  const int lane = threadIdx.x & (kDblLanes - 1);
  const bool live = i < n;
  const long long row = (live ? i : 0) * 16;   // a dummy point past the end
  const FieldConsts& F = kField[1];
  uint32_t a[8], b[8], own[8], r[8], t0[8], zz[8], z3[8], t2[8], y3[8];
  load_elem((lane == 1 ? z1 : lane == 3 ? x1 : y1) + row, a);
  load_elem((lane == 1 || lane == 2 ? z1 : y1) + row, b);
  fmul_lazy(own, a, b, F);          // Y², Z², Y·Z, X·Y
  from_lane(t0, own, 0);
  from_lane(zz, own, 1);
  dbl_adds(t0, zz, z3, t2, y3, F);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = lane == 0 ? t2[j] : lane == 2 ? own[j] : t0[j];
    b[j] = lane == 1 ? y3[j] : lane == 3 ? own[j] : z3[j];
  }
  fmul_lazy(r, a, b, F);            // t2·z3, t0·y3, Z3 = t1·z3, t0·XY
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = __shfl_up_sync(kWarp, r[j], 1, kDblLanes);
  pick(b, lane == 1, r, b);
  fadd_lazy(a, b, r, F);            // lane 1: Y3; lane 3: X3
  pick(a, lane == 2, a, r);
  fcanon(a, a, F);
  int32_t* const dst = lane == 1 ? oy : lane == 2 ? oz : ox;
  if (live && lane != 0) store_elem(dst + i * 16, a);
}

unsigned int n_blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// The ladder: four threads a point, every value held by all four
// ---------------------------------------------------------------------------

// The threads of one point: `sub` is this thread's place among them and
// `mask` names them in its warp
struct Group {
  int sub;
  unsigned mask;
};

__device__ __forceinline__ Group group_of_thread() {
  const int lane = threadIdx.x & 31;
  const int first = lane - lane % kDblLanes;
  return Group{lane % kDblLanes, ((1u << kDblLanes) - 1) << first};
}

// r[k] = a[k]·b[k] for k < 4, every thread of the group ending with all
// four (r[k] must not alias any a or b): thread s forms product s and the
// results are broadcast from the four
__device__ __forceinline__ void products4(uint32_t* const (&r)[kDblLanes],
                                          const uint32_t* const (&a)[kDblLanes],
                                          const uint32_t* const (&b)[kDblLanes],
                                          const Group& g, const FieldConsts& F) {
  uint32_t x[8], y[8], t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = a[0][j];
    y[j] = b[0][j];
  }
#pragma unroll
  for (int k = 1; k < kDblLanes; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = g.sub == k ? a[k][j] : x[j];
      y[j] = g.sub == k ? b[k][j] : y[j];
    }
  }
  fmul_lazy(t, x, y, F);
#pragma unroll
  for (int k = 0; k < kDblLanes; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[k][j] = __shfl_sync(g.mask, t[j], k, kDblLanes);
  }
}

// r = 2·p (RCB15 algorithm 9, K3's two rounds), lazy; r must not alias p
__device__ __forceinline__ void g1_dbl_group(Pt& r, const Pt& p, const Group& g,
                                             const FieldConsts& F) {
  uint32_t t0[8], zz[8], t1[8], xy[8];
  products4({t0, zz, t1, xy}, {p.y, p.z, p.y, p.x}, {p.y, p.z, p.z, p.y}, g, F);
  uint32_t z3[8], t2[8], y3[8];
  dbl_adds(t0, zz, z3, t2, y3, F);
  uint32_t u[8], v[8], w[8];
  products4({u, v, r.z, w}, {t2, t0, t1, t0}, {z3, y3, z3, xy}, g, F);
  fadd_lazy(r.y, u, v, F);          // Y3 = t2·z3 + t0·y3
  fadd_lazy(r.x, w, w, F);          // X3 = 2·(t0·XY)
}

// r = p + q (RCB15 algorithm 7, K2's values) in three rounds of four
// products, lazy; r must not alias p or q
__device__ __forceinline__ void g1_add_group(Pt& r, const Pt& p, const Pt& q, const Group& g,
                                             const FieldConsts& F) {
  uint32_t sxy1[8], sxy2[8], t0[8], t1[8], t2[8], m[8];
  fadd_lazy(sxy1, p.x, p.y, F);
  fadd_lazy(sxy2, q.x, q.y, F);
  products4({t0, t1, t2, m}, {p.x, p.y, p.z, sxy1}, {q.x, q.y, q.z, sxy2}, g, F);
  uint32_t syz1[8], syz2[8], sxz1[8], sxz2[8], t3[8], u[8];
  fadd_lazy(syz1, p.y, p.z, F);
  fadd_lazy(syz2, q.y, q.z, F);
  fadd_lazy(sxz1, p.x, p.z, F);
  fadd_lazy(sxz2, q.x, q.z, F);
  fadd_lazy(u, t0, t1, F);
  fsub_lazy(t3, m, u, F);           // X1Y2 + X2Y1
  uint32_t three_t0[8], t2b[8], z3[8], t1b[8];
  fadd_lazy(three_t0, t0, t0, F);
  fadd_lazy(three_t0, three_t0, t0, F);
  fmul9_lazy(t2b, t2, F);
  fadd_lazy(z3, t1, t2b, F);
  fsub_lazy(t1b, t1, t2b, F);
  uint32_t m4[8], m5[8], u3[8], u5[8];
  products4({m4, m5, u3, u5}, {syz1, sxz1, t1b, three_t0}, {syz2, sxz2, z3, t3}, g, F);
  uint32_t t4[8], t5[8], y3[8];
  fadd_lazy(u, t1, t2, F);
  fsub_lazy(t4, m4, u, F);          // Y1Z2 + Y2Z1
  fadd_lazy(u, t0, t2, F);
  fsub_lazy(t5, m5, u, F);          // X1Z2 + X2Z1
  fmul9_lazy(y3, t5, F);
  uint32_t u0[8], u1[8], u2[8], u4[8];
  products4({u0, u1, u2, u4}, {t3, t4, y3, z3}, {t1b, y3, three_t0, t4}, g, F);
  fsub_lazy(r.x, u0, u1, F);        // t3·t1b − t4·y3
  fadd_lazy(r.y, u2, u3, F);        // y3·3t0 + t1b·z3
  fadd_lazy(r.z, u4, u5, F);        // z3·t4 + 3t0·t3
}

// R mod p (Montgomery 1) as a lazy value: 2^256 − 4p, which lies in
// [p, 2p) for BN254's moduli (5p < 2^256 < 6p)
__device__ __forceinline__ void mont_one_lazy(uint32_t r[8], const FieldConsts& F) {
  unsigned long long c = 1;         // −x = ~x + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t four_p = (F.p2[j] << 1) | (j ? F.p2[j - 1] >> 31 : 0u);
    c += static_cast<uint32_t>(~four_p);
    r[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// acc = Σ bit_i·2^i·P over i < n_bits, bit i of row i's scalar k (16
// canonical 16-bit limbs); acc starts at the identity (0 : 1 : 0).  Thread
// c < 3 of a point stores coordinate c, made canonical once
__global__ void __launch_bounds__(kThreads)
g1_ladder_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, const int32_t* __restrict__ k,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 long long rows, int n_bits) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kDblLanes;
  if (i >= rows) return;            // a point's threads leave together
  const Group g = group_of_thread();
  const FieldConsts& F = kField[1];
  Pt base, acc, dbl, addend;
  load_pt(base, x, y, z, i);
  uint32_t one[8];
  mont_one_lazy(one, F);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc.x[j] = acc.z[j] = 0;
    acc.y[j] = one[j];
  }
  const int32_t* limbs = k + i * 16;
  for (int bit = n_bits - 1; bit >= 0; --bit) {
    g1_dbl_group(dbl, acc, g, F);
    const bool set = (__ldg(limbs + (bit >> 4)) >> (bit & 15)) & 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      addend.x[j] = set ? base.x[j] : 0u;
      addend.y[j] = set ? base.y[j] : one[j];
      addend.z[j] = set ? base.z[j] : 0u;
    }
    g1_add_group(acc, dbl, addend, g, F);
  }
  uint32_t* const coord[3] = {acc.x, acc.y, acc.z};
  int32_t* const out[3] = {ox, oy, oz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (g.sub == c) {
      fcanon(coord[c], coord[c], F);
      store_elem(out[c] + i * 16, coord[c]);
    }
  }
}

}  // namespace

extern "C" int g1_add_launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                             const int32_t* x2, const int32_t* y2, const int32_t* z2,
                             int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  g1_add_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g1_double_launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                                int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  g1_dbl_kernel<<<n_blocks(kDblLanes * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, ox, oy, oz, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g1_scalar_mul_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                                    const int32_t* k, int32_t* ox, int32_t* oy, int32_t* oz,
                                    long long n, int n_bits, void* stream) {
  if (n <= 0) return 0;
  if (n_bits < 0 || n_bits > 256) return static_cast<int>(cudaErrorInvalidValue);
  g1_ladder_kernel<<<n_blocks(kDblLanes * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, k, ox, oy, oz, n, n_bits);
  return static_cast<int>(cudaGetLastError());
}
