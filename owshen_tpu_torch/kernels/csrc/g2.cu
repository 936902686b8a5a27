// K1's G2 point operations: complete projective addition and doubling on
// BN254 G2 (y² = x³ + b' over Fq2 = Fq[u]/(u² + 1), b' = 3/(9 + u)), two
// threads per point.
//
// Replaces the Fq2 arithmetic of the JAX package's G2 add and double
// (owshen_tpu/curves/weierstrass.py Weierstrass.add / .double over
// owshen_tpu/fields/fq2.py), which XLA fuses inside one jit: Renes–
// Costello–Batina 2015 algorithms 7 and 9 for a = 0, with b3 = 3·b' an Fq2
// constant, with the JAX package's operations (the add forms its input sums
// earlier, see g2_add_lazy).  The formulas are complete, so the identity
// (0 : 1 : 0), P + P and P + (−P) need no branch.
//
// What bounds it on an H100: an add reads 12 and writes 6 rows of 64 B and
// does, at the least, 42 Fq products and 106 adds (Karatsuba); a double 12
// rows, 25 products and 58 adds (Karatsuba, and its two squares Y², Z² as
// (a0 + a1)(a0 − a1) and 2·a0a1).  The operations bound both at every
// width (chip_smoke.py computes both bounds).  At the fixed-table build's
// 8192 points the grid holds about one warp per scheduler, so there the
// chain of a lane's 28 dependent products sets the time, not the rate.
//
// Two lanes per point.  Lane c (c = threadIdx.x & 1) holds component c of
// every Fq2 value: the inputs, the temporaries and the outputs.  A G2
// coordinate is stored as int32[N, 2, 16], so thread t loads and stores
// row t of each coordinate array and a warp's loads are contiguous.
//  - Fq2 adds and subtracts are componentwise: each lane does its own, with
//    no exchange.
//  - An Fq2 product a·b is schoolbook.  Each lane takes the other lane's
//    component of a and of b with one __shfl_xor_sync(·, 1) per word; lane 0
//    then forms a0·b0 − a1·b1 and lane 1 a1·b0 + a0·b1.  In both lanes that
//    is own(a)·b0 ∓ other(a)·b1: two lazy products, and fsub_lazy on lane 0
//    or fadd_lazy on lane 1 (both are formed and one is selected, so the
//    warp stays converged).
//  - The product by b3 is own·b3_0 ∓ other·b3_1, two products by constant
//    words (kB3, uploaded by g2_consts_upload).
// Why two lanes: one thread per point would hold two Fq2 points (96 words)
// and their temporaries, where K2 already needs 126 registers for Fq; and at
// the fixed-table build's width (8192 points) one thread per point gives 64
// blocks of 128 threads for 132 SMs.  Two lanes halve the live state per
// thread and double the threads, and their exchange is a pair shuffle.  The
// cost is four Fq products per Fq2 product against Karatsuba's three (the
// bound in chip_smoke.py counts Karatsuba's, the least work).
//
// Arithmetic: field.cuh's lazy section over Fq.  Every value stays in
// [0, 2q): a product of two such values lands there, and every sum or
// difference is brought back below 2q (fadd_lazy, fsub_lazy) before it
// enters a product; the ×3 of three_t0, the 8·Y² and the 3·b3·Z² of the
// double are chains of fadd_lazy.  Each stored coordinate is made canonical
// once (fcanon), so it equals, limb for limb, the value of the canonical
// plain twin (kernels/g2.py).
//
// Any N: the grid has 2N threads rounded up to whole blocks (kThreads is
// even, so a pair never straddles a warp).  A thread past the end runs on a
// dummy point (row 0 or 1) and stores nothing, so every shuffle sees a
// converged warp.
//
// g2_scalar_mul, the ladder: k·P for a scalar k per point, all n_bits steps
// of the double-and-add ladder in one launch, MSB first, on the same two
// lanes a point and the same g2_dbl_lazy and g2_add_lazy, which hand each
// result coordinate to a sink: the add and double kernels store it (Out),
// the ladder keeps it in registers (Keep).  It replaces no Pallas kernel:
// the reference's ladder (owshen_tpu/curves/weierstrass.py scalar_mul) is a
// loop of G2 adds and doubles, and so was the port's, 2·254 launches a
// ladder.  Every step does the double and the add, the addend selected as
// bit ? P : identity (0 : 1 : 0) with no branch, so the time does not
// depend on the scalar (the Groth16 randomizer s).  The proofs launch it
// over one point: two threads, whose chain of a step's 23 Fq2 products
// (two lazy Fq products each, back to back in a lane) sets the time; two
// lanes halve that chain against one thread a point.
#include "field.cuh"

__constant__ uint32_t kB3[2][8];  // b3 = 3·b' in Montgomery form: c0, c1

extern "C" int g2_consts_upload(const uint32_t* words) {
  // words: 8 words of mont(b3_0), then 8 of mont(b3_1)
  cudaMemcpyToSymbol(kB3, words, sizeof(kB3));
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr unsigned kWarp = 0xFFFFFFFFu;  // every lane of the warp takes part

// o = the other lane's a (the pair's other Fq2 component)
__device__ __forceinline__ void other_half(uint32_t o[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __shfl_xor_sync(kWarp, a[j], 1);
}

// r = u − v on lane 0, u + v on lane 1 (r may alias u or v)
__device__ __forceinline__ void sub_add(uint32_t r[8], const uint32_t u[8], const uint32_t v[8],
                                        bool odd, const FieldConsts& F) {
  uint32_t s[8], d[8];
  fadd_lazy(s, u, v, F);
  fsub_lazy(d, u, v, F);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = odd ? s[j] : d[j];
}

// r = a·b over Fq2, this lane's component (r may alias a or b).  The
// other lane's a is fetched after the first product, so that it is not
// live during it
__device__ __forceinline__ void f2mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                      bool odd, const FieldConsts& F) {
  uint32_t b0[8], b1[8], u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t o = __shfl_xor_sync(kWarp, b[j], 1);
    b0[j] = odd ? o : b[j];
    b1[j] = odd ? b[j] : o;
  }
  fmul_lazy(u, a, b0, F);      // a0·b0 on lane 0, a1·b0 on lane 1
  other_half(b0, a);
  fmul_lazy(b0, b0, b1, F);    // a1·b1 on lane 0, a0·b1 on lane 1
  sub_add(r, u, b0, odd, F);
}

// r = b3·a over Fq2, this lane's component
__device__ __forceinline__ void f2mul_b3(uint32_t r[8], const uint32_t a[8], bool odd,
                                         const FieldConsts& F) {
  uint32_t u[8], v[8];
  fmul_lazy(u, a, kB3[0], F);   // a0·b3_0 on lane 0, a1·b3_0 on lane 1
  other_half(v, a);
  fmul_lazy(v, v, kB3[1], F);   // a1·b3_1 on lane 0, a0·b3_1 on lane 1
  sub_add(r, u, v, odd, F);
}

// Where a thread's results go: row i of each output array, stored only by
// a live thread.  Each coordinate (c = 0, 1, 2 for X, Y, Z) is made
// canonical and stored as soon as it is known, so that it holds no
// registers through the rest
struct Out {
  int32_t *x, *y, *z;
  long long i;
  bool live;

  __device__ __forceinline__ void put(int c, uint32_t v[8], const FieldConsts& F) const {
    fcanon(v, v, F);
    if (live) store_elem((c == 0 ? x : c == 1 ? y : z) + i * 16, v);
  }
};

// The ladder's sink: coordinate c is copied, lazy, into a point in registers
struct Keep {
  Pt& r;

  __device__ __forceinline__ void put(int c, const uint32_t v[8], const FieldConsts&) const {
    uint32_t* const dst = c == 0 ? r.x : c == 1 ? r.y : r.z;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = v[j];
  }
};

// RCB15 algorithm 7 (a = 0), the operations of
// owshen_tpu/curves/weierstrass.py Weierstrass.add in its order, except
// that the six sums X1 + Y1, … of the inputs are all formed right after
// t0, t1, t2, so that the inputs are dead before the next products.
// Inputs and every value below 2q.  p and q are read before the first
// result is put, so the sink may write over them
template <class Sink>
__device__ __forceinline__ void g2_add_lazy(const Sink& o, const Pt& p, const Pt& q, bool odd,
                                            const FieldConsts& F) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], u[8], v[8];
  f2mul(t0, p.x, q.x, odd, F);
  f2mul(t1, p.y, q.y, odd, F);
  f2mul(t2, p.z, q.z, odd, F);
  uint32_t sxy1[8], sxy2[8], syz1[8], syz2[8], sxz1[8], sxz2[8];
  fadd_lazy(sxy1, p.x, p.y, F);
  fadd_lazy(sxy2, q.x, q.y, F);
  fadd_lazy(syz1, p.y, p.z, F);
  fadd_lazy(syz2, q.y, q.z, F);
  fadd_lazy(sxz1, p.x, p.z, F);
  fadd_lazy(sxz2, q.x, q.z, F);
  f2mul(t3, sxy1, sxy2, odd, F);
  fadd_lazy(u, t0, t1, F);
  fsub_lazy(t3, t3, u, F);  // X1Y2 + X2Y1
  f2mul(t4, syz1, syz2, odd, F);
  fadd_lazy(u, t1, t2, F);
  fsub_lazy(t4, t4, u, F);  // Y1Z2 + Y2Z1
  f2mul(t5, sxz1, sxz2, odd, F);
  fadd_lazy(u, t0, t2, F);
  fsub_lazy(t5, t5, u, F);  // X1Z2 + X2Z1
  uint32_t three_t0[8], t2b[8], z3[8], t1b[8], y3[8];
  fadd_lazy(three_t0, t0, t0, F);
  fadd_lazy(three_t0, three_t0, t0, F);
  f2mul_b3(t2b, t2, odd, F);
  fadd_lazy(z3, t1, t2b, F);
  fsub_lazy(t1b, t1, t2b, F);
  f2mul_b3(y3, t5, odd, F);
  f2mul(u, t3, t1b, odd, F);
  f2mul(v, t4, y3, odd, F);
  fsub_lazy(u, u, v, F);
  o.put(0, u, F);
  f2mul(u, y3, three_t0, odd, F);
  f2mul(v, t1b, z3, odd, F);
  fadd_lazy(u, u, v, F);
  o.put(1, u, F);
  f2mul(u, z3, t4, odd, F);
  f2mul(v, three_t0, t3, odd, F);
  fadd_lazy(u, u, v, F);
  o.put(2, u, F);
}

// RCB15 algorithm 9 (a = 0), the operation order of Weierstrass.double.
// p is read after Z3 and Y3 are put: the sink must not write over it
template <class Sink>
__device__ __forceinline__ void g2_dbl_lazy(const Sink& o, const Pt& p, bool odd,
                                            const FieldConsts& F) {
  uint32_t t0[8], t1[8], t2[8], z3[8], x3[8], y3[8], u[8];
  f2mul(t0, p.y, p.y, odd, F);
  fadd_lazy(z3, t0, t0, F);
  fadd_lazy(z3, z3, z3, F);
  fadd_lazy(z3, z3, z3, F);  // 8Y²
  f2mul(t1, p.y, p.z, odd, F);
  f2mul(u, p.z, p.z, odd, F);
  f2mul_b3(t2, u, odd, F);
  f2mul(x3, t2, z3, odd, F);
  fadd_lazy(y3, t0, t2, F);
  f2mul(u, t1, z3, odd, F);
  o.put(2, u, F);
  fadd_lazy(t1, t2, t2, F);
  fadd_lazy(t2, t1, t2, F);  // 3·b3·Z²
  fsub_lazy(t0, t0, t2, F);
  f2mul(u, t0, y3, odd, F);
  fadd_lazy(u, x3, u, F);
  o.put(1, u, F);
  f2mul(t1, p.x, p.y, odd, F);
  f2mul(x3, t0, t1, odd, F);
  fadd_lazy(x3, x3, x3, F);
  o.put(0, x3, F);
}

// Registers: ptxas gives the add 164 under a cap of 168 (three blocks of
// kThreads on an SM) and the double 116 under 128 (four blocks), with no
// spills, once each coordinate is stored as soon as it is known (Out).
// Uncapped, ptxas interleaves the independent products and takes more than
// three blocks an SM allow.
constexpr int kThreads = 128;  // even: the two lanes of a point share a warp
constexpr int kAddMinBlocks = 3;
constexpr int kDblMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kAddMinBlocks)
g2_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
              const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz, long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < rows;
  const long long row = live ? i : (i & 1);   // a dummy point past the end
  const bool odd = threadIdx.x & 1;
  const FieldConsts& F = kField[1];
  Pt p, q;
  load_pt(p, x1, y1, z1, row);
  load_pt(q, x2, y2, z2, row);
  g2_add_lazy(Out{ox, oy, oz, i, live}, p, q, odd, F);
}

__global__ void __launch_bounds__(kThreads, kDblMinBlocks)
g2_dbl_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
              const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < rows;
  const long long row = live ? i : (i & 1);
  const bool odd = threadIdx.x & 1;
  const FieldConsts& F = kField[1];
  Pt p;
  load_pt(p, x1, y1, z1, row);
  g2_dbl_lazy(Out{ox, oy, oz, i, live}, p, odd, F);
}

// R mod q (Montgomery 1) as a lazy value: 2^256 − 4q, which lies in
// [q, 2q) (5q < 2^256 < 6q)
__device__ __forceinline__ void mont_one_lazy(uint32_t r[8], const FieldConsts& F) {
  unsigned long long c = 1;         // −x = ~x + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t four_q = (F.p2[j] << 1) | (j ? F.p2[j - 1] >> 31 : 0u);
    c += static_cast<uint32_t>(~four_q);
    r[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// acc = Σ bit_i·2^i·P over i < n_bits, bit i of the point's scalar k (16
// canonical 16-bit limbs), from the identity (0 : 1 : 0); rows = 2·points.
// Registers: no cap, as the launch is one or a few points
__global__ void __launch_bounds__(kThreads)
g2_ladder_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, const int32_t* __restrict__ k,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 long long rows, int n_bits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < rows;
  const long long row = live ? i : (i & 1);   // a dummy point past the end
  const bool odd = threadIdx.x & 1;
  const FieldConsts& F = kField[1];
  Pt base, acc, dbl, addend;
  load_pt(base, x, y, z, row);
  uint32_t one[8];                  // this lane's component of Fq2's 1
  mont_one_lazy(one, F);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    one[j] = odd ? 0u : one[j];
    acc.x[j] = acc.z[j] = 0;
    acc.y[j] = one[j];
  }
  const int32_t* limbs = k + (row >> 1) * 16;   // both lanes read the point's scalar
  for (int bit = n_bits - 1; bit >= 0; --bit) {
    g2_dbl_lazy(Keep{dbl}, acc, odd, F);
    const bool set = (__ldg(limbs + (bit >> 4)) >> (bit & 15)) & 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      addend.x[j] = set ? base.x[j] : 0u;
      addend.y[j] = set ? base.y[j] : one[j];
      addend.z[j] = set ? base.z[j] : 0u;
    }
    g2_add_lazy(Keep{acc}, dbl, addend, odd, F);
  }
  const Out o{ox, oy, oz, i, live};
  o.put(0, acc.x, F);
  o.put(1, acc.y, F);
  o.put(2, acc.z, F);
}

unsigned int n_blocks(long long rows) {
  return static_cast<unsigned int>((rows + kThreads - 1) / kThreads);
}

}  // namespace

// n: points; each coordinate array holds 2n rows (c0, c1 of each point)
extern "C" int g2_add_launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                             const int32_t* x2, const int32_t* y2, const int32_t* z2,
                             int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  g2_add_kernel<<<n_blocks(2 * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, 2 * n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g2_double_launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                                int32_t* ox, int32_t* oy, int32_t* oz, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  g2_dbl_kernel<<<n_blocks(2 * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, ox, oy, oz, 2 * n);
  return static_cast<int>(cudaGetLastError());
}

// n: points, k: int32[n, 16] canonical scalars
extern "C" int g2_scalar_mul_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                                    const int32_t* k, int32_t* ox, int32_t* oy, int32_t* oz,
                                    long long n, int n_bits, void* stream) {
  if (n <= 0) return 0;
  if (n_bits < 0 || n_bits > 256) return static_cast<int>(cudaErrorInvalidValue);
  g2_ladder_kernel<<<n_blocks(2 * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, k, ox, oy, oz, 2 * n, n_bits);
  return static_cast<int>(cudaGetLastError());
}
