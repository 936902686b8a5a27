// K1's BabyJubJub point operations: the complete projective twisted-Edwards
// add over BN254 Fr, and the double-and-add ladder with a scalar per lane,
// all of its steps in one launch.
//
// Replaces the K1-composed Edwards formulas of the JAX package, which XLA
// fuses on the TPU: owshen_tpu/curves/babyjubjub.py `add` (:63, reference
// mod.rs:118-142) and the `lax.scan` ladder of `scalar_mul` (:151, mod.rs:
// 68-78) with `double` (:82, mod.rs:152-163) in its body.  Composed from K1
// on the card, the ladder of a 4096-signature verify took 3,810 launches and
// ~7,600 stacks and selects, each moving every intermediate through device
// memory; here the accumulator and the base stay in registers for all steps.
//
// The formulas are the reference's, over a·x² + y² = 1 + d·x²·y², A = 168700,
// D = 168696 (complete on BabyJubJub: A is a square in Fr, D is not):
//   add:    a = Z1Z2, b = a², c = X1X2, d = Y1Y2, e = D·cd,
//           u = (X1 + Y1)(X2 + Y2), f = b − e, g = b + e,
//           X3 = a·f·(u − c − d), Y3 = a·g·(d − A·c), Z3 = f·g;
//   double: b = (X + Y)², c = X², d = Y², e = A·c, f = e + d, h = Z²,
//           j = f − 2h, X3 = (b − c − d)·j, Y3 = f·(e − d), Z3 = f·j.
// The add takes its products in another order, X3 = (a·(u − c − d))·f and
// Y3 = (a·(d − A·c))·g: the same field values, so that the products of a
// step that do not wait on each other fall into four groups (4, 4, 2, 3),
// where the reference's order gives five.  A and D are Montgomery constants
// here (kJub), so A·c and D·cd are full products.
//
// What bounds it on an H100: the least work takes A and D, both below 2^18,
// as one-word integers, so an add is 10 products, a square, 7 adds and 2
// products by a one-word constant, a double 3 products, 4 squares, 7 adds
// and one product by A (chip_smoke.py computes the bounds from these
// counts).  But 4096 lanes are too few threads to fill the card
// at one thread a lane (32 blocks of 128 for 132 SMs), and a lane's 254
// steps are a chain of ~5,300 dependent products, so at that width the
// chain's latency sets the time, not the rate.
//
// So four threads run a point.  They hold the same values; each group of
// independent products is spread over them, one product a thread, and each
// result is broadcast to the four with __shfl_sync (8 words a value); the
// adds are done by all four.  The chain is then 3 products a double (4
// squares; A·c; 3 products) and 4 an add (4; 4; 2; 3), where one thread a
// point would wait on 8 and 13, and 4096 lanes make 16,384 threads.  A form
// with one thread a point was 2.5× slower than this one at 4096 lanes on an
// H100 and 1.4× faster at 2^16 (PERF.md); the port's paths launch at most
// 8192 points, where this form is the faster.
//
// Arithmetic: field.cuh's lazy section over Fr.  Every value stays in
// [0, 2p): Fr's modulus is below 2^254, so a product of two such values
// lands there, and every sum or difference is brought back below 2p
// (fadd_lazy, fsub_lazy) before it enters a product; the ladder's
// accumulator stays lazy from step to step.  Each stored coordinate is made
// canonical once (fcanon), so it equals, limb for limb, the value of the
// canonical plain twin (kernels/jub.py).
//
// The ladder walks the scalar from bit n_bits − 1 down to bit 0, as the
// reference walks to_le_bits().rev() (mod.rs:71): acc = 2·acc, then
// acc = acc + P where the bit is set.  A lane whose bit is 0 skips the add,
// which the reference's select discards.  The four threads of a point share
// its bit, so a branch never splits them, and their shuffles name only
// their own four lanes.
#include "field.cuh"

__constant__ uint32_t kJub[3][8];  // Montgomery 1, A and D over Fr

extern "C" int jub_consts_upload(const uint32_t* words) {
  // words: 8 words each of mont(1), mont(A), mont(D)
  cudaMemcpyToSymbol(kJub, words, sizeof(kJub));
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kPointThreads = 4;
constexpr int kThreads = 128;

// The threads of one point: `sub` is this thread's place among them and
// `mask` names them in its warp
struct Group {
  int sub;
  unsigned mask;
};

__device__ __forceinline__ Group group_of_thread() {
  const int lane = threadIdx.x & 31;
  const int first = lane - lane % kPointThreads;
  return Group{lane % kPointThreads, ((1u << kPointThreads) - 1) << first};
}

// r[k] = a[k]·b[k] for k < N ≤ 4, every thread of the group ending with all
// N (r[k] must not alias any a or b): thread s forms product min(s, N − 1)
// and the results are broadcast from threads 0 … N − 1
template <int N>
__device__ __forceinline__ void products(uint32_t* const (&r)[N], const uint32_t* const (&a)[N],
                                         const uint32_t* const (&b)[N], const Group& g,
                                         const FieldConsts& F) {
  uint32_t x[8], y[8], t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = a[0][j];
    y[j] = b[0][j];
  }
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const bool mine = g.sub >= k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = mine ? a[k][j] : x[j];
      y[j] = mine ? b[k][j] : y[j];
    }
  }
  fmul_lazy(t, x, y, F);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[k][j] = __shfl_sync(g.mask, t[j], k, kPointThreads);
  }
}

// r[k] = a[k]² for the point's four threads, as `products`
__device__ __forceinline__ void squares(uint32_t* const (&r)[kPointThreads],
                                        const uint32_t* const (&a)[kPointThreads],
                                        const Group& g, const FieldConsts& F) {
  uint32_t x[8], t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = a[0][j];
#pragma unroll
  for (int k = 1; k < kPointThreads; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = g.sub == k ? a[k][j] : x[j];
  }
  fsqr_lazy(t, x, F);
#pragma unroll
  for (int k = 0; k < kPointThreads; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[k][j] = __shfl_sync(g.mask, t[j], k, kPointThreads);
  }
}

// r = p + q (mod.rs:118-142), lazy: every input and output below 2p.  r may
// alias p or q: they are read only before the last group of products
__device__ __forceinline__ void jub_add_lazy(Pt& r, const Pt& p, const Pt& q, const Group& g,
                                             const FieldConsts& F) {
  uint32_t s1[8], s2[8], a[8], c[8], d[8], u[8];
  fadd_lazy(s1, p.x, p.y, F);
  fadd_lazy(s2, q.x, q.y, F);
  products<4>({a, c, d, u}, {p.z, p.x, p.y, s1}, {q.z, q.x, q.y, s2}, g, F);
  uint32_t xp[8], b[8], cd[8], ac[8], axp[8];
  fadd_lazy(xp, c, d, F);
  fsub_lazy(xp, u, xp, F);                           // u − c − d
  products<4>({b, cd, ac, axp}, {a, c, c, a}, {a, d, kJub[1], xp}, g, F);
  uint32_t dac[8], e[8], adac[8];
  fsub_lazy(dac, d, ac, F);                          // d − A·c
  products<2>({e, adac}, {cd, a}, {kJub[2], dac}, g, F);
  uint32_t f[8], gg[8];
  fsub_lazy(f, b, e, F);
  fadd_lazy(gg, b, e, F);
  products<3>({r.x, r.y, r.z}, {axp, adac, f}, {f, gg, gg}, g, F);
}

// p = 2·p (mod.rs:152-163), lazy
__device__ __forceinline__ void jub_dbl_lazy(Pt& p, const Group& g, const FieldConsts& F) {
  uint32_t s[8], b[8], c[8], d[8], h[8];
  fadd_lazy(s, p.x, p.y, F);
  squares({b, c, d, h}, {s, p.x, p.y, p.z}, g, F);
  uint32_t e[8], f[8], j[8], t[8], u[8];
  fmul_lazy(e, c, kJub[1], F);                       // A·c, by every thread
  fadd_lazy(f, e, d, F);
  fadd_lazy(h, h, h, F);
  fsub_lazy(j, f, h, F);
  fsub_lazy(t, b, c, F);
  fsub_lazy(t, t, d, F);                             // b − c − d
  fsub_lazy(u, e, d, F);
  products<3>({p.x, p.y, p.z}, {t, f, f}, {j, u, j}, g, F);
}

// The point's coordinates, canonical: thread k of the point stores
// coordinate k
__device__ __forceinline__ void store_point(Pt& p, int32_t* ox, int32_t* oy, int32_t* oz,
                                            long long i, const Group& g, const FieldConsts& F) {
  uint32_t* const coord[3] = {p.x, p.y, p.z};
  int32_t* const out[3] = {ox, oy, oz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (g.sub == k) {
      fcanon(coord[k], coord[k], F);
      store_elem(out[k] + i * 16, coord[k]);
    }
  }
}

__device__ __forceinline__ long long point_of_thread() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kPointThreads;
}

__global__ void __launch_bounds__(kThreads)
jub_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long long rows) {
  const long long i = point_of_thread();
  if (i >= rows) return;       // a point's threads leave together
  const Group g = group_of_thread();
  const FieldConsts& F = kField[0];
  Pt p, q;
  load_pt(p, x1, y1, z1, i);
  load_pt(q, x2, y2, z2, i);
  jub_add_lazy(p, p, q, g, F);
  store_point(p, ox, oy, oz, i, g, F);
}

// acc = Σ bit_i·2^i·P over i < n_bits, bit i of row i's scalar k (16
// canonical 16-bit limbs); acc starts at the identity (0 : 1 : 1)
__global__ void __launch_bounds__(kThreads)
jub_ladder_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, const int32_t* __restrict__ k,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  long long rows, int n_bits) {
  const long long i = point_of_thread();
  if (i >= rows) return;
  const Group g = group_of_thread();
  const FieldConsts& F = kField[0];
  Pt base, acc;
  load_pt(base, x, y, z, i);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc.x[j] = 0;
    acc.y[j] = acc.z[j] = kJub[0][j];
  }
  const int32_t* limbs = k + i * 16;
  for (int bit = n_bits - 1; bit >= 0; --bit) {
    jub_dbl_lazy(acc, g, F);
    if ((__ldg(limbs + (bit >> 4)) >> (bit & 15)) & 1) jub_add_lazy(acc, acc, base, g, F);
  }
  store_point(acc, ox, oy, oz, i, g, F);
}

unsigned int n_blocks(long long points) {
  return static_cast<unsigned int>((points * kPointThreads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int jub_add_launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                              const int32_t* x2, const int32_t* y2, const int32_t* z2,
                              int32_t* ox, int32_t* oy, int32_t* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  jub_add_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jub_scalar_mul_launch(const int32_t* x, const int32_t* y, const int32_t* z,
                                     const int32_t* k, int32_t* ox, int32_t* oy, int32_t* oz,
                                     long long n, int n_bits, void* stream) {
  if (n <= 0) return 0;
  if (n_bits < 0 || n_bits > 256) return static_cast<int>(cudaErrorInvalidValue);
  jub_ladder_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, k, ox, oy, oz, n, n_bits);
  return static_cast<int>(cudaGetLastError());
}
