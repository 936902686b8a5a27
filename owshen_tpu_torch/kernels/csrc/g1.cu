// K2 / K3: complete projective addition and doubling on BN254 G1
// (y² = x³ + 3 over Fq), one thread per point.
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
// K3 keeps the canonical product (fmul, fadd, fsub, fmul9) in its body.
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

// RCB15 algorithm 9 (a = 0), the operation order of Weierstrass.double
__device__ __forceinline__ void g1_dbl_dev(Pt& r, const Pt& p, const FieldConsts& F) {
  uint32_t t0[8], t1[8], t2[8], z3[8], x3[8], y3[8], u[8];
  fmul(t0, p.y, p.y, F);
  fadd(z3, t0, t0, F);
  fadd(z3, z3, z3, F);
  fadd(z3, z3, z3, F);  // 8Y²
  fmul(t1, p.y, p.z, F);
  fmul(u, p.z, p.z, F);
  fmul9(t2, u, F);
  fmul(x3, t2, z3, F);
  fadd(y3, t0, t2, F);
  fmul(r.z, t1, z3, F);
  fadd(t1, t2, t2, F);
  fadd(t2, t1, t2, F);  // 3·b3·Z²
  fsub(t0, t0, t2, F);
  fmul(u, t0, y3, F);
  fadd(r.y, x3, u, F);
  fmul(t1, p.x, p.y, F);
  fmul(x3, t0, t1, F);
  fadd(r.x, x3, x3, F);
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

__global__ void g1_dbl_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                              const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
                              int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                              long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const FieldConsts& F = kField[1];
  Pt p, r;
  load_pt(p, x1, y1, z1, i);
  g1_dbl_dev(r, p, F);
  store_pt(r, ox, oy, oz, i);
}

unsigned int n_blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
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
  g1_dbl_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, ox, oy, oz, n);
  return static_cast<int>(cudaGetLastError());
}
