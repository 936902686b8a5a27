// K4: circomlib Poseidon t = 3 over BN254 Fr: state (0, l, r); R_F/2 full
// rounds, R_P partial rounds, R_F/2 full rounds; each round adds its
// constants, applies the x^5 S-box (to all three words in a full round, to
// word 0 in a partial one) and the 3×3 MDS; the output is state[0].
//
// Replaces owshen_tpu/pallas/field_kernels.py `poseidon_hash2_pallas`
// (`_poseidon2_kernel`).  Unlike the TPU kernel it takes no lane mask (the
// TPU kernel's `mask` input was never read), takes any N, and derives R_P
// as n_rounds − R_F instead of hardcoding it.
//
// What bounds it on an H100: a hash reads 2 × 64 B and writes 64 B and does
// 828 Montgomery products (8·(9 + 9) + 57·(3 + 9)), far above the card's
// balance point, so the integer multiply-add rate bounds a wide launch.
// The deposit launches it at 4096 hashes, though: one thread per hash
// there fills 32 blocks, a quarter of the SMs with one warp per scheduler,
// and the time is one thread's dependent chain of 828 products.  At that
// width the chain, not the rate, sets the floor: a round's S-box is three
// dependent products and its MDS one more, so 65 rounds are at least 260
// products deep whatever the lane count.
//
// The design shortens the chain and spreads it over the card:
// - three lanes per hash (kLanes), lane k holding state word k, ten hashes
//   to a warp (lanes 30 and 31 run along on a dummy state and store
//   nothing), so 4096 hashes are 410 warps, at most one per scheduler;
// - a round is a few product slots, each lane doing one product a slot:
//   * full round: every lane takes its word to the fifth power (slots 1–3),
//     the three powers are exchanged, and lane k forms row k of the MDS
//     (slots 4–6: M[k][0]·x0, M[k][1]·x1, M[k][2]·x2);
//   * partial round: lane 0 takes t0 to the fifth power (slots 1–3) while
//     lane k = 1, 2 forms the column products M[0][k]·t_k, M[1][k]·t_k,
//     M[2][k]·t_k, which do not wait for the S-box; after the exchange lane
//     k adds M[k][1]·t1 + M[k][2]·t2 to its one product M[k][0]·x0 (slot
//     4).
//   So a partial round is 4 slots deep instead of 12 products, a full
//   round 6 instead of 18: 57·4 + 8·6 = 276 slots in all;
// - the exchange goes through shared memory, each lane writing its slot
//   results and reading the three it needs after a __syncwarp; two
//   buffers alternate by round, so one __syncwarp a round suffices;
// - every product and sum is lazy (field.cuh: fmul_lazy, fsqr_lazy,
//   fadd_lazy on carry chains), values in [0, 2p), and lane 0 makes
//   state[0] canonical once, at the store (fcanon);
// - the round constants and the MDS (Montgomery form, uploaded once per
//   library into global memory) are copied into shared memory by each
//   block, since the lanes of a warp read different entries of them.
// The optimised sparse-matrix form of the partial rounds trades the MDS
// for a sparse one and does not shorten these slots, so it is left out.
#include <cstddef>

#include "field.cuh"

namespace {

constexpr int kRF = 8;                 // full rounds
constexpr int kRounds = 65;            // circomlib t = 3: R_F + R_P
constexpr int kRP = kRounds - kRF;     // partial rounds
constexpr int kLanes = 3;              // threads per hash, one per state word
constexpr int kGroups = 32 / kLanes;   // hashes per warp
constexpr int kWarps = 2;              // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kHashesPerBlock = kGroups * kWarps;

struct __align__(16) Tables {
  uint32_t c[kRounds][3][8];           // round constants, Montgomery
  uint32_t m[3][3][8];                 // MDS, Montgomery
};

__device__ Tables kTables;

// one element of 8 words to and from 16-byte aligned shared memory
__device__ __forceinline__ void ld8(uint32_t x[8], const uint32_t* src) {
  const uint4 a = reinterpret_cast<const uint4*>(src)[0];
  const uint4 b = reinterpret_cast<const uint4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void st8(uint32_t* dst, const uint32_t x[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void sel8(uint32_t r[8], bool c, const uint32_t a[8],
                                     const uint32_t b[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = c ? a[j] : b[j];
}

// The exchange area of one hash for one round: slot s of lane k at [k][s]
typedef uint32_t Exchange[kLanes][3][8];

// s: lane k's state word on entry and exit
__device__ __forceinline__ void full_round(uint32_t s[8], int r, int k, Exchange& x,
                                           const Tables& tab, const FieldConsts& F) {
  uint32_t t[8], p[8], m[8], acc[8];
  ld8(m, tab.c[r][k]);
  fadd_lazy(t, s, m, F);
  fsqr_lazy(p, t, F);                  // slots 1–3: x_k = t^5
  fsqr_lazy(p, p, F);
  fmul_lazy(t, p, t, F);
  st8(x[k][2], t);
  __syncwarp();
  ld8(p, x[0][2]);                     // slots 4–6: row k of the MDS
  ld8(m, tab.m[k][0]);
  fmul_lazy(acc, p, m, F);
  ld8(p, x[1][2]);
  ld8(m, tab.m[k][1]);
  fmul_lazy(p, p, m, F);
  fadd_lazy(acc, acc, p, F);
  ld8(p, x[2][2]);
  ld8(m, tab.m[k][2]);
  fmul_lazy(p, p, m, F);
  fadd_lazy(s, acc, p, F);
}

__device__ __forceinline__ void partial_round(uint32_t s[8], int r, int k, Exchange& x,
                                              const Tables& tab, const FieldConsts& F) {
  const bool k0 = k == 0;
  uint32_t t[8], a[8], b[8], m[8], r1[8], r2[8];
  ld8(m, tab.c[r][k]);
  fadd_lazy(t, s, m, F);               // t_k
  // slot 1: lane 0 t0·t0, lane k M[0][k]·t_k
  ld8(m, tab.m[0][k]);
  sel8(b, k0, t, m);
  fmul_lazy(r1, t, b, F);
  // slot 2: lane 0 t0²·t0², lane k M[1][k]·t_k
  ld8(m, tab.m[1][k]);
  sel8(a, k0, r1, t);
  sel8(b, k0, r1, m);
  fmul_lazy(r2, a, b, F);
  st8(x[k][0], r1);
  st8(x[k][1], r2);
  // slot 3: lane 0 x0 = t0·t0⁴, lane k M[2][k]·t_k
  ld8(m, tab.m[2][k]);
  sel8(b, k0, r2, m);
  fmul_lazy(r1, t, b, F);
  st8(x[k][2], r1);
  __syncwarp();
  // slot 4: s_k = M[k][0]·x0 + (M[k][1]·t1 + M[k][2]·t2)
  ld8(a, x[1][k]);
  ld8(b, x[2][k]);
  fadd_lazy(t, a, b, F);
  ld8(a, x[0][2]);
  ld8(m, tab.m[k][0]);
  fmul_lazy(a, a, m, F);
  fadd_lazy(s, a, t, F);
}

__global__ void __launch_bounds__(kThreads)
poseidon2_kernel(const int32_t* __restrict__ left, const int32_t* __restrict__ right,
                 int32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) Tables tab;
  __shared__ __align__(16) Exchange xb[2][kWarps][kGroups + 1];
  {
    const uint4* src = reinterpret_cast<const uint4*>(&kTables);
    uint4* dst = reinterpret_cast<uint4*>(&tab);
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(Tables) / 16); i += kThreads)
      dst[i] = src[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kLanes, k = lane % kLanes;   // g = kGroups: a spare lane
  const long long h = static_cast<long long>(blockIdx.x) * kHashesPerBlock +
                      warp * kGroups + g;
  const bool valid = g < kGroups && h < n;
  const FieldConsts& F = kField[0];
  uint32_t s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0;
  if (valid && k > 0) load_elem((k == 1 ? left : right) + h * 16, s);
  // every lane runs every round (a tail lane on a dummy state), so the
  // __syncwarp calls see the whole warp
#pragma unroll 1
  for (int r = 0; r < kRF / 2; ++r) full_round(s, r, k, xb[r & 1][warp][g], tab, F);
#pragma unroll 1
  for (int r = kRF / 2; r < kRF / 2 + kRP; ++r)
    partial_round(s, r, k, xb[r & 1][warp][g], tab, F);
#pragma unroll 1
  for (int r = kRF / 2 + kRP; r < kRounds; ++r) full_round(s, r, k, xb[r & 1][warp][g], tab, F);
  if (valid && k == 0) {
    fcanon(s, s, F);
    store_elem(out + h * 16, s);
  }
}

}  // namespace

// c: kRounds × 3 × 8 words, m: 3 × 3 × 8 words (Montgomery form)
extern "C" int poseidon_consts_upload(const uint32_t* c, const uint32_t* m,
                                      int n_rounds) {
  if (n_rounds != kRounds) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemcpyToSymbol(kTables, c, sizeof(Tables::c), offsetof(Tables, c));
  cudaMemcpyToSymbol(kTables, m, sizeof(Tables::m), offsetof(Tables, m));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int poseidon2_launch(const int32_t* left, const int32_t* right,
                                int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kHashesPerBlock - 1) / kHashesPerBlock);
  poseidon2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, n);
  return static_cast<int>(cudaGetLastError());
}
