// K6: circomlib MultiMiMC7([l, r], key 0) over BN254 Fr, one thread per
// hash: acc = 0; for x in (l, r): acc = acc + x + MiMC7(x, acc), where
// MiMC7(x, k) runs 91 rounds of r = (r + k + c_i)^7 (c_0 = 0) and returns
// r + k.
//
// Replaces owshen_tpu/pallas/field_kernels.py `mimc_hash2_pallas`
// (`_mimc_hash2_kernel`, constants `_mimc_tables`).  Unlike the TPU kernel
// it takes any N and masks the tail: no padding to a lane block.
//
// What bounds it on an H100: a hash reads 2 × 64 B and writes 64 B, and
// does 2·91 = 182 rounds of x^7 (two squarings and two products: x² =
// sqr(x), x⁴ = sqr(x²), x⁶ = x⁴·x², x⁷ = x⁶·x) and two additions, about
// 340 k 32-bit operations per hash: three orders of magnitude above the
// card's balance point, so the integer multiply-add rate bounds it.
//
// The design spends as few multiply-adds as it can on that rate:
// - every product and sum is lazy (field.cuh: fmul_lazy, fsqr_lazy,
//   fadd_lazy), so a value stays in [0, 2p) with no final subtraction per
//   operation; one fcanon makes the hash canonical where it is stored;
// - the word loops run on PTX carry chains, and a squaring forms its 28
//   cross products once (36 word products instead of 64);
// - the accumulator, key and round state stay in registers for all 182
//   rounds; the 91 round constants sit in __constant__ memory in
//   Montgomery form (uploaded once per library by mimc_consts_upload), and
//   a warp reads the same constant at the same time, which constant memory
//   broadcasts;
// - kThreads × kMinBlocks caps the registers at 128 a thread; ptxas uses
//   70 with no spills, so up to seven blocks share an SM; at 2^16 hashes
//   each scheduler holds about four warps, each with two independent rows
//   of multiply-adds in flight, which covers their latency.
// What it compiles to (sm_90a, CUDA 12.8): a mad.lo.cc / madc.hi.cc pair
// becomes one IMAD.WIDE.U32(.X), a full 32×32→64 product with carry, at
// half the IMAD instruction rate, so two multiply-add results.  One round
// (two squarings, two products) is 507 IMAD-family instructions: 407
// IMAD.WIDE.U32(.X), 50 IMAD.HI.U32, 50 IMAD, 914 multiply-add results,
// against the 2·200 + 2·256 = 912 its bound counts (228.5 a product on
// average against 228).  chip_smoke.py prints these counts from the
// library's SASS.
#include "field.cuh"

namespace {

constexpr int kRounds = 91;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;

__constant__ uint32_t kC[kRounds][8];   // round constants, Montgomery

// r = MiMC7(x, k), lazy: x, k < 2p -> r < 2p
__device__ __forceinline__ void mimc7(uint32_t r[8], const uint32_t x[8],
                                      const uint32_t k[8], const FieldConsts& F) {
  uint32_t x2[8], x4[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = x[j];
#pragma unroll 1
  for (int i = 0; i < kRounds; ++i) {   // c_0 = 0: round 0 is (x + k)^7
    fadd_lazy(r, r, k, F);
    fadd_lazy(r, r, kC[i], F);
    fsqr_lazy(x2, r, F);
    fsqr_lazy(x4, x2, F);
    fmul_lazy(x4, x4, x2, F);
    fmul_lazy(r, x4, r, F);
  }
  fadd_lazy(r, r, k, F);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
mimc2_kernel(const int32_t* __restrict__ left, const int32_t* __restrict__ right,
             int32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const FieldConsts& F = kField[0];
  uint32_t acc[8], x[8], h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    load_elem((side == 0 ? left : right) + i * 16, x);
    mimc7(h, x, acc, F);
    fadd_lazy(acc, acc, x, F);
    fadd_lazy(acc, acc, h, F);
  }
  fcanon(acc, acc, F);
  store_elem(out + i * 16, acc);
}

}  // namespace

// c: kRounds × 8 words (Montgomery form)
extern "C" int mimc_consts_upload(const uint32_t* c, int n_rounds) {
  if (n_rounds != kRounds) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemcpyToSymbol(kC, c, sizeof(kC));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mimc2_launch(const int32_t* left, const int32_t* right,
                            int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  mimc2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, n);
  return static_cast<int>(cudaGetLastError());
}
