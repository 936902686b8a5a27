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
// does 2·91·4 = 728 Montgomery products (x^7 as x², x⁴, x⁶, x⁷) and 368
// modular adds: about 380 k 32-bit operations per hash, three orders of
// magnitude above the card's balance point, so the integer units bound it.
//
// Why this simple design is a start: the accumulator, the key and the round
// state stay in registers for all 182 rounds; the 91 round constants sit
// in __constant__ memory in Montgomery form (uploaded once per library by
// mimc_consts_upload), and all threads of a warp read the same constant at
// the same time, which constant memory broadcasts.  Several hashes per
// thread to hide the multiply latency are later work.
#include "field.cuh"

namespace {

constexpr int kRounds = 91;

__constant__ uint32_t kC[kRounds][8];   // round constants, Montgomery

__device__ __forceinline__ void pow7(uint32_t x[8], const FieldConsts& F) {
  uint32_t x2[8], x4[8], x6[8];
  fmul(x2, x, x, F);
  fmul(x4, x2, x2, F);
  fmul(x6, x4, x2, F);
  fmul(x, x6, x, F);
}

// r = MiMC7(x, k)
__device__ __forceinline__ void mimc7(uint32_t r[8], const uint32_t x[8],
                                      const uint32_t k[8], const FieldConsts& F) {
  fadd(r, x, k, F);
  pow7(r, F);
#pragma unroll 1
  for (int i = 1; i < kRounds; ++i) {
    fadd(r, r, k, F);
    fadd(r, r, kC[i], F);
    pow7(r, F);
  }
  fadd(r, r, k, F);
}

__global__ void mimc2_kernel(const int32_t* __restrict__ left,
                             const int32_t* __restrict__ right,
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
    fadd(acc, acc, x, F);
    fadd(acc, acc, h, F);
  }
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
  const int threads = 128;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  mimc2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, n);
  return static_cast<int>(cudaGetLastError());
}
