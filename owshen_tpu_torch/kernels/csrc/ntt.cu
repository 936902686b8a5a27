// K5: one decimation-in-time stage of the radix-2 NTT over BN254 Fr,
// in place; K7: the fused column NTT (every stage of an n1-point transform
// in shared memory).
//
// K5 replaces owshen_tpu/pallas/ntt_kernels.py `butterfly_pallas`
// (`_butterfly_kernel`): (lo, hi) = (a + b·w, a − b·w).  The TPU kernel
// takes three gathered arrays; here one launch runs a whole DIT stage on the
// transform's own array: thread (g, j, col) reads a = x[g·m + j],
// b = x[g·m + j + m/2] and w = pows[j·(n/m)], and writes lo and hi back in
// place, so a stage needs no gather, no concatenation and no twiddle
// broadcast in device memory.
//
// K7 replaces `ntt_pallas`'s column kernel (`_col_ntt`,
// `_ntt_col_kernel_factory`) together with the bit-reversal gather of
// `_axis0_ntt`: one block transforms one column of x int32[n1, cols, 16]
// (natural order in and out), loading it bit-reversed into shared memory,
// running all log2(n1) stages there with __syncthreads() between stages, and
// writing it back once.  The stage twiddles come from one table of
// ω_{n1}^j (j < n1/2) that the block also keeps in shared memory: stage s
// reads entry j·(n1/2^s).  The Bailey recursion, the ω^{k1·i2} correction
// (a K1 launch) and the transposes stay in Python (ops/ntt.py).
//
// What bounds them on an H100: a butterfly moves 4 × 64 B of int32 16-limb
// rows (a, b in, lo, hi out) plus its twiddle, and does one Montgomery
// product (512 operations) and two modular adds (48): about 2 operations
// per byte, far below the card's balance point, so a K5 stage is bound by
// memory.  K7 reads and writes each element once for log2(n1) stages of
// butterflies, so at n1 = 2^10 its 10 stages of products outweigh its bytes
// and the integer units bound it.  chip_smoke.py computes both bounds from
// the shapes it runs.
//
// Why this simple design is a start: one thread per butterfly (K5) and one
// block per column (K7) need no cross-block synchronisation and mask any
// shape; the field arithmetic is field.cuh's.  Each thread's 64-byte row is
// one 2-sector load, but neighbouring threads are a stride apart, so warps
// do not coalesce; a word-major layout, several columns per K7 block and
// fusing stages of K5 are later work.
#include "field.cuh"

namespace {

__global__ void ntt_stage_kernel(int32_t* __restrict__ x,
                                 const int32_t* __restrict__ pows,
                                 unsigned int total, unsigned int batch,
                                 int log_half, unsigned int tw_step, int field) {
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const unsigned int bi = t / batch;          // butterfly index in the stage
  const unsigned int col = t - bi * batch;
  const unsigned int j = bi & ((1u << log_half) - 1u);
  const unsigned int g = bi >> log_half;
  const long long ia =
      (static_cast<long long>((g << (log_half + 1)) + j) * batch + col) * 16;
  const long long ib = ia + (static_cast<long long>(batch) << log_half) * 16;
  const FieldConsts& F = kField[field];
  uint32_t a[8], b[8], w[8], tb[8], lo[8], hi[8];
  load_elem(x + ia, a);
  load_elem(x + ib, b);
  load_elem(pows + static_cast<long long>(j) * tw_step * 16, w);
  fmul(tb, b, w, F);
  fadd(lo, a, tb, F);
  fsub(hi, a, tb, F);
  store_elem(x + ia, lo);
  store_elem(x + ib, hi);
}

__global__ void ntt_cols_kernel(const int32_t* __restrict__ x,
                                const int32_t* __restrict__ tw,
                                int32_t* __restrict__ out, int log_n1,
                                long long cols) {
  extern __shared__ uint32_t smem[];
  uint32_t(*v)[8] = reinterpret_cast<uint32_t(*)[8]>(smem);
  const int n1 = 1 << log_n1;
  const int n_half = n1 >> 1;
  uint32_t(*w)[8] = v + n1;
  const long long col = blockIdx.x;
  const FieldConsts& F = kField[0];
  uint32_t e[8];
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const long long src = __brev(static_cast<unsigned int>(i)) >> (32 - log_n1);
    load_elem(x + (src * cols + col) * 16, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[i][k] = e[k];
  }
  for (int j = threadIdx.x; j < n_half; j += blockDim.x) {
    load_elem(tw + static_cast<long long>(j) * 16, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[j][k] = e[k];
  }
  __syncthreads();
  for (int s = 1; s <= log_n1; ++s) {
    const int half = 1 << (s - 1);
    const int step_log = log_n1 - s;          // twiddle j·(n1/2^s)
    for (int bi = threadIdx.x; bi < n_half; bi += blockDim.x) {
      const int j = bi & (half - 1);
      const int ia = ((bi >> (s - 1)) << s) + j;
      const int ib = ia + half;
      uint32_t a[8], b[8], tb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a[k] = v[ia][k];
        b[k] = v[ib][k];
      }
      fmul(tb, b, w[j << step_log], F);
      fadd(v[ia], a, tb, F);
      fsub(v[ib], a, tb, F);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n1; i += blockDim.x)
    store_elem(out + (static_cast<long long>(i) * cols + col) * 16, v[i]);
}

}  // namespace

// x: int32[n, batch, 16] (in place), pows: int32[n/2, 16] = ω_n^j; stage
// m = 2^log_m; (n/2)·batch < 2^31 (checked by the wrapper)
extern "C" int ntt_stage_launch(int32_t* x, const int32_t* pows, long long n,
                                long long batch, int log_m, int field,
                                void* stream) {
  const long long total = (n >> 1) * batch;
  if (total <= 0) return 0;
  const int threads = 128;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  ntt_stage_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pows, static_cast<unsigned int>(total), static_cast<unsigned int>(batch),
      log_m - 1, static_cast<unsigned int>(n >> log_m), field);
  return static_cast<int>(cudaGetLastError());
}

// x, out: int32[n1, cols, 16] (natural order), tw: int32[n1/2, 16] =
// ω_{n1}^j; 1 <= log_n1 <= 12 (checked by the wrapper)
extern "C" int ntt_cols_launch(const int32_t* x, const int32_t* tw, int32_t* out,
                               int log_n1, long long cols, void* stream) {
  if (cols <= 0) return 0;
  const int n1 = 1 << log_n1;
  const size_t smem = static_cast<size_t>(n1 + n1 / 2) * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n1 / 2 < 256 ? n1 / 2 : 256;
  ntt_cols_kernel<<<static_cast<unsigned int>(cols), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(x, tw, out, log_n1, cols);
  return static_cast<int>(cudaGetLastError());
}
