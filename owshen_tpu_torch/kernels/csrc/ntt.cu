// K5: one decimation-in-time stage of the radix-2 NTT over BN254 Fr,
// in place; K7: the fused column NTT (every stage of an n1-point transform
// in one launch, through registers and shared memory).
//
// K5 replaces owshen_tpu/pallas/ntt_kernels.py `butterfly_pallas`
// (`_butterfly_kernel`): (lo, hi) = (a + b·w, a − b·w).  The TPU kernel
// takes three gathered arrays; here one launch runs a whole DIT stage on the
// transform's own array: thread (g, j, col) reads a = x[g·m + j],
// b = x[g·m + j + m/2] and w = pows[j·(n/m)], and writes lo and hi back in
// place, so a stage needs no gather, no concatenation and no twiddle
// broadcast in device memory.  It keeps the canonical arithmetic of
// field.cuh (fmul, fadd, fsub).
//
// K7 replaces `ntt_pallas`'s column kernel (`_col_ntt`,
// `_ntt_col_kernel_factory`) together with the bit-reversal gather of
// `_axis0_ntt`: one block transforms one column of x int32[n1, cols, 16]
// (natural order in and out).  The Bailey recursion, the ω^{k1·i2}
// correction (a K1 launch) and the transposes stay in Python (ops/ntt.py).
//
// What bounds them on an H100: a butterfly moves 4 × 64 B of int32 16-limb
// rows (a, b in, lo, hi out) plus its twiddle, and does one Montgomery
// product (512 operations) and two modular adds (48): about 2 operations
// per byte, far below the card's balance point, so a K5 stage is bound by
// memory.  K7 reads and writes each element once for log2(n1) stages of
// butterflies, so at n1 = 2^10 its 10 stages of products outweigh its bytes
// and the integer multiply-add rate bounds it.  chip_smoke.py computes both
// bounds from the shapes it runs.
//
// K7's design spends its instructions on the products:
// - Lazy arithmetic (field.cuh: fmul_lazy, fadd_lazy, fsub_lazy): every
//   value stays in [0, 2p) through all stages, and fcanon makes each output
//   canonical once, before the store, so the result equals the canonical
//   twin bit for bit.
// - R = 2^kColsLogR = 8 elements a thread, in registers.  A pass holds the
//   R elements whose indices differ only in the bits [ws, ws + log R) (the
//   pass's window) and runs the up to log R stages that pair those bits
//   there; only between passes do the elements go through shared memory,
//   with one __syncthreads().  Pass p runs stages 3p + 1 … on the window
//   ws = min(3p, log n1 − 3), so the last window may overlap the one
//   before; the first pass reads its elements straight from device memory
//   in bit-reversed order.  n1 = 2^10 takes 4 passes and 3 exchanges (10
//   stages and 10 syncs before).
// - Shared memory is word-major: 8 planes of n1 + 4 words for the column,
//   so a warp reads one word of 32 elements per instruction, and element i
//   sits at swz(i), which flips its bank bits by its bits 5–7.  Lane bit b
//   of a thread lands in index bit b or b + log R, so without the flip the
//   windows at 0 and 3 put 8 and 4 lanes on a bank (R = 8); with it every
//   exchange of every log n1 ≤ 12 is free of bank conflicts.  The twiddles
//   ω_{n1}^j (j < n1/2) sit in 8 planes too, entry j at j + j/32: a stage's
//   lanes read entries a power of two apart, and up to n1 = 2^11 that
//   padding puts them on distinct banks or on one broadcast entry
//   (tests/test_torch_k3_k7.py enumerates both).
// - The store goes through shared memory as well: the last pass leaves the
//   canonical column in the planes, and then four lanes write each 64-byte
//   row, one 16-byte quarter each, so a warp instruction writes 8 whole
//   rows, full 32-byte sectors, where a lane storing its own rows wrote 32
//   half sectors.  The planes' stride of n1 + 4 words puts the four lanes
//   of a row on banks 8 apart.  Done the same way, the loads made the
//   kernel slower on the H100; so did a persistent grid striding over the
//   columns and prefetching the next one into the L2.
// - Blocks: 128 threads and 48.6 KB of shared memory at n1 = 2^10.
//   ptxas takes up to 168 registers a thread at R = 8 (so three blocks
//   share an SM, and the 1024 columns of the 2^20 transform's level take
//   2.6 waves of 396 blocks); capped at 128 for four blocks it spilled.  A
//   block loops its threads over a column larger than 128·R elements.
// What the time goes to beyond the products: the device-memory phases at
// the start and end of each block, which the blocks of a wave meet at the
// same time, and the exchanges.  R = 4 (4 exchanges at n1 = 2^10, four
// blocks an SM) was slower on the H100 (PERF.md §6) and was not kept.
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

constexpr int kColsLogR = 3;
constexpr int kColsThreads = 128;

// Where element i of the column sits in its shared-memory plane: bits 0–4
// (the bank) flipped by bits 5–7, a bijection on every aligned run of 32.
// The flips are chosen so that in each pass's window the 5 lane bits of a
// warp reach all 5 bank bits (see the header); below 32 it is i itself.
__device__ __forceinline__ int swz(int i) {
  return i ^ ((i >> 5) & 7) ^ (((i >> 6) & 3) << 3);
}

// Where twiddle j sits in its plane: one word of padding every 32
__device__ __forceinline__ int twz(int j) { return j + (j >> 5); }

// Pass 0's elements of thread t: indices t·R + j of the bit-reversed column
template <int LOG_R>
__device__ __forceinline__ void load_first(uint32_t e[][8], const int32_t* x, int t, int log_n1,
                                           long long cols, long long col) {
#pragma unroll
  for (int j = 0; j < (1 << LOG_R); ++j) {
    const long long src = __brev(static_cast<unsigned int>((t << LOG_R) + j)) >> (32 - log_n1);
    load_elem(x + (src * cols + col) * 16, e[j]);
  }
}

template <int LOG_R>
__global__ void __launch_bounds__(kColsThreads, 3)   // 3 blocks an SM: 168 registers
ntt_cols_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                int32_t* __restrict__ out, int log_n1, long long cols) {
  constexpr int R = 1 << LOG_R;
  extern __shared__ uint32_t smem[];
  const int n1 = 1 << log_n1;
  const int half = n1 >> 1;
  const int tw_plane = half + (half >> 5);
  const int vp = n1 + 4;                       // column plane stride (see the store)
  uint32_t* const wsm = smem;                  // 8 planes of tw_plane words
  uint32_t* const vsm = smem + 8 * tw_plane;   // 8 planes of vp words
  const long long col = blockIdx.x;
  const int n_threads = n1 >> LOG_R;
  const int passes = (log_n1 + LOG_R - 1) / LOG_R;
  const FieldConsts& F = kField[0];
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    uint32_t w[8];
    load_elem(tw + static_cast<long long>(j) * 16, w);
#pragma unroll
    for (int k = 0; k < 8; ++k) wsm[k * tw_plane + twz(j)] = w[k];
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const int ws = min(p * LOG_R, log_n1 - LOG_R);   // the window: bits [ws, ws + LOG_R)
    const int h0 = p * LOG_R - ws;                   // its first stage pairs bit ws + h0
    const int low = (1 << ws) - 1;
    for (int t = threadIdx.x; t < n_threads; t += blockDim.x) {
      const int base = (t & low) | ((t >> ws) << (ws + LOG_R));
      uint32_t e[R][8];
      if (p > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int a = swz(base + (j << ws));
#pragma unroll
          for (int k = 0; k < 8; ++k) e[j][k] = vsm[k * vp + a];
        }
      } else {
        load_first<LOG_R>(e, x, t, log_n1, cols, col);
      }
#pragma unroll
      for (int h = 0; h < LOG_R; ++h) {
        if (h < h0) continue;
        const int s = ws + h + 1;                    // stage s pairs index bit s − 1
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (j & (1 << h)) continue;
          // twiddle ω_{2^s}^(i mod 2^(s−1)) = table entry (i mod 2^(s−1))·2^(log n1 − s)
          const int u = (t & low) + ((j & ((1 << h) - 1)) << ws);
          const int a = twz(u << (log_n1 - s));
          uint32_t w[8], tb[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) w[k] = wsm[k * tw_plane + a];
          fmul_lazy(tb, e[j + (1 << h)], w, F);
          fsub_lazy(e[j + (1 << h)], e[j], tb, F);
          fadd_lazy(e[j], e[j], tb, F);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int a = swz(base + (j << ws));
        if (p == passes - 1) fcanon(e[j], e[j], F);
#pragma unroll
        for (int k = 0; k < 8; ++k) vsm[k * vp + a] = e[j][k];
      }
    }
    __syncthreads();
  }
  // The store: 4 lanes a row, each one 16-byte quarter, so that a warp
  // writes 8 whole 64-byte rows (full 32-byte sectors) per instruction.
  // Lane 4q + c reads words 2c, 2c + 1 of row i_q; the planes' stride of
  // n1 + 4 words puts the four lanes of a row 8 banks apart
#pragma unroll 8
  for (int idx = threadIdx.x; idx < n1 * 4; idx += blockDim.x) {
    const int i = idx >> 2, c = idx & 3, a = swz(i);
    const uint32_t w0 = vsm[2 * c * vp + a], w1 = vsm[(2 * c + 1) * vp + a];
    int4 v;
    v.x = static_cast<int32_t>(w0 & 0xFFFFu);
    v.y = static_cast<int32_t>(w0 >> 16);
    v.z = static_cast<int32_t>(w1 & 0xFFFFu);
    v.w = static_cast<int32_t>(w1 >> 16);
    reinterpret_cast<int4*>(out + (static_cast<long long>(i) * cols + col) * 16)[c] = v;
  }
}

template <int LOG_R>
int launch_cols(const int32_t* x, const int32_t* tw, int32_t* out, int log_n1,
                long long cols, cudaStream_t stream) {
  const int n1 = 1 << log_n1;
  const int half = n1 >> 1;
  const size_t smem = (static_cast<size_t>(half + (half >> 5)) + n1 + 4) * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_cols_kernel<LOG_R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (n1 >> LOG_R) < kColsThreads ? n1 >> LOG_R : kColsThreads;
  ntt_cols_kernel<LOG_R><<<static_cast<unsigned int>(cols), threads, smem, stream>>>(
      x, tw, out, log_n1, cols);
  return static_cast<int>(cudaGetLastError());
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
// ω_{n1}^j; 1 <= log_n1 <= 12 (checked by the wrapper).  A column of fewer
// than R elements runs with R = n1 (one pass)
extern "C" int ntt_cols_launch(const int32_t* x, const int32_t* tw, int32_t* out,
                               int log_n1, long long cols, void* stream) {
  if (cols <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_n1 < kColsLogR ? log_n1 : kColsLogR) {
    case 1: return launch_cols<1>(x, tw, out, log_n1, cols, s);
    case 2: return launch_cols<2>(x, tw, out, log_n1, cols, s);
    default: return launch_cols<kColsLogR>(x, tw, out, log_n1, cols, s);
  }
}
