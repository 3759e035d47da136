// K4 for Hopper: float Levinson-Durbin, order selection, companded 7-bit
// quantization and the modeled cost; one thread a row runs the recursion,
// and the block's 128 threads the work off its chain.
//
// Replaces sela_tpu/kernels/encode.py::_make_levinson_kernel (wrapper
// analyze_pallas, which runs it after K3). Per row, from r[0..32] (float32)
// and n = n_valid:
//   valid = r0 > 0; e = valid ? r0 : 1; for m = 1..32:
//     acc = r_m - (a_0 r_{m-1} + a_1 r_{m-2} + ... + a_{m-2} r_1), summed
//           left to right;
//     k = e > 0 ? acc / max(e, 1e-30) : 0, clipped to +-0.999999;
//     a_i -= k a_{m-2-i} (i < m-1), a_{m-1} = k; e *= 1 - k^2;
//     gamma_{m-1} = valid ? k : 0, err_m = valid ? e : 1;
//   cost(m) = 0.5 n (log(max(err_m + m 2^-12 err_0, 1e-9)) * (1/ln 2)) + 7m
//     for m <= max_order; the order is the first strict minimum ascending;
//   q_m = floor(64 (sqrt(2 (gamma_0 + 1)) - 1)) (m = 0),
//         floor(64 (sqrt(2 (1 - gamma_1)) - 1)) (m = 1), floor(64 gamma_m)
//         beyond, clipped to [-64, 63], zero from the order on.
// These are K4's operations in K4's order. Every float operation is written
// as an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA, and logf
// is the accurate libdevice function that torch.log calls; so given the same
// r the kernel can equal the plain torch version (ops/analysis.py::
// analyze_from_r_reference), which runs each operation as its own kernel.
// NON-NORMATIVE all the same: analysis only picks the emitted stream.
//
// What bounds it on the card: the recursion. A row reads 136 bytes and
// writes 136 (0.17 us at 3.35 TB/s for the main path's 2,048 rows), and
// does ~1,100 float operations and 33 logarithms, but each of the 32 steps
// waits on the previous one: ~465 dependent additions in the dot products'
// left-to-right order (4 cycles each), 32 IEEE divisions and the updates
// between them. No row count shortens that chain; what the design can do is
// keep everything else off the thread that runs it, and give each chain a
// scheduler of its own.
//
// Design: a block of 128 threads owns 4 rows (2,048 rows are 512 blocks,
// ~4 an SM). Its threads stage the rows' r and n_valid in shared memory,
// all loads in flight at once; then thread t < 4 runs row t's recursion with
// r and a in registers (every loop fully unrolled, so that the reversed
// indices are compile-time register names, as csrc/lpc.cu does), and stores
// each step's gamma and err in shared memory, nothing else. A row with
// r0 <= 0 has gamma 0 and err 1 whatever its recursion gives, so it skips
// the recursion: all-zero rows (digital silence) would otherwise send every
// division down its slow path, whose zero dividend it does not take fast.
// After a barrier the block's 128 threads take the (row, m) pairs: the 33
// costs with their logarithms and the 32 quantizations. Thread t < 4 then
// scans row t's costs for the first strict minimum, in ascending m as K4's
// loop does, and the block writes order, cost and q (zero from the order
// on) with coalesced stores. The +1 columns of padding keep the per-thread
// row accesses free of bank conflicts.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;        // MAX_ORDER
constexpr int L = P + 1;     // lags
constexpr int ROWS = 4;      // rows (chain threads) per block
constexpr int THREADS = 128;
constexpr int ITEMS = (ROWS * L + THREADS - 1) / THREADS;   // (row, m) pairs
                                                            // a thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr float K_CLIP = 0.999999f;
constexpr float LAMBDA = 1.0f / 4096.0f;   // ORDER_QNOISE_PENALTY = 2^-12
constexpr float COEFF_BITS = 7.0f;         // COEFF_BIT_COST

__device__ __forceinline__ float model_bits(float half_n, float err) {
  return __fmul_rn(half_n, __fmul_rn(logf(fmaxf(err, 1e-9f)), LOG2E));
}

__device__ __forceinline__ int32_t quantize(float g, int m) {
  float qf;
  if (m == 0) {
    qf = floorf(__fmul_rn(
        64.0f, __fsub_rn(__fsqrt_rn(__fmul_rn(2.0f, __fadd_rn(g, 1.0f))),
                         1.0f)));
  } else if (m == 1) {
    qf = floorf(__fmul_rn(
        64.0f, __fsub_rn(__fsqrt_rn(__fmul_rn(2.0f, __fsub_rn(1.0f, g))),
                         1.0f)));
  } else {
    qf = floorf(__fmul_rn(64.0f, g));
  }
  return static_cast<int32_t>(fminf(fmaxf(qf, -64.0f), 63.0f));
}

__global__ void __launch_bounds__(THREADS)
levinson_kernel(const float* __restrict__ r_in,
                const int32_t* __restrict__ n_valid,
                int32_t* __restrict__ order_out, int32_t* __restrict__ q_out,
                float* __restrict__ cost_out, int n_rows, int max_order) {
  __shared__ float rt[ROWS][L + 1];     // r of the block's rows
  __shared__ float gt[ROWS][P + 1];     // gamma_m, m = 0..31
  __shared__ float et[ROWS][L + 1];     // err_m, m = 0..32
  __shared__ float ct[ROWS][L + 1];     // cost(m), m = 0..max_order
  __shared__ int32_t qt[ROWS][P + 1];   // q_m before the order's cut
  __shared__ int32_t best[ROWS];
  __shared__ float half_n[ROWS];        // 0.5 n_valid
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const int t = threadIdx.x;
  float v[ITEMS];   // every load in flight at once
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = t + THREADS * k;
    v[k] = i < rows * L ? r_in[static_cast<int64_t>(row0) * L + i] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = t + THREADS * k;
    if (i < rows * L) rt[i / L][i % L] = v[k];
  }
  if (t < rows) {
    half_n[t] = __fmul_rn(0.5f, static_cast<float>(n_valid[row0 + t]));
  }
  __syncthreads();

  if (t < rows && !(rt[t][0] > 0.0f)) {   // r0 <= 0: gamma 0, err 1
#pragma unroll
    for (int m = 0; m < P; ++m) gt[t][m] = 0.0f;
#pragma unroll
    for (int m = 0; m < L; ++m) et[t][m] = 1.0f;
  } else if (t < rows) {   // the recursion: nothing but its chain
    float r[L];
#pragma unroll
    for (int m = 0; m < L; ++m) r[m] = rt[t][m];
    float e = r[0];
    et[t][0] = e;
    float a[P];
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = 0.0f;
#pragma unroll
    for (int m = 1; m <= P; ++m) {
      float acc;
      if (m == 1) {
        acc = r[1];
      } else {
        float s = __fmul_rn(a[0], r[m - 1]);
#pragma unroll
        for (int i = 1; i < m - 1; ++i) {
          s = __fadd_rn(s, __fmul_rn(a[i], r[m - 1 - i]));
        }
        acc = __fsub_rn(r[m], s);
      }
      const float quot = __fdiv_rn(acc, fmaxf(e, 1e-30f));
      const float k = fminf(fmaxf(e > 0.0f ? quot : 0.0f, -K_CLIP), K_CLIP);
      float next[P];
#pragma unroll
      for (int i = 0; i < m - 1; ++i) {
        next[i] = __fsub_rn(a[i], __fmul_rn(k, a[m - 2 - i]));
      }
#pragma unroll
      for (int i = 0; i < m - 1; ++i) a[i] = next[i];
      a[m - 1] = k;
      e = __fmul_rn(e, __fsub_rn(1.0f, __fmul_rn(k, k)));
      gt[t][m - 1] = k;
      et[t][m] = e;
    }
  }
  __syncthreads();

  // off the chain, over the block: cost(m) and q_m of every (row, m),
  // unrolled so that the logarithms of a thread's items overlap; m beyond
  // max_order costs +inf, which no finite cost is above
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = t + THREADS * k;
    if (i < rows * L) {
      const int row = i / L, m = i % L;
      const float err0 = et[row][0];
      if (m == 0) {
        ct[row][0] = model_bits(half_n[row], err0);
      } else if (m <= max_order) {
        const float adj = __fadd_rn(
            et[row][m], __fmul_rn(LAMBDA * static_cast<float>(m), err0));
        ct[row][m] = __fadd_rn(model_bits(half_n[row], adj),
                               COEFF_BITS * static_cast<float>(m));
      } else {
        ct[row][m] = INFINITY;
      }
      if (m < P) qt[row][m] = quantize(gt[row][m], m);
    }
  }
  __syncthreads();

  if (t < rows) {   // the first strict minimum, ascending, as K4's scan
    float best_c = ct[t][0];
    int best_m = 0;
#pragma unroll
    for (int m = 1; m <= P; ++m) {
      if (ct[t][m] < best_c) {
        best_c = ct[t][m];
        best_m = m;
      }
    }
    best[t] = best_m;
    order_out[row0 + t] = best_m;
    cost_out[row0 + t] = best_c;
  }
  __syncthreads();
  for (int i = t; i < rows * P; i += THREADS) {
    const int row = i / P, m = i % P;
    q_out[static_cast<int64_t>(row0) * P + i] =
        m < best[row] ? qt[row][m] : 0;
  }
}

}  // namespace

extern "C" int sela_levinson(const void* r, const void* n_valid, void* order,
                             void* q, void* cost, int n_rows, int max_order,
                             void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + ROWS - 1) / ROWS;
    levinson_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const int32_t*>(n_valid),
        static_cast<int32_t*>(order), static_cast<int32_t*>(q),
        static_cast<float*>(cost), n_rows, max_order);
  }
  return static_cast<int>(cudaGetLastError());
}
