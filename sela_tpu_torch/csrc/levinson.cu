// K4 for Hopper: float Levinson-Durbin, order selection, companded 7-bit
// quantization and the modeled cost, one thread per row.
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
// waits on the previous one. With 2,048 rows the grid is 16 blocks of 128
// threads, so the launch takes about one row's chain.
//
// Design: r, a and q live in registers; every loop is fully unrolled so
// that the reversed indices are compile-time register names (as csrc/lpc.cu
// does). The order is chosen on the fly, step by step, which is the same
// strict ascending scan as K4's separate loop; q is zeroed from the chosen
// order at the end. Rows of r and q are staged through shared-memory tiles
// for coalesced loads and stores, the +1 column of padding keeping the
// per-thread row accesses free of bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;        // MAX_ORDER
constexpr int L = P + 1;     // lags
constexpr int ROWS = 128;    // rows (= threads) per block
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

__global__ void __launch_bounds__(ROWS)
levinson_kernel(const float* __restrict__ r_in,
                const int32_t* __restrict__ n_valid,
                int32_t* __restrict__ order_out, int32_t* __restrict__ q_out,
                float* __restrict__ cost_out, int n_rows, int max_order) {
  __shared__ float rt[ROWS][L + 1];
  __shared__ int32_t qt[ROWS][P + 1];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  for (int i = threadIdx.x; i < rows * L; i += ROWS) {
    rt[i / L][i % L] = r_in[static_cast<int64_t>(row0) * L + i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    float r[L];
#pragma unroll
    for (int m = 0; m < L; ++m) r[m] = rt[t][m];
    const bool valid = r[0] > 0.0f;
    const float err0 = valid ? r[0] : 1.0f;
    const float half_n =
        __fmul_rn(0.5f, static_cast<float>(n_valid[row0 + t]));
    float best_c = model_bits(half_n, err0);
    int best_m = 0;
    float e = err0;
    float a[P];
    int32_t q[P];
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
      float k = e > 0.0f ? __fdiv_rn(acc, fmaxf(e, 1e-30f)) : 0.0f;
      k = fminf(fmaxf(k, -K_CLIP), K_CLIP);
      float next[P];
#pragma unroll
      for (int i = 0; i < m - 1; ++i) {
        next[i] = __fsub_rn(a[i], __fmul_rn(k, a[m - 2 - i]));
      }
#pragma unroll
      for (int i = 0; i < m - 1; ++i) a[i] = next[i];
      a[m - 1] = k;
      e = __fmul_rn(e, __fsub_rn(1.0f, __fmul_rn(k, k)));
      q[m - 1] = quantize(valid ? k : 0.0f, m - 1);
      if (m <= max_order) {
        const float adj = __fadd_rn(valid ? e : 1.0f,
                                    __fmul_rn(LAMBDA * m, err0));
        const float c = __fadd_rn(model_bits(half_n, adj), COEFF_BITS * m);
        if (c < best_c) {
          best_c = c;
          best_m = m;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < P; ++m) qt[t][m] = m < best_m ? q[m] : 0;
    order_out[row0 + t] = best_m;
    cost_out[row0 + t] = best_c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * P; i += ROWS) {
    q_out[static_cast<int64_t>(row0) * P + i] = qt[i / P][i % P];
  }
}

}  // namespace

extern "C" int sela_levinson(const void* r, const void* n_valid, void* order,
                             void* q, void* cost, int n_rows, int max_order,
                             void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + ROWS - 1) / ROWS;
    levinson_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const int32_t*>(n_valid),
        static_cast<int32_t*>(order), static_cast<int32_t*>(q),
        static_cast<float*>(cost), n_rows, max_order);
  }
  return static_cast<int>(cudaGetLastError());
}
