// K3 for Hopper: float32 autocorrelation of a row at lags 0..32, one block
// per row.
//
// Replaces sela_tpu/kernels/encode.py::_autocorr_kernel (wrapper
// autocorr_pallas). Per row: xf[n] = x[n] * (1 / 32768), then
//   r[lag] = sum_{n + lag < N} xf[n] xf[n + lag],  lag = 0..32,
// in float32; zero padding at the end of a row contributes nothing.
// NON-NORMATIVE: analysis only picks the stream the encoder emits, so the
// kernel is held to a tolerance (|r - r_plain| <= 1e-5 r[0] a row), not to
// bits: its sums run in another order than the plain torch version
// (ops/analysis.py::autocorr_reference).
//
// What bounds it on the card: bytes. A row reads 4N bytes and writes 132,
// against 33 multiply-adds a sample; at the main path's [2,048, 2,048] the
// bound is 17.05 MB at 3.35 TB/s = 5.09 us, above the 277 MFLOP at 67
// TFLOP/s (4.1 us).
//
// Design: 256 threads own a row of at most 2,048 samples. The scaled row
// sits in shared memory followed by 32 zeros, so every lag reads in bounds
// without a branch. Thread t takes samples t, t + 256, ..., and keeps its 33
// partial sums in registers; neighbouring threads read neighbouring words
// (no bank conflicts). Each lag is then summed across the warp with
// shuffles and across the 8 warps in shared memory, in a fixed order, so
// the result does not change from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LAGS = 33;               // MAX_ORDER + 1
constexpr int THREADS = 256;
constexpr int MAX_N = 2048;            // FRAME_SIZE
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
autocorr_kernel(const int32_t* __restrict__ x, float* __restrict__ r, int n) {
  __shared__ float xs[MAX_N + LAGS - 1];
  __shared__ float part[WARPS][LAGS];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(row) * n;
  for (int s = t; s < MAX_N + LAGS - 1; s += THREADS) {
    xs[s] = s < n ? static_cast<float>(x[base + s]) * (1.0f / 32768.0f) : 0.0f;
  }
  __syncthreads();

  float acc[LAGS];
#pragma unroll
  for (int lag = 0; lag < LAGS; ++lag) acc[lag] = 0.0f;
  for (int s = t; s < n; s += THREADS) {
    const float v = xs[s];
#pragma unroll
    for (int lag = 0; lag < LAGS; ++lag) acc[lag] += v * xs[s + lag];
  }
  const int lane = t % 32, warp = t / 32;
#pragma unroll
  for (int lag = 0; lag < LAGS; ++lag) {
    float v = acc[lag];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) part[warp][lag] = v;
  }
  __syncthreads();
  if (t < LAGS) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += part[w][t];
    r[static_cast<int64_t>(row) * LAGS + t] = total;
  }
}

}  // namespace

extern "C" int sela_autocorr(const void* x, void* r, int n_rows, int n,
                             void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    autocorr_kernel<<<n_rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<float*>(r), n);
  }
  return static_cast<int>(cudaGetLastError());
}
