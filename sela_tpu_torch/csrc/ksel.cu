// K6 for Hopper: exact optimal Rice parameter and block bits from per-bit
// counts, one thread per row.
//
// Replaces sela_tpu/kernels/encode.py::_make_ksel_kernel (wrapper
// ksel_pallas). Per row r, with n = n_valid[r] values whose zigzag codes u
// have counts[r][j] set bits at bit j:
//   S(31) = counts[31], S(k) = 2 S(k+1) + counts[k]   (= sum(u >> k))
//   cost(k) = S(k) + n (k+1) for k <= k_max; the least cost, ties to the
//   lowest k; the verbatim escape k = 31 with 32n bits when 32n < that
//   cost; (0, 0) when n == 0.
// Bit-identical to the plain torch version (ops/rice.py::
// k_and_bits_reference) and to ksel_pallas for every counts <= n <= 65535
// and every k_max in [0, 30]. The TPU kernel carries the 64-bit sums as
// (int32 hi, uint32 lo) lane pairs; here they are native uint64, exact
// because S(0) < n 2^32 <= 2^48.
//
// What bounds it on the card: bytes. A row reads 132 bytes and writes 8,
// against about 31 x 6 integer operations; the main path's 2,048 rows move
// 286,720 bytes, 0.086 us at 3.35 TB/s, so at that size the launch itself
// sets the time whatever the design.
//
// Design: rows of counts are staged through a shared-memory tile so that a
// warp loads one row's 128 contiguous bytes per transaction (the +1 column
// of padding keeps the per-thread row reads free of bank conflicts). The k
// loop is fully unrolled and runs downward with the recurrence; comparing
// with <= on the way down gives the lowest k among equal costs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 32;        // bit columns of a counts row
constexpr int ROWS = 128;    // rows (= threads) per block
constexpr int K_ESCAPE = 31;

__global__ void __launch_bounds__(ROWS)
ksel_kernel(const int32_t* __restrict__ counts,
            const int32_t* __restrict__ n_valid, int32_t* __restrict__ k_out,
            int32_t* __restrict__ bits_out, int n_rows, int k_max) {
  __shared__ int32_t tile[ROWS][K + 1];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const int64_t base = static_cast<int64_t>(row0) * K;
  for (int i = threadIdx.x; i < rows * K; i += ROWS) {
    tile[i / K][i % K] = counts[base + i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= rows) return;
  const int32_t n = n_valid[row0 + r];
  const uint64_t n64 = static_cast<uint32_t>(n);
  uint64_t s = static_cast<uint32_t>(tile[r][K - 1]);
  uint64_t best = ~0ull;
  int best_k = 0;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (k < K - 1) s = 2 * s + static_cast<uint32_t>(tile[r][k]);
    if (k <= k_max) {
      const uint64_t c = s + n64 * static_cast<uint64_t>(k + 1);
      if (c <= best) {
        best = c;
        best_k = k;
      }
    }
  }
  const uint64_t verb = 32 * n64;
  int32_t k = best_k;
  int32_t bits = static_cast<int32_t>(best);
  if (verb < best) {
    k = K_ESCAPE;
    bits = static_cast<int32_t>(verb);
  }
  if (n == 0) {
    k = 0;
    bits = 0;
  }
  k_out[row0 + r] = k;
  bits_out[row0 + r] = bits;
}

}  // namespace

extern "C" int sela_ksel(const void* counts, const void* n_valid, void* k,
                         void* bits, int n_rows, int k_max, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + ROWS - 1) / ROWS;
    ksel_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(k),
        static_cast<int32_t*>(bits), n_rows, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}
