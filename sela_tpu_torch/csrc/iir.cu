// K2/K7 for Hopper: Q20 IIR synthesis, the decode hot loop, one thread per
// row.
//
// Replaces sela_tpu/kernels/iir.py::_make_iir_kernel_fast (K2, exact for
// |x| < 2^26) and ::_make_iir_kernel_generic (K7, exact for every int32
// input), both behind iir_synthesize_pallas. Per row:
//   x[n] = e[n] + low32((sum_{j=1..32} c_j x[n-j] + 2^19) >> 20)
// with x[n-j] = 0 for n < j. The TPU kernels split x and c into 11-13 bit
// limbs because the TPU has no int64; here each product is one
// mul.wide.s32 into a 64-bit sum, which serves both contracts at once:
//   - the sum is a uint64_t, so it wraps mod 2^64 exactly as the JAX
//     i64.add does (signed overflow would be undefined behaviour);
//   - the rounding shift is taken on the unsigned sum: bits 20..51 are the
//     same as those of the arithmetic shift of its signed reading, and only
//     the low 32 bits are kept;
//   - x = (int32_t)((uint32_t)e + pred) wraps mod 2^32 and is stored as
//     history, as the JAX scan and generic paths store it.
// Bit-identical to those paths and to the plain torch version
// (ops/filters.py::iir_synthesize_reference) for every int32 e and every
// |c| <= 2^23.
//
// What bounds it on the card: the recurrence, not bytes or operations.
// rshift_round makes the step non-associative, so there is no parallel scan
// over time; parallelism comes only from rows. Per row the DRAM traffic is
// 8 bytes a sample and the arithmetic 32 wide multiply-adds a sample, but
// every sample waits on the previous one. In the data, only the c_1 x[n-1]
// term, the rounding and the add of e depend on x[n-1]; in this design the
// 32 products are summed into one accumulator, a chain of 32 dependent
// 64-bit adds that a lone thread issues in order, so each sample costs that
// chain's latency. With 1,024 rows (a 512-frame stereo chunk) the grid is
// 8 blocks of 128 threads on 132 SMs: too few warps to hide the chain.
// PERF.md has the measured times against the row count; shortening the
// chain (partial sums) and filling the card (a warp per row, or more rows a
// launch) are the work of a later change.
//
// Design: the 32 coefficients and a 32-sample history ring live in
// registers. Time advances in tiles of 32 samples with the tile loop fully
// unrolled, so the ring slot of x[n-j] is a compile-time register index.
// Each tile of e is staged through shared memory: a warp loads one row's
// 32 consecutive samples (128 contiguous bytes, one coalesced transaction),
// each thread then reads its own row from the tile (the +1 column of
// padding keeps those reads bank-conflict free), writes x back into the
// same slots, and the tile is stored the same coalesced way. Any row count
// and any length are accepted: the ragged last block and the last tile are
// masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;        // taps (MAX_ORDER) = ring length
constexpr int T = 32;        // samples per tile
constexpr int ROWS = 128;    // rows (= threads) per block
static_assert(T == P, "the ring indexing below assumes one tile = P samples");

__global__ void __launch_bounds__(ROWS)
iir_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ coeffs,
           int32_t* __restrict__ x, int n_rows, int n) {
  __shared__ int32_t tile[ROWS][T + 1];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const int r = threadIdx.x;

  for (int i = threadIdx.x; i < rows * P; i += ROWS) {
    tile[i / P][i % P] = coeffs[static_cast<int64_t>(row0) * P + i];
  }
  __syncthreads();
  int32_t c[P];  // c[j] = c_{j+1}
#pragma unroll
  for (int j = 0; j < P; ++j) c[j] = r < rows ? tile[r][j] : 0;
  int32_t h[P];  // h[t % P] = x[t] for the last P samples
#pragma unroll
  for (int j = 0; j < P; ++j) h[j] = 0;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += T) {
    const int cols = min(T, n - t0);
    for (int i = threadIdx.x; i < rows * T; i += ROWS) {
      const int rr = i / T, tt = i % T;
      tile[rr][tt] =
          tt < cols ? e[static_cast<int64_t>(row0 + rr) * n + t0 + tt] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < T; ++j) {
      // x[t0 + j - d] sits in ring slot (j - d) mod P
      uint64_t acc = 0;
#pragma unroll
      for (int d = P; d >= 2; --d) {
        acc += static_cast<uint64_t>(static_cast<int64_t>(c[d - 1]) *
                                     h[(j - d + 2 * P) % P]);
      }
      acc += static_cast<uint64_t>(static_cast<int64_t>(c[0]) *
                                   h[(j - 1 + P) % P]);
      const uint32_t pred = static_cast<uint32_t>((acc + (1u << 19)) >> 20);
      const int32_t xv = static_cast<int32_t>(
          static_cast<uint32_t>(tile[r][j]) + pred);
      h[j] = xv;  // slot j held x[t0 + j - P], just read above for d = P
      tile[r][j] = xv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * T; i += ROWS) {
      const int rr = i / T, tt = i % T;
      if (tt < cols) {
        x[static_cast<int64_t>(row0 + rr) * n + t0 + tt] = tile[rr][tt];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sela_iir_synthesize(const void* e, const void* c, void* x,
                                   int n_rows, int n, void* stream) {
  if (n_rows > 0 && n > 0) {
    const int blocks = (n_rows + ROWS - 1) / ROWS;
    iir_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(e), static_cast<const int32_t*>(c),
        static_cast<int32_t*>(x), n_rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}
