// K2/K7 for Hopper: Q20 IIR synthesis, the decode hot loop, one warp a row.
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
//   - x wraps mod 2^32 and is stored as history, as the JAX scan and
//     generic paths store it.
// Bit-identical to those paths and to the plain torch version
// (ops/filters.py::iir_synthesize_reference) for every int32 e and every
// |c| <= 2^23.
//
// Why any split of the sum is exact: mod-2^64 addition is associative and
// only the rounding shift, which sees the whole sum, is nonlinear. So the
// 32 products may be added in any order and at any time before the shift,
// and so may e * 2^20: bits 20..51 of (sum + 2^19 + e * 2^20) are
// low32((sum + 2^19) >> 20) + e mod 2^32, because e * 2^20 leaves the low
// 20 bits alone. The same shift rules out a parallel scan over time: each
// sample still waits on the one before it.
//
// What bounds it on the card: that dependent chain, not bytes or
// operations. Per row the DRAM traffic is 8 bytes a sample and the work 32
// 64-bit multiply-adds a sample, a few microseconds for the decode's
// 1,024 x 2,048 chunk over 132 SMs; the chain is 2,048 samples long whatever
// the row count. In this design the chain a sample is five instructions:
// SHFL -> IMAD.WIDE -> IADD3 -> IMAD.X -> SHF.R.W (ptxas splits the 64-bit
// addend into a carried add). A launch at 1,024 rows costs about what one
// row alone costs (PERF.md has both); from a few thousand rows on, the nine
// instructions a warp issues a step set the time instead. Tensor cores do
// not apply: each row has its own 32 coefficients, so the products are a
// batched matrix-vector product with no reuse, in exact 64-bit integers
// that no tensor-core type holds.
//
// Design: a warp owns a row, and time advances in tiles of 32 samples, lane
// i finalizing sample t0 + i. Each lane keeps one 64-bit sum for the next
// sample it will finalize, seeded with 2^19 + e * 2^20. At step s of a tile,
// lane s shifts its sum into x[t0 + s] (one funnel shift, e already folded
// in), the value is broadcast with one shuffle, lane s reseeds its sum for
// sample t0 + 32 + s, and every lane adds its tap times x[t0 + s] with one
// mul.wide.s32 (64-bit addend): a lane i > s adds c_{i-s} to the sum of
// x[t0 + i], a lane i <= s adds c_{i+32-s} to the sum of x[t0 + 32 + i]. So a
// tile's history needs no pass of its own, and only the funnel shift, the
// shuffle and the multiply-add lie on the chain. Lane i's tap for the value
// of lane s, c_{((i-s-1) mod 32)+1}, is gathered once a row into 32
// registers, so the unrolled step indexes registers at compile time. A row
// whose coefficients are all zero (order 0) is a copy. Two variants were
// measured and dropped (PERF.md): every lane finalizing every sample from
// the next lane's partial sum, fetched a step ahead, takes the shuffle off
// the chain and was faster for a lone row, but its two shuffles a step made
// it no faster at 1,024 rows and slower from 4,096; separate sums for this
// tile and the next (no reseed select) were slower at 1,024 rows. e is read
// two tiles ahead into registers (the chain of a tile, some thousand
// cycles, covers a load), and e and x move one row's 128 contiguous bytes a
// warp transaction; no cp.async or TMA ring is needed. Any row count and
// any length are accepted: whole warps past the last row exit, and the
// lanes of the last tile past the row's end compute values nobody reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;           // taps (MAX_ORDER) = lanes = samples a tile
constexpr int WARPS = 4;        // rows (= warps) per block
constexpr unsigned FULL = 0xffffffffu;

// e[t] of the row, 0 past its end
__device__ __forceinline__ int32_t load(const int32_t* row, int64_t t,
                                        int n) {
  return t < n ? __ldg(row + t) : 0;
}

// the rounding constant with the residue folded in: 2^19 + e * 2^20 mod 2^64
__device__ __forceinline__ uint64_t seed(int32_t e) {
  return (static_cast<uint64_t>(static_cast<int64_t>(e)) << 20) + (1u << 19);
}

// acc + a * b mod 2^64 as one mul.wide.s32 with a 64-bit addend (written
// out: from the C++ product of two int64 casts nvcc made an unsigned wide
// multiply plus sign corrections, which put two more instructions on the
// chain)
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b,
                                             uint64_t acc) {
  uint64_t r;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(acc));
  return r;
}

// low32(v >> 20): bits 20..51 of the sum, one funnel shift
__device__ __forceinline__ int32_t shift20(uint64_t v) {
  return static_cast<int32_t>(__funnelshift_r(
      static_cast<uint32_t>(v), static_cast<uint32_t>(v >> 32), 20));
}

__global__ void __launch_bounds__(WARPS * 32)
iir_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ coeffs,
           int32_t* __restrict__ x, int n_rows, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp: row is warp-uniform
  const int32_t* er = e + static_cast<int64_t>(row) * n;
  int32_t* xr = x + static_cast<int64_t>(row) * n;
  // lane i holds c_{i+1}
  const int32_t cl = coeffs[static_cast<int64_t>(row) * P + lane];
  if (__ballot_sync(FULL, cl != 0) == 0) {   // order 0: x = e
    for (int64_t t = lane; t < n; t += P) xr[t] = er[t];
    return;
  }
  int32_t tap[P];   // tap[s]: the coefficient this lane applies to lane s's x
#pragma unroll
  for (int s = 0; s < P; ++s) {
    tap[s] = __shfl_sync(FULL, cl, (lane - s - 1) & (P - 1));
  }

  uint64_t acc = seed(load(er, lane, n));   // history before the row is 0
  int32_t e_next = load(er, P + lane, n);
  for (int64_t t0 = 0; t0 < n; t0 += P) {
    const int32_t e_after = load(er, t0 + 2 * P + lane, n);
    const uint64_t reseed = seed(e_next);
    int32_t xo = 0;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int32_t v = __shfl_sync(FULL, shift20(acc), s);
      if (lane == s) {   // x[t0 + s] is final; start the sum of x[t0 + 32 + s]
        xo = v;
        acc = reseed;
      }
      acc = mad_wide(tap[s], v, acc);
    }
    if (t0 + lane < n) xr[t0 + lane] = xo;
    e_next = e_after;
  }
}

}  // namespace

extern "C" int sela_iir_synthesize(const void* e, const void* c, void* x,
                                   int n_rows, int n, void* stream) {
  if (n_rows > 0 && n > 0) {
    const int blocks = (n_rows + WARPS - 1) / WARPS;
    iir_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(e), static_cast<const int32_t*>(c),
        static_cast<int32_t*>(x), n_rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}
