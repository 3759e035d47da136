// K5 for Hopper: Q20 FIR residues, the residue guard, zigzag and the 32
// per-bit counts of a row, one block per row.
//
// Replaces sela_tpu/kernels/encode.py::_fir_rice_kernel (wrapper
// fir_rice_pallas). Per row r with order o, n_valid v and Q20 coefficients
// c_1..c_32 (zero beyond the order):
//   e[n] = x[n] - ((sum_{j=1..32} c_j x[n-j] + 2^19) >> 20), x[n-j] = 0 for
//          n < j, in 64-bit integers;
//   ok   = every e[n], n < v, strictly inside (-2^30, 2^30);
//   out  = ok ? e[n] : x[n] for n < v (the order-0 verbatim fallback), 0
//          beyond v; eff_order = ok ? o : 0;
//   counts[j] = #{n < v : bit j of zigzag(out[n])}.
// NORMATIVE: bit-identical to the plain torch version
// (ops/filters.py::fir_rice_reference) for every int32 input. The sum is a
// uint64_t, which wraps mod 2^64 with defined behaviour as the JAX i64.add
// does, and the rounding shift is taken on its signed reading. The TPU
// kernel splits x and c into 12/13-bit limbs (exact only for |x| < 2^26)
// and the JAX package keeps a separate generic path for 32-bit PCM; one
// int64 kernel serves both here.
//
// What bounds it on the card: by the bytes it must move (8 bytes a sample
// plus 128 of coefficients and counts a row: ~17 MB at the main path's
// [1,024, 2,048], 5.1 us at 3.35 TB/s) and by its integer work, which
// grows with the data: one 32x32->64 multiply-add per sample per tap below
// the row's highest nonzero coefficient, and one shift-and-add per sample
// per bit of the 32 counts. PERF.md has the two bounds against the
// measured time.
//
// Design: 256 threads own a row of at most 2,048 samples, sample n going to
// thread n mod 256, so each warp reads and writes 128 contiguous bytes. The
// row is staged once in shared memory behind 32 zeros of history; the tap
// loop stops at the row's highest nonzero coefficient (a zero tap adds
// nothing, so this is exact) and reads the coefficient as a shared-memory
// broadcast. The 8 residues of a thread stay in registers while the guard
// is decided with __syncthreads_and, so nothing is written before the whole
// row is known to pass or fall back. Counts are taken per thread, summed
// per warp with __reduce_add_sync, then across the 8 warps in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;                  // taps (MAX_ORDER) = zero history
constexpr int THREADS = 256;
constexpr int PER = 8;                 // samples per thread
constexpr int MAX_N = THREADS * PER;   // 2,048 = FRAME_SIZE
constexpr int WARPS = THREADS / 32;
constexpr int64_t LIMIT = int64_t{1} << 30;   // RESIDUE_LIMIT

__global__ void __launch_bounds__(THREADS)
fir_rice_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ coeffs,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ n_valid, int32_t* __restrict__ e,
                int32_t* __restrict__ eff_order, int32_t* __restrict__ counts,
                int n) {
  __shared__ int32_t xs[P + MAX_N];
  __shared__ int32_t c[P];
  __shared__ uint32_t warp_counts[WARPS][32];
  __shared__ int taps;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(row) * n;
  const int nv = min(n_valid[row], n);

  if (t < P) {
    xs[t] = 0;
    c[t] = coeffs[static_cast<int64_t>(row) * P + t];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    xs[P + s] = s < n ? x[base + s] : 0;
  }
  __syncthreads();
  if (t < 32) {   // warp 0: the highest nonzero coefficient
    const unsigned nz = __ballot_sync(0xffffffffu, c[t] != 0);
    if (t == 0) taps = nz ? 32 - __clz(nz) : 0;
  }
  __syncthreads();

  uint64_t acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0;
  const int nt = taps;
  for (int j = 0; j < nt; ++j) {
    const int32_t cj = c[j];   // c_{j+1}, applied to x[s - j - 1]
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = t + i * THREADS;
      // both factors sign-extended from 32 bits: one mul.wide.s32
      acc[i] += static_cast<uint64_t>(static_cast<int64_t>(cj) *
                                      static_cast<int64_t>(xs[P + s - j - 1]));
    }
  }

  int64_t res[PER];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    const int64_t pred = static_cast<int64_t>(acc[i] + (1ull << 19)) >> 20;
    res[i] = static_cast<int64_t>(static_cast<uint64_t>(xs[P + s]) -
                                  static_cast<uint64_t>(pred));
    if (s < nv) ok = ok && res[i] > -LIMIT && res[i] < LIMIT;
  }
  ok = __syncthreads_and(ok);

  uint32_t cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    const int32_t v =
        s < nv ? (ok ? static_cast<int32_t>(res[i]) : xs[P + s]) : 0;
    if (s < n) e[base + s] = v;
    const uint32_t u =
        (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] += (u >> b) & 1u;
  }
  const int lane = t % 32, warp = t / 32;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t w = __reduce_add_sync(0xffffffffu, cnt[b]);
    if (lane == b) warp_counts[warp][b] = w;
  }
  __syncthreads();
  if (t < 32) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_counts[w][t];
    counts[static_cast<int64_t>(row) * 32 + t] = static_cast<int32_t>(total);
  }
  if (t == 0) eff_order[row] = ok ? order[row] : 0;
}

}  // namespace

extern "C" int sela_fir_rice(const void* x, const void* c, const void* order,
                             const void* n_valid, void* e, void* eff_order,
                             void* counts, int n_rows, int n, void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    fir_rice_kernel<<<n_rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(c),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(e),
        static_cast<int32_t*>(eff_order), static_cast<int32_t*>(counts), n);
  }
  return static_cast<int>(cudaGetLastError());
}
