// K8 for Hopper: the 32 per-bit counts of each quarter of a residue row,
// for partitioned-residue planning, one block per row.
//
// Replaces sela_tpu/kernels/encode.py::_quarter_counts_kernel (wrapper
// quarter_counts_pallas). Per row r with n_valid v, quarter q covers the
// samples [lo_q, lo_{q+1}) with lo_q = (q v) >> 2 (lo_4 = v), and
//   out[r][q][j] = #{n in quarter q : bit j of zigzag(e[n])},
//   zigzag(e) = (uint32)(e << 1) ^ (uint32)(e >> 31).
// Samples from v on count in no quarter, whatever e holds there; v < 4
// leaves some quarters empty, v = 0 all of them.
// NORMATIVE: bit-identical to the plain torch version
// (ops/rice.py::quarter_counts_reference) for every int32 residue and every
// 0 <= v <= N. Every sum is an integer sum taken in a fixed order, with no
// atomics, so the counts do not depend on scheduling or the thread count.
//
// What bounds it on the card: the bytes it must move (4 a sample read, 512
// a row written: 8.9 MB at the main path's [1,024, 2,048], 2.66 us at 3.35
// TB/s) against its integer work, which grows with the data: the zigzag and
// the quarter test of each valid sample and a bit test and add per bit up
// to the row's widest code. PERF.md has both bounds against the measured
// time.
//
// Design: 256 threads (8 warps) own a row. A warp takes 32 consecutive
// samples at a time, one a lane, and the block 256 consecutive samples, so
// every load is coalesced. Per run of 32 samples the warp votes 4 ballots,
// "my sample is in quarter q", and 32 ballots, "my code has bit j set";
// lane j keeps the j-th bit mask and adds popc(bits_j & quarter_q) to its 4
// counters, so the 32 lanes together hold the warp's 4 x 32 counts with no
// shuffle. The run loop stops at the row's last valid sample (its bound
// depends on the warp alone, so a warp stays converged for its ballots).
// The 8 warps' counts meet in shared memory, and 128 threads sum them in
// warp order and write the row's [4][32].
// Not carried over from the TPU kernel: its 64-row grid cells and row
// padding, and its 4 x 32 masked full-row sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PARTS = 4;               // RESIDUE_PARTS
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
quarter_counts_kernel(const int32_t* __restrict__ e,
                      const int32_t* __restrict__ n_valid,
                      int32_t* __restrict__ out, int n) {
  __shared__ uint32_t warp_counts[WARPS][PARTS][32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t base = static_cast<int64_t>(row) * n;
  const int nv = n_valid[row];
  // quarter edges, shifts of nonnegative values (= floor division by 4)
  const int lo1 = nv >> 2, lo2 = (2 * nv) >> 2, lo3 = (3 * nv) >> 2;
  const int end = min(nv, n);          // samples from here on count nowhere

  uint32_t cnt[PARTS] = {0, 0, 0, 0};
  for (int s0 = warp * 32; s0 < end; s0 += THREADS) {
    const int s = s0 + lane;
    const bool valid = s < end;
    const int32_t v = valid ? e[base + s] : 0;
    const uint32_t u =
        (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
    const int qi = valid ? (s >= lo1) + (s >= lo2) + (s >= lo3) : PARTS;
    uint32_t bits_of_lane = 0;   // lane j: which lanes' codes have bit j
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t b = __ballot_sync(FULL, (u >> j) & 1u);
      if (lane == j) bits_of_lane = b;
    }
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      cnt[q] += __popc(bits_of_lane & __ballot_sync(FULL, qi == q));
    }
  }
#pragma unroll
  for (int q = 0; q < PARTS; ++q) warp_counts[warp][q][lane] = cnt[q];
  __syncthreads();
  if (threadIdx.x < PARTS * 32) {
    const int q = threadIdx.x / 32, j = threadIdx.x % 32;
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_counts[w][q][j];
    out[static_cast<int64_t>(row) * PARTS * 32 + threadIdx.x] =
        static_cast<int32_t>(total);
  }
}

}  // namespace

extern "C" int sela_quarter_counts(const void* e, const void* n_valid,
                                   void* out, int n_rows, int n,
                                   void* stream) {
  if (n_rows > 0) {
    quarter_counts_kernel<<<n_rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(e), static_cast<const int32_t*>(n_valid),
        static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
