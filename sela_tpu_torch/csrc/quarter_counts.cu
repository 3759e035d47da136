// K8 for Hopper: the 32 per-bit counts of each quarter of a residue row,
// for partitioned-residue planning, one warp a quarter.
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
// 0 <= v <= N <= 2,048. Every sum is an integer sum taken in a fixed order,
// with no atomics, so the counts do not depend on scheduling.
//
// What bounds it on the card: the bytes it must move. It reads e only up
// to n_valid (4 bytes a valid sample) and n_valid, and writes 512 bytes a
// row: at the main path's [1,024, 2,048] and its n_valid, 8.65 MB, 2.583 us
// at 3.35 TB/s. Its integer work, counted as a shift-and-add a bit up to
// the row's widest code (chip_smoke.py::quarter_counts_bound), is below
// that.
//
// Design: 128 threads own a row, warp q its quarter q, lanes on
// consecutive samples (coalesced loads). A lane counts its own samples in
// packed counters, with no ballots: it loads 8 samples at once (8 loads in
// flight a lane), zigzags them, and adds (u >> j) & 0x11111111 into nibble
// counter j (j = 0..3; nibble m counts bit j + 4m), which takes at most 8
// and so cannot carry; after each 8 samples the nibbles are spread into
// byte counters (byte p of word b counts bit b + 8p). A lane holds at most
// ceil(N / 32) = 64 samples of a quarter, so the bytes never carry either:
// the kernel needs N <= 2,048 (the wrapper checks it; so does the entry
// point). That is 11 lane operations a sample for all 32 bits, about what
// the bound's shift-and-add counts for 3 bits of width, so no width test is
// needed. At the end the bytes become 16-bit fields (word h holds bits h and
// h + 16), which a recursive-halving reduce-scatter over the warp sums
// (8 + 4 + 2 + 1 shuffles, then one butterfly across the half-warps: 16
// in all; a sum is at most 2,048), leaving lane l with bit l's count of the
// quarter, and one coalesced 128-byte store writes out[r][q][0..31].
// Not carried over from the TPU kernel: its 64-row grid cells and row
// padding, and its 4 x 32 masked full-row sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PARTS = 4;               // RESIDUE_PARTS
constexpr int THREADS = PARTS * 32;    // one warp a quarter
constexpr int MAX_N = 2048;            // FRAME_SIZE
constexpr int CHUNK = 8;               // samples a lane loads at once;
                                       // a nibble counts at most 8 < 16
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NIBBLES = 0x11111111u;
constexpr uint32_t LOW_NIBBLES = 0x0f0f0f0fu;
constexpr uint32_t LOW_BYTES = 0x00ff00ffu;

// One step of a recursive-halving reduce-scatter over the warp: a lane
// keeps the upper half of its live words v[0 .. 2H) if bit H of its lane is
// set, else the lower, sends the other half to lane ^ H and adds what that
// lane sends back into v[0 .. H). H is a template argument so that every
// index is known at compile time and v stays in registers.
template <int H>
__device__ __forceinline__ void halve(uint32_t (&v)[16], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const uint32_t send = upper ? v[i] : v[i + H];
    const uint32_t keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

__global__ void __launch_bounds__(THREADS)
quarter_counts_kernel(const int32_t* __restrict__ e,
                      const int32_t* __restrict__ n_valid,
                      int32_t* __restrict__ out, int n) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const int nv = n_valid[row];
  // quarter edges: arithmetic shifts (= floor division by 4, as the plain
  // version's //), clipped to the row
  const int lo = max((q * nv) >> 2, 0);
  const int hi = min(((q + 1) * nv) >> 2, n);
  const int32_t* er = e + static_cast<int64_t>(row) * n;

  uint32_t bytes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int s0 = lo + lane; s0 < hi; s0 += CHUNK * 32) {
    uint32_t u[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int s = s0 + 32 * k;
      const int32_t v = s < hi ? __ldg(er + s) : 0;   // zigzag(0) = 0
      u[k] = (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
    }
    uint32_t nib[4] = {0, 0, 0, 0};   // nibble m of nib[j]: bit j + 4m
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) nib[j] += (u[k] >> j) & NIBBLES;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bytes[j] += nib[j] & LOW_NIBBLES;             // bits j + 8p
      bytes[j + 4] += (nib[j] >> 4) & LOW_NIBBLES;  // bits j + 4 + 8p
    }
  }

  uint32_t half[16];   // field f of word h: the count of bit h + 16 f
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    half[b] = bytes[b] & LOW_BYTES;
    half[b + 8] = (bytes[b] >> 8) & LOW_BYTES;
  }
  // reduce-scatter over lane bits 8, 4, 2, 1: lane l ends with word l % 16
  // summed over its half-warp
  halve<8>(half, lane);
  halve<4>(half, lane);
  halve<2>(half, lane);
  halve<1>(half, lane);
  const uint32_t sum = half[0] + __shfl_xor_sync(FULL, half[0], 16);
  const uint32_t count = lane < 16 ? (sum & 0xffffu) : (sum >> 16);  // bit l
  out[(static_cast<int64_t>(row) * PARTS + q) * 32 + lane] =
      static_cast<int32_t>(count);
}

}  // namespace

extern "C" int sela_quarter_counts(const void* e, const void* n_valid,
                                   void* out, int n_rows, int n,
                                   void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    quarter_counts_kernel<<<n_rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(e), static_cast<const int32_t*>(n_valid),
        static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
