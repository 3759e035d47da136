// K6 for Hopper: exact optimal Rice parameters, one warp a row; its render
// entry does all of the encode render's Rice planning in one launch.
//
// Replaces sela_tpu/kernels/encode.py::_make_ksel_kernel (wrapper
// ksel_pallas). Per block of n values whose zigzag codes u have c_j set
// bits at bit j:
//   S(k) = sum_{j >= k} c_j 2^(j - k)   (= sum(u >> k))
//   cost(k) = S(k) + n (k+1) for k <= k_max; the least cost, ties to the
//   lowest k; the verbatim escape k = 31 with 32n bits when 32n < that
//   cost; (0, 0) when n == 0.
// The TPU kernel carries S as (int32 hi, uint32 lo) lane pairs; here it is
// native uint64, exact because S(0) < n 2^32 <= 2^48.
//
// Two C entry points share the selection (warp_select):
// - sela_ksel, the generic entry (ops/rice.py::ksel, plain version
//   k_and_bits_reference): counts [B, 32] + n [B] -> k, bits [B];
// - sela_rice_plan, the render entry (ops/rice.py::rice_plan, plain version
//   rice_plan_reference): K5's residue counts, K4's q, K5's eff_order and
//   n_valid and, under partitioned residues, K8's quarter counts -> q_eff,
//   the coefficient block's bit counts, the residue, coefficient and
//   quarter selections and the partition decision, k_res, kr4, k_coeff,
//   nw_res, nw_coeff and block_bits (the JAX _render_rows from K5 on).
// Both are bit-identical to their plain versions for every counts <= n <=
// 65535, 0 <= eff_order <= 32, every int32 q and every k_max in [0, 30].
//
// What bounds it on the card: the launch. A render row reads 264 bytes
// (776 under partitioned residues) and writes 152; the main path's 1,024
// rows move 0.43 MB, 0.13 us at 3.35 TB/s, against ~3 us for any launch.
// So the design gives this one launch the work that sat around it: as
// PyTorch operations the planning was 117 device launches a chunk (143
// under partitioned residues; H100 profile of a 512-frame stereo chunk),
// 96 of them the coefficient counts' shift / mask / sum passes.
//
// Design: lane j of a row's warp holds bit column j. Coefficient counts:
// lane j zigzags q_eff_j, and bit b's count is the popcount of a ballot of
// bit b, kept by lane b, for b below the width of the warp's OR (7 bits
// for the encoder's q in [-64, 63], 32 at most). S(k) is a weighted suffix
// scan: five __shfl_down_sync doubling steps, lane k adding 2^m times lane
// k + m's window. cost(k) takes a five-step xor-shuffle minimum, and the
// lowest lane holding it (a ballot) is the lowest k among equal costs. The
// selections of a row (2, or 6 with the quarters) run interleaved. The
// epilogue is computed by every lane; lane i stores output i.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 32;              // bit columns of a counts row
constexpr int WARPS = 4;           // rows (= warps) per block
constexpr int K_ESCAPE = 31;
constexpr int PARTS = 4;           // RESIDUE_PARTS (format.py)
constexpr int PART_MARKER = 32;    // RICE_PARTITION_MARKER (format.py)
constexpr unsigned FULL = 0xffffffffu;
using u64 = unsigned long long;    // the shuffles' 64-bit type

// NS selections at once: lane j holds c[s] = bit j's count of block s, and
// n[s] (the same in every lane) its value count. Every lane gets k and
// bits of every block.
template <int NS>
__device__ __forceinline__ void warp_select(const uint32_t (&c)[NS],
                                            const uint32_t (&n)[NS],
                                            int k_max, int lane,
                                            int32_t (&k)[NS],
                                            int32_t (&bits)[NS]) {
  u64 s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = c[i];
  // after the step of offset m, lane k holds sum_{j=k}^{k+2m-1} c_j 2^(j-k)
#pragma unroll
  for (int m = 1; m < K; m <<= 1) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const u64 up = __shfl_down_sync(FULL, s[i], m);
      if (lane + m < K) s[i] += up << m;
    }
  }
  u64 cost[NS], best[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    cost[i] = lane <= k_max
                  ? s[i] + static_cast<u64>(n[i]) * (lane + 1)
                  : ~0ull;
    best[i] = cost[i];
  }
#pragma unroll
  for (int m = K / 2; m >= 1; m >>= 1) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const u64 other = __shfl_xor_sync(FULL, best[i], m);
      best[i] = other < best[i] ? other : best[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    // the lowest k whose cost is the least (lanes past k_max hold ~0)
    int32_t kk = __ffs(__ballot_sync(FULL, cost[i] == best[i])) - 1;
    u64 b = best[i];
    const u64 verb = 32ull * n[i];
    if (verb < b) {
      kk = K_ESCAPE;
      b = verb;
    }
    if (n[i] == 0) {
      kk = 0;
      b = 0;
    }
    k[i] = kk;
    bits[i] = static_cast<int32_t>(b);
  }
}

__device__ __forceinline__ int32_t block_words(int32_t bits) {
  return (bits + 31) >> 5;
}

__global__ void __launch_bounds__(WARPS * 32)
ksel_kernel(const int32_t* __restrict__ counts,
            const int32_t* __restrict__ n_valid, int32_t* __restrict__ k_out,
            int32_t* __restrict__ bits_out, int n_rows, int k_max) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp: its row is past the end
  const uint32_t c[1] = {static_cast<uint32_t>(
      counts[static_cast<int64_t>(row) * K + lane])};
  const uint32_t n[1] = {static_cast<uint32_t>(n_valid[row])};
  int32_t k[1], bits[1];
  warp_select<1>(c, n, k_max, lane, k, bits);
  if (lane == 0) k_out[row] = k[0];
  if (lane == 1) bits_out[row] = bits[0];
}

// out: [6, n_rows] k_res, kr4, k_coeff, nw_res, nw_coeff, block_bits
template <bool PART>
__global__ void __launch_bounds__(WARPS * 32)
rice_plan_kernel(const int32_t* __restrict__ counts_res,
                 const int32_t* __restrict__ q,
                 const int32_t* __restrict__ eff_order,
                 const int32_t* __restrict__ n_valid,
                 const int32_t* __restrict__ quarter_counts,
                 int32_t* __restrict__ q_eff, int32_t* __restrict__ out,
                 int n_rows, int k_max) {
  constexpr int NS = PART ? 2 + PARTS : 2;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp: its row is past the end
  const int64_t at = static_cast<int64_t>(row) * K + lane;
  uint32_t c[NS], n[NS];
  c[0] = static_cast<uint32_t>(counts_res[at]);
  const int32_t qv = q[at];
  const int32_t eo = eff_order[row];
  const int32_t nv = n_valid[row];
  if (PART) {
#pragma unroll
    for (int i = 0; i < PARTS; ++i) {
      c[2 + i] = static_cast<uint32_t>(
          quarter_counts[(static_cast<int64_t>(row) * PARTS + i) * K + lane]);
      // quarter i is [(i nv) >> 2, ((i + 1) nv) >> 2), in int32 as the
      // plain version computes it
      const uint32_t nvu = static_cast<uint32_t>(nv);
      const int32_t lo = static_cast<int32_t>(i * nvu) >> 2;
      const int32_t hi = static_cast<int32_t>((i + 1) * nvu) >> 2;
      n[2 + i] = static_cast<uint32_t>(hi - lo);
    }
  }
  n[0] = static_cast<uint32_t>(nv);
  n[1] = static_cast<uint32_t>(eo);

  // q_eff, and its zigzag codes' bit counts: lane b keeps bit b's
  const int32_t qe = lane < eo ? qv : 0;
  q_eff[at] = qe;
  const uint32_t z = (static_cast<uint32_t>(qe) << 1) ^
                     static_cast<uint32_t>(qe >> 31);
  const int width = 32 - __clz(__reduce_or_sync(FULL, z));
  uint32_t cc = 0;
  for (int b = 0; b < width; ++b) {
    const uint32_t cnt = __popc(__ballot_sync(FULL, (z >> b) & 1u));
    if (lane == b) cc = cnt;
  }
  c[1] = cc;

  int32_t k[NS], bits[NS];
  warp_select<NS>(c, n, k_max, lane, k, bits);

  int32_t k_res = k[0], nw_res = block_words(bits[0]), kr4 = 0, header = 0;
  const int32_t nw_coeff = block_words(bits[1]);
  if (PART) {
    const int32_t nw_part =
        block_words(bits[2] + bits[3] + bits[4] + bits[5]);
    // the partitioned block pays one sub-k byte a quarter in its header
    if (nv >= PARTS && 32 * nw_part + 8 * PARTS < 32 * nw_res) {
      kr4 = k[2] | (k[3] << 8) | (k[4] << 16) | (k[5] << 24);
      k_res = PART_MARKER;
      nw_res = nw_part;
      header = PARTS;
    }
  }
  const int32_t vals[6] = {k_res,  kr4,      k[1],
                           nw_res, nw_coeff,
                           32 * (nw_res + nw_coeff) + 8 * header};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (lane == i) out[static_cast<int64_t>(i) * n_rows + row] = vals[i];
  }
}

int blocks_for(int n_rows) { return (n_rows + WARPS - 1) / WARPS; }

}  // namespace

extern "C" int sela_ksel(const void* counts, const void* n_valid, void* k,
                         void* bits, int n_rows, int k_max, void* stream) {
  if (n_rows > 0) {
    ksel_kernel<<<blocks_for(n_rows), WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(k),
        static_cast<int32_t*>(bits), n_rows, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// quarter_counts may be null: then no partitioned-residue decision (v1)
extern "C" int sela_rice_plan(const void* counts_res, const void* q,
                              const void* eff_order, const void* n_valid,
                              const void* quarter_counts, void* q_eff,
                              void* out, int n_rows, int k_max, void* stream) {
  if (n_rows > 0) {
    const auto kernel = quarter_counts != nullptr ? &rice_plan_kernel<true>
                                                  : &rice_plan_kernel<false>;
    kernel<<<blocks_for(n_rows), WARPS * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(counts_res),
        static_cast<const int32_t*>(q),
        static_cast<const int32_t*>(eff_order),
        static_cast<const int32_t*>(n_valid),
        static_cast<const int32_t*>(quarter_counts),
        static_cast<int32_t*>(q_eff), static_cast<int32_t*>(out), n_rows,
        k_max);
  }
  return static_cast<int>(cudaGetLastError());
}
