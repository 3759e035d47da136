// K5 for Hopper: Q20 FIR residues, the residue guard, zigzag and the 32
// per-bit counts of a row; one block of four warps a row, 16 consecutive
// samples a lane, the taps dispatched per row and run on the FP64 pipe
// where that is exact.
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
// (ops/filters.py::fir_rice_reference) for every int32 input. The TPU
// kernel splits x and c into 12/13-bit limbs (exact only for |x| < 2^26)
// and the JAX package keeps a separate generic path for 32-bit PCM; here
// one kernel serves both, with two exact ways to take the sum (below).
//
// What bounds it on the card: the bytes it must move (8 bytes a sample
// plus 128 of coefficients and counts a row: ~17 MB at the main path's
// [1,024, 2,048], 5.0 us at 3.35 TB/s); its integer work, which grows with
// the data (a multiply-add per sample per tap below the row's highest
// nonzero coefficient, the epilogue and the bit counts), is below that.
// PERF.md has both bounds against the measured time. What costs on the
// card is the multiply-adds: on an H100 80GB HBM3 at 700 W each tap of the
// main path's rows took ~0.24 us as IMAD.WIDE (~32 lanes a clock an SM, on
// the integer pipe that the epilogue and the counts need too) and ~0.15 us
// as DFMA (chip_smoke.py's row and tap sweeps; PERF.md).
//
// Design. A block of 4 warps owns a row of at most 2,048 samples; warp w
// its samples [512 w, 512 w + 512), lane l the T = 16 consecutive samples
// 512 w + 16 l + [0, 16). No step but the guard's vote and the final sum of
// the counts needs the block:
// - Staging: a warp copies its 512 samples and the 32 before them (zeros
//   before the row) into its own shared-memory region with 16-byte
//   cp.async copies (zero-filled past n), and waits for its own copies
//   only. Groups of 4 samples sit in XOR-permuted slots (slot()), so the 8
//   lanes of a 128-bit load phase hit all 32 banks.
// - Taps: the row's highest nonzero coefficient (a ballot over the 32
//   coefficients, the same in every warp) picks an unrolled body for 0, 8,
//   16, 24 or 32 taps; a zero tap adds nothing, so this is exact, and the
//   branch is uniform over the block. A body loads only the window its taps
//   reach (16 + taps samples, 128-bit shared loads).
// - Sums: where max |x| of the warp's staged samples times sum |c_j|, plus
//   2^19, is within 2^53 (every <= 24-bit row, and more), every product and
//   partial sum is an integer that a double holds exactly, so the taps run
//   as DFMA on the FP64 pipe (otherwise idle here) and the integer pipe is
//   left to the epilogue and the counts; the rounding shift and the
//   subtraction from x are one rounded-up fma onto 1.5 * 2^52, whose low
//   word is e's. Elsewhere (full-scale 32-bit rows under large
//   coefficients) the taps run as one IMAD.WIDE each into a uint64_t, which
//   wraps mod 2^64 as the JAX i64.add does.
// - Guard: each warp writes its residues at once, optimistically, and the
//   block decides the row with one __syncthreads_or. A row that fails (rare:
//   a prediction past 2^30 of the sample) is written again from the staged
//   x and counted again. Nothing reads e before the kernel ends. The stores
//   go through a per-warp shared-memory tile, so that each 128-bit store
//   instruction writes 512 contiguous bytes.
// - Counts: a lane adds (u >> j) & 0x11111111 of each zigzag code u into
//   nibble counter j (j = 0..3; nibble m counts bit j + 4m; at most 8, so no
//   carry), spilled into byte counters every 8 samples: 11 lane operations
//   a sample for all 32 bits, and half that when every code of the warp is
//   under 2^16, two codes then sharing a word. A recursive-halving
//   reduce-scatter over the warp (16 shuffles, 16-bit fields) leaves lane l
//   with its warp's count of bit l, and warp 0 adds the 4 warps' counts from
//   shared memory.
// Rows whose length is not a multiple of 4, or whose base is not 16-byte
// aligned, are staged by scalar loads and written by scalar stores instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;                  // taps (MAX_ORDER)
constexpr int MAX_N = 2048;            // FRAME_SIZE
constexpr int T = 16;                  // consecutive samples a lane owns
constexpr int PASS = 32 * T;           // 512 samples a warp
constexpr int WARPS = MAX_N / PASS;    // 4 warps a row
constexpr int THREADS = 32 * WARPS;
constexpr int STAGE = P + PASS;        // 544 samples a warp stages
constexpr int GROUPS = STAGE / 4;      // 136 groups of 4
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t LIMIT = int64_t{1} << 30;   // RESIDUE_LIMIT
constexpr uint32_t NIBBLES = 0x11111111u;
constexpr uint32_t LOW_NIBBLES = 0x0f0f0f0fu;
constexpr uint32_t LOW_BYTES = 0x00ff00ffu;

// Shared-memory slot of a warp's 4-sample group g: groups stay whole (one
// 128-bit word each), and row g / 8 of 8 slots is permuted by an XOR with
// its low two bits. Lane l's window starts at group 4l + const, so without
// the XOR the 8 lanes of a 128-bit load phase would land on 2 of the 8 slot
// positions of a row (a 4-way bank conflict); with it they cover all 8.
__device__ __forceinline__ int slot(int g) { return g ^ ((g >> 3) & 3); }

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

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

// Add the bits of the zigzag codes of out[0 .. T) into a lane's byte
// counters (byte p of bytes[b] counts bit b + 8p; zeros count nothing). When
// every code of the warp is under 2^16 (uniform over the warp), in half the
// work: two codes then share a word, the odd sample's in the high half, so
// nibble m of nib[j] counts bit j + 4m of the even code (m < 4) or bit
// j + 4 (m - 4) of the odd one (m >= 4).
__device__ __forceinline__ void count_codes(const int32_t (&out)[T],
                                            uint32_t (&bytes)[8]) {
  uint32_t u[T], any = 0;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    u[i] = (static_cast<uint32_t>(out[i]) << 1) ^
           static_cast<uint32_t>(out[i] >> 31);
    any |= u[i];
  }
  if (__any_sync(FULL, (any >> 16) != 0)) {
#pragma unroll
    for (int h = 0; h < T; h += 8) {
      uint32_t nib[4] = {0, 0, 0, 0};   // nibble m of nib[j]: bit j + 4m
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) nib[j] += (u[h + k] >> j) & NIBBLES;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bytes[j] += nib[j] & LOW_NIBBLES;             // bits j + 8p
        bytes[j + 4] += (nib[j] >> 4) & LOW_NIBBLES;  // bits j + 4 + 8p
      }
    }
  } else {
    uint32_t nib[4] = {0, 0, 0, 0};   // at most T / 2 = 8 a nibble
#pragma unroll
    for (int k = 0; k < T / 2; ++k) {
      const uint32_t w = u[2 * k] | (u[2 * k + 1] << 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) nib[j] += (w >> j) & NIBBLES;
    }
    // byte p of the low nibbles: bit j + 8 (p % 2) of the even (p < 2) or
    // odd (p >= 2) code; the two 16-bit halves add into bytes 0 and 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = nib[j] & LOW_NIBBLES;
      const uint32_t hi = (nib[j] >> 4) & LOW_NIBBLES;
      bytes[j] += (lo & 0xffffu) + (lo >> 16);       // bits j, j + 8
      bytes[j + 4] += (hi & 0xffffu) + (hi >> 16);   // bits j + 4, j + 12
    }
  }
}

// The warp's count of bit `lane` from every lane's byte counters.
__device__ __forceinline__ uint32_t warp_bit_count(const uint32_t (&bytes)[8],
                                                   int lane) {
  uint32_t half[16];   // field f of word h: the count of bit h + 16 f
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    half[b] = bytes[b] & LOW_BYTES;
    half[b + 8] = (bytes[b] >> 8) & LOW_BYTES;
  }
  // reduce-scatter over lane bits 8, 4, 2, 1: lane l ends with word l % 16
  // summed over its half-warp, then over the warp (a field is at most
  // 32 x 16 = 512 < 2^16, so none carries)
  halve<8>(half, lane);
  halve<4>(half, lane);
  halve<2>(half, lane);
  halve<1>(half, lane);
  const uint32_t sum = half[0] + __shfl_xor_sync(FULL, half[0], 16);
  return lane < 16 ? (sum & 0xffffu) : (sum >> 16);
}

// 1.5 * 2^52: a double d in [M - 2^51, M + 2^51) is the integer d - M held
// in its low mantissa bits, bits(d) = bits(M) + (d - M).
constexpr double MAGIC = 6755399441055744.0;
constexpr double TWO31 = 2147483648.0;

// MAGIC + 2^31 + v for an int32 v, exactly, from integer bits: one xor,
// where I2F.F64 would take the conversion unit.
__device__ __forceinline__ double magic_bits(int32_t v) {
  return __hiloint2double(0x43380000, v ^ static_cast<int32_t>(0x80000000));
}

// A lane's T samples of the row with its first TAPS coefficients (those
// beyond are zero): out[i] = the residue's low 32 bits for a valid sample,
// 0 past n_valid; returns whether a valid residue is outside the guard.
// st4: the warp's staged groups; the lane's sample i is staged sample
// P + 16 lane + i. F64: the taps as DFMA (the caller has checked that the
// sums stay within 2^53), taps outermost so that only the window the next
// tap reads is live; else as IMAD.WIDE into a uint64_t.
template <int TAPS, bool F64>
__device__ __forceinline__ bool row_body(const int4* st4, int32_t c_lane,
                                         int lane, int s0, int nv,
                                         int32_t (&out)[T]) {
  int32_t xi[T + P];   // staged samples 16 lane + [0, 48): the taps' window
#pragma unroll
  for (int k = (P - TAPS) / 4; k < (T + P) / 4; ++k) {
    const int4 v = st4[slot(T / 4 * lane + k)];
    xi[4 * k] = v.x;
    xi[4 * k + 1] = v.y;
    xi[4 * k + 2] = v.z;
    xi[4 * k + 3] = v.w;
  }
  bool bad = false;
  if constexpr (F64) {
    double w[T + P];
#pragma unroll
    for (int k = P - TAPS; k < T + P; ++k) {
      w[k] = magic_bits(xi[k]) - (MAGIC + TWO31);
    }
    double acc[T];
#pragma unroll
    for (int i = 0; i < T; ++i) acc[i] = 524288.0;   // 2^19, the rounding term
#pragma unroll
    for (int j = TAPS; j >= 1; --j) {
      const double cj = static_cast<double>(__shfl_sync(FULL, c_lane, j - 1));
#pragma unroll
      for (int i = 0; i < T; ++i) acc[i] = fma(cj, w[P + i - j], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      // MAGIC + x - acc / 2^20, rounded up onto the integers: MAGIC + x -
      // floor(acc / 2^20) = MAGIC + e exactly, and e's low word is its own
      const double t =
          __fma_ru(acc[i], -0x1p-20, magic_bits(xi[P + i]) - TWO31);
      const bool valid = s0 + i < nv;
      bad = bad || (valid && !(fabs(t - MAGIC) < 1073741824.0));
      out[i] = valid ? __double2loint(t) : 0;
    }
  } else {
    int32_t c[TAPS > 0 ? TAPS : 1];   // c_{j+1}, the same in every lane
#pragma unroll
    for (int j = 0; j < TAPS; ++j) c[j] = __shfl_sync(FULL, c_lane, j);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint64_t acc = uint64_t{1} << 19;   // the rounding term of >> 20
#pragma unroll
      for (int j = 1; j <= TAPS; ++j) {
        // both factors sign-extended from 32 bits: one IMAD.WIDE
        acc += static_cast<uint64_t>(static_cast<int64_t>(c[j - 1]) *
                                     static_cast<int64_t>(xi[P + i - j]));
      }
      const int64_t pred = static_cast<int64_t>(acc) >> 20;
      const int64_t e = static_cast<int64_t>(
          static_cast<uint64_t>(static_cast<int64_t>(xi[P + i])) -
          static_cast<uint64_t>(pred));
      const bool valid = s0 + i < nv;
      bad = bad || (valid && (e <= -LIMIT || e >= LIMIT));
      out[i] = valid ? static_cast<int32_t>(e) : 0;
    }
  }
  return bad;
}

// row_body for the row's highest nonzero tap: the tier's unrolled body.
template <bool F64>
__device__ __forceinline__ bool residues(int taps, const int4* st4,
                                         int32_t c_lane, int lane, int s0,
                                         int nv, int32_t (&out)[T]) {
  if (taps == 0) return row_body<0, F64>(st4, c_lane, lane, s0, nv, out);
  if (taps <= 8) return row_body<8, F64>(st4, c_lane, lane, s0, nv, out);
  if (taps <= 16) return row_body<16, F64>(st4, c_lane, lane, s0, nv, out);
  if (taps <= 24) return row_body<24, F64>(st4, c_lane, lane, s0, nv, out);
  return row_body<32, F64>(st4, c_lane, lane, s0, nv, out);
}

// Write a warp's 512 values of the row (those below n): when vec4, with
// coalesced 128-bit stores, each lane putting its 16 values in the warp's
// shared tile ot4 (swizzled groups) and storing groups lane + 32 k.
__device__ __forceinline__ void store_row(int32_t* er, int w0, int s0, int n,
                                          bool vec4, int lane, int4* ot4,
                                          const int32_t (&out)[T]) {
  if (!vec4) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (s0 + i < n) er[s0 + i] = out[i];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < T / 4; ++k) {
    ot4[slot(T / 4 * lane + k)] =
        make_int4(out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < PASS / 128; ++k) {
    const int g = lane + 32 * k;
    if (w0 + 4 * g < n) {
      *reinterpret_cast<int4*>(er + w0 + 4 * g) = ot4[slot(g)];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
fir_rice_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ coeffs,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ n_valid, int32_t* __restrict__ e,
                int32_t* __restrict__ eff_order, int32_t* __restrict__ counts,
                int n, bool vec4) {
  __shared__ __align__(16) int32_t stage[WARPS][STAGE];
  __shared__ uint32_t warp_counts[WARPS][32];
  __shared__ __align__(16) int32_t outs[WARPS][PASS];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t base = static_cast<int64_t>(row) * n;
  const int32_t* xr = x + base;
  const int w0 = PASS * warp;            // the warp's first sample
  const int s0 = w0 + T * lane;          // the lane's first sample
  int4* st4 = reinterpret_cast<int4*>(stage[warp]);
  int4* ot4 = reinterpret_cast<int4*>(outs[warp]);

  const bool active = w0 < n;            // uniform over the warp
  if (active) {   // staged sample i is x[w0 - P + i]
    if (vec4) {
#pragma unroll
      for (int k = 0; k < (GROUPS + 31) / 32; ++k) {
        const int g = lane + 32 * k;
        if (g < GROUPS) {
          const int s = w0 - P + 4 * g;
          const bool in = s >= 0 && s < n;   // else zero-filled
          copy16(st4 + slot(g), in ? xr + s : xr, in ? 16 : 0);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int i = lane; i < STAGE; i += 32) {
        const int s = w0 - P + i;
        stage[warp][4 * slot(i / 4) + i % 4] =
            s >= 0 && s < n ? __ldg(xr + s) : 0;
      }
    }
  }
  const int32_t c_lane = coeffs[static_cast<int64_t>(row) * P + lane];
  const unsigned nz = __ballot_sync(FULL, c_lane != 0);
  const int taps = nz ? 32 - __clz(nz) : 0;   // the highest nonzero tap
  const int nv = min(n_valid[row], n);

  int32_t out[T];
  bool bad = false;
  uint32_t cnt = 0;   // the warp's count of bit `lane`
  if (active) {
    if (vec4) asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
    // the FP64 domain: max |x| of the warp's staged samples times sum |c|,
    // plus 2^19, within 2^53 (a sum of |c| over 2^31 never qualifies)
    uint32_t xm = 0;
#pragma unroll
    for (int k = 0; k < (GROUPS + 31) / 32; ++k) {
      const int g = lane + 32 * k;
      if (g < GROUPS) {
        const int4 v = st4[g];
        xm = max(xm, max(max(static_cast<uint32_t>(abs(v.x)),
                             static_cast<uint32_t>(abs(v.y))),
                         max(static_cast<uint32_t>(abs(v.z)),
                             static_cast<uint32_t>(abs(v.w)))));
      }
    }
    xm = __reduce_max_sync(FULL, xm);
    const uint32_t ca = static_cast<uint32_t>(abs(c_lane));
    const bool small_c = __all_sync(FULL, ca < (1u << 26));
    const uint32_t cs = __reduce_add_sync(FULL, small_c ? ca : 0u);
    const bool f64 = small_c && static_cast<uint64_t>(xm) * cs +
                                    (1u << 19) <= (uint64_t{1} << 53);
    bad = f64 ? residues<true>(taps, st4, c_lane, lane, s0, nv, out)
              : residues<false>(taps, st4, c_lane, lane, s0, nv, out);
    // written at once: final unless the row fails
    store_row(e + base, w0, s0, n, vec4, lane, ot4, out);
    uint32_t bytes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    count_codes(out, bytes);
    cnt = warp_bit_count(bytes, lane);
  }
  warp_counts[warp][lane] = cnt;
  const bool fails = __syncthreads_or(bad);   // uniform over the block
  if (fails) {   // the order-0 fallback: e = x below n_valid
    if (active) {
      const int32_t* xs = stage[warp];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int k = P + T * lane + i;
        out[i] = s0 + i < nv ? xs[4 * slot(k / 4) + k % 4] : 0;
      }
      store_row(e + base, w0, s0, n, vec4, lane, ot4, out);
      uint32_t bytes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      count_codes(out, bytes);
      warp_counts[warp][lane] = warp_bit_count(bytes, lane);
    }
    __syncthreads();
  }
  if (warp == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_counts[w][lane];
    counts[static_cast<int64_t>(row) * 32 + lane] =
        static_cast<int32_t>(total);
    if (lane == 0) eff_order[row] = fails ? 0 : order[row];
  }
}

}  // namespace

extern "C" int sela_fir_rice(const void* x, const void* c, const void* order,
                             const void* n_valid, void* e, void* eff_order,
                             void* counts, int n_rows, int n, void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(e) % 16 == 0;
  if (n_rows > 0) {
    fir_rice_kernel<<<n_rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(c),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(e),
        static_cast<int32_t*>(eff_order), static_cast<int32_t*>(counts), n,
        vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
