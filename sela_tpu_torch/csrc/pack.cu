// Rice packing of plain blocks on the card: one block a row.
//
// Replaces sela_tpu/ops/pack.py::pack_blocks_device (jnp, not a Pallas
// kernel: a cumsum of code lengths, then searchsorted segment sums of the
// scattered bit patterns). Row r holds n int32 values, the first n_valid[r]
// of which form a Rice block with parameter k[r] (0 <= k <= 30); the kernel
// writes the block's MSB-first uint32 word stream (FORMAT.md §Rice: per value
// u = zigzag(v), (u >> k) one-bits, a zero stop bit, the k low bits of u)
// into words[r][0 .. max_words) and its true word count into nwords[r]. Bits
// past the block's bit count are zero, so words[r][:nwords[r]] is
// byte-identical to the host packer's (native/bitio.cpp, ref.rice.encode).
// A row whose words exceed max_words keeps its first max_words words and
// reports its true count. Escape (k = 31) and partitioned blocks are not
// plain blocks; the wrapper refuses them, and a row whose k is outside
// [0, 30] gets nwords -1 and zero words.
//
// Two entries. `sela_pack` writes row r at words[r][0 .. max_words) of a
// [rows, max_words] array (the bench's A/B). `sela_pack_at` is the
// encoder's: codec/encoder.py::encode_wav launches it twice a chunk of the
// v1 profile (the residue blocks, then the coefficient blocks), and row r
// goes to words[offs[r] .. offs[r] + cap[r]) of one flat buffer, offs
// being the exclusive cumsum of K6's planned word counts and cap[r] the
// row's own, so the chunk's words come back to the host already in emit
// order. A row whose k is outside [0, 30] writes nothing there and gets
// nwords -1: the host packs it and fills its gap, and compares every
// nwords with the plan.
// NORMATIVE: bit-identical to the plain torch version
// (ops/pack.py::pack_blocks_reference) for every int32 value, 0 <= n <=
// 2,048 and 0 <= k <= 30. Offsets are 64-bit: forced small k on wide values
// can push a row past 2^32 bits (the jnp version wraps there).
//
// The complement trick (the jnp version's): in the complement of the stream
// a value's unary run is all zeros, so a value contributes one (k + 1)-bit
// pattern, its stop bit (1) then ~u's k low bits, ending at bit
// off + q + k, that touches at most two words. Patterns of different values
// have disjoint bits, so ORing them into a zeroed buffer in any order is
// exact, and the row is ~buffer under the mask of its bit count.
//
// What bounds it on the card: the bytes it must move. It reads the values
// only up to n_valid (4 bytes a value), k and n_valid, and writes max_words
// words and nwords a row: at the CD chunk's [1,024, 2,048] under its planned
// k, ~11 MB, ~3.3 us at 3.35 TB/s. Its integer work (~20 operations a
// value, the scan's shuffles) is below that.
//
// Design (simple first; warp-level scans, vectorized loads and one pass are
// later work): 256 threads own a row; thread t takes the ceil(n / 256) <= 8
// consecutive values from t ceil(n / 256), zigzags them into registers and
// sums their code lengths (u >> k) + 1 + k in 64 bits; a block-wide
// exclusive scan (warp shuffles, then the 8 warp sums) gives each thread its
// first bit offset; each value atomicOrs its pattern into a buffer of
// max_words (cap[r]) words, in shared memory where max_words * 4 bytes fit
// in 48 KB (sela_pack_at: where cap[r] fits the launch's buffer of n + 1
// words; every plain block of a 2,048-sample frame at its optimal k: at most
// 2,048 * 32 + 32 bits, 2,049 words), else in the row of the output itself;
// after a barrier, each word is written as ~buffer & the mask of the bits
// the row has in it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 8;                    // values a thread at most
constexpr int MAX_N = THREADS * PER;      // FRAME_SIZE
constexpr int K_MAX = 30;                 // RICE_K_MAX
constexpr int SMEM_WORDS = 12000;         // 48,000 B: under the 48 KB a
                                          // block may use without opt-in
constexpr unsigned FULL = 0xffffffffu;

// Exclusive scan of v over the block; *total receives the block's sum.
// Contains the barriers that order everything before it against
// everything after it.
__device__ __forceinline__ uint64_t block_exclusive_scan(
    uint64_t v, uint64_t* warp_sums, uint64_t* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t x = v;   // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp sums
    uint64_t w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const uint64_t y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[WARPS - 1];
  return (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
}

// Packs one row's block into buf[0, cap) (shared memory, or `out` itself)
// and writes it to out[0, cap) as ~buf under the mask of the row's bit
// count; thread 0 stores the row's true word count in *nwords. The caller
// has checked 0 <= k <= K_MAX.
__device__ __forceinline__ void pack_row(
    const int32_t* __restrict__ x, int k, int nv, int n, uint32_t* buf,
    uint32_t* out, uint64_t cap, uint64_t* warp_sums, int64_t* nwords) {
  const int t = threadIdx.x;
  for (uint64_t w = t; w < cap; w += THREADS) buf[w] = 0;

  const int per = (n + THREADS - 1) / THREADS;
  const int s0 = t * per;
  uint32_t u[PER];
  uint64_t bits = 0;   // this thread's code lengths: < 8 (2^32 + 31)
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    u[i] = 0;
    if (i < per && s0 + i < nv) {
      const int32_t v = x[s0 + i];
      u[i] = (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
      bits += static_cast<uint64_t>(u[i] >> k) + 1 + k;
    }
  }
  uint64_t total;   // the row's bits: < 2,048 (2^32 + 31) < 2^44
  uint64_t off = block_exclusive_scan(bits, warp_sums, &total);

  const uint32_t kmask = (1u << k) - 1u;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i < per && s0 + i < nv) {
      const uint32_t q = u[i] >> k;
      const uint64_t stop = off + q;                  // the stop bit
      const uint32_t pat = (1u << k) | (~u[i] & kmask);   // k + 1 bits
      const uint64_t w0 = stop >> 5;
      const int end = static_cast<int>(stop & 31) + k;    // pattern's last
      if (w0 < cap) {                                     // bit, <= 61
        if (end <= 31) {
          atomicOr(&buf[w0], pat << (31 - end));
        } else {
          atomicOr(&buf[w0], pat >> (end - 31));
          if (w0 + 1 < cap) atomicOr(&buf[w0 + 1], pat << (63 - end));
        }
      }
      off = stop + 1 + k;
    }
  }
  __syncthreads();
  for (uint64_t w = t; w < cap; w += THREADS) {
    const int64_t left = static_cast<int64_t>(total) - 32 * static_cast<int64_t>(w);
    const uint32_t mask = left >= 32 ? FULL
                        : left <= 0  ? 0u
                                     : ~(FULL >> static_cast<int>(left));
    out[w] = ~buf[w] & mask;
  }
  if (t == 0) *nwords = static_cast<int64_t>((total + 31) >> 5);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ ks,
            const int32_t* __restrict__ n_valid, uint32_t* __restrict__ words,
            int64_t* __restrict__ nwords, int n, int max_words) {
  extern __shared__ uint32_t smem[];
  __shared__ uint64_t warp_sums[WARPS];
  const int row = blockIdx.x, t = threadIdx.x;
  uint32_t* out = words + static_cast<int64_t>(row) * max_words;
  const int k = ks[row];
  if (k < 0 || k > K_MAX) {   // not a plain block (the wrapper refuses it)
    for (int w = t; w < max_words; w += THREADS) out[w] = 0;
    if (t == 0) nwords[row] = -1;
    return;
  }
  pack_row(values + static_cast<int64_t>(row) * n, k,
           min(max(n_valid[row], 0), n), n, kShared ? smem : out, out,
           static_cast<uint64_t>(max_words), warp_sums, nwords + row);
}

// The encoder's entry: row r's block goes to words[offs[r], offs[r] +
// cap[r]) of one flat buffer of `total` words, cap[r] being its planned
// word count, so a wrong plan cannot write into the next row's words (nor
// past the buffer: the span is clipped to [0, total)). Rows with k outside
// [0, 30] (the escape 31, the partition marker 32) write nothing and get
// nwords -1. A row packs in shared memory where cap[r] <= smem_words, else
// in its span of the output.
__global__ void __launch_bounds__(THREADS)
pack_at_kernel(const int32_t* __restrict__ values,
               const int32_t* __restrict__ ks,
               const int32_t* __restrict__ n_valid,
               const int64_t* __restrict__ offs,
               const int32_t* __restrict__ caps, uint32_t* __restrict__ words,
               int64_t* __restrict__ nwords, int n, int64_t total,
               int smem_words) {
  extern __shared__ uint32_t smem[];
  __shared__ uint64_t warp_sums[WARPS];
  const int row = blockIdx.x;
  const int k = ks[row];
  if (k < 0 || k > K_MAX) {
    if (threadIdx.x == 0) nwords[row] = -1;
    return;
  }
  const int64_t off = offs[row];
  const int64_t room = off >= 0 && off < total ? total - off : 0;
  const int64_t cap = min(static_cast<int64_t>(max(caps[row], 0)), room);
  uint32_t* out = words + (room ? off : 0);
  pack_row(values + static_cast<int64_t>(row) * n, k,
           min(max(n_valid[row], 0), n), n, cap <= smem_words ? smem : out,
           out, static_cast<uint64_t>(cap), warp_sums, nwords + row);
}

}  // namespace

extern "C" int sela_pack(const void* values, const void* k, const void* n_valid,
                         void* words, void* nwords, int n_rows, int n,
                         int max_words, void* stream) {
  if (n < 0 || n > MAX_N || max_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* v = static_cast<const int32_t*>(values);
    const auto* kk = static_cast<const int32_t*>(k);
    const auto* nv = static_cast<const int32_t*>(n_valid);
    auto* w = static_cast<uint32_t*>(words);
    auto* nw = static_cast<int64_t*>(nwords);
    if (max_words <= SMEM_WORDS) {
      pack_kernel<true><<<n_rows, THREADS, max_words * sizeof(uint32_t), s>>>(
          v, kk, nv, w, nw, n, max_words);
    } else {
      pack_kernel<false><<<n_rows, THREADS, 0, s>>>(v, kk, nv, w, nw, n,
                                                    max_words);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sela_pack_at(const void* values, const void* k,
                            const void* n_valid, const void* offs,
                            const void* caps, void* words, void* nwords,
                            int n_rows, int n, long long total,
                            int smem_words, void* stream) {
  if (n < 0 || n > MAX_N || total < 0 || smem_words < 0
      || smem_words > SMEM_WORDS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    pack_at_kernel<<<n_rows, THREADS, smem_words * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(values), static_cast<const int32_t*>(k),
        static_cast<const int32_t*>(n_valid),
        static_cast<const int64_t*>(offs), static_cast<const int32_t*>(caps),
        static_cast<uint32_t*>(words), static_cast<int64_t*>(nwords), n,
        static_cast<int64_t>(total), smem_words);
  }
  return static_cast<int>(cudaGetLastError());
}
