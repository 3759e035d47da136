// K1 for Hopper: Q20 dequantize + integer Levinson, one thread per row.
//
// Replaces sela_tpu/kernels/coeffs.py::_lpc_kernel (wrapper
// lpc_from_q_pallas). Per row r (a frame-channel):
//   g_m = 128(q_m+64)^2 - 2^20 (m=0), 2^20 - 128(q_m+64)^2 (m=1),
//         16384 q_m (m>=2), in wrapping int32 as the Pallas kernel does,
//         clamped to |g| <= 2^20 and zeroed for m >= order;
//   for m = 1..order: a'_i = clamp(a_i - ((k a_{m-2-i} + 2^19) >> 20),
//                                  -2^23, 2^23-1) for i < m-1; a'_{m-1} = k.
// Output c[r, :] = a (zeros beyond order). Bit-identical to the Pallas
// kernel and to the plain torch version (ops/coeffs.py::lpc_from_q_reference)
// for every int32 q.
//
// What bounds it on the card: by the work, bytes. Per row it reads 132
// bytes and writes 128, against at most 496 multiply-adds of a 32x32->64
// product, a fraction of a microsecond at the decode path's row counts
// (1,024 to 7,752). In practice the time is one row's serial recursion:
// 32 dependent steps, each a round of 64-bit products, shifts and clamps,
// and every row fits in one wave of blocks, so the launch takes that chain's
// latency whatever the row count (PERF.md). The TPU version's limb identity
// for the 64-bit product is unnecessary: k * a (|k| <= 2^20, |a| <= 2^23) is
// one mul.wide.s32 here.
//
// Design: the recursion is serial in m but independent across rows, so one
// thread owns one row and holds q, g and a in registers. Both loops are
// fully unrolled so the reversed index a[m-2-i] is a compile-time register
// name, never dynamically indexed local memory. Rows are staged through a
// shared-memory tile so that global loads and stores are coalesced (a warp
// moves one row's 128 contiguous bytes); the +1 column of padding makes the
// per-thread row reads bank-conflict free.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;        // MAX_ORDER
constexpr int ROWS = 128;    // rows (= threads) per block
constexpr int32_t G_LIM = 1 << 20;
constexpr int64_t SAT_LO = -(1 << 23);
constexpr int64_t SAT_HI = (1 << 23) - 1;

__global__ void __launch_bounds__(ROWS)
lpc_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ order,
           int32_t* __restrict__ c, int n_rows) {
  __shared__ int32_t tile[ROWS][P + 1];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const int64_t base = static_cast<int64_t>(row0) * P;
  for (int i = threadIdx.x; i < rows * P; i += ROWS) {
    tile[i / P][i % P] = q[base + i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    const int ord = order[row0 + r];
    int32_t g[P];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const uint32_t qm = static_cast<uint32_t>(tile[r][m]);
      uint32_t gm;
      if (m == 0) {
        gm = 128u * (qm + 64u) * (qm + 64u) - (1u << 20);
      } else if (m == 1) {
        gm = (1u << 20) - 128u * (qm + 64u) * (qm + 64u);
      } else {
        gm = qm * 16384u;
      }
      const int32_t gs = max(-G_LIM, min(G_LIM, static_cast<int32_t>(gm)));
      g[m] = m < ord ? gs : 0;
    }
    int32_t a[P];
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = 0;
#pragma unroll
    for (int m = 1; m <= P; ++m) {
      if (m > ord) break;  // later steps have k = 0: a stays as it is
      const int32_t k = g[m - 1];
      int32_t next[P];
#pragma unroll
      for (int i = 0; i < m - 1; ++i) {
        const int64_t d =
            (static_cast<int64_t>(k) * a[m - 2 - i] + (1 << 19)) >> 20;
        const int64_t v = static_cast<int64_t>(a[i]) - d;
        next[i] = static_cast<int32_t>(v < SAT_LO ? SAT_LO
                                                  : (v > SAT_HI ? SAT_HI : v));
      }
#pragma unroll
      for (int i = 0; i < m - 1; ++i) a[i] = next[i];
      a[m - 1] = k;
    }
#pragma unroll
    for (int m = 0; m < P; ++m) tile[r][m] = a[m];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * P; i += ROWS) {
    c[base + i] = tile[i / P][i % P];
  }
}

}  // namespace

extern "C" int sela_lpc_from_q(const void* q, const void* order, void* c,
                               int n_rows, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + ROWS - 1) / ROWS;
    lpc_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(q), static_cast<const int32_t*>(order),
        static_cast<int32_t*>(c), n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
