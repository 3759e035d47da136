// K1 for Hopper: Q20 dequantize + integer Levinson, one warp a row.
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
// What bounds it on the card: by the work, bytes (132 bytes read and 128
// written a row, against at most 496 multiply-adds), a fraction of a
// microsecond at the decode's 1,024 to 7,752 rows. In practice the time is
// the launch and one row's recursion: 32 steps, each serial on the last.
// Tensor cores do not apply: the steps are a chain of 32 exact integer
// updates, each a rank-one reflection of one row's 32 values with its own k.
//
// Design: a warp owns a row, and lane i holds a_i and g_i (dequantized in
// the prologue, off the chain). Step m broadcasts k = g_{m-1} with a
// shuffle (it does not depend on a), fetches a_{m-2-i} with a second
// shuffle, and lane i < m-1 does one mul.wide.s32 with the rounding
// constant as its 64-bit addend, a funnel shift, a 32-bit subtract and a
// clamp: |k| <= 2^20 and |a| <= 2^23 keep the shifted product within
// 2^23 + 1 and a - d within int32, so only the product is 64-bit. The
// dependent chain a step is six instructions: SHFL -> IMAD.WIDE ->
// SHF.R.U64 -> VIADDMNMX (the subtract and the upper clamp) -> VIMNMX ->
// SEL (lane i's new value). Steps past the row's order have k = 0 and change
// nothing, so the warp stops at its order. q is read and c written one
// row's 128 contiguous bytes a warp transaction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 32;          // MAX_ORDER = lanes
constexpr int WARPS = 8;       // rows (= warps) per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t G_LIM = 1 << 20;
constexpr int32_t SAT_LO = -(1 << 23);
constexpr int32_t SAT_HI = (1 << 23) - 1;

__global__ void __launch_bounds__(WARPS * 32)
lpc_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ order,
           int32_t* __restrict__ c, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp: row is warp-uniform
  const int64_t base = static_cast<int64_t>(row) * P;
  const int steps = min(order[row], P);
  const uint32_t qm = static_cast<uint32_t>(q[base + lane]);
  const uint32_t sq = 128u * (qm + 64u) * (qm + 64u);
  const uint32_t gm =
      lane == 0 ? sq - (1u << 20) : (lane == 1 ? (1u << 20) - sq : qm * 16384u);
  const int32_t g = max(-G_LIM, min(G_LIM, static_cast<int32_t>(gm)));

  int32_t a = 0;
  for (int m = 1; m <= steps; ++m) {
    const int32_t k = __shfl_sync(FULL, g, m - 1);
    const int32_t am = __shfl_sync(FULL, a, (m - 2 - lane) & (P - 1));
    const int64_t s = static_cast<int64_t>(k) * am + (1 << 19);
    const int32_t d = static_cast<int32_t>(s >> 20);
    const int32_t v = max(SAT_LO, min(SAT_HI, a - d));
    a = lane < m - 1 ? v : (lane == m - 1 ? k : a);
  }
  c[base + lane] = a;
}

}  // namespace

extern "C" int sela_lpc_from_q(const void* q, const void* order, void* c,
                               int n_rows, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + WARPS - 1) / WARPS;
    lpc_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(q), static_cast<const int32_t*>(order),
        static_cast<int32_t*>(c), n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
