// K9 for Hopper: the int32 chain microkernel, the roofline tool's probe of
// the card's integer multiply-add rate.
//
// Replaces tools/roofline.py::chain_kernel (built by make_probe inside
// vpu_microbench, pl.pallas_call at tools/roofline.py:79). Each of the
// rows x 128 int32 elements goes through T dependent steps
//     y <- y * 1103515245 + 12345   (mod 2^32)
// and is written back. The arithmetic is unsigned: signed overflow is
// undefined in C++, and the TPU kernel wraps. Bit-identical to the plain
// version (ops/chain.py::int_chain_reference) for every input and T.
//
// What bounds it on the card: operations, by design. A step is one IMAD
// (a 32-bit multiply-add) on the element's own chain; the bytes are one
// read and one write of 4 bytes an element, whatever T. With few elements
// a chain (rows = 8: 8 warps on 8 SMs) the time is T times the dependent
// IMAD latency; with many (rows = 512, or 2,112 = 16 blocks on each of
// 132 SMs) it is the IMAD issue rate. The tool reads both as the slope
// between two T, which cancels the launch and the memory traffic.
//
// The trap is the compiler: unrolled, (y a + b) a + b reassociates to
// y a^2 + (a b + b), one IMAD for two steps, and the rate would read 2x
// (or 4x, 8x) too high while staying bit-exact. So every step is its own
// `mad.lo.u32` in `asm volatile`, on operands the compiler cannot fold,
// and chip_smoke.py counts the IMADs by `a` in the static SASS: exactly
// UNROLL in the unrolled loop and one in the remainder loop, and none by
// a^2. Design: one element a thread (a block is one row of 128), the
// chain in a register, UNROLL steps an iteration so the loop's own
// counter and branch take a small share of the issue slots.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;       // elements a row = threads a block
constexpr int UNROLL = 16;       // steps an iteration of the main loop
constexpr uint32_t A = 1103515245u;
constexpr uint32_t B = 12345u;

__device__ __forceinline__ uint32_t step(uint32_t y, uint32_t b) {
  asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y) : "n"(A), "r"(b));
  return y;
}

__global__ void __launch_bounds__(LANES)
int_chain_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                 long long steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * LANES + threadIdx.x;
  uint32_t v = static_cast<uint32_t>(x[i]);
  uint32_t b = B;
  // b through an empty asm: a register the compiler cannot see the value
  // of, so it cannot fold two steps' additions either
  asm volatile("" : "+r"(b));
#pragma unroll 1
  for (long long n = steps / UNROLL; n > 0; --n) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = step(v, b);
  }
#pragma unroll 1
  for (int r = static_cast<int>(steps % UNROLL); r > 0; --r) v = step(v, b);
  y[i] = static_cast<int32_t>(v);
}

}  // namespace

extern "C" int sela_int_chain(const int32_t* x, int32_t* y, int rows,
                              long long steps, cudaStream_t stream) {
  if (rows <= 0) return 0;
  int_chain_kernel<<<rows, LANES, 0, stream>>>(x, y, steps);
  return static_cast<int>(cudaGetLastError());
}
