// K3 for Hopper: float32 autocorrelation of a row at lags 0..32, one warp
// per row, a register-tiled sliding window over a row staged by cp.async.
//
// Replaces sela_tpu/kernels/encode.py::_autocorr_kernel (wrapper
// autocorr_pallas). Per row: xf[n] = x[n] * (1 / 32768), then
//   r[lag] = sum_{n + lag < N} xf[n] xf[n + lag],  lag = 0..32,
// in float32; zero padding at the end of a row contributes nothing.
// NON-NORMATIVE: analysis only picks the stream the encoder emits, so the
// kernel is held to a tolerance (|r - r_plain| <= 1e-5 r[0] a row), not to
// bits: its sums run in another order than the plain torch version
// (ops/analysis.py::autocorr_reference).
//
// What bounds it on the card: bytes. A row reads 4N bytes and writes 132,
// against 33 multiply-adds a sample; at the main path's [2,048, 2,048] the
// bound is 17.05 MB at 3.35 TB/s = 5.09 us, just above the 277 MFLOP at 67
// TFLOP/s (4.13 us), so the kernel has to keep the FMA pipe busy while the
// row streams in.
//
// Design: a warp (one block of 32 threads) owns a row of at most 2,048
// samples, so no step needs a block barrier. The row is copied raw into
// shared memory by 16-byte cp.async copies, issued at once in 4 chunks of
// 512 samples (one commit group each), followed by 32 zeros; copies past n
// zero-fill, so every lag reads in bounds without a branch. Lane l owns the
// T = 16 consecutive samples 16l + 512p of pass p. Before pass p the warp
// waits for chunks p and p + 1 only, each lane converts the groups it copied
// to float in place, and the later chunks keep streaming in under the pass's
// FMAs. A pass loads the lane's 48-sample window with twelve 128-bit shared
// loads and does the 16 x 33 FMAs from registers. Groups of 4 samples sit in
// XOR-permuted slots (slot()), so the 8 lanes of a load phase hit all 32
// banks. The sums are taken on x unscaled and multiplied by 2^-30 at the
// end: every product and partial sum is an integer of magnitude 0 or 1 to
// 2^73, so that is exact and rounds as scaling first would. The warp
// reduces its 33 partial sums by recursive halving (a reduce-scatter: a
// lane sends the half it gives away, 16 + 8 + 4 + 2 + 1 shuffles, and lane
// l ends with lag l's sum), lag 32 by a 5-shuffle butterfly, in a fixed
// order, so the result does not change from run to run. Rows whose length
// is not a multiple of 4, or whose base is not 16-byte aligned, are staged
// by scalar loads instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LAGS = 33;               // MAX_ORDER + 1
constexpr int MAX_N = 2048;            // FRAME_SIZE
constexpr int T = 16;                  // consecutive samples a lane owns
constexpr int WIN = T + LAGS - 1;      // 48: the window a pass reads
constexpr int PASS = 32 * T;           // 512 samples a pass, one chunk
constexpr int CHUNKS = MAX_N / PASS;   // 4
constexpr int GROUPS = PASS / 4;       // 128 groups of 4 samples a chunk
constexpr unsigned FULL = 0xffffffffu;
constexpr float SCALE2 = 1.0f / 1073741824.0f;   // (1 / 32768)^2 = 2^-30

// One step of a recursive-halving reduce-scatter over the warp: of its H
// live sums per half (v[0 .. 2H)), a lane keeps the upper half if bit H of
// its lane is set, else the lower, sends the other half to lane ^ H and
// adds what that lane sends back into v[0 .. H). H is a template argument
// so that every index is known at compile time and v stays in registers.
template <int H>
__device__ __forceinline__ void halve(float (&v)[LAGS], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Shared-memory slot of the row's 4-sample group g: groups stay whole (one
// 128-bit word each), and row g / 8 of 8 slots is permuted by an XOR with
// its low two bits. Lane l's windows start at group 4l, so without the XOR
// the 8 lanes of a 128-bit load phase would land on 2 of the 8 slot
// positions of a row (a 4-way bank conflict); with it they cover all 8. A
// pass moves every window by 16 rows, so slot(g + pass) = slot(g) + pass.
__device__ __forceinline__ int slot(int g) { return g ^ ((g >> 3) & 3); }

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most `pending` commit groups are in flight (a constant once
// the pass loop is unrolled).
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending >= 2) {
    wait_groups<2>();
  } else if (pending == 1) {
    wait_groups<1>();
  } else {
    wait_groups<0>();
  }
}

// The groups of chunk c that this lane copied, from int32 to float in
// place (a lane sees its own copies once they have landed).
__device__ __forceinline__ void to_float(float4* xs4, int c, int lane) {
#pragma unroll
  for (int k = 0; k < GROUPS / 32; ++k) {
    const int g = slot(c * GROUPS + lane + 32 * k);
    const int4 v = reinterpret_cast<const int4*>(xs4)[g];
    xs4[g] = make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                         static_cast<float>(v.z), static_cast<float>(v.w));
  }
}

__global__ void __launch_bounds__(32)
autocorr_kernel(const int32_t* __restrict__ x, float* __restrict__ r, int n,
                bool vec4) {
  __shared__ __align__(16) float xs[MAX_N + LAGS - 1];
  float4* xs4 = reinterpret_cast<float4*>(xs);
  const int lane = threadIdx.x;
  const int32_t* xr = x + static_cast<int64_t>(blockIdx.x) * n;
  if (vec4) {   // n % 4 == 0 and x 16-byte aligned
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
      for (int k = 0; k < GROUPS / 32; ++k) {
        const int g = c * GROUPS + lane + 32 * k;
        const bool in = 4 * g < n;            // else zero-filled
        copy16(xs4 + slot(g), in ? xr + 4 * g : xr, in ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    xs[MAX_N + lane] = 0.0f;                  // the 32 zeros after the row
  } else {
    for (int s = lane; s < MAX_N + LAGS - 1; s += 32) {
      xs[4 * slot(s / 4) + s % 4] =
          s < n ? static_cast<float>(__ldg(xr + s)) : 0.0f;
    }
  }

  int off[WIN / 4];   // the window's slots in pass 0
#pragma unroll
  for (int k = 0; k < WIN / 4; ++k) off[k] = slot(lane * T / 4 + k);
  float acc[LAGS];
#pragma unroll
  for (int lag = 0; lag < LAGS; ++lag) acc[lag] = 0.0f;
#pragma unroll
  for (int p = 0; p < CHUNKS; ++p) {
    if (p * PASS >= n) break;
    if (vec4) {   // pass p reads chunks p and p + 1 (32 samples of it)
      if (p == 0) {
        wait_pending(CHUNKS - 2);
        to_float(xs4, 0, lane);
        to_float(xs4, 1, lane);
      } else if (p + 1 < CHUNKS) {
        wait_pending(CHUNKS - 2 - p);
        to_float(xs4, p + 1, lane);
      }
    }
    __syncwarp();
    float w[WIN];
#pragma unroll
    for (int k = 0; k < WIN / 4; ++k) {
      const float4 v = xs4[off[k] + p * GROUPS];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int lag = 0; lag < LAGS; ++lag) {
#pragma unroll
      for (int i = 0; i < T; ++i) acc[lag] = fmaf(w[i], w[i + lag], acc[lag]);
    }
  }
  if (vec4) wait_groups<0>();   // no copy in flight when the block ends

  halve<16>(acc, lane);         // lane l ends with lag l
  halve<8>(acc, lane);
  halve<4>(acc, lane);
  halve<2>(acc, lane);
  halve<1>(acc, lane);
  float last = acc[LAGS - 1];
#pragma unroll
  for (int off16 = 16; off16 > 0; off16 /= 2) {
    last += __shfl_xor_sync(FULL, last, off16);
  }
  float* rr = r + static_cast<int64_t>(blockIdx.x) * LAGS;
  rr[lane] = acc[0] * SCALE2;
  if (lane == 0) rr[LAGS - 1] = last * SCALE2;
}

}  // namespace

extern "C" int sela_autocorr(const void* x, void* r, int n_rows, int n,
                             void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (n_rows > 0) {
    autocorr_kernel<<<n_rows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<float*>(r), n, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
