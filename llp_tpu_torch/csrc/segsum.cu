// Segment sum over a receiver-sorted edge list (CSR by receiver), fp32.
//
//   out[r, :] = scale[r] * sum_{e in [in_ptr[r], in_ptr[r+1])} x[senders[e], :]
//
// Replaces the TPU kernel llp_tpu/ops/pallas/segsum_kernel.py::_kernel (the
// windowed one-hot MXU segment sum behind spmm(impl="segsum")): the forward,
// fp32, unweighted mode that SAGE mean aggregation runs.  scale is
// 1/max(deg, 1) for the mean, or null for the plain sum.
//
// What bounds it on an H100: memory.  Each edge reads one D-wide row of x
// from a random sender (4*D bytes) and adds D floats; at D=256 that is one
// add per 4 bytes read, far below the ~20 FLOP/byte at which fp32 compute
// would matter.  The least traffic is x once, the index arrays once and out
// once; the gather reads E rows of x instead, from L2 when x fits in its 50 MB.
//
// Design:
// * One warp owns one receiver row x one 128-feature tile.  It walks the
//   row's edges, gathers x[sender] itself and keeps the sum in registers, then
//   writes the tile once.  No atomics: every output element has one writer,
//   and the sum runs in edge order, so the result is deterministic.
// * The TPU gathered all messages into an (E, D) tensor in XLA before its
//   kernel, and had to cut that stream into chunks (_CHUNK_MSG_BYTES) to fit
//   HBM.  Here no message tensor exists, so there is nothing to chunk.
// * Loads are 16 bytes a lane (float4) when D % 4 == 0 and x is 16-byte
//   aligned, scalar otherwise; the edge loop is unrolled by four so that four
//   row loads are in flight per warp.
// * Row offsets are 64-bit: N*D passes 2^31 at 10M nodes x 256 features.
// * Load balance is one warp per row: a hub row of degree 10^4 runs on one
//   warp while the others finish.  Correct, but slow on power-law graphs;
//   splitting long rows across warps is left to the PR that makes it fast.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // warps per block
constexpr int kTile = 128;   // features per warp: 32 lanes x 4

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

// kVec: lane l owns features [f0 + 4l, f0 + 4l + 4) and loads them as one float4.
// Otherwise lane l owns features f0 + l + 32j, j < 4, loaded one by one.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const float* __restrict__ x, const int64_t* __restrict__ senders,
              const int64_t* __restrict__ in_ptr, const float* __restrict__ scale,
              float* __restrict__ out, int64_t n_rows, int64_t d, int64_t n_tiles) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_rows * n_tiles) return;
  const int64_t row = w / n_tiles;
  const int64_t f0 = (w - row * n_tiles) * kTile;
  const int64_t e0 = in_ptr[row];
  const int64_t e1 = in_ptr[row + 1];
  const float sc = scale ? scale[row] : 1.0f;

  if constexpr (kVec) {
    const int64_t f = f0 + 4 * lane;
    if (f >= d) return;  // d % 4 == 0: f < d means all four features exist
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t e = e0;
    for (; e + 4 <= e1; e += 4) {
      const int64_t s0 = senders[e], s1 = senders[e + 1];
      const int64_t s2 = senders[e + 2], s3 = senders[e + 3];
      const float4 v0 = __ldg(reinterpret_cast<const float4*>(x + s0 * d + f));
      const float4 v1 = __ldg(reinterpret_cast<const float4*>(x + s1 * d + f));
      const float4 v2 = __ldg(reinterpret_cast<const float4*>(x + s2 * d + f));
      const float4 v3 = __ldg(reinterpret_cast<const float4*>(x + s3 * d + f));
      add4(acc, v0); add4(acc, v1); add4(acc, v2); add4(acc, v3);
    }
    for (; e < e1; ++e) {
      add4(acc, __ldg(reinterpret_cast<const float4*>(x + senders[e] * d + f)));
    }
    acc.x *= sc; acc.y *= sc; acc.z *= sc; acc.w *= sc;
    *reinterpret_cast<float4*>(out + row * d + f) = acc;
  } else {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    bool on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) on[j] = f0 + lane + 32 * j < d;
    if (!on[0]) return;
    for (int64_t e = e0; e < e1; ++e) {
      const float* xr = x + senders[e] * d + f0 + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (on[j]) acc[j] += __ldg(xr + 32 * j);
      }
    }
    float* orow = out + row * d + f0 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (on[j]) orow[32 * j] = acc[j] * sc;
    }
  }
}

}  // namespace

// x (n_src, d) fp32 row-major; senders (E,) int64 sorted by receiver;
// in_ptr (n_rows + 1,) int64; scale (n_rows,) fp32 or null; out (n_rows, d).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int llp_segsum_f32(const float* x, const int64_t* senders,
                              const int64_t* in_ptr, const float* scale,
                              float* out, int64_t n_rows, int64_t d,
                              void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (d + kTile - 1) / kTile;
  const int64_t blocks = (n_rows * n_tiles + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    segsum_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        x, senders, in_ptr, scale, out, n_rows, d, n_tiles);
  } else {
    segsum_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        x, senders, in_ptr, scale, out, n_rows, d, n_tiles);
  }
  return (int)cudaGetLastError();
}
