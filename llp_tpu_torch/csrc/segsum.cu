// Segment sum over a CSR edge list, fp32 accumulation, templated on the
// input and output types.
//
//   out[r, :] = scale[r] * sum_{e in [in_ptr[r], in_ptr[r+1])} x[senders[e], :]
//
// Replaces the TPU kernels of llp_tpu/ops/pallas/segsum_kernel.py (the
// windowed one-hot MXU segment sum behind spmm(impl="segsum")), unweighted:
// * _kernel, in both directions.  The forward runs over the receiver CSR
//   (senders, in_ptr); the backward of spmm launches this same kernel over
//   the sender CSR (col, row_ptr), as the JAX package launches _kernel over
//   its sender-sorted layout.  Instances float->float and bf16->float (the
//   TPU kernel's bf16-message mode: bf16 in, fp32 out).
// * _kernel_cast: instance bf16->bf16.  The sum stays fp32 in registers, the
//   row scale is applied in fp32, and the result is rounded to bf16 once at
//   the store: (sum * scale).astype(bf16), as the JAX cached path computes.
// scale is 1/max(deg, 1) for the mean, or null for the plain sum.
//
// What bounds it on an H100: memory.  Each edge reads one D-wide row of x
// from a random sender and adds D values; at D=256 that is one add per 4 (fp32)
// or 2 (bf16) bytes read, far below the ~20 FLOP/byte at which fp32 compute
// would matter.  The least traffic is x once, the index arrays once and out
// once; bf16 halves the bytes of x and of a bf16 out, so its byte bound
// is about half the fp32 one.  The gather reads E rows of x instead, from L2
// when x fits in its 50 MB.
//
// Design:
// * One warp owns one output row x one feature tile.  It walks the row's
//   edges, gathers x[sender] itself and keeps the sum in fp32 registers, then
//   writes the tile once.  No atomics: every output element has one writer,
//   and the sum runs in edge order, so the result is deterministic.
// * The TPU gathered all messages into an (E, D) tensor in XLA before its
//   kernel, and had to cut that stream into chunks (_CHUNK_MSG_BYTES) to fit
//   HBM.  Here no message tensor exists, so there is nothing to chunk.
// * Loads are 16 bytes a lane when D is a multiple of the vector width and x
//   and out are 16-byte aligned: 4 floats (a 128-feature tile per warp) or
//   8 bf16 (a 256-feature tile).  Otherwise each lane loads 4 scalars 32
//   features apart (a 128-feature tile); cora's width 1433 takes that path.
//   The vector edge loop is unrolled by four, so four row loads are in
//   flight per warp.
// * Row offsets are 64-bit: N*D passes 2^31 at 10M nodes x 256 features.
// * Load balance is still one warp per row: a hub row of degree 10^4 runs on
//   one warp while the others finish.  Correct, but slow on power-law graphs;
//   splitting long rows across warps is left to the PR that makes it fast.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // warps per block
constexpr int kScalarN = 4;    // features per lane on the scalar path

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 16-byte vector loads: kN values of T per lane.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  typedef float4 Raw;
  __device__ static __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ void add(float (&a)[kN], const Raw v) {
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int kN = 8;
  typedef uint4 Raw;
  __device__ static __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void add(float (&a)[kN], const Raw v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k sits in the low half of word k
      a[2 * k] += bf16_bits_to_float(w[k] & 0xffffu);
      a[2 * k + 1] += bf16_bits_to_float(w[k] >> 16);
    }
  }
};

__device__ __forceinline__ void store_vec(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(a[4], a[5], a[6], a[7]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&a)[8]) {
  uint4 v;
  v.x = float_to_bf16_bits(a[0]) | (float_to_bf16_bits(a[1]) << 16);
  v.y = float_to_bf16_bits(a[2]) | (float_to_bf16_bits(a[3]) << 16);
  v.z = float_to_bf16_bits(a[4]) | (float_to_bf16_bits(a[5]) << 16);
  v.w = float_to_bf16_bits(a[6]) | (float_to_bf16_bits(a[7]) << 16);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float load_scalar(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_scalar(const bf16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TIn, bool kVec>
__host__ __device__ constexpr int tile_width() {
  return 32 * (kVec ? Vec<TIn>::kN : kScalarN);
}

// kVec: lane l owns features [f0 + kN*l, f0 + kN*l + kN), loaded as one
// 16-byte vector.  Otherwise lane l owns features f0 + l + 32j, j < 4.
template <typename TIn, typename TOut, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const TIn* __restrict__ x, const int64_t* __restrict__ senders,
              const int64_t* __restrict__ in_ptr, const float* __restrict__ scale,
              TOut* __restrict__ out, int64_t n_rows, int64_t d, int64_t n_tiles) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_rows * n_tiles) return;
  const int64_t row = w / n_tiles;
  const int64_t f0 = (w - row * n_tiles) * tile_width<TIn, kVec>();
  const int64_t e0 = in_ptr[row];
  const int64_t e1 = in_ptr[row + 1];
  const float sc = scale ? scale[row] : 1.0f;

  if constexpr (kVec) {
    typedef Vec<TIn> V;
    constexpr int kN = V::kN;
    const int64_t f = f0 + kN * lane;
    if (f >= d) return;  // d % kN == 0: f < d means all kN features exist
    float acc[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] = 0.f;
    int64_t e = e0;
    for (; e + 4 <= e1; e += 4) {
      const int64_t s0 = senders[e], s1 = senders[e + 1];
      const int64_t s2 = senders[e + 2], s3 = senders[e + 3];
      const typename V::Raw v0 = V::load(x + s0 * d + f);
      const typename V::Raw v1 = V::load(x + s1 * d + f);
      const typename V::Raw v2 = V::load(x + s2 * d + f);
      const typename V::Raw v3 = V::load(x + s3 * d + f);
      V::add(acc, v0); V::add(acc, v1); V::add(acc, v2); V::add(acc, v3);
    }
    for (; e < e1; ++e) V::add(acc, V::load(x + senders[e] * d + f));
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] *= sc;
    store_vec(out + row * d + f, acc);
  } else {
    float acc[kScalarN];
    bool on[kScalarN];
#pragma unroll
    for (int j = 0; j < kScalarN; ++j) {
      acc[j] = 0.f;
      on[j] = f0 + lane + 32 * j < d;
    }
    if (!on[0]) return;
    for (int64_t e = e0; e < e1; ++e) {
      const TIn* xr = x + senders[e] * d + f0 + lane;
#pragma unroll
      for (int j = 0; j < kScalarN; ++j) {
        if (on[j]) acc[j] += load_scalar(xr + 32 * j);
      }
    }
    TOut* orow = out + row * d + f0 + lane;
#pragma unroll
    for (int j = 0; j < kScalarN; ++j) {
      if (on[j]) store_scalar(orow + 32 * j, acc[j] * sc);
    }
  }
}

template <typename TIn, typename TOut, bool kVec>
int launch(const void* x, const int64_t* senders, const int64_t* in_ptr,
           const float* scale, void* out, int64_t n_rows, int64_t d,
           cudaStream_t s) {
  constexpr int64_t tile = tile_width<TIn, kVec>();
  const int64_t n_tiles = (d + tile - 1) / tile;
  const int64_t blocks = (n_rows * n_tiles + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  segsum_kernel<TIn, TOut, kVec><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
      static_cast<const TIn*>(x), senders, in_ptr, scale, static_cast<TOut*>(out),
      n_rows, d, n_tiles);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int dispatch(const void* x, const int64_t* senders, const int64_t* in_ptr,
             const float* scale, void* out, int64_t n_rows, int64_t d,
             cudaStream_t s) {
  const bool vec = d % Vec<TIn>::kN == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<TIn, TOut, true>(x, senders, in_ptr, scale, out, n_rows, d, s)
             : launch<TIn, TOut, false>(x, senders, in_ptr, scale, out, n_rows, d, s);
}

}  // namespace

// x (n_src, d) row-major, fp32 (in_type 0) or bf16 (in_type 1); senders (E,)
// int64 grouped by output row; in_ptr (n_rows + 1,) int64; scale (n_rows,)
// fp32 or null; out (n_rows, d), fp32 (out_type 0) or bf16 (out_type 1).
// Instances: fp32->fp32, bf16->fp32, bf16->bf16; any other pair is refused.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int llp_segsum(const void* x, const int64_t* senders,
                          const int64_t* in_ptr, const float* scale, void* out,
                          int64_t n_rows, int64_t d, int in_type, int out_type,
                          void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return dispatch<float, float>(x, senders, in_ptr, scale, out, n_rows, d, s);
  if (in_type == 1 && out_type == 0)
    return dispatch<bf16, float>(x, senders, in_ptr, scale, out, n_rows, d, s);
  if (in_type == 1 && out_type == 1)
    return dispatch<bf16, bf16>(x, senders, in_ptr, scale, out, n_rows, d, s);
  return (int)cudaErrorInvalidValue;
}
