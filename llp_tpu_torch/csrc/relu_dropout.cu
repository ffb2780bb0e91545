// ReLU and inverted dropout in one pass over a train-mode dropout site's
// tensor, forward and backward, in fp32 and bf16.
//
//   forward:  s = pre (+ addend);  r = relu(s);  kept = u < thr
//             out  = kept ? r * inv : 0
//             mask = kept && !(r <= 0)                    (one byte each)
//   backward: dpre = mask ? g * inv : 0    (also the gradient of addend)
//
// u is the site's uniform draw (fp32, the tensor's shape), which the
// wrapper takes from torch.rand under the run's generator exactly as
// llp_tpu_torch/ops/rng.py::inverted_dropout does, so the masks and the
// generator's stream are those of the plain composition; thr is keep = 1 -
// rate as fp32, and inv is 1 / keep (computed in double) as fp32: PyTorch's
// CUDA division h / keep by a Python scalar multiplies by that factor
// (NVIDIA H100, torch 2.11: at rate 0.15 the fp32 reciprocal of fp32 keep
// differs from it by an ulp, and does not reproduce the division's bits).
//
// Replaces no TPU kernel: the JAX package leaves ReLU and dropout to XLA,
// which fuses them into the neighbouring ops.  PyTorch runs the site
// inverted_dropout(relu(pre + addend)) as separate full-tensor passes: the
// sum, relu, rand < keep, h / keep, zeros_like, where; and in the backward
// where's, the division's and relu's (threshold_backward).  At the
// teacher's hidden layer (235,868 x 256 fp32, E = 241.5 MB) that is 12.5 E
// of traffic forward and 7.25 E backward.
//
// What bounds it on an H100: bytes.  A few operations per element against
// 17 (fp32) or 9 (bf16) bytes forward and 9 or 5 backward, far below the
// card's operations per byte.  The least traffic is what this kernel moves:
// forward pre, addend, the draw read once, out and the mask written once
// (4.25 E at fp32 with the addend); backward g and the mask read once and
// dpre written once (2.25 E).  The draw itself stays a torch.rand pass, so
// that the stream that the tests and the benchmark replay is unchanged.
//
// Rounding points, those of the plain composition on the card:
// * bf16: the sum is rounded to bf16 before the ReLU (a bf16 add); the
//   scale is an fp32 product of the bf16 value and inv, rounded once to
//   bf16.  fp32: the sum and the product in fp32, no contraction.
// * ReLU is torch.relu's clamp_min: NaN passes, else fmaxf(s, 0).
// * The mask holds what threshold_backward lets through, r > 0 or NaN,
//   for the kept elements only: where's backward zeroes the others.
// * The backward's product g * inv is the division's backward (g / keep by
//   the same reciprocal), rounded once in bf16.
//
// Design: 16-byte loads and stores, 4 fp32 or 8 bf16 elements a thread
// (the draw as one or two float4, the mask as 4 or 8 bytes), one vector a
// thread over a grid that covers the tensor once; the elements past the
// last whole vector (fewer than one vector) go to the threads after the
// last vector, one element each.  Every pointer must be 16-byte aligned
// (the entry points refuse one that is not; the wrapper copies such an
// input first).  Inputs read once stream (evict first); the mask, read
// only by the backward much later, is stored streaming; out and dpre,
// which the next GEMM reads, are stored normally.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

// Per element type: the elements of a 16-byte vector, and the conversions
// between a vector's 32-bit words and fp32 values.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static __forceinline__ void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ float load(const void* p, int64_t i) {
    return __ldcs(static_cast<const float*>(p) + i);
  }
  __device__ static __forceinline__ void store(void* p, int64_t i, float v) {
    static_cast<float*>(p)[i] = v;
  }
};

template <> struct Elem<bf16> {
  static constexpr int kVec = 8;
  // A word holds two bf16 values, the lower-addressed one in its low half.
  __device__ static __forceinline__ void unpack(uint4 r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | (bits(f[1]) << 16), bits(f[2]) | (bits(f[3]) << 16),
                      bits(f[4]) | (bits(f[5]) << 16), bits(f[6]) | (bits(f[7]) << 16));
  }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ float load(const void* p, int64_t i) {
    return __bfloat162float(__ldcs(static_cast<const bf16*>(p) + i));
  }
  __device__ static __forceinline__ void store(void* p, int64_t i, float v) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  }
};

// One element of the forward: s is pre's value, with the addend's already
// added and rounded to the type; returns the output (before its rounding to
// the type) and sets m.
__device__ __forceinline__ float forward_one(float s, float u, float thr, float inv,
                                             uint32_t& m) {
  const float r = isnan(s) ? s : fmaxf(s, 0.f);
  const bool kept = u < thr;
  m = kept && !(r <= 0.f);
  return kept ? __fmul_rn(r, inv) : 0.f;
}

// The mask bytes of one vector: 4 in a 32-bit word, 8 in two.
template <int kVec> struct MaskVec;
template <> struct MaskVec<4> {
  __device__ static __forceinline__ void store(uint8_t* mask, int64_t v, const uint32_t* m) {
    __stcs(reinterpret_cast<unsigned int*>(mask) + v,
           m[0] | (m[1] << 8) | (m[2] << 16) | (m[3] << 24));
  }
  __device__ static __forceinline__ void load(const uint8_t* mask, int64_t v, uint32_t* m) {
    const uint32_t w = __ldcs(reinterpret_cast<const unsigned int*>(mask) + v);
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = (w >> (8 * k)) & 0xffu;
  }
};
template <> struct MaskVec<8> {
  __device__ static __forceinline__ void store(uint8_t* mask, int64_t v, const uint32_t* m) {
    __stcs(reinterpret_cast<uint2*>(mask) + v,
           make_uint2(m[0] | (m[1] << 8) | (m[2] << 16) | (m[3] << 24),
                      m[4] | (m[5] << 8) | (m[6] << 16) | (m[7] << 24)));
  }
  __device__ static __forceinline__ void load(const uint8_t* mask, int64_t v, uint32_t* m) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(mask) + v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m[k] = (w.x >> (8 * k)) & 0xffu;
      m[4 + k] = (w.y >> (8 * k)) & 0xffu;
    }
  }
};

// Thread t of the grid: vector t while t < n / kVec, then element
// (n / kVec) * kVec + (t - n / kVec) of the tail.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
relu_dropout_kernel(const void* __restrict__ pre, const void* __restrict__ addend,
                    const float* __restrict__ draw, void* __restrict__ out,
                    uint8_t* __restrict__ mask, int64_t n, float thr, float inv) {
  typedef Elem<T> E;
  constexpr int kV = E::kVec;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_vec = n / kV;
  if (t < n_vec) {
    float s[kV], u[kV], o[kV];
    uint32_t m[kV];
    E::unpack(__ldcs(static_cast<const uint4*>(pre) + t), s);
    if constexpr (kAdd) {
      float a[kV];
      E::unpack(__ldcs(static_cast<const uint4*>(addend) + t), a);
#pragma unroll
      for (int k = 0; k < kV; ++k) s[k] = E::round(__fadd_rn(s[k], a[k]));
    }
#pragma unroll
    for (int k = 0; k < kV / 4; ++k) {
      const float4 d = __ldcs(reinterpret_cast<const float4*>(draw) + t * (kV / 4) + k);
      u[4 * k] = d.x;
      u[4 * k + 1] = d.y;
      u[4 * k + 2] = d.z;
      u[4 * k + 3] = d.w;
    }
#pragma unroll
    for (int k = 0; k < kV; ++k) o[k] = forward_one(s[k], u[k], thr, inv, m[k]);
    static_cast<uint4*>(out)[t] = E::pack(o);
    MaskVec<kV>::store(mask, t, m);
    return;
  }
  const int64_t i = n_vec * kV + (t - n_vec);
  if (i >= n) return;
  float s = E::load(pre, i);
  if constexpr (kAdd) s = E::round(__fadd_rn(s, E::load(addend, i)));
  uint32_t m;
  const float o = forward_one(s, __ldcs(draw + i), thr, inv, m);
  E::store(out, i, o);
  mask[i] = static_cast<uint8_t>(m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relu_dropout_backward_kernel(const void* __restrict__ g, const uint8_t* __restrict__ mask,
                             void* __restrict__ dx, int64_t n, float inv) {
  typedef Elem<T> E;
  constexpr int kV = E::kVec;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_vec = n / kV;
  if (t < n_vec) {
    float v[kV];
    uint32_t m[kV];
    E::unpack(__ldcs(static_cast<const uint4*>(g) + t), v);
    MaskVec<kV>::load(mask, t, m);
#pragma unroll
    for (int k = 0; k < kV; ++k) v[k] = m[k] ? __fmul_rn(v[k], inv) : 0.f;
    static_cast<uint4*>(dx)[t] = E::pack(v);
    return;
  }
  const int64_t i = n_vec * kV + (t - n_vec);
  if (i >= n) return;
  E::store(dx, i, __ldcs(mask + i) ? __fmul_rn(E::load(g, i), inv) : 0.f);
}

// Threads that cover n elements: one a vector and one a tail element.
template <typename T>
unsigned int blocks(int64_t n) {
  const int64_t kV = Elem<T>::kVec;
  return static_cast<unsigned int>((n / kV + n % kV + kThreads - 1) / kThreads);
}

template <typename T>
int launch_forward(const void* pre, const void* addend, const float* draw, void* out,
                   uint8_t* mask, int64_t n, float thr, float inv, cudaStream_t s) {
  const unsigned int grid = blocks<T>(n);
  if (addend)
    relu_dropout_kernel<T, true><<<grid, kThreads, 0, s>>>(pre, addend, draw, out, mask, n, thr,
                                                           inv);
  else
    relu_dropout_kernel<T, false><<<grid, kThreads, 0, s>>>(pre, addend, draw, out, mask, n, thr,
                                                            inv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* g, const uint8_t* mask, void* dx, int64_t n, float inv,
                    cudaStream_t s) {
  relu_dropout_backward_kernel<T><<<blocks<T>(n), kThreads, 0, s>>>(g, mask, dx, n, inv);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// type: 0 fp32, 1 bf16 (pre, addend and out alike).  addend may be null;
// every pointer given must be 16-byte aligned.
extern "C" int llp_relu_dropout(const void* pre, const void* addend, const float* draw,
                                void* out, uint8_t* mask, int64_t n, float thr, float inv,
                                int type, void* stream) {
  if (n <= 0 || !aligned(pre) || (addend && !aligned(addend)) || !aligned(draw) ||
      !aligned(out) || !aligned(mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (type == 0) return launch_forward<float>(pre, addend, draw, out, mask, n, thr, inv, s);
  if (type == 1) return launch_forward<bf16>(pre, addend, draw, out, mask, n, thr, inv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int llp_relu_dropout_backward(const void* g, const uint8_t* mask, void* dx,
                                         int64_t n, float inv, int type, void* stream) {
  if (n <= 0 || !aligned(g) || !aligned(mask) || !aligned(dx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (type == 0) return launch_backward<float>(g, mask, dx, n, inv, s);
  if (type == 1) return launch_backward<bf16>(g, mask, dx, n, inv, s);
  return (int)cudaErrorInvalidValue;
}
