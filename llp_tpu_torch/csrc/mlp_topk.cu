// Fused 'mlp'-decoder retrieval scoring: for every (query, candidate) pair,
// the raw logit of an L-layer MLP head on the Hadamard product,
//
//   logit[i, j] = W_L . relu(... relu((q_i * c_j) W_1 + b_1) ...) + b_L
//
// with no sigmoid (the caller's top-k ranks raw logits and squashes only the
// k winners).  Candidates are rows of the compute type T (float or bf16) or
// int8 codes with per-row fp32 scales, dequantized here.
//
// Replaces the TPU kernel llp_tpu/ops/pallas/mlp_topk_kernel.py::
// _mlp_tile_kernel (launched by _mlp_logits_call through mlp_block_logits).
// Its rounding points are kept: int8 codes dequantize in fp32 and round to T;
// the Hadamard product is taken in T; each hidden layer accumulates in fp32,
// adds the fp32 bias, applies relu and rounds back to T; the last layer (a
// scalar output) stays fp32.  The TPU kernel asked for widths that are
// multiples of its 128-lane tiles; this one takes any width whose buffers
// fit shared memory (smem_bytes below, mirrored by the wrapper's gate).
//
// What bounds it on an H100: operations.  A pair costs 2 * sum_l(K_l F_l)
// FLOPs (131,584 at H = F = 256) against H values of table read once: at the
// collab table (235,868 x 256) and Q = 256 that is 7.9 TFLOP against 0.24 GB,
// some 33,000 FLOP a byte.  This first version runs fp32 FMAs outside the
// tensor cores (67 TFLOP/s peak, about 118 ms at that shape); bf16 changes
// the rounding points, not the arithmetic.  wgmma on bf16 tiles is the
// lever for a later PR.
//
// Design (right and simple first):
// * A block owns a tile of kTB = 64 candidates, so the table is read from
//   device memory once.  It stages the tile in shared memory, dequantized
//   and rounded to T, transposed to [feature][candidate], and then loops
//   over every query (the TPU grid's query axis becomes this loop: one
//   query, 64 pairs, per step; there is no ragged query chunk).
// * Each layer is a (64 pairs x K) by (K x F) product.  The weights stream
//   through shared memory in chunks of kKC = 16 rows x 256 units.  Thread
//   (warp w, lane l) accumulates a register tile of 8 pairs (w*8 ...) x 8
//   units (l*4 ... and 128 + l*4 ...): per input feature, four 16-byte
//   shared loads feed 64 FMAs.  The first layer forms the Hadamard product
//   on the fly from the query row and the candidate tile; widths above 256
//   units run in passes of 256.
// * Hidden activations of layers before the last hidden one go to shared
//   memory ([unit][pair], fp32 values already rounded to T), two buffers in
//   turn for L >= 4.  The last hidden layer never leaves registers: its
//   epilogue dots relu(z) with the output weights and the warp's 32 lanes
//   add their parts with shuffles, so only the (Q, B) logits are written.
// * Ragged edges are masked here, not padded by the caller: candidates past
//   the table stage zeros and are not stored; feature and unit tails stage
//   zero weights (K is padded to kKC with zero rows of the tile).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTB = 64;                // candidates (pairs) per block step
constexpr int kPPT = kTB / kWarps;     // pairs per thread: 8
constexpr int kUPT = 8;                // units per thread
constexpr int kUnits = 32 * kUPT;      // units per pass: 256
constexpr int kKC = 16;                // weight rows per staged chunk
constexpr int kMaxLayers = 8;
constexpr int64_t kMaxSmem = 232448;   // bytes of shared memory a block may use

typedef __nv_bfloat16 bf16;

struct Head {
  int layers;                     // L >= 2
  int dims[kMaxLayers + 1];       // dims[0] = H, dims[l + 1] = width of layer l, dims[L] = 1
  int64_t w_off[kMaxLayers];      // element offset of layer l's (dims[l], dims[l+1]) matrix in w
  int64_t b_off[kMaxLayers];      // element offset of its bias in b
  int act_rows;                   // rows of one activation buffer
};

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T> struct Dt;
template <> struct Dt<float> {
  __device__ static __forceinline__ float load(const float* p) { return __ldg(p); }
  __device__ static __forceinline__ float round(float v) { return v; }
};
template <> struct Dt<bf16> {
  __device__ static __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Column of the pass that unit slot u of a lane holds: 16-byte runs, so the
// warp's weight loads from shared memory are contiguous.
__device__ __forceinline__ int unit_of(int lane, int u) {
  return (u < 4 ? 0 : kUnits / 2) + lane * 4 + (u & 3);
}

// acc[p][u] = sum_k x(k, pair p) * wl[k][u0 + unit_of(lane, u)] for this
// thread's pairs and units.  kFirst: x(k, p) = round_T(qs[k] * xin[k][p])
// (the Hadamard product); otherwise x(k, p) = xin[k][p].  xin holds
// round_up(K, kKC) rows, zero past K.
template <typename T, bool kFirst>
__device__ __forceinline__ void layer_pass(float (&acc)[kPPT][kUPT], const float* xin,
                                           const float* qs, float* ws,
                                           const T* __restrict__ wl, int k_dim, int f_dim,
                                           int u0, int pg, int lane) {
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
#pragma unroll
    for (int u = 0; u < kUPT; ++u) acc[p][u] = 0.f;
  }
  const int kp = round_up(k_dim, kKC);
  for (int k0 = 0; k0 < kp; k0 += kKC) {
    __syncthreads();  // every thread is done with the previous chunk, and xin is written
    for (int i = threadIdx.x; i < kKC * kUnits; i += kThreads) {
      const int kk = i / kUnits;
      const int col = u0 + (i - kk * kUnits);
      const int k = k0 + kk;
      ws[i] = (k < k_dim && col < f_dim) ? Dt<T>::load(wl + (int64_t)k * f_dim + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const int k = k0 + kk;
      const float4 a0 = *reinterpret_cast<const float4*>(xin + k * kTB + pg * kPPT);
      const float4 a1 = *reinterpret_cast<const float4*>(xin + k * kTB + pg * kPPT + 4);
      float xv[kPPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      if (kFirst) {
        const float qk = qs[k];
#pragma unroll
        for (int p = 0; p < kPPT; ++p) xv[p] = Dt<T>::round(qk * xv[p]);
      }
      const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * kUnits + lane * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(ws + kk * kUnits + kUnits / 2 + lane * 4);
      const float wv[kUPT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < kPPT; ++p) {
#pragma unroll
        for (int u = 0; u < kUPT; ++u) acc[p][u] = fmaf(xv[p], wv[u], acc[p][u]);
      }
    }
  }
}

// out[i, c0 + p] for every query i and the block's candidates.  qh (q_count,
// h) in T; cand (n_cand, h) in T, or int8 codes with scales (n_cand,) when
// kQuant; w holds every layer's (in, out) matrix in T, b every bias in fp32.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
mlp_topk_kernel(const T* __restrict__ qh, const void* __restrict__ cand,
                const float* __restrict__ scales, const T* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ out, int q_count,
                int64_t n_cand, int h, Head head) {
  extern __shared__ float4 smem4[];
  const int hp = round_up(h, kKC);
  float* cs = reinterpret_cast<float*>(smem4);  // [hp][kTB] candidate tile
  float* ws = cs + hp * kTB;                    // [kKC][kUnits] weight chunk
  float* qs = ws + kKC * kUnits;                // [hp] query row
  float* act0 = qs + hp;                        // [act_rows][kTB] activations
  float* act1 = act0 + head.act_rows * kTB;     // the second buffer, for L >= 4

  const int64_t c0 = (int64_t)blockIdx.x * kTB;
  const int64_t rest = n_cand - c0;
  const int nb = rest < kTB ? (int)rest : kTB;
  for (int i = threadIdx.x; i < kTB * hp; i += kThreads) {
    const int p = i / hp;  // consecutive threads read consecutive features of a row
    const int k = i - p * hp;
    float v = 0.f;
    if (p < nb && k < h) {
      const int64_t at = (c0 + p) * h + k;
      if (kQuant) {
        v = Dt<T>::round((float)static_cast<const int8_t*>(cand)[at] * scales[c0 + p]);
      } else {
        v = Dt<T>::load(static_cast<const T*>(cand) + at);
      }
    }
    cs[k * kTB + p] = v;
  }

  const int lane = threadIdx.x & 31;
  const int pg = threadIdx.x >> 5;  // the warp's pairs: pg * kPPT ...
  const int last = head.layers - 1;
  const float b_last = b[head.b_off[last]];
  for (int qi = 0; qi < q_count; ++qi) {
    __syncthreads();  // the previous query is done with qs and the activations
    for (int k = threadIdx.x; k < hp; k += kThreads) {
      qs[k] = k < h ? Dt<T>::load(qh + (int64_t)qi * h + k) : 0.f;
    }
    float logit[kPPT];
#pragma unroll
    for (int p = 0; p < kPPT; ++p) logit[p] = 0.f;
    const float* xin = cs;
    for (int l = 0; l < last; ++l) {
      const int k_dim = head.dims[l];
      const int f_dim = head.dims[l + 1];
      const bool last_hidden = l + 1 == last;
      float* xout = (l & 1) ? act1 : act0;
      const int rows_out = round_up(f_dim, kKC);
      for (int u0 = 0; u0 < f_dim; u0 += kUnits) {
        float acc[kPPT][kUPT];
        if (l == 0) {
          layer_pass<T, true>(acc, cs, qs, ws, w + head.w_off[0], k_dim, f_dim, u0, pg, lane);
        } else {
          layer_pass<T, false>(acc, xin, qs, ws, w + head.w_off[l], k_dim, f_dim, u0, pg, lane);
        }
#pragma unroll
        for (int u = 0; u < kUPT; ++u) {
          const int col = u0 + unit_of(lane, u);
          const bool ok = col < f_dim;
          const float bj = ok ? b[head.b_off[l] + col] : 0.f;
          if (last_hidden) {
            const float vj = ok ? Dt<T>::load(w + head.w_off[last] + col) : 0.f;
#pragma unroll
            for (int p = 0; p < kPPT; ++p) {
              logit[p] = fmaf(Dt<T>::round(fmaxf(acc[p][u] + bj, 0.f)), vj, logit[p]);
            }
          } else if (col < rows_out) {  // rows past f_dim get relu(0) = 0
            float z[kPPT];
#pragma unroll
            for (int p = 0; p < kPPT; ++p) z[p] = Dt<T>::round(fmaxf(acc[p][u] + bj, 0.f));
            float4* dst = reinterpret_cast<float4*>(xout + col * kTB + pg * kPPT);
            dst[0] = make_float4(z[0], z[1], z[2], z[3]);
            dst[1] = make_float4(z[4], z[5], z[6], z[7]);
          }
        }
      }
      xin = xout;
    }
#pragma unroll
    for (int p = 0; p < kPPT; ++p) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        logit[p] += __shfl_xor_sync(0xffffffffu, logit[p], off);
      }
    }
    if (lane == 0) {
      float* row = out + (int64_t)qi * n_cand + c0 + pg * kPPT;
#pragma unroll
      for (int p = 0; p < kPPT; ++p) {
        if (pg * kPPT + p < nb) row[p] = logit[p] + b_last;
      }
    }
  }
}

// Bytes of shared memory one block uses (ops/mlp_topk.py::smem_bytes mirrors
// this count for its gate).
int64_t smem_bytes(const Head& head, int h) {
  const int64_t hp = round_up(h, kKC);
  const int buffers = head.layers - 2 < 2 ? head.layers - 2 : 2;
  return (hp * kTB + kKC * kUnits + hp + (int64_t)buffers * head.act_rows * kTB) *
         (int64_t)sizeof(float);
}

template <typename T, bool kQuant>
int launch(const void* qh, const void* cand, const float* scales, const void* w,
           const float* b, float* out, int64_t q_count, int64_t n_cand, int h,
           const Head& head, int64_t smem, cudaStream_t stream) {
  const auto kernel = mlp_topk_kernel<T, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (n_cand + kTB - 1) / kTB;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(qh), cand, scales, static_cast<const T*>(w), b, out,
      (int)q_count, n_cand, h, head);
  return (int)cudaGetLastError();
}

}  // namespace

// qh (q_count, h) and w (every layer's (dims[l], dims[l+1]) matrix, in
// order) of type dtype (0 float32, 1 bfloat16); cand (n_cand, h) of that
// type, or int8 codes when scales (n_cand,) fp32 is not null; b every bias
// in fp32, in order; out (q_count, n_cand) fp32.  dims is a host array of
// layers + 1 widths.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int llp_mlp_topk(const void* qh, const void* cand, const float* scales,
                            const void* w, const float* b, float* out, int64_t q_count,
                            int64_t n_cand, int64_t h, const int64_t* dims, int layers,
                            int dtype, void* stream) {
  if (q_count <= 0 || q_count > 0x7fffffff || n_cand <= 0 || h <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((n_cand + kTB - 1) / kTB > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // The heads the wrapper's gate admits: 2 to 8 layers, a first width of h,
  // a scalar output, and buffers that fit a block's shared memory.
  if (layers < 2 || layers > kMaxLayers || dims[0] != h || dims[layers] != 1) {
    return (int)cudaErrorInvalidValue;
  }
  Head head{};
  head.layers = layers;
  int64_t w_at = 0, b_at = 0;
  for (int l = 0; l < layers; ++l) {
    if (dims[l] <= 0 || dims[l] > (1 << 20)) return (int)cudaErrorInvalidValue;
    head.dims[l] = (int)dims[l];
    head.w_off[l] = w_at;
    head.b_off[l] = b_at;
    w_at += dims[l] * dims[l + 1];
    b_at += dims[l + 1];
  }
  head.dims[layers] = 1;
  for (int l = 1; l < layers - 1; ++l) {
    const int rows = round_up(head.dims[l], kKC);
    if (rows > head.act_rows) head.act_rows = rows;
  }
  const int64_t smem = smem_bytes(head, (int)h);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = scales != nullptr;
  if (dtype == 0 && !quant)
    return launch<float, false>(qh, cand, scales, w, b, out, q_count, n_cand, (int)h, head, smem, s);
  if (dtype == 0 && quant)
    return launch<float, true>(qh, cand, scales, w, b, out, q_count, n_cand, (int)h, head, smem, s);
  if (dtype == 1 && !quant)
    return launch<bf16, false>(qh, cand, scales, w, b, out, q_count, n_cand, (int)h, head, smem, s);
  if (dtype == 1 && quant)
    return launch<bf16, true>(qh, cand, scales, w, b, out, q_count, n_cand, (int)h, head, smem, s);
  return (int)cudaErrorInvalidValue;
}
