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
// fit shared memory (the SIMT route's count, smem_simt below, mirrored by
// the wrapper's gate).
//
// What bounds it on an H100: operations.  A pair costs 2 * sum_l(K_l F_l)
// FLOPs (131,584 at H = F = 256) against H values of table read once: at the
// collab table (235,868 x 256) and Q = 256 that is 7.9 TFLOP against
// 0.24 GB, some 33,000 FLOP a byte.  So fp32 is held to the 67 TFLOP/s of
// the FMA units (118 ms at that shape; TF32 stays off for parity) and bf16
// to the 989 TFLOP/s of the tensor cores (8.0 ms).
//
// What held the first design back (chip_smoke.py at that shape, NVIDIA H100
// 80GB HBM3 at 700 W): one SIMT kernel served both types.  bf16 ran the same
// fp32 FMAs as fp32, outside the tensor cores: 361.5 ms, 45x its bound, and
// 2.1x slower than the unfused route; fp32 took 352.0 ms (3.0x its bound).
// 143 registers a thread allowed one block an SM; each 16-row weight chunk
// was staged from L2 between two barriers with nothing overlapping it;
// every lane recomputed its warp's Hadamard products for each k; and the
// whole W1 streamed from L2 for every query of every 64-candidate tile
// (about 240 GB of L2 reads at that shape).
//
// Design.  Two routes; the wrapper (ops/mlp_topk.py) picks by type and
// shape, the C entry points below check the same conditions.
//
// * Tensor-core route (bf16, every instance whose hidden-layer weights fit
//   shared memory beside the tile: 2-layer heads up to H = F = 272, and the
//   serving head, H = F = 256).  A block of 8 warps owns 64 candidates.  It
//   copies every hidden layer's weights into shared memory once, laid out by
//   the wrapper's one-time prep as W_l^T [N_l][K_l + 8] bf16 (K_l padded to
//   16, N_l to 64, zeros in the padding; the 8 extra columns make ldmatrix
//   conflict-free), with the fp32 biases and w_L beside them; W1 stays
//   resident for the block's whole walk, 128 KB at H = F = 256.  It stages
//   its candidate tile once (int8 codes dequantize in fp32 and round to
//   bf16), then walks the queries two at a time: per step each layer is a
//   (128 pairs x K) by (K x N) product on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulation) in passes of 256 units; a warp's tile is one query's 64
//   pairs x 64 units, so each B fragment feeds 4 MMAs, each A fragment 8,
//   and ldmatrix moves 128 bytes of shared memory per MMA.  The first
//   layer's A fragment is the candidate tile's (ldmatrix) times the query's
//   bf16 pairs with mul.rn.bf16x2: a bf16 x bf16 product is exact before its
//   one rounding,
//   so this is the Hadamard product rounded to bf16, bit for bit.  Hidden
//   activations before the last hidden layer go to shared memory as bf16
//   (bias, relu, one rounding); the last hidden layer's epilogue stays in
//   registers: bias, relu, round to bf16, a dot with w_L in fp32, sums
//   across the quad's lanes and then, in a fixed order, across the 4 warps
//   that share a row.  Only the (Q, B) logits are written.
// * SIMT route (fp32, and bf16 heads too wide for the tensor-core route).
//   A block of 256 threads owns 64 candidates, stages them once in shared
//   memory as fp32 [feature][candidate], and walks the queries.  Each layer
//   is a (64 pairs x K) by (K x F) product on fp32 FMAs: thread (warp w,
//   lane l) keeps 8 pairs x 8 units in registers; per input feature two
//   broadcast and two 16-byte shared loads feed 64 FMAs.  The weights stream
//   through shared memory in chunks of 16 rows x 256 units.  Where it fits
//   (the pipelined layout), chunks are double-buffered with cp.async, so the
//   next chunk's L2 loads overlap this chunk's FMAs, and the first layer's
//   Hadamard products are formed once per chunk into shared memory (each
//   product once, not once per lane); launch bounds ask for two blocks an
//   SM.  Where it does not (heads near the 227 KB limit), the first
//   design's single-buffered layout runs, with the Hadamard formed per lane.
//   The last hidden layer never leaves registers either.
// * Ragged Q, B and widths: no ragged query chunk (one query a step);
//   candidates past the table stage zeros and are not stored; feature and
//   unit tails stage zero weights or are zero in the prepped layout.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTB = 64;                // candidates (pairs) per block step, both routes
constexpr int kPPT = kTB / kWarps;     // SIMT: pairs per thread, 8
constexpr int kUPT = 8;                // SIMT: units per thread
constexpr int kUnits = 32 * kUPT;      // SIMT: units per pass, 256
constexpr int kKC = 16;                // SIMT: weight rows per staged chunk
constexpr int kMaxLayers = 8;
constexpr int64_t kMaxSmem = 232448;   // bytes of shared memory a block may use

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; with ok false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------- SIMT route

struct Head {
  int layers;                     // L >= 2
  int dims[kMaxLayers + 1];       // dims[0] = H, dims[l + 1] = width of layer l, dims[L] = 1
  int64_t w_off[kMaxLayers];      // element offset of layer l's (dims[l], dims[l+1]) matrix in w
  int64_t b_off[kMaxLayers];      // element offset of its bias in b
  int act_rows;                   // rows of one activation buffer
};

// Column of the pass that unit slot u of a lane holds: 16-byte runs, so the
// warp's weight loads from shared memory are contiguous.
__device__ __forceinline__ int unit_of(int lane, int u) {
  return (u < 4 ? 0 : kUnits / 2) + lane * 4 + (u & 3);
}

// Stage chunk c (rows c * kKC ...) of layer l's weights, columns u0 ...
// u0 + kUnits, into ws (fp32, zero past K and F); kFirst && kPipe: also the
// chunk's Hadamard products hs[kk][p] = round_T(q[k] * cs[k][p]).
template <typename T, bool kFirst, bool kPipe>
__device__ __forceinline__ void stage_chunk(int c, float* ws, float* hs, const float* cs,
                                            const T* __restrict__ qrow,
                                            const T* __restrict__ wl, int k_dim, int f_dim,
                                            int h, int u0) {
  const int k0 = c * kKC;
  // The loops stay rolled: the registers go to the FMA tile, which then
  // fits 128 a thread without spilling (two blocks an SM).
  if constexpr (sizeof(T) == 4) {
    if (f_dim % 4 == 0 && reinterpret_cast<uintptr_t>(wl) % 16 == 0) {
#pragma unroll 1
      for (int i = threadIdx.x; i < kKC * kUnits / 4; i += kThreads) {
        const int kk = i / (kUnits / 4);
        const int j = (i - kk * (kUnits / 4)) * 4;
        const int k = k0 + kk, col = u0 + j;
        const bool ok = k < k_dim && col < f_dim;
        cp_async16(ws + kk * kUnits + j, ok ? wl + (int64_t)k * f_dim + col : wl, ok);
      }
    } else {
#pragma unroll 1
      for (int i = threadIdx.x; i < kKC * kUnits; i += kThreads) {
        const int kk = i / kUnits;
        const int k = k0 + kk, col = u0 + (i - kk * kUnits);
        const bool ok = k < k_dim && col < f_dim;
        cp_async4(ws + i, ok ? wl + (int64_t)k * f_dim + col : wl, ok);
      }
    }
  } else {  // bf16 weights widen to fp32 on the way
#pragma unroll 1
    for (int i = threadIdx.x; i < kKC * kUnits; i += kThreads) {
      const int kk = i / kUnits;
      const int k = k0 + kk, col = u0 + (i - kk * kUnits);
      ws[i] = (k < k_dim && col < f_dim) ? Dt<T>::load(wl + (int64_t)k * f_dim + col) : 0.f;
    }
  }
  if constexpr (kFirst && kPipe) {
#pragma unroll 1
    for (int i = threadIdx.x; i < kKC * kTB; i += kThreads) {
      const int kk = i / kTB;
      const int k = k0 + kk;
      const float qk = k < h ? Dt<T>::load(qrow + k) : 0.f;
      hs[i] = Dt<T>::round(qk * cs[k * kTB + (i - kk * kTB)]);
    }
  }
}

// acc[p][u] = sum_k x(k, pair p) * wl[k][u0 + unit_of(lane, u)] for this
// thread's pairs and units.  kFirst: x(k, p) = round_T(q[k] * cs[k][p]) (the
// Hadamard product); otherwise x(k, p) = xin[k][p].  xin and cs hold
// round_up(K, kKC) rows, zero past K.  Starts and ends with a barrier.
template <typename T, bool kFirst, bool kPipe>
__device__ __forceinline__ void layer_pass(float (&acc)[kPPT][kUPT], const float* xin,
                                           const float* cs, const float* qs,
                                           const T* __restrict__ qrow, float* ws, float* hs,
                                           const T* __restrict__ wl, int k_dim, int f_dim,
                                           int h, int u0, int pg, int lane) {
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
#pragma unroll
    for (int u = 0; u < kUPT; ++u) acc[p][u] = 0.f;
  }
  const int chunks = round_up(k_dim, kKC) / kKC;
  __syncthreads();  // every thread is done with the buffers; xin and qs are written
  stage_chunk<T, kFirst, kPipe>(0, ws, hs, cs, qrow, wl, k_dim, f_dim, h, u0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int cur = kPipe ? (c & 1) : 0;
    if (kPipe && c + 1 < chunks) {  // the next chunk's loads overlap this chunk's FMAs
      stage_chunk<T, kFirst, kPipe>(c + 1, ws + (cur ^ 1) * kKC * kUnits,
                                    hs + (cur ^ 1) * kKC * kTB, cs, qrow, wl, k_dim, f_dim,
                                    h, u0);
    }
    const float* wc = ws + cur * kKC * kUnits;
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const int k = c * kKC + kk;
      const float* xr = (kFirst && kPipe) ? hs + cur * kKC * kTB + kk * kTB
                                          : (kFirst ? cs : xin) + k * kTB;
      const float4 a0 = *reinterpret_cast<const float4*>(xr + pg * kPPT);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + pg * kPPT + 4);
      float xv[kPPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      if (kFirst && !kPipe) {
        const float qk = qs[k];
#pragma unroll
        for (int p = 0; p < kPPT; ++p) xv[p] = Dt<T>::round(qk * xv[p]);
      }
      const float4 b0 = *reinterpret_cast<const float4*>(wc + kk * kUnits + lane * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wc + kk * kUnits + kUnits / 2 + lane * 4);
      const float wv[kUPT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < kPPT; ++p) {
#pragma unroll
        for (int u = 0; u < kUPT; ++u) acc[p][u] = fmaf(xv[p], wv[u], acc[p][u]);
      }
    }
    if (c + 1 < chunks) {
      if (kPipe) {
        cp_async_wait_all();
        __syncthreads();
      } else {
        __syncthreads();
        stage_chunk<T, kFirst, kPipe>(c + 1, ws, hs, cs, qrow, wl, k_dim, f_dim, h, u0);
        cp_async_wait_all();
        __syncthreads();
      }
    }
  }
}

// out[i, c0 + p] for every query i and the block's candidates.  qh (q_count,
// h) in T; cand (n_cand, h) in T, or int8 codes with scales (n_cand,) when
// kQuant; w holds every layer's (in, out) matrix in T, b every bias in fp32.
// kPipe: the pipelined layout (two weight chunks, two Hadamard chunks);
// otherwise one weight chunk and the query row.
template <typename T, bool kQuant, bool kPipe>
__global__ void __launch_bounds__(kThreads, 2)
mlp_simt_kernel(const T* __restrict__ qh, const void* __restrict__ cand,
                const float* __restrict__ scales, const T* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ out, int q_count,
                int64_t n_cand, int h, Head head) {
  extern __shared__ float4 smem4[];
  const int hp = round_up(h, kKC);
  float* cs = reinterpret_cast<float*>(smem4);      // [hp][kTB] candidate tile
  float* ws = cs + hp * kTB;                        // [1 or 2][kKC][kUnits] weight chunks
  float* hs = ws + (kPipe ? 2 : 1) * kKC * kUnits;  // kPipe: [2][kKC][kTB]; else qs [hp]
  float* act0 = hs + (kPipe ? 2 * kKC * kTB : hp);  // [act_rows][kTB] activations
  float* act1 = act0 + head.act_rows * kTB;         // the second buffer, for L >= 4
  float* qs = hs;

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
    const T* qrow = qh + (int64_t)qi * h;
    if (!kPipe) {
      __syncthreads();  // the previous query is done with qs
      for (int k = threadIdx.x; k < hp; k += kThreads) {
        qs[k] = k < h ? Dt<T>::load(qrow + k) : 0.f;
      }
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
          layer_pass<T, true, kPipe>(acc, cs, cs, qs, qrow, ws, hs, w + head.w_off[0], k_dim,
                                     f_dim, h, u0, pg, lane);
        } else {
          layer_pass<T, false, kPipe>(acc, xin, cs, qs, qrow, ws, hs, w + head.w_off[l], k_dim,
                                      f_dim, h, u0, pg, lane);
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

// Bytes of shared memory one SIMT block uses.  The single-buffered layout is
// the count ops/mlp_topk.py::smem_bytes mirrors for its gate; the pipelined
// one runs wherever it fits too.
int64_t smem_simt(const Head& head, int h, bool pipe) {
  const int64_t hp = round_up(h, kKC);
  const int buffers = head.layers - 2 < 2 ? head.layers - 2 : 2;
  const int64_t acts = (int64_t)buffers * head.act_rows * kTB;
  const int64_t floats = pipe ? hp * kTB + 2 * kKC * kUnits + 2 * kKC * kTB + acts
                              : hp * kTB + kKC * kUnits + hp + acts;
  return floats * (int64_t)sizeof(float);
}

template <typename T, bool kQuant, bool kPipe>
int launch_simt(const void* qh, const void* cand, const float* scales, const void* w,
                const float* b, float* out, int64_t q_count, int64_t n_cand, int h,
                const Head& head, int64_t smem, cudaStream_t stream) {
  const auto kernel = mlp_simt_kernel<T, kQuant, kPipe>;
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

template <typename T, bool kQuant>
int launch_simt_layout(const void* qh, const void* cand, const float* scales, const void* w,
                       const float* b, float* out, int64_t q_count, int64_t n_cand, int h,
                       const Head& head, cudaStream_t stream) {
  const int64_t pipe = smem_simt(head, h, true);
  if (pipe <= kMaxSmem) {
    return launch_simt<T, kQuant, true>(qh, cand, scales, w, b, out, q_count, n_cand, h, head,
                                        pipe, stream);
  }
  return launch_simt<T, kQuant, false>(qh, cand, scales, w, b, out, q_count, n_cand, h, head,
                                       smem_simt(head, h, false), stream);
}

// ------------------------------------------------------ tensor-core route

constexpr int kWarpN = 64;            // units of a warp's tile
constexpr int kPassN = 4 * kWarpN;    // units of a pass: 4 warps across
constexpr int kQS = 2;                // queries a step: one per 2 warps down
constexpr int kRows = kQS * kTB;      // pairs a step: 128

// The prepped layout (ops/mlp_topk.py::mma_layout mirrors it): hidden layer
// l's W_l^T as [np[l]][stride[l]] bf16 at w_off[l] of the weight buffer,
// kp[l] = K_l padded to 16 (the previous layer's np for l > 0), np[l] = N_l
// padded to 64, stride[l] = kp[l] + 8; in the fp32 buffer each bias (np[l]
// values) at b_off[l], then w_L (np of the last hidden layer) at wl_off and
// b_L at bl_off.  Shared memory holds the same buffers, then the candidate
// tile [kTB][hp + 8], the step's query rows [kQS][round_up(hp, 8)], the
// activation buffers [kRows][act_np + 8] and the cross-warp sums
// [4][kRows].
struct MmaHead {
  int hidden;                     // hidden layers: L - 1
  int kp[kMaxLayers], np[kMaxLayers], stride[kMaxLayers];
  int w_off[kMaxLayers], b_off[kMaxLayers];
  int wl_off, bl_off, w_total, f_total;
  int hp, act_np, buffers;
  int64_t smem;
};

MmaHead mma_head(const int64_t* dims, int layers) {
  MmaHead hd{};
  hd.hidden = layers - 1;
  int kp = round_up((int)dims[0], 16), w_at = 0, f_at = 0;
  for (int l = 0; l < hd.hidden; ++l) {
    hd.kp[l] = kp;
    hd.np[l] = round_up((int)dims[l + 1], kWarpN);
    hd.stride[l] = kp + 8;
    hd.w_off[l] = w_at;
    hd.b_off[l] = f_at;
    w_at += hd.np[l] * hd.stride[l];
    f_at += hd.np[l];
    kp = hd.np[l];
    if (l + 1 < hd.hidden && hd.np[l] > hd.act_np) hd.act_np = hd.np[l];
  }
  hd.wl_off = f_at;
  f_at += hd.np[hd.hidden - 1];
  hd.bl_off = f_at;
  hd.w_total = w_at;
  hd.f_total = round_up(f_at + 1, 4);
  hd.hp = hd.kp[0];
  hd.buffers = hd.hidden - 1 < 2 ? hd.hidden - 1 : 2;
  hd.smem = 2 * (int64_t)hd.w_total + 4 * (int64_t)hd.f_total +
            2 * (int64_t)kTB * (hd.hp + 8) + 2 * (int64_t)kQS * round_up(hd.hp, 8) +
            2 * (int64_t)hd.buffers * kRows * (hd.act_np + 8) + 4 * 4 * (int64_t)kRows;
  return hd;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 products, each rounded once (round to nearest even).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// out[i, c0 + p] for every query i and the block's 64 candidates, bf16
// compute.  qh (q_count, h) bf16; cand (n_cand, h) bf16, or int8 codes with
// scales when kQuant; wpack and fpack the prepped buffers of MmaHead.  A
// step takes kQS queries: warp (wm, wn) computes query slot wm's 64 pairs
// (4 m tiles of 16) against units wn * 64 ... of the pass (8 n tiles of 8),
// so each B fragment feeds 4 MMAs and each A fragment 8.
template <bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
mlp_mma_kernel(const bf16* __restrict__ qh, const void* __restrict__ cand,
               const float* __restrict__ scales, const bf16* __restrict__ wpack,
               const float* __restrict__ fpack, float* __restrict__ out, int q_count,
               int64_t n_cand, int h, MmaHead hd) {
  extern __shared__ uint4 smem16[];
  bf16* wt = reinterpret_cast<bf16*>(smem16);
  float* fp = reinterpret_cast<float*>(wt + hd.w_total);
  bf16* ct = reinterpret_cast<bf16*>(fp + hd.f_total);
  const int cstride = hd.hp + 8;
  bf16* qv = ct + kTB * cstride;
  const int qstride = round_up(hd.hp, 8);
  bf16* act = qv + kQS * qstride;
  const int astride = hd.act_np + 8;
  float* red = reinterpret_cast<float*>(act + hd.buffers * kRows * astride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // query slot wm; units wn * 64 ... of a pass
  const int g = lane >> 2, t = lane & 3;

  // the weights, once per block: the smem layout is the prepped layout
  for (int i = tid; i < hd.w_total / 8; i += kThreads) {
    smem16[i] = __ldg(reinterpret_cast<const uint4*>(wpack) + i);
  }
  for (int i = tid; i < hd.f_total / 4; i += kThreads) {
    reinterpret_cast<float4*>(fp)[i] = __ldg(reinterpret_cast<const float4*>(fpack) + i);
  }
  const int64_t c0 = (int64_t)blockIdx.x * kTB;
  const int nb = n_cand - c0 < kTB ? (int)(n_cand - c0) : kTB;
  for (int i = tid; i < kTB * hd.hp; i += kThreads) {
    const int p = i / hd.hp, k = i - p * hd.hp;
    bf16 v = __float2bfloat16_rn(0.f);
    if (p < nb && k < h) {
      const int64_t at = (c0 + p) * h + k;
      v = kQuant ? __float2bfloat16_rn((float)static_cast<const int8_t*>(cand)[at] *
                                       scales[c0 + p])
                 : static_cast<const bf16*>(cand)[at];
    }
    ct[p * cstride + k] = v;
  }
  const float b_last = fpack[hd.bl_off];

  for (int q0 = 0; q0 < q_count; q0 += kQS) {
    // the step's queries; a missing second query computes on zeros, unstored
    for (int i = tid; i < kQS * hd.hp; i += kThreads) {
      const int s = i / hd.hp, k = i - s * hd.hp;
      qv[s * qstride + k] = q0 + s < q_count && k < h ? qh[(int64_t)(q0 + s) * h + k]
                                                      : __float2bfloat16_rn(0.f);
    }
    __syncthreads();  // the queries (and, the first time, the weights and the tile)
    float part[4][2];  // [m tile][row g, g + 8]
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) part[mt][0] = part[mt][1] = 0.f;
    for (int l = 0; l < hd.hidden; ++l) {
      const bool first = l == 0, last = l + 1 == hd.hidden;
      // layer 0 reads the candidate tile (the same rows for both slots);
      // later layers the slot's rows of the activations
      const bf16* a_src =
          first ? ct : act + ((l - 1) & 1) * kRows * astride + wm * kTB * astride;
      const int a_str = first ? cstride : astride;
      const bf16* qs = qv + wm * qstride;
      const bf16* wl = wt + hd.w_off[l];
      const int w_str = hd.stride[l], kp = hd.kp[l], np = hd.np[l];
      const float* bias = fp + hd.b_off[l];
      bf16* dst = act + (l & 1) * kRows * astride + wm * kTB * astride;
      for (int n0 = 0; n0 < np; n0 += kPassN) {
        const int nw = n0 + wn * kWarpN;
        if (nw >= np) continue;  // warp-uniform: this warp's units are all padding
        float acc[4][8][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
          }
        }
        for (int k0 = 0; k0 < kp; k0 += 16) {
          uint32_t a[4][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            ldmatrix_x4(a[mt], a_src + (mt * 16 + (lane & 15)) * a_str + k0 + (lane >> 4) * 8);
          }
          if (first) {  // the Hadamard product, rounded to bf16 once
            const uint32_t q01 = *reinterpret_cast<const uint32_t*>(qs + k0 + 2 * t);
            const uint32_t q89 = *reinterpret_cast<const uint32_t*>(qs + k0 + 8 + 2 * t);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              a[mt][0] = mul_bf16x2(a[mt][0], q01);
              a[mt][1] = mul_bf16x2(a[mt][1], q01);
              a[mt][2] = mul_bf16x2(a[mt][2], q89);
              a[mt][3] = mul_bf16x2(a[mt][3], q89);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bq[4];
            ldmatrix_x4(bq, wl + (nw + jj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * w_str +
                                k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              mma_bf16(acc[mt][2 * jj], a[mt], bq[0], bq[1]);
              mma_bf16(acc[mt][2 * jj + 1], a[mt], bq[2], bq[3]);
            }
          }
        }
        // epilogue: bias, relu, one rounding to bf16
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nw + j * 8 + 2 * t;
          const float b0 = bias[col], b1 = bias[col + 1];
          const float w0 = last ? fp[hd.wl_off + col] : 0.f;
          const float w1 = last ? fp[hd.wl_off + col + 1] : 0.f;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const float z0 = round_bf16(fmaxf(acc[mt][j][0] + b0, 0.f));
            const float z1 = round_bf16(fmaxf(acc[mt][j][1] + b1, 0.f));
            const float z2 = round_bf16(fmaxf(acc[mt][j][2] + b0, 0.f));
            const float z3 = round_bf16(fmaxf(acc[mt][j][3] + b1, 0.f));
            if (last) {
              part[mt][0] = fmaf(z1, w1, fmaf(z0, w0, part[mt][0]));
              part[mt][1] = fmaf(z3, w1, fmaf(z2, w0, part[mt][1]));
            } else {
              const int row = mt * 16 + g;
              *reinterpret_cast<uint32_t*>(dst + row * astride + col) = pack_bf16x2(z0, z1);
              *reinterpret_cast<uint32_t*>(dst + (row + 8) * astride + col) =
                  pack_bf16x2(z2, z3);
            }
          }
        }
      }
      if (!last) __syncthreads();  // the activations are written before the next layer
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = part[mt][hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[wn * kRows + wm * kTB + mt * 16 + hh * 8 + g] = v;
      }
    }
    __syncthreads();  // the four warps' sums of each row are in red; qv is free
    if (tid < kRows) {
      const int s = tid / kTB, p = tid - s * kTB;
      if (p < nb && q0 + s < q_count) {
        out[(int64_t)(q0 + s) * n_cand + c0 + p] =
            ((red[tid] + red[kRows + tid]) + (red[2 * kRows + tid] + red[3 * kRows + tid])) +
            b_last;
      }
    }
  }
}

template <bool kQuant>
int launch_mma(const void* qh, const void* cand, const float* scales, const void* wpack,
               const float* fpack, float* out, int64_t q_count, int64_t n_cand, int h,
               const MmaHead& hd, cudaStream_t stream) {
  const auto kernel = mlp_mma_kernel<kQuant>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hd.smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_cand + kTB - 1) / kTB;
  kernel<<<(unsigned)blocks, kThreads, (size_t)hd.smem, stream>>>(
      static_cast<const bf16*>(qh), cand, scales, static_cast<const bf16*>(wpack), fpack, out,
      (int)q_count, n_cand, h, hd);
  return (int)cudaGetLastError();
}

// The checks both entry points share: 2 to 8 layers, a first width of h, a
// scalar output, sizes the grid and int offsets can take.
bool valid_head(int64_t q_count, int64_t n_cand, int64_t h, const int64_t* dims, int layers) {
  if (q_count <= 0 || q_count > 0x7fffffff || n_cand <= 0 || h <= 0) return false;
  if ((n_cand + kTB - 1) / kTB > 0x7fffffff) return false;
  if (layers < 2 || layers > kMaxLayers || dims[0] != h || dims[layers] != 1) return false;
  for (int l = 0; l < layers; ++l) {
    if (dims[l] <= 0 || dims[l] > (1 << 20)) return false;
  }
  return true;
}

}  // namespace

// The SIMT route.  qh (q_count, h) and w (every layer's (dims[l], dims[l+1])
// matrix, in order) of type dtype (0 float32, 1 bfloat16); cand (n_cand, h)
// of that type, or int8 codes when scales (n_cand,) fp32 is not null; b
// every bias in fp32, in order; out (q_count, n_cand) fp32.  dims is a host
// array of layers + 1 widths.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int llp_mlp_topk(const void* qh, const void* cand, const float* scales,
                            const void* w, const float* b, float* out, int64_t q_count,
                            int64_t n_cand, int64_t h, const int64_t* dims, int layers,
                            int dtype, void* stream) {
  if (!valid_head(q_count, n_cand, h, dims, layers)) return (int)cudaErrorInvalidValue;
  Head head{};
  head.layers = layers;
  int64_t w_at = 0, b_at = 0;
  for (int l = 0; l < layers; ++l) {
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
  if (smem_simt(head, (int)h, false) > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = scales != nullptr;
  const int hi = (int)h;
  if (dtype == 0 && !quant)
    return launch_simt_layout<float, false>(qh, cand, scales, w, b, out, q_count, n_cand, hi,
                                            head, s);
  if (dtype == 0 && quant)
    return launch_simt_layout<float, true>(qh, cand, scales, w, b, out, q_count, n_cand, hi,
                                           head, s);
  if (dtype == 1 && !quant)
    return launch_simt_layout<bf16, false>(qh, cand, scales, w, b, out, q_count, n_cand, hi,
                                           head, s);
  if (dtype == 1 && quant)
    return launch_simt_layout<bf16, true>(qh, cand, scales, w, b, out, q_count, n_cand, hi,
                                          head, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route, bf16 compute.  qh (q_count, h) bf16; cand (n_cand,
// h) bf16, or int8 codes when scales (n_cand,) fp32 is not null; wpack
// (w_elems,) bf16 and fpack (f_elems,) fp32 in the layout of MmaHead, both
// 16-byte aligned; out (q_count, n_cand) fp32.  Refuses (cudaErrorInvalidValue)
// a head whose buffers do not fit a block or whose sizes disagree with the
// layout.
extern "C" int llp_mlp_topk_mma(const void* qh, const void* cand, const float* scales,
                                const void* wpack, const float* fpack, float* out,
                                int64_t q_count, int64_t n_cand, int64_t h,
                                const int64_t* dims, int layers, int64_t w_elems,
                                int64_t f_elems, void* stream) {
  if (!valid_head(q_count, n_cand, h, dims, layers)) return (int)cudaErrorInvalidValue;
  const MmaHead hd = mma_head(dims, layers);
  if (hd.smem > kMaxSmem || w_elems != hd.w_total || f_elems != hd.f_total) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(wpack) % 16 || reinterpret_cast<uintptr_t>(fpack) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scales ? launch_mma<true>(qh, cand, scales, wpack, fpack, out, q_count, n_cand,
                                   (int)h, hd, s)
                : launch_mma<false>(qh, cand, scales, wpack, fpack, out, q_count, n_cand,
                                    (int)h, hd, s);
}
