// Fused pair scoring for a 2-layer MLP link predictor, fp32:
//
//   out[p] = sigmoid(w2 . relu((ha[src[p]] * hb[dst[p]]) W1 + b1) + b2)
//
// Replaces the TPU kernel llp_tpu/ops/pallas/sddmm_kernel.py::_kernel
// (launched by _sddmm_call through fused_mlp_score).  The TPU kernel took
// rows gathered by XLA; this one gathers ha[src] and hb[dst] itself, so
// neither the gathered rows, the Hadamard product z nor the hidden layer z1
// ever reach device memory.
//
// What bounds it on an H100: operations.  Each pair costs 2*D*H FLOPs of
// the W1 product against 8*D bytes of gathered rows; at D = H = 256 that is
// 64 FLOP/byte, above the ~20 FLOP/byte where the fp32 (non-tensor-core)
// peak of 67 TFLOP/s, not the 3.35 TB/s of memory, is the limit.
//
// Design (simple first; wgmma/TMA come later):
// * One block of 256 threads owns a tile of 32 pairs.  It stages
//   z = ha[src] * hb[dst] for the tile in shared memory (32 x D floats,
//   rows padded to a multiple of 4 with zeros).
// * Thread j owns hidden units j, j + 256, ...  For each, it streams column
//   j of W1 (row-major (D, H): the warp's loads are coalesced, and W1 stays
//   in L1/L2) and accumulates the unit for all 32 pairs in registers, reading
//   z four features at a time as broadcast float4 loads: one shared-memory
//   load per four FMAs.
// * Each thread adds relu(z1 + b1) * w2 of its units into 32 per-pair
//   partial logits; warp shuffles and one shared-memory pass reduce them
//   across the block; the first 32 threads add b2 and apply the sigmoid.
// * The ragged last tile is masked here (rows past the end stage zeros and
//   are not stored); there is no padding of the batch to the TPU's 1024.
// * Any D and H.  A tile's z takes 128*D bytes of shared memory (above
//   48 KB only after raising the kernel's dynamic shared-memory limit).
//   Up to D = 1808 it is staged once.  Wider rows are staged in equal
//   chunks of at most 1808 features: the block walks its hidden units 256
//   at a time and re-stages every chunk for each group of 256, trading
//   re-gathers (from L2) for a width limit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 32;   // pairs per block
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ void fma_tile(float (&acc)[kPairs], const float* z,
                                         int d4, int k, float c0, float c1,
                                         float c2, float c3) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(z + p * d4 + k);
    acc[p] = fmaf(v.x, c0, acc[p]);
    acc[p] = fmaf(v.y, c1, acc[p]);
    acc[p] = fmaf(v.z, c2, acc[p]);
    acc[p] = fmaf(v.w, c3, acc[p]);
  }
}

// z[p][k] = ha[src[p0+p]][c0+k] * hb[dst[p0+p]][c0+k] for the tile's pairs
// and the chunk's features; zero past the batch and past d.
__device__ __forceinline__ void stage_z(float* z, const float* __restrict__ ha,
                                        const float* __restrict__ hb,
                                        const int64_t* __restrict__ src,
                                        const int64_t* __restrict__ dst,
                                        int64_t p0, int np, int d, int c0, int dc) {
  for (int i = threadIdx.x; i < kPairs * dc; i += kThreads) {
    const int p = i / dc;
    const int k = i - p * dc;
    float v = 0.f;
    if (p < np && c0 + k < d) {
      v = ha[src[p0 + p] * d + c0 + k] * hb[dst[p0 + p] * d + c0 + k];
    }
    z[i] = v;
  }
}

// acc[p] += z[p][0:len] . wj[0:len] (wj a column of W1, stride h); z is zero
// from len to the next multiple of 4.
__device__ __forceinline__ void dot_chunk(float (&acc)[kPairs], const float* z,
                                          const float* __restrict__ wj, int h,
                                          int len, int dc) {
  const int lfull = len & ~3;
  int k = 0;
  for (; k < lfull; k += 4) {
    fma_tile(acc, z, dc, k, __ldg(wj + (int64_t)k * h),
             __ldg(wj + (int64_t)(k + 1) * h), __ldg(wj + (int64_t)(k + 2) * h),
             __ldg(wj + (int64_t)(k + 3) * h));
  }
  if (k < len) {  // last 1-3 features
    const float c0 = __ldg(wj + (int64_t)k * h);
    const float c1 = k + 1 < len ? __ldg(wj + (int64_t)(k + 1) * h) : 0.f;
    const float c2 = k + 2 < len ? __ldg(wj + (int64_t)(k + 2) * h) : 0.f;
    fma_tile(acc, z, dc, k, c0, c1, c2, 0.f);
  }
}

// kChunked: z is staged a chunk of dc < d features at a time, again for
// every group of kThreads hidden units; otherwise it is staged once (dc >= d).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
sddmm_mlp_kernel(const float* __restrict__ ha, const float* __restrict__ hb,
                 const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ out, int64_t n_pairs, int d, int h, int dc) {
  extern __shared__ float4 smem4[];
  float* z = reinterpret_cast<float*>(smem4);  // [kPairs][dc]
  float* part = z + kPairs * dc;               // [kWarps][kPairs]
  const int64_t p0 = (int64_t)blockIdx.x * kPairs;
  const int64_t rest = n_pairs - p0;
  const int np = rest < kPairs ? (int)rest : kPairs;

  if (!kChunked) {
    stage_z(z, ha, hb, src, dst, p0, np, d, 0, dc);
    __syncthreads();
  }
  float logit[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) logit[p] = 0.f;
  // Block-uniform: the chunked path synchronises inside the loop.
  for (int j0 = 0; j0 < h; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    float acc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
    if (kChunked) {
      for (int c0 = 0; c0 < d; c0 += dc) {
        __syncthreads();  // every thread is done with the previous chunk
        stage_z(z, ha, hb, src, dst, p0, np, d, c0, dc);
        __syncthreads();
        if (j < h) dot_chunk(acc, z, w1 + (int64_t)c0 * h + j, h, min(dc, d - c0), dc);
      }
    } else if (j < h) {
      dot_chunk(acc, z, w1 + j, h, d, dc);
    }
    if (j < h) {
      const float bj = __ldg(b1 + j);
      const float vj = __ldg(w2 + j);
#pragma unroll
      for (int p = 0; p < kPairs; ++p) logit[p] += fmaxf(acc[p] + bj, 0.f) * vj;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    float v = logit[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp * kPairs + p] = v;
  }
  __syncthreads();
  if (threadIdx.x < np) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * kPairs + threadIdx.x];
    s += __ldg(b2);
    out[p0 + threadIdx.x] = 1.f / (1.f + expf(-s));
  }
}

}  // namespace

// ha (*, d), hb (*, d) fp32 row-major tables; src, dst (n_pairs,) int64 rows
// into them; w1 (d, h) row-major; b1, w2 (h,); b2 (1,); out (n_pairs,).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int llp_sddmm_mlp_f32(const float* ha, const float* hb,
                                 const int64_t* src, const int64_t* dst,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 int64_t n_pairs, int64_t d, int64_t h,
                                 void* stream) {
  if (n_pairs <= 0 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  // Features per staged chunk: a multiple of 4, as wide as shared memory
  // allows, and equal across chunks.
  const int64_t max_dc = (kMaxSmem / (int64_t)sizeof(float) - kWarps * kPairs) / kPairs / 4 * 4;
  const int64_t d4 = (d + 3) / 4 * 4;
  const int64_t chunks = (d4 + max_dc - 1) / max_dc;
  const int64_t dc = ((d4 + chunks - 1) / chunks + 3) / 4 * 4;
  const int64_t smem = (kPairs * dc + kWarps * kPairs) * (int64_t)sizeof(float);
  const int64_t blocks = (n_pairs + kPairs - 1) / kPairs;
  if (blocks > 0x7fffffff || d > 0x7fffffff || h > 0x7fffffff) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const auto kernel = dc < d ? sddmm_mlp_kernel<true> : sddmm_mlp_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      ha, hb, src, dst, w1, b1, w2, b2, out, n_pairs, (int)d, (int)h, (int)dc);
  return (int)cudaGetLastError();
}
