// Tile SpMM: out = A x over a 128 x 128 blocked (receiver, sender)
// adjacency, fp32 accumulation, templated on the type of x and on optional
// per-edge weights.
//
//   out[r, :] = sum over the valid slots of the chunks of row block r / 128
//               whose coordinate has er = r % 128 of  w * x[c * 128 + ec, :]
//
// with c the chunk's tile column, (er, ec) = (coord / 128, coord % 128) the
// slot's local coordinate (-1 pads), and w the slot's weight (1 unweighted).
// Duplicate edges add; a row block with no chunk is zero.  The tiles come
// from llp_tpu_torch/data/tiles.py::build_tiles: chunks of at most 128 edges
// of one tile, sorted by tile row, each chunk's edges in its first slots, and
// block_ptr, each row block's run of chunks.
//
// Replaces the TPU kernel docs/archived/spmm_tile_kernel.py::_make_kernel
// (its pallas_call in _spmm_tiles_call), in its four instances: x fp32 or
// bf16, unweighted or weighted.  The TPU kernel expands each chunk's
// coordinates into one-hot matrices R and S, recovers the tile A = R^T S
// (weighted: (R o w)^T S) on the MXU and adds A x_tile into the output row
// block it keeps resident across the row's chunks.  That costs 128 x 128 x D
// multiply-adds per chunk whatever the fill; this kernel adds each valid
// slot's row of x directly, D multiply-adds a slot.
//
// What bounds it on an H100: memory.  The least traffic is each valid slot's
// coordinate (4 bytes) and weight (4 more), each chunk's tile column, the
// rows of x the tiles point at (D x its element size each) and out
// (N_out x D x 4 bytes), against 2 D operations a slot, far below the fp32
// rate.  The gather reads one row of x per valid slot, from L2 when x fits
// in its 50 MB; an order that fills the tiles (--reorder rcm|locality) makes
// a chunk's rows come from one 128-row block of x.
//
// What held the first design back (chip_smoke.py on the collab stand-in in
// RCM order, D = 256, NVIDIA H100 80GB HBM3 at 700 W): a block of two warps
// owned one (row block, 64-column slice) and walked the row block's chunks
// one after another, each a dependent chain of coordinates, x rows and adds.  At
// min_tile_edges=0 a row block holds about 554 chunks of 2.46 edges, so the
// walk was latency-bound: 9.39 ms fp32 weighted, 9.48 ms bf16 (62x its byte
// bound; torch.sparse.mm over the same edges 0.89 / 0.70 ms); at >= 16
// edges 0.716 / 0.692 ms against 0.421 / 0.295.  Its 32 KB slab per two
// warps capped an SM at 14 warps, each lane loaded 4 bytes (2 in bf16) of x,
// and every chunk's coordinates were read again for each 64-column slice.
//
// Design:
// * The valid slots, not the chunks, are the unit of work.  The wrapper
//   derives once per tile set, on the device, each valid slot's chunk
//   (relative to its row block's first, times 128, plus the slot) in chunk
//   order (valid_slot, int32) and each row block's range of them
//   (valid_ptr, int64); the tile arrays stay as build_tiles makes them.  So
//   no padding is ever read: the kernel leaves every chunk before its first
//   padded slot, and a row block of 554 chunks of 2.46 edges is 1,363 slots
//   of work, not 554 dependent walks.
// * One block of 32 warps owns one (row block, 256-column pass of D).  It
//   stages up to 1,024 valid slots at a time in shared memory, one a thread,
//   as (x row, local row er, weight): their coordinates, tile columns and
//   weights are read once a pass (once in all for D <= 256).  Each thread
//   loads the next batch's slot index before the current batch is summed.
// * Warp-private rows: warp w owns the rows er with er % 32 == w.  It filters
//   the staged batch for its rows with ballots, in order, into a queue in
//   shared memory, then sums its queue with 4 rows of x in flight: each lane
//   takes 16 bytes of a row (4 fp32 or 8 bf16 values; two loads for 256 fp32
//   columns), or 8 scalars on the path for widths that are not a multiple
//   of the vector or an x that is not 16-byte aligned.  The sums go into a
//   128 x 256 fp32 block in shared memory that only the row's warp touches,
//   so there are no atomics and each element sums its slots in chunk and
//   slot order, as the first design did: the result is deterministic.
//   Weighted products round before the add (__fmul_rn), as the plain
//   version forms them.
// * The block writes its 128 output rows once at the end, 16 bytes a thread
//   where D is a multiple of 4, zeros for a row block with no slot, so the
//   wrapper allocates out with torch.empty.
// * Shared memory: 128 KB of sums, 9 KB of staged slots, 64 KB of queues;
//   one block (32 warps) an SM.
// * block_ptr, valid_ptr and chunk offsets are 64-bit; a row block may hold
//   at most 2^24 chunks (the wrapper checks).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // rows and columns of a tile
constexpr int kTileE = 128;     // slots of a chunk
constexpr int kThreads = 1024;  // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 256;      // columns of D a block sums (a pass)
constexpr int kBatch = 1024;    // valid slots staged at a time: one a thread
constexpr int kInFlight = 4;    // rows of x in flight per warp
constexpr int kPer = 8;         // values of a row per lane
constexpr size_t kSmem = sizeof(float) * kTile * kCols       // sums
                         + (sizeof(int32_t) + sizeof(float) + 1) * kBatch  // staged slots
                         + sizeof(uint16_t) * kWarps * kBatch;  // queues

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Load the lane's kPer values of one row of x (dd columns left in this pass):
// value j sits at sum position pos(lane, j) = (j < 4 ? 0 : 128) + lane * 4 +
// (j & 3) on the vector paths and j * 32 + lane on the scalar path.
// Columns past dd load as 0 (and are never written out).
template <typename T, bool kVec> struct Row;

template <> struct Row<float, true> {  // column = pos: two 16-byte loads
  __device__ static __forceinline__ void load(float (&v)[kPer], const float* row, int lane,
                                              int dd, bool ok) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 128 + lane * 4;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && c < dd) q = __ldg(reinterpret_cast<const float4*>(row + c));
      v[4 * h] = q.x; v[4 * h + 1] = q.y; v[4 * h + 2] = q.z; v[4 * h + 3] = q.w;
    }
  }
};

template <> struct Row<bf16, true> {  // columns lane * 8 ... + 7: one 16-byte load
  __device__ static __forceinline__ void load(float (&v)[kPer], const bf16* row, int lane,
                                              int dd, bool ok) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (ok && lane * 8 < dd) q = __ldg(reinterpret_cast<const uint4*>(row + lane * 8));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
  }
};

template <typename T> struct Row<T, false> {  // column = pos = j * 32 + lane
  __device__ static __forceinline__ void load(float (&v)[kPer], const T* row, int lane,
                                              int dd, bool ok) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = j * 32 + lane;
      if constexpr (sizeof(T) == 4) {
        v[j] = ok && c < dd ? __ldg(reinterpret_cast<const float*>(row) + c) : 0.f;
      } else {
        v[j] = ok && c < dd
                   ? bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(row) + c))
                   : 0.f;
      }
    }
  }
};

// Sum position of the first of four output columns 4g ... 4g + 3: the
// identity, except on the bf16 vector path, where a lane's columns
// 8l ... 8l + 3 sit at 4l and 8l + 4 ... 8l + 7 at 128 + 4l.
template <typename T, bool kVec>
__device__ __forceinline__ int granule_pos(int g) {
  if constexpr (kVec && sizeof(T) == 2) return (g & 1) * 128 + (g >> 1) * 4;
  return 4 * g;
}

template <typename T, bool kW, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
spmm_tiles_kernel(const int32_t* __restrict__ tile_cols,
                  const int64_t* __restrict__ block_ptr,
                  const int32_t* __restrict__ coords, const float* __restrict__ w,
                  const int64_t* __restrict__ valid_ptr,
                  const int32_t* __restrict__ valid_slot, const T* __restrict__ x,
                  float* __restrict__ out, int64_t n_out, int64_t d) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);           // [kTile][kCols]
  int32_t* s_col = reinterpret_cast<int32_t*>(acc + kTile * kCols);
  float* s_w = reinterpret_cast<float*>(s_col + kBatch);
  uint8_t* s_er = reinterpret_cast<uint8_t*>(s_w + kBatch);
  uint16_t* queue = reinterpret_cast<uint16_t*>(s_er + kBatch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t rb = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * kCols;
  const int dd = (int)(d - c0 < kCols ? d - c0 : kCols);  // columns of this pass
  for (int i = tid; i < kTile * kCols / 4; i += kThreads) {
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int64_t t0 = block_ptr[rb];
  const int64_t f_begin = valid_ptr[rb], f_end = valid_ptr[rb + 1];
  uint16_t* myq = queue + warp * kBatch;
  int32_t next = f_begin + tid < f_end ? __ldg(valid_slot + f_begin + tid) : 0;
  for (int64_t f0 = f_begin; f0 < f_end; f0 += kBatch) {
    const int nb = (int)(f_end - f0 < kBatch ? f_end - f0 : kBatch);
    __syncthreads();  // the sums are zeroed; every warp is done with the last batch
    if (tid < nb) {
      const int64_t t = t0 + (next >> 7);
      const int64_t slot = t * kTileE + (next & (kTileE - 1));
      const int coord = __ldg(coords + slot);
      s_col[tid] = __ldg(tile_cols + t) * kTile + (coord & (kTile - 1));
      s_er[tid] = (uint8_t)(coord >> 7);
      if (kW) s_w[tid] = __ldg(w + slot);
    }
    if (f0 + kBatch + tid < f_end) next = __ldg(valid_slot + f0 + kBatch + tid);
    __syncthreads();

    // this warp's slots of the batch, in order
    int qn = 0;
    for (int b = 0; b < nb; b += 32) {
      const int e = b + lane;
      const bool mine = e < nb && (s_er[e] & (kWarps - 1)) == warp;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) myq[qn + __popc(m & ((1u << lane) - 1u))] = (uint16_t)e;
      qn += __popc(m);
    }
    __syncwarp();

    for (int i = 0; i < qn; i += kInFlight) {
      float v[kInFlight][kPer];
      int er[kInFlight];
      float wk[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const bool ok = i + k < qn;
        const int e = myq[ok ? i + k : i];
        er[k] = s_er[e];
        wk[k] = kW ? s_w[e] : 1.f;
        Row<T, kVec>::load(v[k], x + (int64_t)s_col[e] * d + c0, lane, dd, ok);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (i + k < qn) {
          float* a = acc + er[k] * kCols;
          if constexpr (kVec) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float4* p = reinterpret_cast<float4*>(a + h * 128 + lane * 4);
              float4 s = *p;
              if (kW) {
                s.x = __fadd_rn(s.x, __fmul_rn(wk[k], v[k][4 * h]));
                s.y = __fadd_rn(s.y, __fmul_rn(wk[k], v[k][4 * h + 1]));
                s.z = __fadd_rn(s.z, __fmul_rn(wk[k], v[k][4 * h + 2]));
                s.w = __fadd_rn(s.w, __fmul_rn(wk[k], v[k][4 * h + 3]));
              } else {
                s.x += v[k][4 * h]; s.y += v[k][4 * h + 1];
                s.z += v[k][4 * h + 2]; s.w += v[k][4 * h + 3];
              }
              *p = s;
            }
          } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              float& s = a[j * 32 + lane];
              s = kW ? __fadd_rn(s, __fmul_rn(wk[k], v[k][j])) : s + v[k][j];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  const int64_t row0 = rb * kTile;
  const int rows = (int)(n_out - row0 < kTile ? n_out - row0 : kTile);
  if (d % 4 == 0) {  // 16 bytes a thread, consecutive threads on consecutive columns
    const int granules = dd / 4;
    for (int i = tid; i < rows * granules; i += kThreads) {
      const int r = i / granules, g = i - r * granules;
      const float4 s = *reinterpret_cast<const float4*>(acc + r * kCols + granule_pos<T, kVec>(g));
      *reinterpret_cast<float4*>(out + (row0 + r) * d + c0 + 4 * g) = s;
    }
  } else {  // the scalar path's identity layout
    for (int i = tid; i < rows * dd; i += kThreads) {
      const int r = i / dd, c = i - r * dd;
      out[(row0 + r) * d + c0 + c] = acc[r * kCols + c];
    }
  }
}

template <typename T, bool kW, bool kVec>
int launch(const int32_t* tile_cols, const int64_t* block_ptr, const int32_t* coords,
           const float* w, const int64_t* valid_ptr, const int32_t* valid_slot,
           const void* x, float* out, int64_t n_out, int64_t d, cudaStream_t s) {
  const auto kernel = spmm_tiles_kernel<T, kW, kVec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t row_blocks = (n_out + kTile - 1) / kTile;
  const int64_t passes = (d + kCols - 1) / kCols;
  if (row_blocks > INT_MAX || passes > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_blocks, (unsigned)passes);
  kernel<<<grid, kThreads, kSmem, s>>>(tile_cols, block_ptr, coords, w, valid_ptr, valid_slot,
                                       static_cast<const T*>(x), out, n_out, d);
  return (int)cudaGetLastError();
}

template <typename T, bool kW>
int launch_vec(bool vec, const int32_t* tile_cols, const int64_t* block_ptr,
               const int32_t* coords, const float* w, const int64_t* valid_ptr,
               const int32_t* valid_slot, const void* x, float* out, int64_t n_out,
               int64_t d, cudaStream_t s) {
  return vec ? launch<T, kW, true>(tile_cols, block_ptr, coords, w, valid_ptr, valid_slot, x,
                                   out, n_out, d, s)
             : launch<T, kW, false>(tile_cols, block_ptr, coords, w, valid_ptr, valid_slot,
                                    x, out, n_out, d, s);
}

}  // namespace

// tile_cols (T,) int32; block_ptr (>= ceil(n_out / 128) + 1,) int64, the
// chunks of row block b are [block_ptr[b], block_ptr[b + 1]); coords
// (T * 128,) int32, er * 128 + ec, each chunk's valid slots first and -1
// after them; w (T * 128,) fp32 per-slot weights or null; valid_ptr
// (>= ceil(n_out / 128) + 1,) int64 and valid_slot (V,) int32: row block b's
// valid slots are valid_slot[valid_ptr[b] ... valid_ptr[b + 1]), each
// (chunk - block_ptr[b]) * 128 + slot, in chunk and slot order; x (N, d)
// row-major, fp32 (x_type 0) or bf16 (x_type 1), with every
// tile_cols[t] * 128 + ec < N; out (n_out, d) fp32, 16-byte aligned, every
// element written.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int llp_spmm_tiles(const int32_t* tile_cols, const int64_t* block_ptr,
                              const int32_t* coords, const float* w,
                              const int64_t* valid_ptr, const int32_t* valid_slot,
                              const void* x, float* out, int64_t n_out, int64_t d, int x_type,
                              void* stream) {
  if (n_out <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the vector paths: whole 16-byte pieces of every row of x
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_type == 0) {
    const bool vec = aligned && d % 4 == 0;
    return w ? launch_vec<float, true>(vec, tile_cols, block_ptr, coords, w, valid_ptr,
                                       valid_slot, x, out, n_out, d, s)
             : launch_vec<float, false>(vec, tile_cols, block_ptr, coords, w, valid_ptr,
                                        valid_slot, x, out, n_out, d, s);
  }
  if (x_type == 1) {
    const bool vec = aligned && d % 8 == 0;
    return w ? launch_vec<bf16, true>(vec, tile_cols, block_ptr, coords, w, valid_ptr,
                                      valid_slot, x, out, n_out, d, s)
             : launch_vec<bf16, false>(vec, tile_cols, block_ptr, coords, w, valid_ptr,
                                       valid_slot, x, out, n_out, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
