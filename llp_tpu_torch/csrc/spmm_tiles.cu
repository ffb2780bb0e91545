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
// of one tile, sorted by tile row, and block_ptr, each row block's run of
// chunks.
//
// Replaces the TPU kernel docs/archived/spmm_tile_kernel.py::_make_kernel
// (its pallas_call in _spmm_tiles_call), in its four instances: x fp32 or
// bf16, unweighted or weighted.  The TPU kernel expands each chunk's
// coordinates into one-hot matrices R and S, recovers the tile A = R^T S
// (weighted: (R o w)^T S) on the MXU and adds A x_tile into the output row
// block it keeps resident across the row's chunks.  That is the TPU's way to
// scatter: it costs 128 x 128 x D multiply-adds per chunk whatever the
// fill.  This kernel does not build A; it adds each slot's row directly,
// 128 x D multiply-adds per chunk at most, and D per valid slot.
//
// What bounds it on an H100: memory.  The least traffic is what the sum
// needs read once and the output written once: per valid slot its
// coordinate (4 bytes) and weight (4 more), not the padding; each chunk's
// tile column; the rows of x the tiles point at (D x its element size each);
// out (N_out x D x 4 bytes).  The operations are 2 D a valid slot, far below
// the fp32 rate.  Like the
// segsum kernel (csrc/segsum.cu) the gather reads one row of x per valid
// slot instead, from L2 when x fits in its 50 MB; a node order that fills
// the tiles (--reorder rcm|locality) makes a chunk's rows come from one
// 128-row block of x.
//
// Design:
// * One block of 64 threads owns one (row block, 64-column tile of D).  Its
//   128 x 64 fp32 output block (32 KB) stays in shared memory; thread c owns
//   column c of it, so no two threads touch one element, no atomics and no
//   barrier are needed, and each element's sum runs in slot order: the
//   result is deterministic.
// * The thread walks the row block's chunks and each chunk's slots in
//   order, 16 slots at a time: 16 coordinates (and weights) as four
//   warp-uniform 16-byte loads (coords and w must be 16-byte aligned), then
//   16 predicated loads of x in flight, then the adds.  build_tiles packs a
//   chunk's edges into its first slots and pads the rest with -1, so the
//   walk leaves a chunk after the first group that ends in padding: at low
//   fill most chunks take one group of 16 slots, not eight.
// * The block writes its output rows once at the end, zeros for a row block
//   with no chunk, so every output element is written exactly once and the
//   wrapper allocates out with torch.empty.
// * Shared memory caps residency at 7 blocks (14 warps) an SM.  A
//   dense-tile tensor-core design (mma.sync or wgmma on A_tile x x_tile) is
//   later work: it pays only at the tile fills the reorder phase of
//   chip_smoke.py measures, and those are low (PERF.md).
// * Row and chunk offsets are 64-bit.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // rows and columns of a tile
constexpr int kTileE = 128;  // slots of a chunk
constexpr int kCols = 64;    // threads of a block: columns of its D tile
constexpr int kUnroll = 16;  // slots in flight per thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T, bool kW>
__global__ void __launch_bounds__(kCols)
spmm_tiles_kernel(const int32_t* __restrict__ tile_cols,
                  const int64_t* __restrict__ block_ptr,
                  const int32_t* __restrict__ coords, const float* __restrict__ w,
                  const T* __restrict__ x, float* __restrict__ out, int64_t n_out,
                  int64_t d) {
  __shared__ float acc[kTile * kCols];  // element (row r, column c) at r * kCols + c
  const int c = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.y * kCols + c;
  if (col >= d) return;  // the ragged last D tile; no barrier follows
  float* a = acc + c;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) a[r * kCols] = 0.f;

  const int64_t rb = blockIdx.x;
  const int64_t t1 = block_ptr[rb + 1];
  for (int64_t t = block_ptr[rb]; t < t1; ++t) {
    const T* xb = x + (int64_t)__ldg(tile_cols + t) * kTile * d + col;
    const int32_t* ct = coords + t * kTileE;
    const float* wt = kW ? w + t * kTileE : nullptr;
    for (int s = 0; s < kTileE; s += kUnroll) {
      int cc[kUnroll];
      float wk[kUnroll], v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll / 4; ++q) {
        const int4 c4 = __ldg(reinterpret_cast<const int4*>(ct + s) + q);
        cc[4 * q] = c4.x; cc[4 * q + 1] = c4.y; cc[4 * q + 2] = c4.z; cc[4 * q + 3] = c4.w;
        if constexpr (kW) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + s) + q);
          wk[4 * q] = w4.x; wk[4 * q + 1] = w4.y; wk[4 * q + 2] = w4.z; wk[4 * q + 3] = w4.w;
        } else {
          wk[4 * q] = wk[4 * q + 1] = wk[4 * q + 2] = wk[4 * q + 3] = 1.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        v[k] = cc[k] >= 0 ? load_x(xb + (int64_t)(cc[k] & (kTile - 1)) * d) : 0.f;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (cc[k] >= 0) {
          float& o = a[(cc[k] >> 7) * kCols];
          o = kW ? fmaf(wk[k], v[k], o) : o + v[k];
        }
      }
      if (cc[kUnroll - 1] < 0) break;  // padding fills only a chunk's tail
    }
  }

  const int64_t row0 = rb * kTile;
  const int rows = (int)(n_out - row0 < kTile ? n_out - row0 : kTile);
  for (int r = 0; r < rows; ++r) out[(row0 + r) * d + col] = a[r * kCols];
}

template <typename T, bool kW>
int launch(const int32_t* tile_cols, const int64_t* block_ptr, const int32_t* coords,
           const float* w, const void* x, float* out, int64_t n_out, int64_t d,
           cudaStream_t s) {
  const int64_t row_blocks = (n_out + kTile - 1) / kTile;
  const int64_t d_tiles = (d + kCols - 1) / kCols;
  if (row_blocks > INT_MAX || d_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_blocks, (unsigned)d_tiles);
  spmm_tiles_kernel<T, kW><<<grid, kCols, 0, s>>>(
      tile_cols, block_ptr, coords, w, static_cast<const T*>(x), out, n_out, d);
  return (int)cudaGetLastError();
}

}  // namespace

// tile_cols (T,) int32; block_ptr (>= ceil(n_out / 128) + 1,) int64, the
// chunks of row block b are [block_ptr[b], block_ptr[b + 1]); coords
// (T * 128,) int32, er * 128 + ec, each chunk's valid slots first and -1
// after them; w (T * 128,) fp32 per-slot weights or null (coords and w
// 16-byte aligned); x (N, d) row-major, fp32 (x_type 0) or bf16 (x_type 1),
// with every tile_cols[t] * 128 + ec < N; out (n_out, d) fp32, every
// element written.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int llp_spmm_tiles(const int32_t* tile_cols, const int64_t* block_ptr,
                              const int32_t* coords, const float* w, const void* x,
                              float* out, int64_t n_out, int64_t d, int x_type,
                              void* stream) {
  if (n_out <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(coords) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == 0)
    return w ? launch<float, true>(tile_cols, block_ptr, coords, w, x, out, n_out, d, s)
             : launch<float, false>(tile_cols, block_ptr, coords, w, x, out, n_out, d, s);
  if (x_type == 1)
    return w ? launch<bf16, true>(tile_cols, block_ptr, coords, w, x, out, n_out, d, s)
             : launch<bf16, false>(tile_cols, block_ptr, coords, w, x, out, n_out, d, s);
  return (int)cudaErrorInvalidValue;
}
