// Segment sum over a CSR edge list, fp32 accumulation, templated on the
// input and output types and on an optional per-edge weight.
//
//   out[r, :] = scale[r] * sum_{e in [in_ptr[r], in_ptr[r+1])} m_e
//   m_e = x[senders[e], :]             (unweighted)
//   m_e = w[e] * x[senders[e], :]      (weighted: w lists one weight per
//                                       edge, in the order of the CSR walked)
//
// Replaces the TPU kernels of llp_tpu/ops/pallas/segsum_kernel.py (the
// windowed one-hot MXU segment sum behind spmm(impl="segsum")):
// * _kernel, in both directions and both modes.  The forward runs over the
//   receiver CSR (senders, in_ptr); the backward of spmm launches this same
//   kernel over the sender CSR (col, row_ptr), as the JAX package launches
//   _kernel over its sender-sorted layout.  Unweighted instances
//   float->float and bf16->float (the TPU kernel's bf16-message mode: bf16
//   in, fp32 out).  Weighted instances float->float, bf16->float (the fp32
//   partials of the data-parallel aggregation, parallel/sharded.py) and
//   bf16->bf16: the weighted mode of _kernel (_segment_sum_arrays'
//   slot_weights, the weighted SpMM of get_blocked_spmm_weighted_fn), whose
//   backward runs the float->float instance over the sender CSR with the
//   weights re-read through the sender CSR's edge ids.
// * _kernel_cast: instance bf16->bf16.  The sum stays fp32 in registers, the
//   row scale is applied in fp32, and the result is rounded to bf16 once at
//   the store: (sum * scale).astype(bf16), as the JAX cached path computes.
// scale is 1/max(deg, 1) for the mean, or null for the plain sum.
//
// Rounding points of the weighted mode, as the JAX package's: fp32 forms
// each product w * x in fp32 (no FMA contraction: __fmul_rn), then adds.
// bf16 rounds the weight to bf16 (wl.astype(m.dtype)), rounds each product
// to bf16 (a bf16 multiply), sums the products in fp32, scales in fp32 and
// rounds once at the store, which equals the JAX fp32 output cast once.
//
// What bounds it on an H100.  The least traffic is x once, the index arrays
// (and the weights) once and out once: at D = 256 one or two operations per
// 4 (fp32) or 2 (bf16) bytes, far below the ~20 FLOP/byte at which fp32
// compute would matter.  But each edge gathers a D-wide row of x from a
// random sender, so x is read E/N times (10.6 on the collab stand-in), and
// when x outgrows the 50 MB L2 every gather comes from HBM.  The first
// design (one warp per row x 128-feature tile, warps numbered row-major, so
// the grid touched all of x at once) did exactly that: 241 MB of x at
// 235,868 x 256 fp32, 2.57 GB of gathers, 0.752 ms, HBM's rate and 5x its
// byte bound (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).  The lever is
// reuse, not bandwidth.
//
// Design: feature slices, slowest-varying; a group of lanes per row.
// * The features are cut into slices of kL = 8 16-byte vectors: 128 bytes
//   of each row, 32 fp32 or 64 bf16 features.  The block index is
//   slice-major: blocks are dispatched in index order, so the blocks in
//   flight all read one slice, whose x columns (N x 128 bytes: 30 MB on the
//   collab stand-in) stay in L2 while the slice's gathers hit them.  HBM
//   sees x about once, out once, and the index arrays once a slice; the
//   gathers (E x D values in all) are served from L2, whose rate now bounds
//   the fp32 instances.  The width is fixed: 64- and 32-byte slices read
//   1.3x and 2.7x slower on the collab stand-in.  Stores, index and weight
//   loads stream (evict first), so they do not push the slice out of L2.
// * Past L2 the slice does not stay: on the ogbl-citation2 stand-in
//   (2,927,963 rows) one slice is 375 MB, 7.5x the H100's 50 MB, and
//   slice-major gathers came from HBM (~21 ms a D = 256 pass, 10 % of the
//   byte bound).  No narrower slice fits at that height (even one 16-byte
//   vector a row is 47 MB, and it reads half of each 32-byte sector for
//   nothing).  There the wrapper passes a locality order of the rows
//   (ops/segsum.py::locality_order: rows that share senders next to each
//   other) and the blocks run row-block-major: the slices of one block of
//   rows are dispatched together, row slot i of row block p owning row
//   rows[p * rows_per_block + i].  The blocks in flight then cover a few
//   clusters of rows, whose senders' rows HBM sends once and L2 serves to
//   the other edges and slices (slice-major over the same order read 11 %
//   slower; index loads cached in place of streamed, 24 % slower).  Only
//   the rows a block sums change: each row's sum is the same, bit for bit.
// * A group of kL lanes owns one row of a slice, one 16-byte vector a lane,
//   and a warp 32 / kL = 4 rows (a whole warp per (row, slice) made 1.9 M
//   warps of a few loads each on the collab stand-in, bound by load latency
//   and slower than the first design).  A group walks its row's edges kL at
//   a time: one coalesced load of kL senders (and weights), handed out by shuffles, then
//   all kL gathers in flight before any is added (past the row's end a
//   gather loads nothing and adds zero, so no branch splits the loads from
//   the adds); the next kL senders load meanwhile.  The warp walks as many
//   chunks as its longest row needs.
// * The sum runs in edge order, in fp32 registers, one writer per output
//   element and no atomics: deterministic, and in the plain version's order.
// * Heavy rows (more than ops/segsum.py::HEAVY_EDGES edges) run first: the
//   blocks that hold one are dispatched before all others, every slice of
//   them at once (ops/segsum.py::heavy_first derives the order once per
//   CSR; the locality order lists heavy rows first).  A hub row walked by
//   one group takes as long as its edges, so on a power-law graph
//   (ba_graph(235_868, 5), rows up to 1,610 edges; the citation2 stand-in's
//   hubs) the slice-major order would leave it running alone at the end of
//   the kernel; first, it overlaps all the rest.  The collab graphs have no
//   such row.
// * Senders are int32 (the wrapper caches the copy once per index tensor):
//   a slice pass reads 4 bytes an edge, not 8.
// * Launch bounds ask for 4 blocks of 8 warps an SM (64 registers a
//   thread): without them ptxas interleaved the weighted instances' loads
//   with their adds, one gather in flight instead of kL.
// * The scalar path (D not a multiple of the vector width, or x or out not
//   16-byte aligned; cora's width 1433) keeps 32-feature slices, slice-major
//   too: lane l owns feature l of the slice and walks the row's edges in
//   order, four gathers in flight.
// * Row offsets are 64-bit: N*D passes 2^31 at 10M nodes x 256 features.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kL = 8;              // 16-byte vectors of a row in one feature slice
constexpr int kMinBlocks = 4;      // blocks an SM: at most 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The value a message is rounded to: a float stays a float; a bf16
// message is a bf16 value (held in a float).
template <typename TIn> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Edge e's weight in the message type (1 unweighted, never read then).
template <typename TIn, bool kW>
__device__ __forceinline__ float weight_of(const float* w, int64_t e) {
  if constexpr (kW) return round_to<TIn>(__ldcs(w + e));
  return 1.0f;
}

// Add one message value: v itself, or the product w * v rounded where the
// JAX package rounds it (__fmul_rn keeps the product out of an FMA).
template <typename TIn, bool kW>
__device__ __forceinline__ void add_msg(float& acc, float v, float wv) {
  if constexpr (kW) acc += round_to<TIn>(__fmul_rn(wv, v));
  else acc += v;
}

// 16-byte vector loads: kN values of T per lane.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  typedef float4 Raw;
  __device__ static __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ void unpack(const Raw v, float (&t)[kN]) {
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int kN = 8;
  typedef uint4 Raw;
  __device__ static __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static __forceinline__ void unpack(const Raw v, float (&t)[kN]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k sits in the low half of word k
      t[2 * k] = bf16_bits_to_float(w[k] & 0xffffu);
      t[2 * k + 1] = bf16_bits_to_float(w[k] >> 16);
    }
  }
};

// Two bf16 products, each rounded once (round to nearest even): the bits of
// a bf16 multiply, and of the fp32 product (exact for two bf16 values)
// rounded to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <typename TIn, bool kW>
__device__ __forceinline__ void add_vec(float (&a)[Vec<TIn>::kN],
                                        const typename Vec<TIn>::Raw v, float wv) {
  if constexpr (kW && std::is_same_v<TIn, bf16>) {
    // wv is a bf16 value: multiply two features a bf16x2 instruction
    const uint32_t w1 = float_to_bf16_bits(wv);
    const uint32_t w2 = w1 | (w1 << 16);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t p = mul_bf16x2(words[k], w2);
      a[2 * k] += bf16_bits_to_float(p & 0xffffu);
      a[2 * k + 1] += bf16_bits_to_float(p >> 16);
    }
  } else {
    float t[Vec<TIn>::kN];
    Vec<TIn>::unpack(v, t);
#pragma unroll
    for (int k = 0; k < Vec<TIn>::kN; ++k) add_msg<TIn, kW>(a[k], t[k], wv);
  }
}

// Stores, index and weight loads stream (.cs: evict first), so that they do
// not push the feature slice being gathered out of L2.
__device__ __forceinline__ void store_vec(float* p, const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(a[4], a[5], a[6], a[7]));
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&a)[8]) {
  uint4 v;
  v.x = float_to_bf16_bits(a[0]) | (float_to_bf16_bits(a[1]) << 16);
  v.y = float_to_bf16_bits(a[2]) | (float_to_bf16_bits(a[3]) << 16);
  v.z = float_to_bf16_bits(a[4]) | (float_to_bf16_bits(a[5]) << 16);
  v.w = float_to_bf16_bits(a[6]) | (float_to_bf16_bits(a[7]) << 16);
  __stcs(reinterpret_cast<uint4*>(p), v);
}

__device__ __forceinline__ float load_scalar(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_scalar(const bf16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int64_t load_index(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

// The row's edges [c, e1), n at a time: lane l's sender (0 past the end)
// and weight, for edge c + l % n.
template <typename TIn, bool kW>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ senders,
                                           const float* __restrict__ w, int64_t c, int64_t e1,
                                           int l, int32_t& s, float& wv) {
  const bool in = c + l < e1;
  s = in ? __ldcs(senders + c + l) : 0;
  wv = in ? weight_of<TIn, kW>(w, c + l) : 0.f;
}

// The order blocks run in: block b is (feature slice, block of rows).
// With a row order (rows), row-block-major: block b is row block
// b / n_slices, slice b % n_slices, and row slot i holds row rows[i].
// Else blocks holding a heavy row (order[0 .. n_heavy), every slice of
// each) come first; then the others, slice-major (order[n_heavy ...]).
// Without either (order and rows null) block b is slice b / row_blocks,
// row block b % row_blocks.
struct Schedule {
  const int32_t* order;  // row blocks, heavy ones first; or null
  const int32_t* rows;   // the row of each row slot (locality order); or null
  int64_t n_heavy, row_blocks, n_slices;
};

__device__ __forceinline__ void block_cell(const Schedule& sc, int64_t& slice, int64_t& rb) {
  const int64_t b = blockIdx.x;
  if (sc.rows != nullptr) {
    rb = b / sc.n_slices;
    slice = b - rb * sc.n_slices;
    return;
  }
  if (sc.order == nullptr) {
    slice = b / sc.row_blocks;
    rb = b - slice * sc.row_blocks;
    return;
  }
  const int64_t first = sc.n_heavy * sc.n_slices;
  if (b < first) {
    rb = __ldg(sc.order + b / sc.n_slices);
    slice = b % sc.n_slices;
  } else {
    const int64_t n_light = sc.row_blocks - sc.n_heavy;
    slice = (b - first) / n_light;
    rb = __ldg(sc.order + sc.n_heavy + (b - first) % n_light);
  }
}

// The row that row slot `slot` (< n_rows) holds.
__device__ __forceinline__ int64_t slot_row(const Schedule& sc, int64_t slot) {
  return sc.rows != nullptr ? __ldg(sc.rows + slot) : slot;
}

// Block b holds a block of kWarps * (32 / kL) rows of one feature slice
// (block_cell).  A group of kL lanes owns one row of the slice (kL * kN
// features, one 16-byte vector a lane), so a warp sums 32 / kL rows at once.
// Each group walks its row's edges kL at a time: one coalesced load of kL
// senders (and weights), shuffled to the group's lanes, then kL gathers in
// flight, added in edge order; the next kL senders load meanwhile.
template <typename TIn, typename TOut, bool kW>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
segsum_vec_kernel(const TIn* __restrict__ x, const int32_t* __restrict__ senders,
                  const int64_t* __restrict__ in_ptr, const float* __restrict__ scale,
                  const float* __restrict__ w, TOut* __restrict__ out, int64_t n_rows,
                  int64_t d, Schedule sc) {
  typedef Vec<TIn> V;
  constexpr int kN = V::kN;
  constexpr int kG = 32 / kL;  // rows per warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / kL, sub = lane % kL;
  int64_t slice, rb;
  block_cell(sc, slice, rb);
  const int64_t slot = (rb * kWarps + (threadIdx.x >> 5)) * kG + grp;
  const int64_t f = slice * (kL * kN) + sub * kN;
  const bool on = f < d;  // d % kN == 0: f < d means all kN features exist
  const bool live = slot < n_rows;
  const int64_t row = live ? slot_row(sc, slot) : 0;
  const int64_t e0 = live ? load_index(in_ptr + row) : 0;
  const int64_t e1 = live ? load_index(in_ptr + row + 1) : 0;
  // the warp walks as many chunks as its longest row needs (warp-uniform)
  const int chunks = __reduce_max_sync(kFull, (int)((e1 - e0 + kL - 1) / kL));

  float acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.f;
  int32_t s_l;
  float w_l;
  load_chunk<TIn, kW>(senders, w, e0, e1, sub, s_l, w_l);
  for (int ch = 0; ch < chunks; ++ch) {
    const int64_t c = e0 + (int64_t)ch * kL;
    int32_t s_n;
    float w_n;
    load_chunk<TIn, kW>(senders, w, c + kL, e1, sub, s_n, w_n);  // the next chunk's
    typename V::Raw v[kL];
    float wv[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {  // every gather of the chunk in flight
      const int32_t s = __shfl_sync(kFull, s_l, grp * kL + j);
      wv[j] = __shfl_sync(kFull, w_l, grp * kL + j);  // 0 past the row's end
      v[j] = V::zero();
      if (c + j < e1 && on) v[j] = V::load(x + (int64_t)s * d + f);
    }
    // past the row's end v is zero (and so is the weight): adding it changes
    // nothing, and no branch splits the loads from the adds
#pragma unroll
    for (int j = 0; j < kL; ++j) add_vec<TIn, kW>(acc, v[j], wv[j]);
    s_l = s_n;
    w_l = w_n;
  }
  if (live && on) {
    const float sc = scale ? scale[row] : 1.0f;
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] *= sc;
    store_vec(out + row * d + f, acc);
  }
}

// The scalar path: 32-feature slices, lane l owns feature l of the slice,
// the row's edges in order.
template <typename TIn, typename TOut, bool kW>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
segsum_scalar_kernel(const TIn* __restrict__ x, const int32_t* __restrict__ senders,
                     const int64_t* __restrict__ in_ptr, const float* __restrict__ scale,
                     const float* __restrict__ w, TOut* __restrict__ out, int64_t n_rows,
                     int64_t d, Schedule sc) {
  const int lane = threadIdx.x & 31;
  int64_t slice, rb;
  block_cell(sc, slice, rb);
  const int64_t slot = rb * kWarps + (threadIdx.x >> 5);
  if (slot >= n_rows) return;  // warp-uniform
  const int64_t row = slot_row(sc, slot);
  const int64_t f = slice * 32 + lane;
  const bool on = f < d;
  const int64_t e0 = load_index(in_ptr + row);
  const int64_t e1 = load_index(in_ptr + row + 1);

  float acc = 0.f;
  int32_t s_l;
  float w_l;
  load_chunk<TIn, kW>(senders, w, e0, e1, lane, s_l, w_l);
  for (int64_t c = e0; c < e1; c += 32) {
    const int64_t left = e1 - c;
    const int cnt = left < 32 ? (int)left : 32;
    int32_t s_n;
    float w_n;
    load_chunk<TIn, kW>(senders, w, c + 32, e1, lane, s_n, w_n);
    for (int i = 0; i < cnt; i += 4) {  // cnt is warp-uniform
      float v[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int32_t s = __shfl_sync(kFull, s_l, (i + u) & 31);
        wv[u] = __shfl_sync(kFull, w_l, (i + u) & 31);
        v[u] = i + u < cnt && on ? load_scalar(x + (int64_t)s * d + f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u < cnt) add_msg<TIn, kW>(acc, v[u], wv[u]);
      }
    }
    s_l = s_n;
    w_l = w_n;
  }
  if (on) store_scalar(out + row * d + f, acc * (scale ? scale[row] : 1.0f));
}

// vec: the vector path, as the caller picked it (refused where the shape
// does not allow it, and where it does but the scalar path was asked for).
// The heavy-first order, when given, lists row blocks of order_rows rows;
// the row order (rows) is a permutation of the n_rows rows, and excludes it.
template <typename TIn, typename TOut, bool kW>
int launch(const void* x, const int32_t* senders, const int64_t* in_ptr, const float* scale,
           const float* w, void* out, int64_t n_rows, int64_t d, int vec,
           const int32_t* order, int64_t n_heavy, int64_t order_rows, const int32_t* rows,
           cudaStream_t s) {
  const bool vec_ok = d % Vec<TIn>::kN == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec != (int)vec_ok) return (int)cudaErrorInvalidValue;
  const int64_t width = vec ? (int64_t)kL * Vec<TIn>::kN : 32;  // features a slice
  const int64_t rows_per_block = vec ? kWarps * (32 / kL) : kWarps;
  if (order && (rows || order_rows != rows_per_block || n_heavy < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Schedule sc;
  sc.order = order;
  sc.rows = rows;
  sc.row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  sc.n_heavy = order ? n_heavy : 0;
  sc.n_slices = (d + width - 1) / width;
  if (sc.n_heavy > sc.row_blocks) return (int)cudaErrorInvalidValue;
  const int64_t blocks = sc.n_slices * sc.row_blocks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* ot = static_cast<TOut*>(out);
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  if (vec) {
    segsum_vec_kernel<TIn, TOut, kW><<<grid, block, 0, s>>>(
        xt, senders, in_ptr, scale, w, ot, n_rows, d, sc);
  } else {
    segsum_scalar_kernel<TIn, TOut, kW><<<grid, block, 0, s>>>(
        xt, senders, in_ptr, scale, w, ot, n_rows, d, sc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_src, d) row-major, fp32 (in_type 0) or bf16 (in_type 1); senders (E,)
// int32 grouped by output row; in_ptr (n_rows + 1,) int64; scale (n_rows,)
// fp32 or null; w (E,) fp32 per-edge weights in the order of senders, or
// null; out (n_rows, d), fp32 (out_type 0) or bf16 (out_type 1); vec 1 for
// the vector path, 0 for the scalar one; order (row blocks of order_rows
// rows, the n_heavy that hold a heavy row first) or null; rows (n_rows,)
// int32, a permutation of the rows that row slots walk, or null (not both
// order and rows).  Instances:
// unweighted fp32->fp32, bf16->fp32, bf16->bf16; weighted fp32->fp32,
// bf16->fp32, bf16->bf16; any other combination is refused.  The caller picks the path
// (ops/segsum.py::_route) and this entry refuses a pick that disagrees with
// the shape: the vector path where d is a multiple of the vector width and
// x and out are 16-byte aligned, else the scalar one.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int llp_segsum(const void* x, const int32_t* senders, const int64_t* in_ptr,
                          const float* scale, const float* w, void* out, int64_t n_rows,
                          int64_t d, int in_type, int out_type, int vec,
                          const int32_t* order, int64_t n_heavy, int64_t order_rows,
                          const int32_t* rows, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LLP_SEGSUM_ARGS x, senders, in_ptr, scale, w, out, n_rows, d, vec, order, n_heavy, \
                        order_rows, rows, s
  if (w) {
    if (in_type == 0 && out_type == 0) return launch<float, float, true>(LLP_SEGSUM_ARGS);
    if (in_type == 1 && out_type == 0) return launch<bf16, float, true>(LLP_SEGSUM_ARGS);
    if (in_type == 1 && out_type == 1) return launch<bf16, bf16, true>(LLP_SEGSUM_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (in_type == 0 && out_type == 0) return launch<float, float, false>(LLP_SEGSUM_ARGS);
  if (in_type == 1 && out_type == 0) return launch<bf16, float, false>(LLP_SEGSUM_ARGS);
  if (in_type == 1 && out_type == 1) return launch<bf16, bf16, false>(LLP_SEGSUM_ARGS);
#undef LLP_SEGSUM_ARGS
  return (int)cudaErrorInvalidValue;
}

// The marker of the program's clock tie (llp_tpu_torch/utils/profiling.py):
// one thread writes one int.  It lives in B1's library because every
// training step on the card has loaded that library (the SpMM, the
// gathers' backward) before a profiler opens, so a tie costs no library
// load.  Launched through this plain C interface right after a
// synchronise, it starts within the launch latency of the host's
// timestamp, with no PyTorch dispatch in between; no other code launches
// a kernel of this name, so a profiler's trace finds it by name.
__global__ void llp_trace_marker_kernel(int32_t* flag) { *flag = 1; }

extern "C" int llp_trace_marker(int32_t* flag, void* stream) {
  llp_trace_marker_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(flag);
  return (int)cudaGetLastError();
}
