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
// the W1 product against 8*D bytes of gathered rows: at D = H = 256 and
// 2^20 pairs, 137 GFLOP against 2.15 GB.  On the fp32 FMA units (67 TFLOP/s)
// that is 2.07 ms; the first design (a block of 256 threads per 32 pairs,
// each thread streaming a column of W1 from L2) took 6.203 ms, a third of
// that bound, reading W1 four times over the rows' own bytes from L2
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// Design: the W1 product on the tensor cores in TF32, split three ways so
// that it keeps fp32's accuracy (3xTF32).  Each fp32 value a is split as
// a_hi = tf32(a) (round to nearest, cvt.rna) and a_lo = tf32(a - a_hi), and
// z W1 ~ z_lo W_hi + z_hi W_lo + z_hi W_hi (the lo.lo term, 2^-22 of the
// product, is dropped): 3 x 137 GFLOP at the 495 TFLOP/s of TF32 is 0.83 ms,
// the new bound at that shape, above the rows' 0.64 ms from HBM.
// ops/sddmm.py::tf32_split is the same split in plain PyTorch.
// * W1 is split once a call, in the kernel's layout (split_w1_kernel,
//   launched by the scorer's entry point before the scores, and alone by
//   ops/sddmm.py::split_w1; split_w1_plain is that layout in plain
//   PyTorch, and chip_smoke.py holds the two equal): hi and lo of
//   W1^T, zero-padded to (Hp, Dp) (Hp a multiple of 256, Dp of 32), cut
//   into the pipeline's steps of 256 units x 32 features, each step's
//   values in the order of wgmma's core matrices (8 units x 4 features, 128
//   contiguous bytes; 8 of them along the features, then the next 8 units).
//   A step of W1 is two contiguous 32 KB blocks, read by the tensor cores
//   from shared memory as they are.
// * A block of two warpgroups owns 128 pairs, 64 each, and walks the
//   features in steps of 32 through two stages of shared memory (one block
//   an SM: 207 KB): at the start of a step the block sends the next step's
//   copies (the 128 pairs' 32-feature slices of ha[src] and hb[dst],
//   16-byte cp.async or 4-byte where D is not a multiple of 4, and the
//   step's W1 blocks, bulk copies counted on an mbarrier), which land while
//   the tensor cores work on this one.  Steps of 16 features in a ring of 3
//   or 4 stages, and sending the copies after the products, measured
//   slower: each step pays a barrier, the A fragments and the wgmma wait,
//   so fewer, longer steps win.
// * L2 traffic: W1's hi and lo are 512 KB a block at D = H = 256, 4 KB a
//   pair against the rows' 2 KB, and a block cannot take more pairs (its
//   128 x 256 fp32 sums take half the SM's registers).  So the blocks of a
//   cluster share each step's W1: each bulk-copies 1 / kCluster of it into
//   the shared memory of all of them (multicast), and a cluster barrier at
//   each step keeps a stage from being refilled while a block still reads
//   it.  kCluster = 2 halves W1's L2 reads to the rows' 2 KB a pair; 4 would
//   take them to 1 KB, but every step then waits for the slowest of four
//   blocks, and it measured slower than 2 and than 1, which are even
//   (llp_tpu_torch/tools/probes.py w1, which also times the kernel with
//   W1's copies left out).
// * Each thread forms its own A fragments: z = ha * hb in fp32 (__fmul_rn:
//   the plain version's rounding) at the 4 x 4 (pair, feature) places that
//   wgmma's register layout gives it, split into hi and lo.  Every z value
//   is formed and split once.  Per 8-feature k step a warpgroup issues
//   three wgmma.m64n256k8 TF32 (z_lo W_hi, z_hi W_lo, z_hi W_hi: small terms
//   first) on its 64 pairs x 256 units, A from registers and B through a
//   shared-memory descriptor; the 64 x 256 fp32 sums stay in registers
//   (128 a thread), the warpgroups' products are asynchronous to their
//   other work.
// * The epilogue never leaves registers: bias, relu, times w2, summed per
//   pair in fp32 over the thread's units, then across the quad's lanes in a
//   fixed order; b2 and the sigmoid last.  H > 256 runs further passes over
//   the features, adding to the same per-pair sums.  The sums run in the
//   same order every run.
// * Ragged B: pairs past the end gather zeros (cp.async with no source
//   bytes) and are not stored; so do the blocks past the batch that fill
//   the last cluster.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // pairs per block, 64 per warpgroup
constexpr int kBN = 256;       // hidden units per pass: wgmma's widest N
constexpr int kBK = 32;        // features per pipeline step
constexpr int kStages = 2;     // steps in the ring: one in flight
constexpr int kAS = kBK + 4;   // row stride of a staged row slice, floats
constexpr int kWFloats = kBN * kBK;  // a step of W1's hi (or lo), core-matrix order
constexpr int kStageFloats = 2 * kWFloats + 2 * kBM * kAS;
constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats +
                         sizeof(const float*) * 2 * kBM + sizeof(uint64_t) * kStages;
#ifndef LLP_SDDMM_CLUSTER
#define LLP_SDDMM_CLUSTER 2
#endif
// Blocks of a cluster, which share each step's copy of W1: each block
// copies 1 / kCluster of it into the shared memory of all of them.
constexpr int kCluster = LLP_SDDMM_CLUSTER;
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4, "cluster of 1, 2 or 4");
constexpr int kPieces = kCluster < 2 ? 2 : kCluster;  // a step's W1 copies
constexpr int kPieceFloats = 2 * kWFloats / kPieces;

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// mbarriers: a step's W1 copies land on its stage's barrier, which counts
// the bytes (one arrival: the block's own expect_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait for the barrier's phase `parity` to complete; a wait of some seconds
// traps (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
// Every thread of every block of the cluster; release and acquire order the
// blocks' shared-memory reads and writes around it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// A bulk copy of `bytes` (a multiple of 16) into this offset of the shared
// memory of every block of the cluster, counted on the barrier at `bar`'s
// offset in each.
__device__ __forceinline__ void bulk_copy_all(void* dst, const void* src, unsigned bytes,
                                              uint64_t* bar) {
  if constexpr (kCluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  } else {
    const unsigned short mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
        "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  }
}

// Wait until at most kStages - 2 groups of copies are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// a = hi + lo, each a TF32 value in a float's bits (cvt.rna: round to
// nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float rest = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// The shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (the leading
// byte offset) and kBK / 4 x 128 bytes apart along N (the stride byte
// offset).
__device__ __forceinline__ uint64_t w_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kBK * 32 >> 4) << 32);
}

// acc[64 x 256 of the warpgroup] += A (64 x 8, TF32, from registers) x
// B (8 x 256, TF32, at desc).  Thread (warp w, lane 4g + t) holds A at rows
// 16w + g (+8), features t (+4); and acc[4j ... 4j+3] at rows 16w + g, g + 8,
// units 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void wgmma_tf32(float (&acc)[128], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]),
        "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]), "+f"(acc[16]),
        "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]), "+f"(acc[20]), "+f"(acc[21]),
        "+f"(acc[22]), "+f"(acc[23]), "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]),
        "+f"(acc[27]), "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]), "+f"(acc[36]),
        "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]), "+f"(acc[40]), "+f"(acc[41]),
        "+f"(acc[42]), "+f"(acc[43]), "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]),
        "+f"(acc[47]), "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]), "+f"(acc[56]),
        "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]), "+f"(acc[60]), "+f"(acc[61]),
        "+f"(acc[62]), "+f"(acc[63]), "+f"(acc[64]), "+f"(acc[65]), "+f"(acc[66]),
        "+f"(acc[67]), "+f"(acc[68]), "+f"(acc[69]), "+f"(acc[70]), "+f"(acc[71]),
        "+f"(acc[72]), "+f"(acc[73]), "+f"(acc[74]), "+f"(acc[75]), "+f"(acc[76]),
        "+f"(acc[77]), "+f"(acc[78]), "+f"(acc[79]), "+f"(acc[80]), "+f"(acc[81]),
        "+f"(acc[82]), "+f"(acc[83]), "+f"(acc[84]), "+f"(acc[85]), "+f"(acc[86]),
        "+f"(acc[87]), "+f"(acc[88]), "+f"(acc[89]), "+f"(acc[90]), "+f"(acc[91]),
        "+f"(acc[92]), "+f"(acc[93]), "+f"(acc[94]), "+f"(acc[95]), "+f"(acc[96]),
        "+f"(acc[97]), "+f"(acc[98]), "+f"(acc[99]), "+f"(acc[100]), "+f"(acc[101]),
        "+f"(acc[102]), "+f"(acc[103]), "+f"(acc[104]), "+f"(acc[105]), "+f"(acc[106]),
        "+f"(acc[107]), "+f"(acc[108]), "+f"(acc[109]), "+f"(acc[110]), "+f"(acc[111]),
        "+f"(acc[112]), "+f"(acc[113]), "+f"(acc[114]), "+f"(acc[115]), "+f"(acc[116]),
        "+f"(acc[117]), "+f"(acc[118]), "+f"(acc[119]), "+f"(acc[120]), "+f"(acc[121]),
        "+f"(acc[122]), "+f"(acc[123]), "+f"(acc[124]), "+f"(acc[125]), "+f"(acc[126]),
        "+f"(acc[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// W1 (d, h) -> wsplit: its hi parts, then its lo parts, each as `steps`
// blocks of kWFloats (pass s / kc, features (s % kc) * kBK ...), each block
// in core-matrix order [unit / 8][feature / 4][unit % 8][feature % 4];
// zeros past d and h.
__global__ void split_w1_kernel(const float* __restrict__ w1, float* __restrict__ wsplit,
                                int d, int h, int kc, int steps) {
  const int64_t per = (int64_t)steps * kWFloats;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * per;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int part = (int)(i / per);
    const int64_t j = i - part * per;
    const int s = (int)(j / kWFloats);
    const int o = (int)(j % kWFloats);
    const int n = (s / kc) * kBN + (o / (8 * kBK)) * 8 + (o / 4) % 8;
    const int k = (s % kc) * kBK + ((o / 32) % (kBK / 4)) * 4 + o % 4;
    uint32_t hi = 0, lo = 0;
    if (k < d && n < h) split_tf32(w1[(int64_t)k * h + n], hi, lo);
    wsplit[i] = __uint_as_float(part ? lo : hi);
  }
}

// Step s's W1 (features k0 ... k0 + kBK of a pass): its hi and lo blocks
// ([2][kWFloats]) into stage `st` of every block of the cluster, this
// block's 1 / kCluster of them, counted on `bar`.  One thread a block.
__device__ __forceinline__ void send_w1(float* st, uint64_t* bar,
                                        const float* __restrict__ wsplit, int64_t per, int s) {
#ifdef LLP_SDDMM_PROBE_W1_ONCE
  // A timing probe, never a result: each stage's W1 blocks are copied by
  // the first steps only and reused stale after, so W1's L2 reads drop out.
  if (s >= kStages) {
    mbar_arrive(bar);
    return;
  }
#endif
  mbar_expect_tx(bar, 2 * kWFloats * sizeof(float));
  for (int p = (int)cluster_rank(); p < kPieces; p += kCluster) {
    const int part = p / (kPieces / 2);
    const int o = (p % (kPieces / 2)) * kPieceFloats;
    bulk_copy_all(st + part * kWFloats + o, wsplit + part * per + (int64_t)s * kWFloats + o,
                  kPieceFloats * sizeof(float), bar);
  }
}

// Stage step s's rows (features k0 ... k0 + kBK): the block's ha rows and
// hb rows ([kBM][kAS] each, after W1's blocks; zeros past d and past the
// batch).  kVec: 16-byte row copies (d % 4 == 0, aligned tables).
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* st, const float* const* ra,
                                           const float* const* rb, const float* dummy, int d,
                                           int k0) {
  const int tid = threadIdx.x;
  float* a = st + 2 * kWFloats;
  float* b = a + kBM * kAS;
  if constexpr (kVec) {
    for (int i = tid; i < 2 * kBM * (kBK / 4); i += kThreads) {
      const int tbl = i / (kBM * (kBK / 4));
      const int r = (i / (kBK / 4)) % kBM;
      const int k = (i % (kBK / 4)) * 4;
      const float* row = tbl ? rb[r] : ra[r];
      const bool ok = row != nullptr && k0 + k < d;
      cp_async16((tbl ? b : a) + r * kAS + k, ok ? row + k0 + k : dummy, ok);
    }
  } else {
    for (int i = tid; i < 2 * kBM * kBK; i += kThreads) {
      const int tbl = i / (kBM * kBK);
      const int r = (i / kBK) % kBM;
      const int k = i % kBK;
      const float* row = tbl ? rb[r] : ra[r];
      const bool ok = row != nullptr && k0 + k < d;
      cp_async4((tbl ? b : a) + r * kAS + k, ok ? row + k0 + k : dummy, ok);
    }
  }
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
sddmm_tc_kernel(const float* __restrict__ ha, const float* __restrict__ hb,
                const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
                const float* __restrict__ wsplit, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ out, int64_t n_pairs, int d, int h, int kc, int steps) {
  extern __shared__ __align__(128) float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kStageFloats]
  const float** ra = reinterpret_cast<const float**>(ring + kStages * kStageFloats);  // [kBM]
  const float** rb = ra + kBM;                                                   // [kBM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rb + kBM);                        // [kStages]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's rows: r0, r0 + 8
  const int64_t p0 = (int64_t)blockIdx.x * kBM;
  const int np = n_pairs - p0 < kBM ? (int)(n_pairs - p0) : kBM;
  const int64_t per = (int64_t)steps * kWFloats;

  if (tid < kBM) {  // a block past the batch (the cluster's last) gathers zeros
    ra[tid] = tid < np ? ha + src[p0 + tid] * d : nullptr;
    rb[tid] = tid < np ? hb + dst[p0 + tid] * d : nullptr;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are set before any copy lands on them
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // a group per step, empty past the end
    if (i < steps) {
      float* st = ring + i * kStageFloats;
      if (tid == 0) send_w1(st, bars + i, wsplit, per, i);
      stage_rows<kVec>(st, ra, rb, wsplit, d, (i % kc) * kBK);
    }
    cp_async_commit();
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float part0 = 0.f, part1 = 0.f;  // the partial logits of rows r0, r0 + 8

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_ring();  // this thread's row copies of step s have landed
    // ... every thread's; and every block of the cluster is done with step
    // s - 1, so its stage is free in all of them
    cluster_sync();
    const int next = s + kStages - 1;
    if (next < steps) {
      float* st = ring + (next % kStages) * kStageFloats;
      if (tid == 0) send_w1(st, bars + next % kStages, wsplit, per, next);
      stage_rows<kVec>(st, ra, rb, wsplit, d, (next % kc) * kBK);
    }
    cp_async_commit();  // an empty group past the end keeps the count
    mbar_wait(bars + s % kStages, (s / kStages) & 1);  // step s's W1 has landed
    const float* wh = ring + (s % kStages) * kStageFloats;
    const float* wl = wh + kWFloats;
    const float* a = wl + kWFloats;
    const float* b = a + kBM * kAS;
    constexpr int kSub = kBK / 8;  // 8-feature k steps a pipeline step
    // [k step][a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)]
    uint32_t ah[kSub][4], al[kSub][4];
#pragma unroll
    for (int ks = 0; ks < kSub; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (r0 + (e & 1) * 8) * kAS + ks * 8 + t + (e >> 1) * 4;
        split_tf32(__fmul_rn(a[at], b[at]), ah[ks][e], al[ks][e]);
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kSub; ++ks) {  // k step ks: core matrices 2 ks, 2 ks + 1
      const uint64_t dh = w_desc(wh + ks * 64), dl = w_desc(wl + ks * 64);
      wgmma_tf32(acc, al[ks], dh);
      wgmma_tf32(acc, ah[ks], dl);
      wgmma_tf32(acc, ah[ks], dh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    if (s % kc == kc - 1) {  // the pass's last step: bias, relu, w2, per pair
      const int n0 = (s / kc) * kBN;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int u = n0 + j * 8 + 2 * t;
        // units past h: relu(0 + 0) * 0
        const float bb0 = u < h ? __ldg(b1 + u) : 0.f, bb1 = u + 1 < h ? __ldg(b1 + u + 1) : 0.f;
        const float v0 = u < h ? __ldg(w2 + u) : 0.f, v1 = u + 1 < h ? __ldg(w2 + u + 1) : 0.f;
        part0 = fmaf(fmaxf(acc[4 * j] + bb0, 0.f), v0, part0);
        part0 = fmaf(fmaxf(acc[4 * j + 1] + bb1, 0.f), v1, part0);
        part1 = fmaf(fmaxf(acc[4 * j + 2] + bb0, 0.f), v0, part1);
        part1 = fmaf(fmaxf(acc[4 * j + 3] + bb1, 0.f), v1, part1);
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    }
  }

  cluster_sync();  // no block leaves while a copy of the cluster may still land
  part0 += __shfl_xor_sync(0xffffffffu, part0, 1);
  part0 += __shfl_xor_sync(0xffffffffu, part0, 2);
  part1 += __shfl_xor_sync(0xffffffffu, part1, 1);
  part1 += __shfl_xor_sync(0xffffffffu, part1, 2);
  if (t == 0) {
    if (r0 < np) out[p0 + r0] = 1.f / (1.f + expf(-(part0 + __ldg(b2))));
    if (r0 + 8 < np) out[p0 + r0 + 8] = 1.f / (1.f + expf(-(part1 + __ldg(b2))));
  }
}

// W1's split into wsplit, on stream s (the entry points check the sizes).
int launch_split(const float* w1, float* wsplit, int64_t d, int64_t h, cudaStream_t s) {
  const int64_t kc = (d + kBK - 1) / kBK;
  const int64_t steps = kc * ((h + kBN - 1) / kBN);
  const int64_t n_el = 2 * steps * kWFloats;
  const int64_t blocks = (n_el + 255) / 256 < 4096 ? (n_el + 255) / 256 : 4096;
  split_w1_kernel<<<(unsigned)blocks, 256, 0, s>>>(w1, wsplit, (int)d, (int)h, (int)kc,
                                                    (int)steps);
  return (int)cudaGetLastError();
}

int check_sizes(int64_t d, int64_t h, const float* wsplit) {
  if (d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const int64_t steps = (d + kBK - 1) / kBK * ((h + kBN - 1) / kBN);
  if (d > 0x7fffffff || h > 0x7fffffff || steps > 0x7fffffff) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (reinterpret_cast<uintptr_t>(wsplit) % 16) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// W1's split alone: w1 (d, h) row-major fp32 -> wsplit, 2 * hp * dp floats
// (hp = h rounded up to 256, dp = d rounded up to 32), 16-byte aligned:
// W1's hi and lo parts in the scorer's layout (ops/sddmm.py::
// split_w1_plain).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int llp_sddmm_split_w1(const float* w1, float* wsplit, int64_t d, int64_t h,
                                  void* stream) {
  const int rc = check_sizes(d, h, wsplit);
  return rc ? rc : launch_split(w1, wsplit, d, h, static_cast<cudaStream_t>(stream));
}

// The scores: ha (*, d), hb (*, d) fp32 row-major tables; src, dst
// (n_pairs,) int64 rows into them; w1 (d, h) row-major, which this entry
// first splits into the scratch wsplit (as llp_sddmm_split_w1); b1, w2 (h,);
// b2 (1,); out (n_pairs,).  vec 1 for 16-byte row copies, 0 for 4-byte
// ones: the caller picks (ops/sddmm.py::gather_route) and this entry
// refuses a pick that disagrees with the shape, 16-byte copies where
// d % 4 == 0 and ha and hb are 16-byte aligned, else 4-byte ones.  Every
// shape runs the tensor cores.  Launches on `stream` (the split, then the
// scores), allocates nothing, returns cudaGetLastError().
extern "C" int llp_sddmm_mlp_f32(const float* ha, const float* hb, const int64_t* src,
                                 const int64_t* dst, const float* w1, float* wsplit,
                                 const float* b1, const float* w2, const float* b2, float* out,
                                 int64_t n_pairs, int64_t d, int64_t h, int vec, void* stream) {
  if (n_pairs <= 0) return (int)cudaErrorInvalidValue;
  int rc = check_sizes(d, h, wsplit);
  if (rc) return rc;
  const int64_t kc = (d + kBK - 1) / kBK;
  const int64_t steps = kc * ((h + kBN - 1) / kBN);
  // whole clusters: the last may hold blocks past the batch
  const int64_t blocks = (n_pairs + kBM * kCluster - 1) / (kBM * kCluster) * kCluster;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool vec_ok = d % 4 == 0 && reinterpret_cast<uintptr_t>(ha) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(hb) % 16 == 0;
  if (vec != (int)vec_ok) return (int)cudaErrorInvalidValue;
  const auto kernel = vec ? sddmm_tc_kernel<true> : sddmm_tc_kernel<false>;
  // the shared-memory limit is raised once per instance and card
  static bool raised[64][2] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !raised[dev][vec]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) raised[dev][vec] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = launch_split(w1, wsplit, d, h, s);
  if (rc) return rc;
  kernel<<<(unsigned)blocks, kThreads, kSmem, s>>>(ha, hb, src, dst, wsplit, b1, w2, b2, out,
                                                   n_pairs, (int)d, (int)h, (int)kc, (int)steps);
  return (int)cudaGetLastError();
}
