// K2, eval mode: one fused spline-conv block.  For each destination m
//
//   y   = g[m] @ W + x[m] @ root (+ bias)        g[m] = the K2 aggregation
//   y   = bn(y)                                  ((y - mean) * rsqrt(var + eps))
//                                                 * gamma + beta, if given
//   y  += bn_skip(skip[m] @ lin^T)               if a skip branch is given
//   out = mask[m] ? act(y) : 0                   relu | elu | silu | gelu-tanh
//
// Replaces the eval branch of dagr_tpu/models/blocks.py:133 ConvBlock and
// :156 ConvBlockWithSkip over dagr_tpu/ops/spline.py:242 spline_conv (the
// event level, K = 16 graph slots) and :145 stencil_spline_conv (the
// pooled levels, K = 9 cells), and the head's prediction convs (no batch
// norm, no activation).  The aggregation is K2's (spline_taps.cuh): each
// edge adds its 4 bilinear taps, slots in order, no atomics.
//
// What bounds it on an H100: at DAGR-S widths, bytes.  The gathered
// source rows, the edge tables, the weights and the output are a few MB
// per conv, while the product is 2 * M * (26 Cin + Cs) * Cout operations
// (0.9 GFLOP at the event level of a 50k window at Cin = 16, Cout = 16).
// The unfused route also wrote g [M, 25 Cin] to HBM and read it back
// (80 MB a conv at the event level) and ran ~15 PyTorch ops around it.
//
// Design.  A block owns TM destinations (TM = 64 while its g tile fits
// in 128 KB, Cin <= 19; else 16) and builds their rows of
// A = [g | x | 0] [TM, 26 Cin padded to 8] in shared memory, all of them
// at once, min(Cin, 256 / TM) threads per destination; g never goes to
// HBM.  The
// weights B = [W ; root] stream through shared memory in slabs of 128
// rows, double-buffered with cp.async (16-byte copies where Cout
// is a multiple of 4, else 4-byte ones, with zero fill, so any Cout and
// the row padding need no packed copy of the weights).
// The product runs on the tensor cores, mma.sync m16n8k8 TF32, with the
// 3xTF32 split that keeps float32 accuracy: a = hi + lo with
// hi = cvt.rna.tf32(a) and lo = a - hi (its TF32 part, which is what the
// tensor core reads of it), and the accumulator takes lo*hi + hi*lo +
// hi*hi in f32 (one TF32 pass keeps ~3 digits and breaks the 1e-5 twin
// bar).  8 warps.  At 64 rows warp w takes m-tile w % 4 and every other
// n-tile of 8 columns.  At 16 rows (Cin >= 20, the stencil levels'
// 1600-1700-deep products) warp w takes every n-tile but only the w-th
// k-step of each 8, so the conversions of A are not repeated by 8
// warps and each warp has up to 8 independent accumulators; the 8
// partial sums are added in warp order through shared memory.  The skip
// product [TM, Cs] @ lin^T reuses the A buffer after the main product
// and accumulates apart, because its batch norm is separate.  The
// epilogue (bias, batch norm, skip, activation, mask) runs in registers
// and writes [M, Cout] once.  Row strides are padded so that
// the fragment loads hit 32 distinct banks (A: lda = 4 mod 8 words;
// B: ldb = 8 or 24 mod 32).  The kernels take up to 227 KB of dynamic
// shared memory; dagr_spline_conv_init sets that limit once, when the
// library is loaded, so a launch inside a CUDA-graph capture sets nothing.
//
// The 16-row tile over a thread-block cluster.  At DAGR-S's pooled
// levels and heads (Cin 64 and 66; 2240, 560, 140 and 35 rows a window)
// the 16-row tile has few blocks for its depth: each builds its A,
// streams all 13-14 of B's slabs through two stages and runs the whole
// 1716-deep product with ~180 KB of shared memory (one block an SM), so
// a launch of 3 or 9 tiles leaves most of the 132 SMs idle and one of
// 140 runs in two waves, each block bound by the latency of its slabs,
// not by the card's bytes or operations.  So that depth is split over
// the s blocks (s = 2, 4 or 8) of one cluster a tile: rank r builds the
// tap and root columns of its chunk of cc = ceil(Cin / s) input
// channels only (the split route's A_chunk layout), streams the
// matching rows of B (ChunkB), runs block_gemm over that ~26 cc-deep
// slice and the skip product over its chunk of Cs, and leaves both
// [16, coutp] partials in its shared memory; after a cluster barrier,
// rank r adds the s partials of its 16 / s rows, read through
// distributed shared memory in rank order, runs the epilogue and
// writes them; a second barrier keeps every block's shared memory
// until the others have read it.  No atomics and no second kernel, and
// every sum in a fixed order, so two calls are bit-identical.  s comes
// from the shapes and the card's SM count alone (block_split): the
// least waves(s) x (the slice's depth in slabs + a block's fixed cost),
// with one or two blocks an SM as shared memory allows, and no slice
// shallower than a slab; at s = 1 the launch is the plain one above.
// On an H100 at DAGR-S's widths that is 8 for 3-18 tiles, 4 for 35 and
// 1 from 70 tiles on (the prediction convs, Cout 2 and 5: 2 at 70); a
// split block costs ~8 us however thin its slice, which pays only while
// the tiles leave SMs idle.
//
// The 16-row tile's 64-row form, for launches whose 16-row tiles fill
// the card many times over (a batch of 8's 17,920- and 4,480-row convs:
// 1,120 and 280 tiles, 8.5 and 2.1 waves).  There every 16-row block
// reads all of B = [W ; root] (Cin 66: 1,716 x 64 floats, 440 KB) from
// L2 again, so a launch reads the weights M / 16 times (490 MB at
// 17,920 rows) and each block waits on its slabs one after another: what
// bounds it is the weights' L2 reads and their latency, not the card's
// bytes or operations (3.9 GFLOP, x3 in 3xTF32).  A block of the 64-row
// form owns 64 rows and all of Cout and reads B once per 64 rows.  Its A
// (64 x 1,720 floats) does not fit in shared memory, so it walks Cin in
// chunks of 4 channels, as the split route does: A_chunk [64, 104] in
// (channel, tap) column order, B_chunk the matching 104 rows.  16 warps:
// 8 builder warps (4 threads a row) sum each chunk's tap products into
// A_chunk (build_chunk's sums, entry by entry in slot order) from a
// window of x's rows that the block copies into shared memory once (at a
// pooled level the 3x3 stencil's 64 + 2 nx + 2 rows; x itself where the
// tile's sources spread wider), with each entry's taps and weights
// worked out once a tile; 8 product warps (an m-tile of 16 rows and half
// the n-tiles each) multiply each chunk as it is built (3xTF32 mma.sync,
// each chunk's products summed in the fragments, then added to float32
// sums in registers).  B reaches shared memory through the bulk-copy
// unit: a chunk's rows of one tap are contiguous in W, so a chunk is 26
// copies of 1 KB (a tap's 4 rows, then root's), three chunks deep, an
// mbarrier a stage, issued by a 17th warp of their own as each stage
// frees (1,664 16-byte cp.async copies a chunk held a block to a few
// GB/s, 104 bulk copies of a row each were slower still, and a product
// warp issuing them held the others at its barriers).
// A is double buffered, handed over by named barriers (built /
// multiplied).  The skip product and the epilogue run in the block.
// Not split-K: Cout <= 64 fits one block's registers, and a split would
// add partial sums, atomics or a second kernel for the one place it could
// pay, 4,480 rows (70 blocks on 132 SMs; 17,920 rows are 280); every sum
// is in a fixed order, so two calls are bit-identical.  block_form
// chooses among the plain tile, its cluster form and the 64-row form by
// the same wave model, the 64-row form at waves of its blocks (one an
// SM) x (1.55 units a chunk + 18.3), fitted on an H100 to the forced
// forms' per-launch times at DAGR-S's B=1 and B=8 shapes (the fixed cost
// raised from the fit's 16.8, as kRows64Cost's note says): a
// block takes 66-76 us, against 31-34 us for a 16-row block, so the form
// pays from about 3 waves of 16-row tiles on (serve's 17,920- and
// 4,480-row convs; not the 2,240-row convs of a window, nor the
// 1,120-row calls).  It takes Cout 16, 32 and 64 (a tap's
// rows are copied dense) at ks = 5, with W and root 16-byte aligned.
//
// Cout 65-128 (DAGR-M's and -L's pooled levels and heads) is the wide
// block's, dagr_spline_conv_wide_block (its note is with the split
// route, whose chunked tile build it shares): the same computation,
// split over the depth in partial sums that a second kernel adds up.
//
// K7, the gathered block (dagr_spline_conv_gather_block): the same
// kernel over a streaming chunk.  Replaces dagr_tpu/models/functional.py:
// 109 spline_conv_gather and the bn_eval, activation and mask around it
// at dagr_tpu/streaming/engine.py:208-226: the engine's two event convs
// (Cin 3 -> 16, then 16 -> 16 with the Cs = 3 skip), whose M = C
// destinations (1 to 1024) read K = 16 sources from the 50k-row event
// store.  Two differences from the sync block, both in the tile build:
// the root rows come from their own table (the chunk's rows, not row m
// of the sources), and a slot's attribute is made from the store's and
// the chunk's positions, clip((src - dst) / (2 mv) + 0.5, 0, 1) on (x,
// y), divided as the twin divides, instead of read from an [M, K, 2]
// table; every other step is the fused block's, on its 16-row tiles
// (rows16: the 1024 destinations of a chunk are 64 blocks; on 64-row
// tiles 16 blocks left most of the card idle and the two blocks took
// 1.2x the device time).  What bounds it: the
// bytes of the distinct source rows and positions, the edge tables, the
// chunk's rows, the weights and the output (under 1 MB at C = 1024: a
// fraction of a microsecond at 3.35 TB/s); the products, 2 C (26 Cin +
// Cs) Cout, are 14 MFLOP at Cin = 16.  It replaces a split form that
// wrote g [C, 25 Cin] to HBM and ran ~15 PyTorch ops and cuBLAS around
// each aggregation launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "spline_taps.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kSlab = 128;             // rows of B per cp.async stage
constexpr int kStages = 2;             // B slabs in flight
constexpr int kSmemMax = 232448;       // H100: 227 KB a block, opt-in
constexpr int kMaxK = 16;              // neighbour slots a destination
constexpr int kMaxSplit = 8;           // blocks a cluster (portable size)

enum Act { kNone = 0, kRelu = 1, kElu = 2, kSilu = 3, kGelu = 4 };

// A batch norm on running statistics: ((y - mean) * rsqrt(var + eps))
// * gamma + beta; mean null for none.
struct BatchNorm {
  const float *mean, *var, *gamma, *beta;
  float eps;
  __device__ __forceinline__ float operator()(float y, int n) const {
    return ((y - mean[n]) * rsqrtf(var[n] + eps)) * gamma[n] + beta[n];
  }
};

struct ConvArgs {
  const float* x;          // [N, Cin] sources (N = M unless x_root is given)
  const float* x_root;     // [M, Cin] root rows, or null: row m of x
  const int* nbr;          // [M, K] global source rows
  const uint8_t* emask;    // [M, K]
  const float* attr;       // [M, K, 2], or null: made from the positions
  const float* pos_src;    // [N, ps] source positions (x, y, ...)
  const float* pos_dst;    // [M, pd] destination positions
  int ps, pd;
  float two_mv;            // attr = clip((src - dst) / two_mv + 0.5, 0, 1)
  const float* W;          // [P*Cin, Cout]
  const float* root;       // [Cin, Cout]
  const float* bias;       // [Cout] or null
  BatchNorm bn;            // [Cout] vectors
  const float* skip;       // [M, Cs] or null
  const float* lin;        // [Cout, Cs]
  BatchNorm bn_skip;
  const uint8_t* mask;     // [M] or null
  int M, K, Cin, Cout, Cs, ks, act;
  float* out;              // [M, Cout]
};

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo: hi rounded to TF32, lo = v - hi exactly in float32; lo's
// bits go to the tensor core as they are, which reads their TF32 part
// (the low 13 mantissa bits are dropped: an error of at most 2^-21 |v|).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid (src-size 0
// reads nothing; ``src`` is a valid address all the same).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 16 bytes global -> shared, asynchronously, bypassing L1; zeros when
// !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows of the main product's B = [W ; root ; 0] and of the skip's lin^T.
// ``vec``: Cout % 4 == 0 and W, root 16-byte aligned, so a row's four
// columns n..n+3 are one 16-byte copy.
struct MainB {
  const float* W;
  const float* root;
  int pc, cin, cout;
  bool vec;
  __device__ __forceinline__ const float* at(int k, int n) const {
    if (n >= cout) return nullptr;
    if (k < pc) return W + (size_t)k * cout + n;
    if (k < pc + cin) return root + (size_t)(k - pc) * cout + n;
    return nullptr;
  }
};

// lin's columns 0 .. cs of each row (row stride ld).
struct SkipB {
  const float* lin;
  int cs, cout, ld;
  __device__ __forceinline__ const float* at(int k, int n) const {
    return (n < cout && k < cs) ? lin + (size_t)n * ld + k : nullptr;
  }
};

// Slab s of B (rows s*kSlab ..) into stage s % kStages of sB, in 4-byte
// copies; the caller commits the group.
template <class BSrc>
__device__ __forceinline__ void load_slab(float* sB, int ldb, int coutp,
                                          const BSrc& b, int s,
                                          const float* any) {
  float* dst = sB + (s % kStages) * kSlab * ldb;
  const int k0 = s * kSlab;
  for (int i = threadIdx.x; i < kSlab * coutp; i += kThreads) {
    const int kk = i / coutp, n = i - kk * coutp;
    const float* src = b.at(k0 + kk, n);
    cp_async4(dst + kk * ldb + n, src ? src : any, src != nullptr);
  }
}



// The main product's slabs, in 16-byte copies where the rows allow.
__device__ __forceinline__ void load_slab(float* sB, int ldb, int coutp,
                                          const MainB& b, int s,
                                          const float* any) {
  if (!b.vec) {
    load_slab<MainB>(sB, ldb, coutp, b, s, any);
    return;
  }
  float* dst = sB + (s % kStages) * kSlab * ldb;
  const int k0 = s * kSlab, cpr = coutp >> 2;   // 16-byte chunks a row
  if (kThreads % cpr == 0) {
    // a thread keeps its column and steps over rows
    const int n = (threadIdx.x % cpr) << 2, step = kThreads / cpr;
#pragma unroll 4
    for (int kk = threadIdx.x / cpr; kk < kSlab; kk += step) {
      const float* src = b.at(k0 + kk, n);
      cp_async16(dst + kk * ldb + n, src ? src : any, src != nullptr);
    }
    return;
  }
  for (int i = threadIdx.x; i < kSlab * cpr; i += kThreads) {
    const int kk = i / cpr, n = (i - kk * cpr) << 2;
    const float* src = b.at(k0 + kk, n);
    cp_async16(dst + kk * ldb + n, src ? src : any, src != nullptr);
  }
}

// B of a chunk: rows (p, j) = tap p of the chunk's channel c0 + j
// (j < cc), then cc root rows (with root); column n0 + n.  W is [P,
// Crows, ncols] and root [Crows, ncols], rows contiguous: the forward's
// W [P, Cin, Cout] and root, grad_x's W^T [P, Cout, Cin] and root^T
// (transposed into scratch by the backward entry).  ``vec``: ncols a
// multiple of 4 and both 16-byte aligned, so four columns are one
// 16-byte copy.
struct ChunkB {
  const float* W;
  const float* root;
  int P, Crows, cc, c0, n0, ncols;
  bool vec;
  // the first element of row k, or null past the chunk's rows
  __device__ __forceinline__ const float* row(int k) const {
    if (k < P * cc) {
      const int p = k / cc;
      return W + ((size_t)p * Crows + c0 + k - p * cc) * ncols;
    }
    k -= P * cc;
    return root && k < cc ? root + (size_t)(c0 + k) * ncols : nullptr;
  }
};

// its slab loader (defined with the split route, below)
template <int SLAB>
__device__ __forceinline__ void load_chunk_slab(float* sB, int ldb,
                                                int coutp, const ChunkB& b,
                                                int s, const float* any);

// The skip's B = lin^T of the wide block (lin [Cout, Cs], row stride
// cs): as SkipB, but streamed in SLAB-row slabs by load_lin_slab
// (defined with the wide block, below).
struct LinB {
  const float* lin;
  int cs, cout;
};

template <int SLAB>
__device__ __forceinline__ void load_lin_slab(float* sB, int ldb, int coutp,
                                              const LinB& b, int s,
                                              const float* any);

// acc += A [TM, kdim] (shared, row stride lda) @ B [kdim, coutp] in
// 3xTF32, B streamed slab by slab through kStages stages, one commit
// group a slab (empty past the last); slab 0 already issued and
// committed if ``issued``.  Warp w takes m-tile w % MT and n-tiles
// w / MT + j * (8 / MT) over every k-step; with KSPLIT (MT = 1) it takes
// every n-tile but only every 8th k-step (w, w + 8, ...), so no two warps
// split the same A values, and its acc is a partial sum over its
// k-steps.  B: MainB or SkipB in kSlab-row slabs, or a ChunkB.  Ends
// with every copy landed and a __syncthreads, after
// which A and sB may be reused.  With FLUSH each k-step's three products
// go into a zeroed fragment that is then added to acc in float32: the
// tensor core's accumulator adds without rounding to nearest, which over
// the split route's 3380-deep products (Cin 130) drifts past 1e-5 of the
// output; the fused block (depth <= 1716) keeps the plain form.  SLAB:
// B's rows a stage (the split route streams 64).
template <int MT, int NTW, bool KSPLIT, class BSrc, bool FLUSH = false,
          int SLAB = kSlab>
__device__ __forceinline__ void block_gemm(const float* sA, int lda, int kdim,
                                           float* sB, int ldb, int coutp,
                                           const BSrc& b, bool issued,
                                           const float* any,
                                           float acc[NTW][4]) {
  constexpr int NGRP = 8 / MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % MT, grp = warp / MT;
  const int g = lane >> 2, t = lane & 3;
  const int nslab = (kdim + SLAB - 1) / SLAB;
  auto load = [&](int s) {
    if constexpr (std::is_same<BSrc, ChunkB>::value)
      load_chunk_slab<SLAB>(sB, ldb, coutp, b, s, any);
    else if constexpr (std::is_same<BSrc, LinB>::value)
      load_lin_slab<SLAB>(sB, ldb, coutp, b, s, any);
    else
      load_slab(sB, ldb, coutp, b, s, any);
  };
  for (int s = issued ? 1 : 0; s < kStages - 1; ++s) {
    if (s < nslab) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    // slab s has landed once at most kStages - 2 newer groups are pending
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage it refills was read in iteration s - 1, before the barrier
    if (s + kStages - 1 < nslab) load(s + kStages - 1);
    cp_async_commit();
    const float* bs = sB + (s % kStages) * SLAB * ldb;
    const int kend = min(SLAB, kdim - s * SLAB);
    for (int kk = KSPLIT ? 8 * warp : 0; kk < kend; kk += KSPLIT ? 64 : 8) {
      // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float* ar = sA + (mt * 16 + g) * lda + s * SLAB + kk + t;
      uint32_t ahi[4], alo[4];
      split_tf32(ar[0], ahi[0], alo[0]);
      split_tf32(ar[8 * lda], ahi[1], alo[1]);
      split_tf32(ar[4], ahi[2], alo[2]);
      split_tf32(ar[8 * lda + 4], ahi[3], alo[3]);
      // coutp is exactly the n-tiles of the warps (8 * NTW * (8 / MT)
      // without KSPLIT, 8 * NTW with it): no bounds test, so the loads of
      // every n-tile issue before their products
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = KSPLIT ? j : grp + j * NGRP;
        // B fragment: (t, g), (t + 4, g) of n-tile nt
        const float* bc = bs + (kk + t) * ldb + nt * 8 + g;
        uint32_t bhi[2], blo[2];
        split_tf32(bc[0], bhi[0], blo[0]);
        split_tf32(bc[4 * ldb], bhi[1], blo[1]);
        if constexpr (FLUSH) {
          // the two small products in one chain, the large one apart
          float ts[4] = {0.f, 0.f, 0.f, 0.f}, tb[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(ts, alo, bhi);
          mma_tf32(tb, ahi, bhi);
          mma_tf32(ts, ahi, blo);
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[j][f] += tb[f] + ts[f];
        } else {
          mma_tf32(acc[j], alo, bhi);
          mma_tf32(acc[j], ahi, blo);
          mma_tf32(acc[j], ahi, bhi);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float activation(float y, int act) {
  switch (act) {
    case kRelu: return y > 0.f ? y : 0.f;
    case kElu: return y > 0.f ? y : expm1f(y);
    case kSilu: return y / (1.f + expf(-y));
    case kGelu:
      return 0.5f * y * (1.f + tanhf(0.7978845608028654f
                                      * (y + 0.044715f * (y * y * y))));
    default: return y;
  }
}

// The fused block's results as elements of this thread: with KSPLIT,
// elements tid + e * kThreads of the [16, coutp] tile, after summing
// the 8 warps' partials (in warp order) through ``red``; else the
// accumulator fragments (element 4j + e: row mt*16 + g + 8*(e >> 1),
// column nt*8 + 2t + (e & 1) of n-tile nt = grp + j * (8 / MT)).
template <int MT, int NTW, bool KSPLIT>
struct Elems {
  static constexpr int kN = KSPLIT ? 16 * 64 / kThreads : NTW * 4;
  float v[kN];

  __device__ __forceinline__ void coord(int e, int coutp, int& r,
                                        int& n) const {
    if (KSPLIT) {
      const int i = threadIdx.x + e * kThreads;
      r = i / coutp;
      n = i - r * coutp;
      if (r >= 16) r = n = 1 << 20;     // past the tile
    } else {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int j = e >> 2, f = e & 3;
      r = (warp % MT) * 16 + (lane >> 2) + 8 * (f >> 1);
      n = (warp / MT + j * (8 / MT)) * 8 + 2 * (lane & 3) + (f & 1);
    }
  }

  __device__ __forceinline__ void take(float acc[NTW][4], float* red,
                                       int coutp) {
    if (!KSPLIT) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) v[4 * j + f] = acc[j][f];
      return;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, rs = coutp + 1;
    float* mine = red + warp * 16 * rs;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        mine[(g + 8 * (f >> 1)) * rs + j * 8 + 2 * t + (f & 1)] = acc[j][f];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      int r, n;
      coord(e, coutp, r, n);
      float sum = 0.f;
      if (r < 16)
        for (int w = 0; w < 8; ++w) sum += red[(w * 16 + r) * rs + n];
      v[e] = sum;
    }
    __syncthreads();
  }
};

// Rows m0 .. m0 + nd of the fused block's A into sA (zeroed first, TM
// rows of lda): row d's tap sums of channels c0 .. c0 + cc of x over its
// K slots, in slot order, at columns p * cc + j, then its own channels at
// P * cc + j; every destination of the tile in one pass, TM groups of
// min(cc, kThreads / TM) threads, each over its channels.
template <int TM>
__device__ __forceinline__ void build_tile(float* sA, int lda,
                                           const ConvArgs& a, int m0, int nd,
                                           int c0, int cc) {
  for (int i = threadIdx.x; i < TM * lda / 4; i += kThreads)
    reinterpret_cast<float4*>(sA)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int pc = a.ks * a.ks * cc;
  const int tpd = cc < kThreads / TM ? cc : kThreads / TM;
  if (tpd > 0) {
    const int dpp = kThreads / tpd;
    const int d0 = threadIdx.x / tpd, lane = threadIdx.x - d0 * tpd;
    if (d0 < dpp) {
      for (int d = d0; d < nd; d += dpp) {
        const int m = m0 + d;
        float* row = sA + d * lda;
        // the slots' ids, masks and attributes are loaded together
        // first (independent loads), then added in slot order
        int src[kMaxK];
        float ax[kMaxK], ay[kMaxK];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          src[k] = -1;
          if (k < a.K) {
            const size_t mk = (size_t)m * a.K + k;
            if (a.emask[mk]) src[k] = a.nbr[mk];
            if (a.attr) {
              ax[k] = a.attr[2 * mk];
              ay[k] = a.attr[2 * mk + 1];
            }
          }
        }
        if (!a.attr) {
          // the gathered form: each slot's attribute from the source's
          // and the destination's positions, as the twin makes it
          const float dx = a.pos_dst[(size_t)m * a.pd];
          const float dy = a.pos_dst[(size_t)m * a.pd + 1];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (src[k] >= 0) {
              const float* p = a.pos_src + (size_t)src[k] * a.ps;
              ax[k] = (p[0] - dx) / a.two_mv + 0.5f;
              ay[k] = (p[1] - dy) / a.two_mv + 0.5f;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (src[k] >= 0)
            add_edge(row, a.x + (size_t)src[k] * a.Cin + c0, ax[k], ay[k],
                     a.ks, cc, lane, tpd);
        }
        const float* xr = a.x_root ? a.x_root : a.x;
        for (int c = lane; c < cc; c += tpd)
          row[pc + c] = xr[(size_t)m * a.Cin + c0 + c];
      }
    }
  }
  __syncthreads();
}

// The 16-row tile's cluster form (see the note at the top; launched
// with s blocks a cluster): this block is rank r of the s blocks of tile
// blockIdx.x / s.  It builds the A and runs the products of its chunk
// of the input channels and of Cs, keeps the two [16, coutp] partials in
// its shared memory (after sA and sB), then, past a cluster barrier,
// sums rows 16 / s * r .. of every rank's partials in rank order and
// runs the epilogue on them.  lda, lds: the widest chunk's strides.  An
// overload of the plain kernel's name, so that device traces find both
// under it; at most 128 registers a thread, so that two blocks fit an SM
// where their shared memory does (block_split counts on it).
template <int NTW>
__global__ void __launch_bounds__(kThreads, 2) spline_conv_block_kernel(
    ConvArgs a, int lda, int lds, int coutp, int ldb) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int m0 = (int)(blockIdx.x / s) * 16;
  const int nd = min(16, a.M - m0);
  const int P = a.ks * a.ks;
  const int cc = (a.Cin + s - 1) / s, c0 = rank * cc;
  const int ccr = max(0, min(cc, a.Cin - c0));
  float* sA = smem;                                   // [16, max(lda, lds)]
  float* sB = smem + 16 * (lda > lds ? lda : lds);    // [kStages, kSlab, ldb]
  float* part = sB + kStages * kSlab * ldb;           // [2, 16, coutp]
  const bool vec = a.Cout % 4 == 0
                   && (((uintptr_t)a.W | (uintptr_t)a.root) & 15) == 0;
  const ChunkB b{a.W, a.root, P, a.Cin, ccr, c0, 0, a.Cout, vec};
  // the first weight slab flies while the tile is built
  load_chunk_slab<kSlab>(sB, ldb, coutp, b, 0, a.W);
  cp_async_commit();
  build_tile<16>(sA, lda, a, m0, nd, c0, ccr);

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  block_gemm<1, NTW, true>(sA, lda, (P * ccr + ccr + 7) / 8 * 8, sB, ldb,
                           coutp, b, true, a.W, acc);
  Elems<1, NTW, true> y;
  y.take(acc, sB, coutp);
#pragma unroll
  for (int e = 0; e < y.kN; ++e) {
    int r, n;
    y.coord(e, coutp, r, n);
    if (r < 16) part[r * coutp + n] = y.v[e];
  }
  if (a.skip) {
    const int csc = (a.Cs + s - 1) / s, cs0 = rank * csc;
    const int csr = max(0, min(csc, a.Cs - cs0));
    for (int i = threadIdx.x; i < 16 * lds; i += kThreads) {
      const int d = i / lds, c = i - d * lds;
      sA[i] = (d < nd && c < csr)
                  ? a.skip[(size_t)(m0 + d) * a.Cs + cs0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const SkipB sb{a.lin + cs0, csr, a.Cout, a.Cs};
    block_gemm<1, NTW, true>(sA, lds, (csr + 7) / 8 * 8, sB, ldb, coutp, sb,
                             false, a.W, acc);
    Elems<1, NTW, true> sk;
    sk.take(acc, sB, coutp);
#pragma unroll
    for (int e = 0; e < sk.kN; ++e) {
      int r, n;
      sk.coord(e, coutp, r, n);
      if (r < 16) part[(16 + r) * coutp + n] = sk.v[e];
    }
  }

  // every rank's partials written (and visible across the cluster)
  cluster.sync();
  const int rows = 16 / s, r0 = rank * rows;
  for (int i = threadIdx.x; i < rows * coutp; i += kThreads) {
    const int r = r0 + i / coutp, n = i % coutp;
    if (n >= a.Cout || r >= nd) continue;
    const int o = r * coutp + n;
    float v = 0.f;
    for (int q = 0; q < s; ++q) v += cluster.map_shared_rank(part, q)[o];
    if (a.bias) v = v + a.bias[n];
    if (a.bn.mean) v = a.bn(v, n);
    if (a.skip) {
      float sv = 0.f;
      for (int q = 0; q < s; ++q)
        sv += cluster.map_shared_rank(part, q)[16 * coutp + o];
      if (a.bn_skip.mean) sv = a.bn_skip(sv, n);
      v = v + sv;
    }
    const int m = m0 + r;
    float out = activation(v, a.act);
    if (a.mask && !a.mask[m]) out = 0.f;
    a.out[(size_t)m * a.Cout + n] = out;
  }
  // no block leaves (and frees its shared memory) while another reads it
  cluster.sync();
}

template <int MT, int NTW, bool KSPLIT>
__global__ void __launch_bounds__(kThreads) spline_conv_block_kernel(
    ConvArgs a, int ka, int lda, int csp, int lds, int coutp, int ldb) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                                   // [TM, max(lda, lds)]
  float* sB = smem + TM * (lda > lds ? lda : lds);    // [kStages, kSlab, ldb]
  const int m0 = blockIdx.x * TM;
  const int nd = min(TM, a.M - m0);
  const int Cin = a.Cin, pc = a.ks * a.ks * Cin;
  const bool vec = a.Cout % 4 == 0
                   && (((uintptr_t)a.W | (uintptr_t)a.root) & 15) == 0;
  const MainB mb{a.W, a.root, pc, Cin, a.Cout, vec};
  // the first weight slab flies while the tile is built
  load_slab(sB, ldb, coutp, mb, 0, a.W);
  cp_async_commit();
  build_tile<TM>(sA, lda, a, m0, nd, 0, Cin);

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  block_gemm<MT, NTW, KSPLIT>(sA, lda, ka, sB, ldb, coutp, mb, true, a.W,
                              acc);
  Elems<MT, NTW, KSPLIT> y;
  y.take(acc, sB, coutp);
#pragma unroll
  for (int e = 0; e < y.kN; ++e) {
    int r, n;
    y.coord(e, coutp, r, n);
    if (n >= a.Cout) continue;
    if (a.bias) y.v[e] = y.v[e] + a.bias[n];
    if (a.bn.mean) y.v[e] = a.bn(y.v[e], n);
  }

  if (a.skip) {
    for (int i = threadIdx.x; i < TM * lds; i += kThreads) {
      const int d = i / lds, c = i - d * lds;
      sA[i] = (d < nd && c < a.Cs) ? a.skip[(size_t)(m0 + d) * a.Cs + c]
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const SkipB sb{a.lin, a.Cs, a.Cout, a.Cs};
    block_gemm<MT, NTW, KSPLIT>(sA, lds, csp, sB, ldb, coutp, sb, false, a.W,
                                acc);
    Elems<MT, NTW, KSPLIT> sk;
    sk.take(acc, sB, coutp);
#pragma unroll
    for (int e = 0; e < y.kN; ++e) {
      int r, n;
      y.coord(e, coutp, r, n);
      if (n >= a.Cout) continue;
      float s = sk.v[e];
      if (a.bn_skip.mean) s = a.bn_skip(s, n);
      y.v[e] = y.v[e] + s;
    }
  }

#pragma unroll
  for (int e = 0; e < y.kN; ++e) {
    int r, n;
    y.coord(e, coutp, r, n);
    if (n >= a.Cout || r >= nd) continue;
    const int m = m0 + r;
    float out = activation(y.v[e], a.act);
    if (a.mask && !a.mask[m]) out = 0.f;
    a.out[(size_t)m * a.Cout + n] = out;
  }
}

// the kernel's tile for (Cin, Cout, Cs): rows TM, the n-tiles a warp
// takes, and the padded widths and shared-memory bytes; false if the
// shapes do not fit.  rows16: 16 rows whatever the widths (the gathered
// block: a chunk of 1024 destinations is 64 blocks, not 16; a 16-row
// tile takes less shared memory than the 64-row one it replaces)
struct Tile {
  int mt, ntw, ka, lda, csp, lds, coutp, ldb;
  size_t smem;
};

bool conv_tile(int cin, int cout, int cs, int ks, int K, Tile* t,
               bool rows16 = false) {
  if (cin < 1 || cout < 1 || cout > 64 || cs < 0 || K < 0 || K > kMaxK)
    return false;
  t->ka = (ks * ks * cin + cin + 7) / 8 * 8;
  t->lda = t->ka + 4;
  t->csp = (cs + 7) / 8 * 8;
  t->lds = t->csp + 4;
  t->mt = !rows16 && (size_t)64 * t->lda * 4 <= 128 * 1024 ? 4 : 1;
  // the n-tiles of a warp, a power of 2: at 64 rows two warps share an
  // m-tile, at 16 rows every warp takes every n-tile (KSPLIT); Cout is
  // padded with zero columns up to the warps' n-tiles
  const int per = t->mt == 1 ? 8 : 16;
  t->ntw = 1;
  while (t->ntw * per < cout) t->ntw *= 2;
  t->coutp = t->ntw * per;
  t->ldb = t->coutp + ((t->coutp % 32 == 0 || t->coutp % 32 == 16) ? 8 : 0);
  const int la = t->lda > t->lds ? t->lda : t->lds;
  t->smem = ((size_t)16 * t->mt * la + kStages * kSlab * t->ldb)
            * sizeof(float);
  return t->smem <= (size_t)kSmemMax;
}

// ---- the split route: a spline conv of any width, and its backward -----
//
// dagr_spline_conv: y = A(x_src) @ W + x_root @ root (+ bias), where
// A(x_src)[m] = g[m] is the K2 aggregation of destination m's edges.
// Replaces dagr_tpu/ops/spline.py:242 spline_conv and :145
// stencil_spline_conv (the conv whole: aggregation and products) on the
// convs the fused block does not take (training, the DAGR-M/-L widths,
// the 100-class prediction, the server's event convs, whose sources are
// ring rows and whose root rows are the chunk's).  dagr_spline_conv_
// backward: what jax.grad derives from them for x and W.
//
// What bounds them on an H100: at the event level of a batch of 8
// (M = 400k rows, K = 16, Cin = Cout = 16) the inputs, outputs and edge
// tables are ~160 MB; the products are 2 M (26 Cin) Cout = 5.3 GFLOP
// (x3 in 3xTF32).  The route they replace wrote g [M, 25 Cin] (640 MB),
// read it back for the product and again for grad_W (autograd saved it),
// wrote grad_g = grad_y @ W^T (640 MB) and read it back scattered (the
// earlier K9a): ~3.8 GB a conv.  Here neither g nor grad_g reaches HBM.
//
// Design.  The forward and grad_x are one kernel, split_conv_kernel: a
// block owns 64 rows and up to 128 output columns (more columns: more
// blocks along y).  It walks the rows' input channels in chunks of cc
// (<= 16, fewer where shared memory asks): it builds A_chunk = [the rows'
// tap sums of channels c0..c0+cc (25 cc columns) | their root inputs (cc
// columns)] in shared memory, each row's edges added in a fixed order
// (spline_taps.cuh's add_edge, no atomics), and multiplies it by the
// matching rows of B on the tensor cores with the fused block's
// block_gemm (3xTF32 mma.sync, B streamed in cp.async slabs), each
// k-step's products added to float32 accumulators that stay in registers
// across chunks (FLUSH: the tensor core's own accumulation does not round
// to nearest, and these products are up to 3380 deep).  The forward walks
// each destination's slots in order (SlotEdges).  grad_x is the same
// product over the transposed edges: row s sums grad_y[m] * B_p(attr_mk)
// over the edges (m, k) that read s, Cout wide, then multiplies by W^T,
// and adds grad_y[s] @ root^T.  At the event level the edges into s come
// from a transposed CSR (RunEdges: graph_search.cu's dagr_source_runs,
// K1's stable radix sort keyed by source row and its run table, built
// once per level and kept by the caller), in edge order; at a pooled
// level the edges are the mirrored stencil (StencilEdges: every pooled
// neighbour list is the 3x3 cell stencil in GRID_OFFSETS order, so the
// edge of slot k into cell s is slot k of cell s - off_k), in slot order,
// with no sort.  grad_W = sum_m g[m]^T grad_y[m] is split_conv_wgrad_
// kernel: block (chunk, group) rebuilds the g chunk of each 64-row tile
// of its group of tiles in shared memory, multiplies its transpose by
// the tile's grad_y rows on the tensor cores (3xTF32), and adds the
// product into a [25 cc, Cout] partial in shared memory (each element
// owned by one lane, tiles in order); wgrad_reduce_kernel sums the
// groups' partials in group order.  Every sum runs in a fixed order, so
// two runs are bit-identical.

constexpr int kTM = 64;                // rows of a split-route tile
constexpr int kSplitSlab = 64;         // rows of B a split-route stage
constexpr int kMaxChunk = 16;          // input channels of a chunk

ChunkB chunk_b(const float* W, const float* root, int P, int Crows,
               int ncols) {
  const bool vec = ncols % 4 == 0
                   && (((uintptr_t)W | (uintptr_t)root) & 15) == 0;
  return ChunkB{W, root, P, Crows, 0, 0, 0, ncols, vec};
}

// Rows k0 .. k0 + rows of a chunk's B into dst (row stride ldb): rows
// through ChunkB::row, 16-byte copies of four columns where ``vec``,
// else 4-byte ones (coutp a power of 2: the row and column by shifts);
// the caller commits the group.
__device__ __forceinline__ void load_chunk_rows(float* dst, int ldb,
                                                int coutp, const ChunkB& b,
                                                int k0, int rows,
                                                const float* any) {
  const int per = b.vec ? coutp >> 2 : coutp;      // copies a row
  const int sh = __ffs(per) - 1;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int kk = i >> sh, j = i & (per - 1);
    const int n = b.vec ? 4 * j : j;
    const float* r = b.n0 + n < b.ncols ? b.row(k0 + kk) : nullptr;
    const float* src = r ? r + b.n0 + n : any;
    if (b.vec)
      cp_async16(dst + kk * ldb + n, src, r != nullptr);
    else
      cp_async4(dst + kk * ldb + n, src, r != nullptr);
  }
}

// A chunk's slab s of SLAB rows into stage s % kStages of sB.
template <int SLAB>
__device__ __forceinline__ void load_chunk_slab(float* sB, int ldb,
                                                int coutp, const ChunkB& b,
                                                int s, const float* any) {
  load_chunk_rows(sB + (s % kStages) * SLAB * ldb, ldb, coutp, b, s * SLAB,
                  SLAB, any);
}

// acc += A [64, ka] @ B [ka, 16 NTW], both in shared memory (B resident
// for the whole block): block_gemm's fragments and warp layout (MT = 4)
// and its FLUSH sums, with no slab to wait for.
template <int NTW>
__device__ __forceinline__ void resident_gemm(const float* sA, int lda,
                                              int ka, const float* sB,
                                              int ldb, float acc[NTW][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % 4, grp = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < ka; kk += 8) {
    const float* ar = sA + (mt * 16 + g) * lda + kk + t;
    uint32_t ahi[4], alo[4];
    split_tf32(ar[0], ahi[0], alo[0]);
    split_tf32(ar[8 * lda], ahi[1], alo[1]);
    split_tf32(ar[4], ahi[2], alo[2]);
    split_tf32(ar[8 * lda + 4], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float* bc = sB + (kk + t) * ldb + (grp + 2 * j) * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(bc[0], bhi[0], blo[0]);
      split_tf32(bc[4 * ldb], bhi[1], blo[1]);
      float ts[4] = {0.f, 0.f, 0.f, 0.f}, tb[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(ts, alo, bhi);
      mma_tf32(tb, ahi, bhi);
      mma_tf32(ts, ahi, blo);
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[j][f] += tb[f] + ts[f];
    }
  }
}

// dst[p][c][r] = src[p][r][c] for src [P, R, C].
__global__ void transpose_kernel(const float* __restrict__ src, int P, int R,
                                 int C, float* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * R * C) return;
  const int r = (int)(i % R);
  const long long pc = i / R;
  const int c = (int)(pc % C), p = (int)(pc / C);
  dst[i] = src[((long long)p * R + r) * C + c];
}

// A tile's edges, as positions: row m's entries are positions
// bound(m) .. bound(m + 1), in the order its sums take them; entry(pos)
// gives the other end's row (-1: none) and the edge's attribute.
//
// The forward: destination m's slots in order; the other end is the
// source row.
struct SlotEdges {
  const int* nbr;
  const uint8_t* mask;
  const float* attr;
  int K;
  __device__ __forceinline__ int bound(int m) const { return m * K; }
  // the three loads issue together (a masked slot's id is read too)
  __device__ __forceinline__ int entry(int pos, float& ax, float& ay) const {
    const float2 a = reinterpret_cast<const float2*>(attr)[pos];
    const int n = nbr[pos];
    ax = a.x;
    ay = a.y;
    return mask[pos] ? n : -1;
  }
};

// grad_x at the event level: the edges that read source s, in edge
// order, from the transposed CSR; the other end is the destination row.
struct RunEdges {
  const int* order;
  const int* start;
  const float* attr;
  int K;
  __device__ __forceinline__ int bound(int s) const { return start[s]; }
  __device__ __forceinline__ int entry(int pos, float& ax, float& ay) const {
    const int e = order[pos];
    const float2 a = reinterpret_cast<const float2*>(attr)[e];
    ax = a.x;
    ay = a.y;
    return e / K;
  }
};

// grad_x at a pooled level: the edges that read cell s, in slot order:
// slot k of cell s - off_k, off_k = dy * nx + dx for GRID_OFFSETS[k] =
// (dy, dx) = (k / 3 - 1, k % 3 - 1).  The pooled tables point slot k of
// cell m at m + off_k wherever it is unmasked
// (tests/test_torch_spline_train.py).
struct StencilEdges {
  const uint8_t* mask;
  const float* attr;
  int M, K, nx;
  __device__ __forceinline__ int bound(int s) const { return s * K; }
  __device__ __forceinline__ int entry(int pos, float& ax, float& ay) const {
    const int s = pos / K, k = pos - s * K;
    const int m = s - ((k / 3 - 1) * nx + (k % 3 - 1));
    ax = ay = 0.f;
    if ((unsigned)m >= (unsigned)M) return -1;
    const size_t e = (size_t)m * K + k;
    const float2 a = reinterpret_cast<const float2*>(attr)[e];
    if (!mask[e]) return -1;
    ax = a.x;
    ay = a.y;
    return m;
  }
};

// A tile's edge entries in shared memory: cap entries of a batch (the
// other end's row, and edge_taps' base tap by * ks + bx and fractions
// fx, fy, once an entry), and beg[d] = bound(m0 + d) for d = 0..nd.
// Slots and stencils (K entries a row) always fit; a tile whose
// transposed runs pass cap is staged again batch by batch.
struct EdgeStage {
  int* row;
  int* tap;
  float* fx;
  float* fy;
  int* beg;
  int cap;
};

// Staged entry q's taps at a chunk of cc channels: edge_taps' offsets
// and weights, the same expressions.
__device__ __forceinline__ Taps staged_taps(const EdgeStage& st, int q,
                                            int ks, int cc) {
  const float fx = st.fx[q], fy = st.fy[q];
  Taps t;
  t.w00 = (1.f - fy) * (1.f - fx);
  t.w01 = (1.f - fy) * fx;
  t.w10 = fy * (1.f - fx);
  t.w11 = fy * fx;
  t.t00 = st.tap[q] * cc;
  t.t10 = t.t00 + ks * cc;
  return t;
}

template <class Edges>
__device__ __forceinline__ void stage_edges(const Edges& edges,
                                            const EdgeStage& st, int b0,
                                            int b1, int ks) {
  for (int p = b0 + (int)threadIdx.x; p < b1; p += kThreads) {
    float ax, ay;
    const int r = edges.entry(p, ax, ay);
    // edge_taps' base tap and fractions
    const float kmax = (float)(ks - 1);
    const float px = fminf(fmaxf(ax, 0.f), 1.f) * kmax;
    const float py = fminf(fmaxf(ay, 0.f), 1.f) * kmax;
    const float bx = fminf(fmaxf(floorf(px), 0.f), kmax - 1.f);
    const float by = fminf(fmaxf(floorf(py), 0.f), kmax - 1.f);
    st.row[p - b0] = r;
    st.tap[p - b0] = (int)by * ks + (int)bx;
    st.fx[p - b0] = px - bx;
    st.fy[p - b0] = py - by;
  }
}

// The tile's bounds into st.beg, then, if they fit, its entries; returns
// whether they were staged (the caller syncs before use).
template <class Edges>
__device__ __forceinline__ bool stage_tile(const Edges& edges,
                                           const EdgeStage& st, int m0,
                                           int nd, int ks) {
  for (int d = threadIdx.x; d <= nd; d += kThreads)
    st.beg[d] = edges.bound(m0 + d);
  __syncthreads();
  const bool fits = st.beg[nd] - st.beg[0] <= st.cap;
  if (fits) stage_edges(edges, st, st.beg[0], st.beg[nd], ks);
  return fits;
}

// Staged entries p .. pend (batch-relative) into one row of A: each
// entry's 4 bilinear taps of this thread's channels lane, lane + tpd, ..
// (at most 4) of the cc from c0 of src [*, C], in entry order.  Eight
// entries' source values are loaded before any is added, so the gathers
// overlap.
constexpr int kGather = 8;

__device__ __forceinline__ void add_entries(
    float* row, const EdgeStage& st, int p, int pend,
    const float* __restrict__ src, int C, int c0, int cc, int ks, int lane,
    int tpd) {
  for (; p < pend; p += kGather) {
    int r[kGather];
    float v[kGather][4];
#pragma unroll
    for (int q = 0; q < kGather; ++q)
      r[q] = p + q < pend ? st.row[p + q] : -1;
#pragma unroll
    for (int q = 0; q < kGather; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + i * tpd;
        v[q][i] = (r[q] >= 0 && c < cc)
                      ? src[(size_t)r[q] * C + c0 + c] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < kGather; ++q) {
      if (r[q] < 0) continue;
      const Taps t = staged_taps(st, p + q, ks, cc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + i * tpd;
        if (c < cc) {
          row[t.t00 + c] += t.w00 * v[q][i];
          row[t.t00 + cc + c] += t.w01 * v[q][i];
          row[t.t10 + c] += t.w10 * v[q][i];
          row[t.t10 + cc + c] += t.w11 * v[q][i];
        }
      }
    }
  }
}

__device__ __forceinline__ void add4(float* a, float w, const float4& v) {
  float4 x = *reinterpret_cast<float4*>(a);
  x.x += w * v.x;
  x.y += w * v.y;
  x.z += w * v.z;
  x.w += w * v.w;
  *reinterpret_cast<float4*>(a) = x;
}

// add_entries where cc and C are multiples of 4: thread lane takes the
// four channels 4 lane .. 4 lane + 3, one 16-byte gather an entry and
// 16-byte read-modify-writes of A (the same sums, in the same order).
__device__ __forceinline__ void add_entries4(
    float* row, const EdgeStage& st, int p, int pend,
    const float* __restrict__ src, int C, int c0, int cc, int ks,
    int lane) {
  for (; p < pend; p += kGather) {
    int r[kGather];
    float4 v[kGather];
#pragma unroll
    for (int q = 0; q < kGather; ++q) {
      r[q] = p + q < pend ? st.row[p + q] : -1;
      v[q] = r[q] >= 0 ? *reinterpret_cast<const float4*>(
                             src + (size_t)r[q] * C + c0 + 4 * lane)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kGather; ++q) {
      if (r[q] < 0) continue;
      const Taps t = staged_taps(st, p + q, ks, cc);
      add4(row + t.t00 + 4 * lane, t.w00, v[q]);
      add4(row + t.t00 + cc + 4 * lane, t.w01, v[q]);
      add4(row + t.t10 + 4 * lane, t.w10, v[q]);
      add4(row + t.t10 + cc + 4 * lane, t.w11, v[q]);
    }
  }
}

// Rows m0 .. m0 + nd of A_chunk into sA (zeroed first): row d's tap sums
// of channels c0 .. c0 + cc of src [*, C] over its entries, at columns
// p * cc + j, then, with root_src, its own channels at P * cc + j.
// min(cc, 4) threads a row.  ``staged``: stage_tile staged the entries;
// else they are staged here, batch by batch.
template <class Edges>
__device__ __forceinline__ void build_chunk(
    float* sA, int lda, const Edges& edges, const EdgeStage& st, bool staged,
    const float* __restrict__ src, const float* __restrict__ root_src,
    int m0, int nd, int C, int c0, int cc, int ks) {
  for (int i = threadIdx.x; i < kTM * lda; i += kThreads) sA[i] = 0.f;
  __syncthreads();
  const int P = ks * ks;
  // 16-byte gathers where the chunk's channels allow (src rows and c0
  // 16-byte aligned: src, C and every chunk before a multiple of 4)
  const bool vec = cc % 4 == 0 && C % 4 == 0
                   && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int tpd = vec ? cc / 4 : cc < kThreads / kTM ? cc : kThreads / kTM;
  const int dpp = kThreads / tpd;
  const int d0 = threadIdx.x / tpd, lane = threadIdx.x - d0 * tpd;
  const int lo = st.beg[0], hi = st.beg[nd];
  for (int b0 = lo; b0 < hi; b0 += st.cap) {
    const int b1 = min(hi, b0 + st.cap);
    if (!staged) {
      stage_edges(edges, st, b0, b1, ks);
      __syncthreads();
    }
    if (d0 < dpp)
      for (int d = d0; d < nd; d += dpp) {
        const int p0 = max(st.beg[d], b0) - b0;
        const int p1 = min(st.beg[d + 1], b1) - b0;
        if (vec)
          add_entries4(sA + d * lda, st, p0, p1, src, C, c0, cc, ks, lane);
        else
          add_entries(sA + d * lda, st, p0, p1, src, C, c0, cc, ks, lane,
                      tpd);
      }
    if (!staged) __syncthreads();
  }
  if (root_src && d0 < dpp)
    for (int d = d0; d < nd; d += dpp)
      for (int j = lane; j < cc; j += tpd)
        sA[d * lda + P * cc + j] = root_src[(size_t)(m0 + d) * C + c0 + j];
  __syncthreads();
}

// The staging area after `used` floats of dynamic shared memory.
__device__ __forceinline__ EdgeStage edge_stage(float* smem, int used,
                                                int cap) {
  EdgeStage st;
  st.row = reinterpret_cast<int*>(smem + used);
  st.tap = reinterpret_cast<int*>(smem + used + cap);
  st.fx = smem + used + 2 * cap;
  st.fy = smem + used + 3 * cap;
  st.beg = reinterpret_cast<int*>(smem + used + 4 * cap);
  st.cap = cap;
  return st;
}

// The forward (SlotEdges) and grad_x (RunEdges, StencilEdges): rows of
// 64, columns n0 = blockIdx.y * 16 NTW; out[r, n] = sum over chunks of
// A_chunk[r] @ B_chunk (+ bias[n]).  With part (few row tiles), block z
// takes chunks z * cpz .. and writes its partial sums to part[z] [rows,
// ncols]; splitk_reduce_kernel adds them up.  With ka_max (many row
// tiles, B small), every chunk's B stays in shared memory (chunk i at
// row i * ka_max), loaded once, and the block walks the row tiles
// blockIdx.x, + gridDim.x, ..; else B streams through kStages slabs a
// chunk.  sb_words: the floats of shared memory B takes.
template <int NTW, class Edges>
__global__ void __launch_bounds__(kThreads) split_conv_kernel(
    Edges edges, const float* __restrict__ src,
    const float* __restrict__ root_src, ChunkB b,
    const float* __restrict__ bias, int rows, int C, int ks, int cc_max,
    int cpz, int lda, int ldb, int sb_words, int ka_max, int cap,
    float* __restrict__ part, float* __restrict__ out) {
  constexpr int kCoutp = 16 * NTW;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                                   // [kTM, lda]
  float* sB = smem + kTM * lda;                       // sb_words
  const EdgeStage st = edge_stage(smem, kTM * lda + sb_words, cap);
  b.n0 = blockIdx.y * kCoutp;
  const int nroot = root_src ? 1 : 0;
  const int c_begin = blockIdx.z * cpz * cc_max;
  const int c_end = min(C, c_begin + cpz * cc_max);
  if (ka_max) {
    for (int c0 = c_begin, i = 0; c0 < c_end; c0 += cc_max, ++i) {
      b.c0 = c0;
      b.cc = min(cc_max, C - c0);
      load_chunk_rows(sB + i * ka_max * ldb, ldb, kCoutp, b, 0,
                      (b.P * b.cc + nroot * b.cc + 7) / 8 * 8, b.W);
    }
    cp_async_commit();
  }
  const int tiles = (rows + kTM - 1) / kTM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * kTM, nd = min(kTM, rows - m0);
    const bool staged = stage_tile(edges, st, m0, nd, ks);
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = c_begin, i = 0; c0 < c_end; c0 += cc_max, ++i) {
      b.c0 = c0;
      b.cc = min(cc_max, C - c0);
      const int ka = (b.P * b.cc + nroot * b.cc + 7) / 8 * 8;
      if (!ka_max) {
        // the chunk's first B slab flies while A is built
        load_chunk_slab<kSplitSlab>(sB, ldb, kCoutp, b, 0, b.W);
        cp_async_commit();
      }
      build_chunk(sA, lda, edges, st, staged, src, root_src, m0, nd, C, c0,
                  b.cc, ks);
      if (ka_max) {
        cp_async_wait<0>();            // the resident B (the first time)
        __syncthreads();
        resident_gemm<NTW>(sA, lda, ka, sB + i * ka_max * ldb, ldb, acc);
        __syncthreads();               // before sA is built again
      } else {
        block_gemm<4, NTW, false, ChunkB, true, kSplitSlab>(
            sA, lda, ka, sB, ldb, kCoutp, b, true, b.W, acc);
      }
    }
    Elems<4, NTW, false> y;
    y.take(acc, sB, kCoutp);
#pragma unroll
    for (int e = 0; e < y.kN; ++e) {
      int r, n;
      y.coord(e, kCoutp, r, n);
      n += b.n0;
      if (r >= nd || n >= b.ncols) continue;
      const size_t o = (size_t)(m0 + r) * b.ncols + n;
      if (part)
        part[(size_t)blockIdx.z * rows * b.ncols + o] = y.v[e];
      else
        out[o] = bias ? y.v[e] + bias[n] : y.v[e];
    }
  }
}

// out = the z partials summed in z order (+ bias).
__global__ void splitk_reduce_kernel(const float* __restrict__ part, int z,
                                     long long n, int ncols,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < z; ++k) s += part[k * n + i];
  out[i] = bias ? s + bias[i % ncols] : s;
}

// grad_W partials: block (chunk, group, column tile) accumulates, over
// the 64-row tiles of its group, g_chunk^T [25 cc, 64] @ grad_y [64,
// 8 NT] in registers (3xTF32), then writes partial[group][p, c0 + j,
// n0 + n].  Warp w owns the 16-row m-tiles w, w + 8, .. (at most MTW)
// of the 25 cc rows and all NT n-tiles of 8 columns; A fragments read
// g_chunk transposed (row stride lda = 8 mod 32, as grad_y's ldg, so
// that the fragment loads hit 32 banks).
template <int NT>
__global__ void __launch_bounds__(kThreads) split_conv_wgrad_kernel(
    SlotEdges edges, const float* __restrict__ x,
    const float* __restrict__ gy, int M, int Cin, int Cout, int ks,
    int cc_max, int tiles_per_group, int lda, int ldg,
    float* __restrict__ partial) {
  constexpr int MTW = NT >= 8 ? 16 / NT : 4;
  extern __shared__ __align__(16) float smem[];
  const int P = ks * ks;
  const int c0 = blockIdx.x * cc_max, cc = min(cc_max, Cin - c0);
  const int n0 = blockIdx.z * 8 * NT;
  const int R = P * cc;
  float* sA = smem;                                   // [kTM, lda]
  float* sG = sA + kTM * lda;                         // [kTM, ldg]
  const EdgeStage st = edge_stage(smem, kTM * (lda + ldg), kTM * edges.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MTW][NT][4];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
  const int ntile_rows = (M + kTM - 1) / kTM;
  const int t0 = blockIdx.y * tiles_per_group;
  const int t1 = min(ntile_rows, t0 + tiles_per_group);
  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * kTM, nd = min(kTM, M - m0);
    for (int i = threadIdx.x; i < kTM * 8 * NT; i += kThreads) {
      const int d = i / (8 * NT), n = i - d * (8 * NT);
      sG[d * ldg + n] = (d < nd && n0 + n < Cout)
                            ? gy[(size_t)(m0 + d) * Cout + n0 + n] : 0.f;
    }
    stage_tile(edges, st, m0, nd, ks);
    build_chunk(sA, lda, edges, st, true, x, nullptr, m0, nd, Cin, c0, cc,
                ks);
#pragma unroll 2
    for (int kk = 0; kk < kTM; kk += 8) {
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        const int r0 = (warp + 8 * mi) * 16;
        if (r0 >= R) break;
        // A[r][k] = g_chunk[kk + k][r0 + r]: (g, t), (g + 8, t),
        // (g, t + 4), (g + 8, t + 4)
        const float* ar = sA + (kk + t) * lda + r0 + g;
        uint32_t ahi[4], alo[4];
        split_tf32(ar[0], ahi[0], alo[0]);
        split_tf32(ar[8], ahi[1], alo[1]);
        split_tf32(ar[4 * lda], ahi[2], alo[2]);
        split_tf32(ar[4 * lda + 8], ahi[3], alo[3]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          // B[k][n] = grad_y[kk + k][8 ni + n]: (t, g), (t + 4, g)
          const float* bc = sG + (kk + t) * ldg + 8 * ni + g;
          uint32_t bhi[2], blo[2];
          split_tf32(bc[0], bhi[0], blo[0]);
          split_tf32(bc[4 * ldg], bhi[1], blo[1]);
          float ts[4] = {0.f, 0.f, 0.f, 0.f}, tb[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(ts, alo, bhi);
          mma_tf32(tb, ahi, bhi);
          mma_tf32(ts, ahi, blo);
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[mi][ni][f] += tb[f] + ts[f];
        }
      }
    }
    __syncthreads();                 // before the next tile rebuilds sA, sG
  }
  float* dst = partial + (size_t)blockIdx.y * P * Cin * Cout;
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = (warp + 8 * mi) * 16 + g + 8 * (f >> 1);
        const int n = n0 + 8 * ni + 2 * t + (f & 1);
        if (r >= R || n >= Cout) continue;
        const int p = r / cc;
        dst[((size_t)p * Cin + c0 + r - p * cc) * Cout + n] = acc[mi][ni][f];
      }
}

// grad_W = the groups' partials summed in group order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    int groups, long long n,
                                    float* __restrict__ grad_w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int gr = 0; gr < groups; ++gr) s += partial[gr * n + i];
  grad_w[i] = s;
}

// Shared memory of an edge staging area of cap entries.
size_t stage_bytes(int cap) {
  return ((size_t)4 * cap + kTM + 1) * sizeof(float);
}

// Half the shared memory an SM has: two blocks an SM fit under it.
constexpr size_t kTwoBlocks = 113 * 1024;

// split_conv_kernel's tile for `rows` rows of C input channels, ncols
// output columns, with or without root rows, an edge staging area of cap
// entries: NTW, the chunk's channels cc, the row strides, shared memory;
// false if no chunk fits.  Few row tiles (under an SM each): at most 64
// columns a block (more blocks) and the widest chunk that fits (fewer
// passes in a row); else all columns up to 128 a block and the widest
// chunk with which two blocks share an SM.
struct SplitTile {
  int ntw, coutp, ldb, cc, lda;
  size_t smem;
};

bool split_tile(int rows, int C, int ncols, int ks, bool root, int cap,
                SplitTile* t) {
  if (C < 1 || ncols < 1 || ks < 2) return false;
  const bool few = (rows + kTM - 1) / kTM < 132;
  t->ntw = ncols <= 16 ? 1 : ncols <= 32 ? 2 : (ncols <= 64 || few) ? 4 : 8;
  t->coutp = 16 * t->ntw;
  t->ldb = t->coutp + ((t->coutp % 32 == 0 || t->coutp % 32 == 16) ? 8 : 0);
  const size_t budgets[2] = {few ? (size_t)kSmemMax : kTwoBlocks,
                             (size_t)kSmemMax};
  for (const size_t budget : budgets) {
    for (t->cc = C < kMaxChunk ? C : kMaxChunk;; t->cc = (t->cc + 1) / 2) {
      const int ka = (ks * ks * t->cc + (root ? t->cc : 0) + 7) / 8 * 8;
      t->lda = ka + 4;
      t->smem = ((size_t)kTM * t->lda
                 + (size_t)kStages * kSplitSlab * t->ldb) * sizeof(float)
                + stage_bytes(cap);
      if (t->smem <= budget) return true;
      if (t->cc == 1) break;
    }
  }
  return false;
}

// A row stride >= n that is 8 mod 32 words.
int stride8(int n) { return (n + 23) / 32 * 32 + 8; }

// split_conv_wgrad_kernel's column tile (NT n-tiles of 8, a power of 2,
// up to 128 columns), chunk, strides, shared memory and grid: the widest
// chunk (<= 16) whose 25 cc rows the warps' m-tiles cover (MTW each)
// and with which two blocks share an SM, else the widest that fits;
// about two blocks an SM in all, each over a run of consecutive row
// tiles.
struct WgradTile {
  int nt, cc, lda, ldg, chunks, ztiles, groups, tiles_per_group;
  size_t smem;
};

bool wgrad_tile(int M, int K, int Cin, int Cout, int ks, WgradTile* t) {
  if (Cin < 1 || Cout < 1 || ks < 2) return false;
  t->nt = 1;
  while (t->nt < 16 && 8 * t->nt < Cout) t->nt *= 2;
  const int mtw = t->nt >= 8 ? 16 / t->nt : 4;
  t->ldg = stride8(8 * t->nt);
  int cc = Cin < kMaxChunk ? Cin : kMaxChunk;
  while (cc > 1 && (ks * ks * cc + 15) / 16 > 8 * mtw) cc = (cc + 1) / 2;
  if ((ks * ks * cc + 15) / 16 > 8 * mtw) return false;
  bool ok = false;
  const size_t budgets[2] = {kTwoBlocks, (size_t)kSmemMax};
  for (const size_t budget : budgets) {
    for (t->cc = cc;; t->cc = (t->cc + 1) / 2) {
      t->lda = stride8(ks * ks * t->cc);
      t->smem = (size_t)kTM * (t->lda + t->ldg) * sizeof(float)
                + stage_bytes(kTM * K);
      if (t->smem <= budget) {
        ok = true;
        break;
      }
      if (t->cc == 1) break;
    }
    if (ok) break;
  }
  if (!ok) return false;
  t->chunks = (Cin + t->cc - 1) / t->cc;
  t->ztiles = (Cout + 8 * t->nt - 1) / (8 * t->nt);
  const int tiles = (M + kTM - 1) / kTM;
  const int per = t->chunks * t->ztiles;
  int groups = (264 + per - 1) / per;
  if (groups > tiles) groups = tiles;
  if (groups < 1) groups = 1;
  t->tiles_per_group = (tiles + groups - 1) / groups;
  t->groups = tiles == 0 ? 0 : (tiles + t->tiles_per_group - 1)
                                   / t->tiles_per_group;
  return true;
}

// Entries a split_conv_kernel tile stages at once: a slot or stencil
// tile's K a row; 2048 of a tile's transposed runs (more: in batches).
template <class Edges>
int stage_cap(const Edges& e) { return kTM * e.K; }
template <>
int stage_cap(const RunEdges&) { return 2048; }

// A split_conv_kernel launch: its tile, grid and chunks per z block.
// Where the row and column tiles fill less than the SMs, the chunks are
// spread over z blocks too (up to one block an SM in all), whose partial
// sums take ``scratch`` floats.
// Many row tiles (a wave or more) and every chunk's B in shared memory
// with as many blocks an SM as streaming it allows: B stays resident
// (ka_max rows a chunk) and about one block an SM-slot walks the tiles.
struct SplitPlan {
  SplitTile t;
  int cap, cpz, ka_max, sb_words;
  dim3 grid;
  long long scratch;
};

bool split_plan(int rows, int C, int ncols, int ks, bool root, int cap,
                SplitPlan* p) {
  p->cap = cap;
  if (!split_tile(rows, C, ncols, ks, root, cap, &p->t)) return false;
  const int tiles = (rows + kTM - 1) / kTM;
  const int ytiles = (ncols + p->t.coutp - 1) / p->t.coutp;
  const int nch = (C + p->t.cc - 1) / p->t.cc;
  // z blocks a tile: under a wave of blocks, enough to fill the SMs;
  // else the z (a power of 2) whose last wave wastes least, counting a
  // twentieth of a block's time for each extra split
  int z = 1;
  if (tiles > 0 && tiles * ytiles < 132 && nch > 1) {
    z = (132 + tiles * ytiles - 1) / (tiles * ytiles);
    if (z > nch) z = nch;
  } else if (tiles > 0) {
    const int slots = (p->t.smem <= kTwoBlocks ? 2 : 1) * 132;
    const long long n = (long long)tiles * ytiles;
    double best = (double)((n + slots - 1) / slots);
    for (int zz = 2; zz <= nch; zz *= 2) {
      const double cost = (double)((n * zz + slots - 1) / slots) / zz
                          + 0.05 * (zz - 1);
      if (cost < best) {
        best = cost;
        z = zz;
      }
    }
  }
  p->cpz = (nch + z - 1) / z;
  z = (nch + p->cpz - 1) / p->cpz;
  p->grid = dim3(tiles, ytiles, z);
  p->scratch = z > 1 ? (long long)z * rows * ncols : 0;
  p->ka_max = 0;
  p->sb_words = kStages * kSplitSlab * p->t.ldb;
  if (z == 1 && tiles * ytiles >= 132) {
    const int ka = (ks * ks * p->t.cc + (root ? p->t.cc : 0) + 7) / 8 * 8;
    const int words = nch * ka * p->t.ldb;
    const size_t smem = p->t.smem + (size_t)(words - p->sb_words)
                                        * sizeof(float);
    const int per_sm = p->t.smem <= kTwoBlocks ? 2 : 1;
    if (smem <= (per_sm == 2 ? kTwoBlocks : (size_t)kSmemMax)) {
      p->ka_max = ka;
      p->sb_words = words;
      p->t.smem = smem;
      const int slots = per_sm * 132 / ytiles;
      if (tiles > slots) p->grid.x = slots > 0 ? slots : 1;
    }
  }
  return true;
}

template <class Edges>
int launch_split(const Edges& edges, const float* src, const float* root_src,
                 const ChunkB& b, const float* bias, int rows, int C, int ks,
                 float* scratch, float* out, cudaStream_t st) {
  SplitPlan p;
  if (!split_plan(rows, C, b.ncols, ks, root_src != nullptr,
                  stage_cap(edges), &p))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  float* part = p.grid.z > 1 ? scratch : nullptr;
#define DAGR_SPLIT_LAUNCH(NTW)                                              \
  split_conv_kernel<NTW, Edges><<<p.grid, kThreads, p.t.smem, st>>>(        \
      edges, src, root_src, b, bias, rows, C, ks, p.t.cc, p.cpz, p.t.lda,   \
      p.t.ldb, p.sb_words, p.ka_max, p.cap, part, out)
  switch (p.t.ntw) {
    case 1: DAGR_SPLIT_LAUNCH(1); break;
    case 2: DAGR_SPLIT_LAUNCH(2); break;
    case 4: DAGR_SPLIT_LAUNCH(4); break;
    default: DAGR_SPLIT_LAUNCH(8); break;
  }
#undef DAGR_SPLIT_LAUNCH
  if (part) {
    const long long n = (long long)rows * b.ncols;
    splitk_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        part, (int)p.grid.z, n, b.ncols, bias, out);
  }
  return (int)cudaGetLastError();
}

// Scratch floats of launch_split's partial sums.
template <class Edges>
long long split_scratch(const Edges& edges, int rows, int C, int ncols,
                        int ks, bool root) {
  SplitPlan p;
  return split_plan(rows, C, ncols, ks, root, stage_cap(edges), &p)
             ? p.scratch : -1;
}

// The cluster form's kernel at NTW (the overload of one template
// parameter).
template <int NTW>
auto cluster_kernel() -> void (*)(ConvArgs, int, int, int, int) {
  return spline_conv_block_kernel<NTW>;
}

// SMs of the card, read by dagr_spline_conv_init.
int g_sms = 132;

// A fused block's fixed cost (its tile build, its epilogue, its share of
// the launch) and what a cluster adds to it (the partials through shared
// memory, two cluster barriers), in 128-row slabs of B streamed: fitted
// to the per-launch device times of DAGR-S's 16-row-tile calls at a
// batch of 1 and of 8 with s forced to 1, 2, 4 and 8 (H100 SXM).
constexpr double kBlockCost = 8.0;
constexpr double kClusterCost = 3.0;

// The cluster form of the 16-row tile t at s blocks a tile: each rank's
// chunk of ceil(Cin / s) input channels and ceil(Cs / s) skip columns
// (ka, lda, csp, lds of the widest chunk) and its shared memory, with the
// two partials; false where a rank would get no channel or a slice
// shallower than one slab of B.
bool cluster_tile(const Tile& t, int cin, int cs, int ks, int s, Tile* c) {
  const int cc = (cin + s - 1) / s;
  if ((s - 1) * cc >= cin) return false;
  *c = t;
  c->ka = (ks * ks * cc + cc + 7) / 8 * 8;
  if (c->ka < kSlab) return false;
  c->lda = c->ka + 4;
  c->csp = ((cs + s - 1) / s + 7) / 8 * 8;
  c->lds = c->csp + 4;
  const int la = c->lda > c->lds ? c->lda : c->lds;
  c->smem = ((size_t)16 * la + kStages * kSlab * t.ldb
             + (size_t)(cs ? 2 : 1) * 16 * t.coutp) * sizeof(float);
  return c->smem <= (size_t)kSmemMax;
}

// The estimated time of `blocks` blocks of tile t, each over t's depth,
// split over clusters or not: waves of the card's SMs at one or two
// blocks an SM (by shared memory), each as long as a block's slabs of B
// and its fixed cost.
double tile_cost(const Tile& t, long long blocks, bool cluster) {
  const long long resident = (long long)g_sms * (t.smem <= kTwoBlocks ? 2 : 1);
  const long long waves = (blocks + resident - 1) / resident;
  return (double)waves * ((double)(t.ka + t.csp) / kSlab + kBlockCost
                          + (cluster ? kClusterCost : 0.0));
}

// How many blocks (a cluster) split the depth of each 16-row tile of t
// over M rows, the tile they run (``run``) and its tile_cost (``cost``):
// the s in {1, 2, 4, 8} with the least tile_cost; 1 for the 64-row tile.
int block_split(const Tile& t, int cin, int cs, int ks, int M, Tile* run,
                double* cost) {
  *run = t;
  *cost = 0.0;
  if (t.mt != 1 || M <= 0) return 1;
  const long long tiles = (M + 15) / 16;
  int best = 1;
  *cost = tile_cost(t, tiles, false);
  for (int s = 2; s <= kMaxSplit; s *= 2) {
    Tile c;
    if (!cluster_tile(t, cin, cs, ks, s, &c)) continue;
    const double k = tile_cost(c, tiles * s, true);
    if (k < *cost) {
      *cost = k;
      best = s;
      *run = c;
    }
  }
  return best;
}

// ---- the 16-row tile's 64-row form ---------------------------------------
//
// (See the note at the top.)  A block owns 64 rows and all of Cout and
// walks Cin in chunks of kRows64Chunk channels.  It first copies the
// window of x's rows that the tile's entries and its own rows read (at a
// pooled level the 3x3 stencil's: 64 + 2 nx + 2 rows) into shared memory
// with one bulk copy, where the window fits (else the build reads x).
// Eight builder warps build each chunk's A from the window (build_chunk's
// tap sums and root inputs); eight product warps, an m-tile of 16 rows
// and half the n-tiles each, multiply each A chunk as it is built, with
// B's rows of the chunk streamed by the bulk-copy unit kRows64Stages chunks
// deep (an mbarrier a stage), issued by a warp of their own.  A is double
// buffered; named barriers hand it over (FULL s: built; EMPTY s:
// multiplied), and one a B stage tells the B warp it is free.

constexpr int kRows64Chunk = 4;       // input channels of an A chunk
constexpr int kRows64Ks = 5;          // the spline's taps a row (ks)
constexpr int kRows64Stages = 3;      // B chunks in flight
constexpr int kRows64ABufs = 2;       // A chunks: one built, one multiplied
constexpr int kRows64Warps = 8;       // product warps: 2 an m-tile
constexpr int kBuilders = 256;        // builder threads: 4 a row
// and one warp that issues B's bulk copies
constexpr int kRows64Threads = 32 * kRows64Warps + kBuilders + 32;
// its dynamic shared memory: 227 KB less its static mbarriers and bounds
constexpr int kRows64Smem = kSmemMax - 256;
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1, kBarEmpty = 1 + kRows64ABufs;
// B stage s used (a barrier a stage: the product warps arrive at stage
// s again only for a chunk whose B the B warp issued after its wait)
constexpr int kBarBFree = 1 + 2 * kRows64ABufs;
constexpr int kBarBuild = kBarBFree + kRows64Stages;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An mbarrier in shared memory: one arrival a phase, with the bytes of
// the bulk copies it waits for (expect_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared by
// the bulk-copy unit, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Warp 0's bulk copies of a chunk's B into dst: block q of 26 (tap q of
// W, then root) is the chunk's cc channel rows, contiguous in W [P, Cin,
// Cout] and in root (cc Cout floats), at dst + q * bs; completing on bar.
__device__ __forceinline__ void load_chunk_bulk(float* dst, int bs,
                                                const ChunkB& b,
                                                uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const uint32_t bytes = (uint32_t)(b.cc * b.ncols * 4);
  if (lane == 0) mbar_expect(bar, (uint32_t)(b.P + 1) * bytes);
  __syncwarp();
  for (int q = lane; q <= b.P; q += 32)
    bulk_copy(dst + q * bs,
              q < b.P ? b.W + ((size_t)q * b.Crows + b.c0) * b.ncols
                      : b.root + (size_t)b.c0 * b.ncols,
              bytes, bar);
}

// Where the build reads: row r of x [*, C] at base + (r - lo) C (the
// window of rows lo .. in shared memory, or x itself, lo 0), and the
// tile's entries, worked out once a tile: entry e's source row (-1:
// masked), its base tap (by ks + bx) and its 4 tap weights.
struct Rows64Src {
  const float* base;
  int lo, C;
  const int* src;
  const int* tap;
  const float4* w;
  __device__ __forceinline__ const float* row(int r) const {
    return base + (size_t)(r - lo) * C;
  }
};

// A chunk of the 64-row form's A (cc <= CC channels from c0) into sA
// (zeroed first), its columns in (channel, tap) order: channel j's tap
// p at j * (P + 1) + p and its own value at j * (P + 1) + P, so that B's
// rows of a tap are one contiguous copy.  Each row's entries in slot
// order, each adding its 4 bilinear taps' products into the row's tap
// sums (add_entries' sums), then the row's own channels.  A whole chunk
// (cc == CC): four builder threads a row, CC / 4 channels each; the
// entry's four taps lie at fixed offsets from its first (KS known here),
// so their loads issue together.  A shorter last chunk: a thread a
// (row, channel).
template <int KS, int CC>
__device__ __forceinline__ void build_rows64(float* sA, int lda,
                                             const Rows64Src& x, int m0,
                                             int nd, int K, int c0, int cc,
                                             int p) {
  constexpr int T = kBuilders / kTM, H = CC / T, P = KS * KS, Q = P + 1;
  for (int i = p; i < kTM * lda / 4; i += kBuilders)
    reinterpret_cast<float4*>(sA)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  bar_sync(kBarBuild, kBuilders);
  if (cc == CC) {
    const int d = p / T, h = (p % T) * H;
    if (d < nd) {
      float* row = sA + d * lda + h * Q;
      const float* xb = x.base + c0 + h;
      for (int q = 0; q < K; ++q) {
        const int e = d * K + q;
        const int r = x.src[e];
        if (r < 0) continue;
        const float4 w = x.w[e];
        const float* xs = xb + (size_t)(r - x.lo) * x.C;
        float v[H], x00[H], x01[H], x10[H], x11[H];
        float* a = row + x.tap[e];
#pragma unroll
        for (int c = 0; c < H; ++c) {
          v[c] = xs[c];
          x00[c] = a[c * Q];
          x01[c] = a[c * Q + 1];
          x10[c] = a[c * Q + KS];
          x11[c] = a[c * Q + KS + 1];
        }
#pragma unroll
        for (int c = 0; c < H; ++c) {
          a[c * Q] = x00[c] + w.x * v[c];
          a[c * Q + 1] = x01[c] + w.y * v[c];
          a[c * Q + KS] = x10[c] + w.z * v[c];
          a[c * Q + KS + 1] = x11[c] + w.w * v[c];
        }
      }
      const float* own = x.row(m0 + d) + c0 + h;
#pragma unroll
      for (int c = 0; c < H; ++c) row[c * Q + P] = own[c];
    }
  } else {
    for (int i = p; i < nd * cc; i += kBuilders) {
      const int d = i / cc, c = i - d * cc;
      float* row = sA + d * lda + c * Q;
      for (int q = 0; q < K; ++q) {
        const int e = d * K + q;
        const int r = x.src[e];
        if (r < 0) continue;
        const float4 w = x.w[e];
        const float v = x.row(r)[c0 + c];
        float* a = row + x.tap[e];
        a[0] += w.x * v;
        a[1] += w.y * v;
        a[KS] += w.z * v;
        a[KS + 1] += w.w * v;
      }
      row[P] = x.row(m0 + d)[c0 + c];
    }
  }
}

// Where B's row k lies in shared memory: a chunk's, in Q blocks of rows
// (the taps and root): row k = j Q + q at q bs + j ncols; lin^T's, at k
// ld.
template <int Q>
struct TapRows {
  int bs, ncols;
  __device__ __forceinline__ int at(int k) const {
    return (k % Q) * bs + (k / Q) * ncols;
  }
};

struct DenseRows {
  int ld;
  __device__ __forceinline__ int at(int k) const { return k * ld; }
};

// acc = rows 16 mt .. of A [64, kdim] @ columns 8 nt0 .. of B [kdim, *]
// (NTW n-tiles; shared memory), 3xTF32 mma.sync summed in the fragments'
// accumulators (as block_gemm without FLUSH; the caller adds acc to its
// float32 sums).
template <int NTW, class BR>
__device__ __forceinline__ void rows64_gemm(const float* sA, int lda,
                                            int kdim, const float* sB,
                                            const BR& br, int mt, int nt0,
                                            float acc[NTW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  sB += nt0 * 8;
  for (int kk = 0; kk < kdim; kk += 8) {
    const float* ar = sA + (mt * 16 + g) * lda + kk + t;
    uint32_t ahi[4], alo[4];
    split_tf32(ar[0], ahi[0], alo[0]);
    split_tf32(ar[8 * lda], ahi[1], alo[1]);
    split_tf32(ar[4], ahi[2], alo[2]);
    split_tf32(ar[8 * lda + 4], ahi[3], alo[3]);
    const float* b0 = sB + br.at(kk + t) + g;
    const float* b1 = sB + br.at(kk + t + 4) + g;
    uint32_t bhi[NTW][2], blo[NTW][2];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      split_tf32(b0[j * 8], bhi[j][0], blo[j][0]);
      split_tf32(b1[j * 8], bhi[j][1], blo[j][1]);
    }
    // pass by pass over the n-tiles, so that no product waits on the one
    // before it (each accumulator still takes its three in that order)
#pragma unroll
    for (int j = 0; j < NTW; ++j) mma_tf32(acc[j], alo, bhi[j]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) mma_tf32(acc[j], ahi, blo[j]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) mma_tf32(acc[j], ahi, bhi[j]);
  }
}

// The 64-row form: rows blockIdx.x * 64 .. of out.  b: B = [W ; root]
// by chunks (ChunkB; c0 and cc set a chunk); lda: A's row stride at
// kRows64Chunk channels; lds: the skip rows' (Cs padded to 8, + 4);
// ldb: lin^T's; bs: a tap block's stride in a B stage (CC Cout + 8, so
// that the fragments' 4 rows of 4 blocks hit distinct banks); cap: the
// tile's edge entries (64 K); wcap: the window's floats.  Shared memory:
// A [kRows64ABufs, 64, lda] (or the skip rows), B [kRows64Stages, P + 1,
// bs] (or lin^T), the entries' weights, sources and taps, the window.
// Product warp w takes m-tile w % 4 and n-tiles NTW / 2 (w / 4) .. of
// the NTW.  An overload of the fused kernel's name, so that device
// traces find it under it; CC, the chunk's channels, tells it apart from
// the cluster form.
template <int NTW, int CC>
__global__ void __launch_bounds__(kRows64Threads, 1) spline_conv_block_kernel(
    ConvArgs a, ChunkB b, int lda, int lds, int ldb, int bs, int cap,
    int wcap) {
  constexpr int SA = kRows64ABufs, SB = kRows64Stages, NT = kRows64Threads;
  constexpr int kAB = 32 * kRows64Warps + kBuilders;  // A's handover
  constexpr int NH = NTW / 2;                         // n-tiles a warp
  constexpr int kCoutp = 8 * NTW;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[SB + 1];       // B stage s landed; the window
  __shared__ int bounds[2 * NT / 32];
  const int P = a.ks * a.ks, C = a.Cin;
  const int wbs = (P + 1) * bs;                       // a B stage's floats
  const int csp = lds - 4;
  const int wa = max(SA * kTM * lda, kTM * lds);
  const int wb = max(SB * wbs, csp * ldb);
  const TapRows<kRows64Ks * kRows64Ks + 1> br{bs, a.Cout};
  float* sA = smem;
  float* sB = smem + wa;
  float4* sEw = reinterpret_cast<float4*>(sB + wb);   // [cap] weights
  int* sEsrc = reinterpret_cast<int*>(sEw + cap);     // [cap] source rows
  int* sEtap = sEsrc + cap;                           // [cap] base taps
  float* sW = reinterpret_cast<float*>(sEtap + cap);  // the window
  const int m0 = blockIdx.x * kTM, nd = min(kTM, a.M - m0);
  const int nch = (C + CC - 1) / CC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto set_chunk = [&](int i) {
    b.c0 = i * CC;
    b.cc = min(CC, C - b.c0);
  };
  // B's stages zeroed (the rows and columns past a chunk's stay finite),
  // ordered before the bulk copies' writes
  for (int i = threadIdx.x; i < SB * wbs / 4; i += NT)
    reinterpret_cast<float4*>(sB)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= SB; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  // the B warp: the first chunks' B fly while the entries are read
  const int bwarp = kRows64Warps + kBuilders / 32;
  if (warp == bwarp)
    for (int i = 0; i < SB && i < nch; ++i) {
      set_chunk(i);
      load_chunk_bulk(sB + i * wbs, bs, b, &full[i]);
    }

  // each entry's source row (-1: masked), base tap and tap weights
  // (edge_taps, as the staged builds make them), and the window: x's rows
  // lo .. hi that the tile reads
  int lo = m0, hi = m0 + nd - 1;
  for (int e = threadIdx.x; e < nd * a.K; e += NT) {
    const size_t mk = (size_t)m0 * a.K + e;
    const int r = a.emask[mk] ? a.nbr[mk] : -1;
    const float2 at = reinterpret_cast<const float2*>(a.attr)[mk];
    const Taps t = edge_taps(at.x, at.y, a.ks, 1);
    sEsrc[e] = r;
    sEtap[e] = t.t00;
    sEw[e] = make_float4(t.w00, t.w01, t.w10, t.w11);
    if (r >= 0) {
      lo = min(lo, r);
      hi = max(hi, r);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    bounds[warp] = lo;
    bounds[NT / 32 + warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < NT / 32; ++w) {
    lo = min(lo, bounds[w]);
    hi = max(hi, bounds[NT / 32 + w]);
  }
  // lo moved down so that the window's first byte is 16-byte aligned
  lo -= lo % (C % 4 == 0 ? 1 : C % 2 == 0 ? 2 : 4);
  const long long nw = (long long)(hi - lo + 1) * C;
  const bool win = nw <= wcap && (((uintptr_t)a.x) & 15) == 0;
  const long long nbulk = win ? nw / 4 * 4 : 0;
  if (win) {
    if (threadIdx.x == 0 && nbulk > 0) {
      mbar_expect(&full[SB], (uint32_t)(nbulk * 4));
      bulk_copy(sW, a.x + (size_t)lo * C, (uint32_t)(nbulk * 4), &full[SB]);
    }
    for (long long i = nbulk + threadIdx.x; i < nw; i += NT)
      sW[i] = a.x[(size_t)lo * C + i];
  }
  __syncthreads();
  const Rows64Src src{win ? sW : a.x, win ? lo : 0, C, sEsrc, sEtap, sEw};

  const int mt = warp % 4, nt0 = (warp / 4) * NH;
  float acc[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (warp == bwarp) {
    // chunk i's B into the stage that chunk i - SB left
    for (int i = SB; i < nch; ++i) {
      bar_sync(kBarBFree + i % SB, 32 * kRows64Warps + 32);
      set_chunk(i);
      load_chunk_bulk(sB + (i % SB) * wbs, bs, b, &full[i % SB]);
    }
  } else if (warp >= kRows64Warps) {
    const int p = threadIdx.x - 32 * kRows64Warps;
    if (nbulk > 0) mbar_wait(&full[SB], 0);
    for (int i = 0; i < nch; ++i) {
      const int s = i % SA, c0 = i * CC;
      if (i >= SA) bar_sync(kBarEmpty + s, kAB);
      build_rows64<kRows64Ks, CC>(sA + s * kTM * lda, lda, src, m0, nd, a.K,
                                  c0, min(CC, C - c0), p);
      bar_arrive(kBarFull + s, kAB);
    }
  } else {
    for (int i = 0; i < nch; ++i) {
      const int s = i % SA, cc = min(CC, C - i * CC);
      mbar_wait(&full[i % SB], (uint32_t)((i / SB) & 1));
      float part[NH][4];
      bar_sync(kBarFull + s, kAB);
      rows64_gemm<NH>(sA + s * kTM * lda, lda, (P * cc + cc + 7) / 8 * 8,
                      sB + (i % SB) * wbs, br, mt, nt0, part);
      if (i + SA < nch) bar_arrive(kBarEmpty + s, kAB);
      if (i + SB < nch)
        bar_arrive(kBarBFree + i % SB, 32 * kRows64Warps + 32);
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[j][f] += part[j][f];
    }
  }
  __syncthreads();

  // the skip's rows and lin^T over the stages, then its product
  if (a.skip) {
    for (int i = threadIdx.x; i < kTM * lds; i += NT) {
      const int d = i / lds, c = i - d * lds;
      sA[i] = (d < nd && c < a.Cs) ? a.skip[(size_t)(m0 + d) * a.Cs + c]
                                   : 0.f;
    }
    for (int i = threadIdx.x; i < kCoutp * csp; i += NT) {
      const int n = i / csp, k = i - n * csp;
      sB[k * ldb + n] = (n < a.Cout && k < a.Cs)
                            ? a.lin[(size_t)n * a.Cs + k] : 0.f;
    }
    __syncthreads();
  }
  if (warp >= kRows64Warps) return;
  float sk[NH][4];
  rows64_gemm<NH>(sA, lds, a.skip ? csp : 0, sB, DenseRows{ldb}, mt, nt0,
                  sk);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = mt * 16 + g + 8 * (f >> 1);
      const int n = (nt0 + j) * 8 + 2 * t + (f & 1);
      if (r >= nd || n >= a.Cout) continue;
      float v = acc[j][f];
      if (a.bias) v = v + a.bias[n];
      if (a.bn.mean) v = a.bn(v, n);
      if (a.skip) {
        const float s = sk[j][f];
        v = v + (a.bn_skip.mean ? a.bn_skip(s, n) : s);
      }
      const int m = m0 + r;
      float out = activation(v, a.act);
      if (a.mask && !a.mask[m]) out = 0.f;
      a.out[(size_t)m * a.Cout + n] = out;
    }
}

// The 64-row form's kernel at NTW.
template <int NTW>
auto rows64_kernel()
    -> void (*)(ConvArgs, ChunkB, int, int, int, int, int, int) {
  return spline_conv_block_kernel<NTW, kRows64Chunk>;
}

// The 64-row form's strides, edge entries, window and shared memory for
// the 16-row tile t (its coutp and ldb): the window takes what the rest
// leaves of 227 KB (less the kernel's static mbarriers and bounds);
// false where Cout is not t's padded width (a tap block's rows are copied
// dense) or ks is not kRows64Ks.
struct Rows64Tile {
  int lda, lds, ldb, bs, cap, wcap;
  size_t smem;
};

bool rows64_tile(const Tile& t, int cout, int cs, int ks, int K,
                 Rows64Tile* r) {
  if (ks != kRows64Ks || cout != t.coutp || cout < 16) return false;
  const int ka = (ks * ks * kRows64Chunk + kRows64Chunk + 7) / 8 * 8;
  r->lda = ka + 4;
  r->lds = (cs + 7) / 8 * 8 + 4;
  r->ldb = t.ldb;
  r->bs = kRows64Chunk * cout + 8;
  r->cap = kTM * K;
  const size_t a1 = (size_t)kRows64ABufs * kTM * r->lda;
  const size_t a2 = (size_t)kTM * r->lds;
  const size_t b1 = (size_t)kRows64Stages * (ks * ks + 1) * r->bs;
  const size_t b2 = (size_t)(r->lds - 4) * r->ldb;
  const size_t wa = a1 > a2 ? a1 : a2, wb = b1 > b2 ? b1 : b2;
  const size_t rest = (wa + wb + (size_t)6 * r->cap) * sizeof(float);
  const size_t room = (size_t)kRows64Smem;
  if (rest > room) return false;
  r->wcap = (int)((room - rest) / sizeof(float) / 4 * 4);
  r->smem = rest + (size_t)r->wcap * sizeof(float);
  return true;
}

// The 64-row form's estimated time over M rows, in tile_cost's units (a
// 128-row slab of the 16-row tile, ~1.5 us): waves of its blocks (one an
// SM: the window takes what shared memory is left), each as long as its
// chunks (the skip's depth counted in chunks too) and its fixed cost (the
// window and the entries, the epilogue); fitted to the per-launch device
// times of DAGR-S's 16-row-tile calls at a batch of 1 and of 8 with the
// form forced, when its products' TF32 splits were integer ops (H100
// SXM: 61-68 us a wave at Cin 64-66; with split_tf32 66-76 us).  The
// fit's fixed cost, 16.8, put the form 1% ahead of two waves of plain
// tiles (2,113-4,224 rows: a window's 2,240-row conv), where it now loses
// (74 against 71 us); 18.3 keeps those launches on the plain tile, and
// the rule takes the faster of the two at every DAGR-S shape.
constexpr double kRows64ChunkCost = 1.55;
constexpr double kRows64Cost = 18.3;

double rows64_cost(const Rows64Tile& r, int cin, int M) {
  const long long tiles = (M + kTM - 1) / kTM;
  const long long waves = (tiles + g_sms - 1) / g_sms;
  const double chunks = (double)((cin + kRows64Chunk - 1) / kRows64Chunk)
                        + (double)(r.lds - 4) / (r.lda - 4);
  return (double)waves * (chunks * kRows64ChunkCost + kRows64Cost);
}

// A launch's form: the 64-row form (rows64, its tile r64) or the 16-row
// tile split over ``split`` blocks a cluster (1: the plain kernel; the
// tile it runs in ``run``), whichever the costs put first; the 64-row
// tile and the gathered block (rows16) keep their plain kernel, and so
// does a launch whose W or root is not 16-byte aligned (``aligned``
// false: the 64-row form's bulk copies read both 16 bytes at a time).
// Shapes, that alignment and the SM count alone decide, so the answer is
// the same on every call.
struct BlockForm {
  int split;
  bool rows64;
  Tile run;
  Rows64Tile r64;
};

BlockForm block_form(const Tile& t, int cin, int cout, int cs, int ks, int K,
                     int M, bool rows16, bool aligned) {
  BlockForm f;
  double cost;
  f.split = block_split(t, cin, cs, ks, M, &f.run, &cost);
  f.rows64 = false;
  if (t.mt != 1 || M <= 0 || rows16 || !aligned
      || !rows64_tile(t, cout, cs, ks, K, &f.r64))
    return f;
  if (rows64_cost(f.r64, cin, M) < cost) {
    f.rows64 = true;
    f.split = 1;
    f.run = t;
  }
  return f;
}

// ---- the wide eval block: Cout 65-128 -----------------------------------
//
// dagr_spline_conv_wide_block: the fused block's computation (the note at
// the top: y = g @ W + x @ root (+ bias), bn(y), + bn_skip(skip @ lin^T),
// mask ? act(y) : 0) for the eval convs whose Cout the fused block's
// tile refuses: 65-128 (DAGR-M's 96, DAGR-L's 128, the NCaltech101
// head's 100 classes), any Cin, a skip branch of up to ~550 channels,
// K <= 16.  The same TPU ops as the fused block (dagr_tpu/models/
// blocks.py:133 ConvBlock, :156 ConvBlockWithSkip over dagr_tpu/ops/
// spline.py:145 stencil_spline_conv, and the head's prediction convs);
// it replaces, on those convs, the split route plus its epilogue's
// PyTorch ops (the batch norm, the skip Linear and its batch norm, the
// activation, torch.where: 5-8 more kernels a conv).
//
// What bounds it on an H100: at DAGR-L's pooled levels and heads (Cin
// 66-130, Cout 128, 35-560 rows a window) the weights (1.7 MB a conv at
// Cin 130) and the products, 2 M (26 Cin + Cs) Cout (0.5 GFLOP at 560
// rows, x3 in 3xTF32), are a few us of the card's bytes or operations.
// What a conv costs is latency: few rows and a 3380-deep product, which
// one block a row tile would walk slab after slab with most SMs idle.
//
// Design: split-K, as the split route does it.  A block owns 64 rows
// and all 128 (padded) output columns, so A is built once for every
// column.  Block (tile, z < zc) builds A_chunk (build_chunk: the tap
// sums and root inputs of cc input channels; the tile's edges staged
// once) for each of its cpz chunks and multiplies it by the chunk's rows
// of B = [W ; root] streamed in 64-row cp.async slabs (block_gemm,
// 3xTF32 mma.sync, FLUSH: each k-step's products added to float32
// accumulators in registers).  With a skip branch one more block a tile
// (z = zc) multiplies the tile's skip rows by lin^T.  Every block writes
// its [64, Cout] partial to scratch, and spline_conv_wide_reduce_kernel
// adds them in z order and runs the epilogue.  No atomics: every sum in
// a fixed order, so two calls are bit-identical; g never reaches HBM.
// (cc, cpz) come from the shapes and the SM count alone (wide_plan: the
// least waves x a block's time in 64-row slabs of B, plus the
// reduction).  At DAGR-L's shapes, a batch of 1 and of 8, every plan
// the rule picks splits the channels (zc = 16-65 and 3-33 blocks a
// tile), so a tile is never one block that could run the epilogue
// itself.  Split-K rather than a thread-block
// cluster over the depth: a cluster holds at most 8 blocks a tile
// (portably), so at 35-140 rows (1-3 tiles) it would leave most SMs
// idle with a 440-deep slice a block, where split-K spreads a tile
// over as many blocks as fill the card, at the cost of one small
// reduction launch and partials that stay in L2.

constexpr int kWideCols = 128;              // output columns a block
constexpr int kWideLdb = kWideCols + 8;     // sB row stride (8 mod 32)

// wide_plan's constants, in 64-row slabs of B streamed (4.6 us a slab
// a block): a chunk's own cost (its A build and the waits around it),
// the reduction launch, its read of the partials a MB and a split
// block's share of it; fitted to the device times of DAGR-L's 12 wide
// convs at a batch of 1 and of 8 with every plan pinned (H100 SXM),
// where a block's cost beyond its chunks fitted to nothing.
constexpr double kWideChunkCost = 1.13;
constexpr double kWideReduceCost = 1.12;
constexpr double kWideReducePerMB = 0.28;
constexpr double kWideReducePerBlock = 0.01;

// Slab s of lin^T (SLAB rows) into stage s % kStages of sB, in 4-byte
// copies, k fastest so that a warp reads consecutive floats of one row
// of lin; zeros past Cs and Cout.
template <int SLAB>
__device__ __forceinline__ void load_lin_slab(float* sB, int ldb, int coutp,
                                              const LinB& b, int s,
                                              const float* any) {
  float* dst = sB + (s % kStages) * SLAB * ldb;
  const int k0 = s * SLAB;
  for (int i = threadIdx.x; i < SLAB * coutp; i += kThreads) {
    const int n = i / SLAB, kk = i - n * SLAB;
    const bool ok = n < b.cout && k0 + kk < b.cs;
    cp_async4(dst + kk * ldb + n,
              ok ? b.lin + (size_t)n * b.cs + k0 + kk : any, ok);
  }
}

// Rows blockIdx.x * 64 .. of the wide block's partial sums part [z, M,
// Cout].  z = blockIdx.y < zc takes the input channels z * cpz * cc_max
// .. (cpz chunks of cc_max, the last may be shorter), z == zc the skip
// product.  lda: A's row stride at cc_max channels; lds: the skip rows'
// (Cs padded to 8, + 4).
__global__ void __launch_bounds__(kThreads) spline_conv_wide_kernel(
    ConvArgs a, ChunkB b, int cc_max, int cpz, int zc, int lda, int lds,
    float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int la = lda > lds ? lda : lds;
  float* sA = smem;                                   // [kTM, la]
  float* sB = smem + kTM * la;                        // [kStages, 64, ldb]
  const EdgeStage st = edge_stage(
      smem, kTM * la + kStages * kSplitSlab * kWideLdb, kTM * a.K);
  const int m0 = blockIdx.x * kTM, nd = min(kTM, a.M - m0);
  const int z = blockIdx.y;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (z < zc) {
    const SlotEdges edges{a.nbr, a.emask, a.attr, a.K};
    const bool staged = stage_tile(edges, st, m0, nd, a.ks);
    const int c_begin = z * cpz * cc_max;
    const int c_end = min(a.Cin, c_begin + cpz * cc_max);
    for (int c0 = c_begin; c0 < c_end; c0 += cc_max) {
      b.c0 = c0;
      b.cc = min(cc_max, a.Cin - c0);
      const int ka = (b.P * b.cc + b.cc + 7) / 8 * 8;
      // the chunk's first B slab flies while A is built
      load_chunk_slab<kSplitSlab>(sB, kWideLdb, kWideCols, b, 0, b.W);
      cp_async_commit();
      build_chunk(sA, lda, edges, st, staged, a.x, a.x, m0, nd, a.Cin, c0,
                  b.cc, a.ks);
      block_gemm<4, 8, false, ChunkB, true, kSplitSlab>(
          sA, lda, ka, sB, kWideLdb, kWideCols, b, true, b.W, acc);
    }
  } else {
    for (int i = threadIdx.x; i < kTM * lds; i += kThreads) {
      const int d = i / lds, c = i - d * lds;
      sA[i] = (d < nd && c < a.Cs) ? a.skip[(size_t)(m0 + d) * a.Cs + c]
                                   : 0.f;
    }
    __syncthreads();
    const LinB lb{a.lin, a.Cs, a.Cout};
    block_gemm<4, 8, false, LinB, true, kSplitSlab>(
        sA, lds, lds - 4, sB, kWideLdb, kWideCols, lb, false, a.W, acc);
  }
  // this block's partial: the main product's or (z == zc) the skip's
  float* dst = part + (size_t)z * a.M * a.Cout;
  Elems<4, 8, false> y;
#pragma unroll
  for (int e = 0; e < y.kN; ++e) {
    int r, n;
    y.coord(e, kWideCols, r, n);
    if (r < nd && n < a.Cout)
      dst[(size_t)(m0 + r) * a.Cout + n] = acc[e >> 2][e & 3];
  }
}

// The wide block's epilogue: out[m, n] = the zc partials summed in z
// order (+ bias), batch norm, + bn_skip(partial zc), activation, mask.
__global__ void spline_conv_wide_reduce_kernel(ConvArgs a,
                                               const float* __restrict__ part,
                                               int zc) {
  const long long n_out = (long long)a.M * a.Cout;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int m = (int)(i / a.Cout), n = (int)(i - (long long)m * a.Cout);
  float v = 0.f;
  for (int q = 0; q < zc; ++q) v += part[q * n_out + i];
  if (a.bias) v = v + a.bias[n];
  if (a.bn.mean) v = a.bn(v, n);
  if (a.skip) {
    const float s = part[zc * n_out + i];
    v = v + (a.bn_skip.mean ? a.bn_skip(s, n) : s);
  }
  float out = activation(v, a.act);
  if (a.mask && !a.mask[m]) out = 0.f;
  a.out[i] = out;
}

// The wide block's plan: chunks of cc input channels, cpz chunks a
// block, zc blocks a tile over the channels (z with the skip's), the
// strides and shared memory, the scratch floats of the partials.
struct WidePlan {
  int cc, cpz, zc, z, lda, lds;
  size_t smem;
  long long scratch;
};

// The tile at chunks of cc channels; false where the widths are not the
// wide block's or its shared memory passes 227 KB.
bool wide_tile(int cin, int cout, int cs, int ks, int K, int cc,
               WidePlan* p) {
  if (cin < 1 || cout <= 64 || cout > kWideCols || cs < 0 || K < 0
      || K > kMaxK || cc < 1 || cc > kMaxChunk)
    return false;
  p->cc = cc;
  p->lda = (ks * ks * cc + cc + 7) / 8 * 8 + 4;
  p->lds = (cs + 7) / 8 * 8 + 4;
  const int la = p->lda > p->lds ? p->lda : p->lds;
  p->smem = ((size_t)kTM * la + (size_t)kStages * kSplitSlab * kWideLdb)
                * sizeof(float) + stage_bytes(kTM * K);
  return p->smem <= (size_t)kSmemMax;
}

// The plan with the least estimated time over M rows: for chunks of
// cc = 16, 8, 4, 2 or 1 channels and each split zc of the channels (cpz
// chunks a block), waves of the SMs (two blocks an SM where shared
// memory allows) x the longest block's time, in 64-row slabs of B (a
// chunk's own cost and slabs for each of its chunks; the skip block's
// one chunk of Cs), plus the reduction.  force_cc,
// force_cpz (0: free) pin a plan, for the card tests and sweeps.
bool wide_plan(int M, int cin, int cout, int cs, int ks, int K,
               int force_cc, int force_cpz, WidePlan* best) {
  const long long tiles = (M + kTM - 1) / kTM;
  bool found = false;
  double best_cost = 0.0;
  for (int c = kMaxChunk; c >= 1; c /= 2) {
    if (c > cin && c / 2 >= cin) continue;        // the same cc = cin
    const int cc = c < cin ? c : cin;
    if (force_cc && cc != force_cc) continue;
    WidePlan p;
    if (!wide_tile(cin, cout, cs, ks, K, cc, &p)) continue;
    const int nch = (cin + cc - 1) / cc;
    const double slabs = (double)(p.lda - 4) / kSplitSlab;
    const long long slots = (long long)g_sms
                            * (p.smem <= kTwoBlocks ? 2 : 1);
    for (int cpz = 1; cpz <= nch; ++cpz) {
      const int zc = (nch + cpz - 1) / cpz;
      if (force_cpz ? cpz != force_cpz
                    : cpz > 1 && (nch + cpz - 2) / (cpz - 1) == zc)
        continue;                    // forced away, or zc at fewer chunks
      const int z = zc + (cs > 0 ? 1 : 0);
      const long long waves = (tiles * z + slots - 1) / slots;
      const double skip_block =
          cs > 0 ? kWideChunkCost + (double)(p.lds - 4) / kSplitSlab : 0.0;
      const double block = fmax(cpz * (kWideChunkCost + slabs), skip_block);
      const double cost = (double)waves * block + kWideReduceCost
                          + kWideReducePerBlock * z
                          + kWideReducePerMB * 4e-6 * (double)z * M * cout;
      if (!found || cost < best_cost) {
        found = true;
        best_cost = cost;
        p.cpz = cpz;
        p.zc = zc;
        p.z = z;
        p.scratch = (long long)z * M * cout;
        *best = p;
      }
    }
  }
  return found;
}

int launch_wide(const ConvArgs& a, int force_cc, int force_cpz,
                float* scratch, cudaStream_t st) {
  WidePlan p;
  if (!wide_plan(a.M, a.Cin, a.Cout, a.Cs, a.ks, a.K, force_cc, force_cpz,
                 &p))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0) return (int)cudaGetLastError();
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const ChunkB b = chunk_b(a.W, a.root, a.ks * a.ks, a.Cin, a.Cout);
  const dim3 grid((unsigned)((a.M + kTM - 1) / kTM), (unsigned)p.z);
  spline_conv_wide_kernel<<<grid, kThreads, p.smem, st>>>(
      a, b, p.cc, p.cpz, p.zc, p.lda, p.lds, scratch);
  const long long n = (long long)a.M * a.Cout;
  spline_conv_wide_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a, scratch, p.zc);
  return (int)cudaGetLastError();
}

template <class Edges>
cudaError_t split_smem_limits() {
  const void* kernels[] = {(const void*)split_conv_kernel<1, Edges>,
                           (const void*)split_conv_kernel<2, Edges>,
                           (const void*)split_conv_kernel<4, Edges>,
                           (const void*)split_conv_kernel<8, Edges>};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Sets the dynamic shared-memory limit of every fused-block and
// split-route kernel, once, when the library is loaded, and reads the
// card's SM count for block_split.
extern "C" int dagr_spline_conv_init(void) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  const void* kernels[] = {
      (const void*)spline_conv_block_kernel<4, 1, false>,
      (const void*)spline_conv_block_kernel<4, 2, false>,
      (const void*)spline_conv_block_kernel<4, 4, false>,
      (const void*)spline_conv_block_kernel<1, 1, true>,
      (const void*)spline_conv_block_kernel<1, 2, true>,
      (const void*)spline_conv_block_kernel<1, 4, true>,
      (const void*)spline_conv_block_kernel<1, 8, true>,
      (const void*)cluster_kernel<1>(), (const void*)cluster_kernel<2>(),
      (const void*)cluster_kernel<4>(), (const void*)cluster_kernel<8>(),
      (const void*)spline_conv_wide_kernel};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  // the 64-row form's static mbarriers and bounds take their share
  const void* rows64[] = {(const void*)rows64_kernel<2>(),
                          (const void*)rows64_kernel<4>(),
                          (const void*)rows64_kernel<8>()};
  for (const void* k : rows64) {
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kRows64Smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = split_smem_limits<SlotEdges>();
  if (err == cudaSuccess) err = split_smem_limits<RunEdges>();
  if (err == cudaSuccess) err = split_smem_limits<StencilEdges>();
  const void* wgrad[] = {(const void*)split_conv_wgrad_kernel<1>,
                         (const void*)split_conv_wgrad_kernel<2>,
                         (const void*)split_conv_wgrad_kernel<4>,
                         (const void*)split_conv_wgrad_kernel<8>,
                         (const void*)split_conv_wgrad_kernel<16>};
  for (const void* k : wgrad)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a block of the fused kernel takes at
// (Cin, Cout, Cs, ks, K), or 0 if it does not take these shapes.
extern "C" long long dagr_spline_conv_block_smem(int cin, int cout, int cs,
                                                 int ks, int K) {
  Tile t;
  return conv_tile(cin, cout, cs, ks, K, &t) ? (long long)t.smem : 0;
}

// The form of dagr_spline_conv_block at (Cin, Cout, Cs, ks, K) over M
// rows, its W and root 16-byte aligned or not: -1 the 16-row tile's
// 64-row form, else the blocks a tile is split over (1: no cluster), or
// 0 if the kernel does not take these shapes.
extern "C" int dagr_spline_conv_block_form(int cin, int cout, int cs, int ks,
                                           int K, int M, int aligned) {
  Tile t;
  if (!conv_tile(cin, cout, cs, ks, K, &t)) return 0;
  const BlockForm f = block_form(t, cin, cout, cs, ks, K, M, false,
                                 aligned != 0);
  return f.rows64 ? -1 : f.split;
}

namespace {

template <int NTW>
cudaError_t launch_cluster(const ConvArgs& a, const Tile& t, int tiles,
                           int split, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = t.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_kernel<NTW>(), a, t.lda, t.lds,
                            t.coutp, t.ldb);
}

template <int NTW>
void launch_rows64(const ConvArgs& a, const Rows64Tile& r, cudaStream_t st) {
  const ChunkB b = chunk_b(a.W, a.root, a.ks * a.ks, a.Cin, a.Cout);
  spline_conv_block_kernel<NTW, kRows64Chunk>
      <<<(a.M + kTM - 1) / kTM, kRows64Threads, r.smem, st>>>(
          a, b, r.lda, r.lds, r.ldb, r.bs, r.cap, r.wcap);
}

// One launch of the fused block's kernel for the tile of a's widths, in
// the form block_form gives: the 64-row form, a cluster split, or the
// plain kernel.
int launch_block(const ConvArgs& a, bool rows16, void* stream) {
  Tile t;
  if (!conv_tile(a.Cin, a.Cout, a.Cs, a.ks, a.K, &t, rows16))
    return (int)cudaErrorInvalidValue;
  const int tm = 16 * t.mt;
  const int blocks = (a.M + tm - 1) / tm;
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)a.W | (uintptr_t)a.root) & 15) == 0;
  const BlockForm f = block_form(t, a.Cin, a.Cout, a.Cs, a.ks, a.K, a.M,
                                 rows16, aligned);
  if (f.rows64) {
    switch (t.ntw) {
      case 2: launch_rows64<2>(a, f.r64, s); break;
      case 4: launch_rows64<4>(a, f.r64, s); break;
      default: launch_rows64<8>(a, f.r64, s); break;
    }
    return (int)cudaGetLastError();
  }
  if (f.split > 1) {
    cudaError_t err;
    switch (t.ntw) {
      case 1: err = launch_cluster<1>(a, f.run, blocks, f.split, s); break;
      case 2: err = launch_cluster<2>(a, f.run, blocks, f.split, s); break;
      case 4: err = launch_cluster<4>(a, f.run, blocks, f.split, s); break;
      default: err = launch_cluster<8>(a, f.run, blocks, f.split, s); break;
    }
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
#define DAGR_CONV_LAUNCH(MT, NTW, KSPLIT)                                  \
  spline_conv_block_kernel<MT, NTW, KSPLIT><<<blocks, kThreads, t.smem,    \
                                              s>>>(                        \
      a, t.ka, t.lda, t.csp, t.lds, t.coutp, t.ldb)
  if (t.mt == 1) {
    if (t.ntw == 1) {
      DAGR_CONV_LAUNCH(1, 1, true);
    } else if (t.ntw == 2) {
      DAGR_CONV_LAUNCH(1, 2, true);
    } else if (t.ntw == 4) {
      DAGR_CONV_LAUNCH(1, 4, true);
    } else {
      DAGR_CONV_LAUNCH(1, 8, true);
    }
  } else if (t.ntw == 1) {
    DAGR_CONV_LAUNCH(4, 1, false);
  } else if (t.ntw == 2) {
    DAGR_CONV_LAUNCH(4, 2, false);
  } else {
    DAGR_CONV_LAUNCH(4, 4, false);
  }
#undef DAGR_CONV_LAUNCH
  return (int)cudaGetLastError();
}

// The fused block's arguments but the sources, roots and attributes.
ConvArgs block_args(
    const void* nbr, const void* emask, const void* W, const void* root,
    const void* bias, const void* bn_mean, const void* bn_var,
    const void* bn_gamma, const void* bn_beta, float bn_eps,
    const void* skip, const void* lin, const void* sk_mean,
    const void* sk_var, const void* sk_gamma, const void* sk_beta,
    float sk_eps, const void* mask, int M, int K, int Cin, int Cout, int Cs,
    int ks, int act, void* out) {
  ConvArgs a{};
  a.nbr = (const int*)nbr;
  a.emask = (const uint8_t*)emask;
  a.W = (const float*)W;
  a.root = (const float*)root;
  a.bias = (const float*)bias;
  a.bn = {(const float*)bn_mean, (const float*)bn_var,
          (const float*)bn_gamma, (const float*)bn_beta, bn_eps};
  a.skip = (const float*)skip;
  a.lin = (const float*)lin;
  a.bn_skip = {(const float*)sk_mean, (const float*)sk_var,
               (const float*)sk_gamma, (const float*)sk_beta, sk_eps};
  a.mask = (const uint8_t*)mask;
  a.M = M;
  a.K = K;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Cs = skip ? Cs : 0;
  a.ks = ks;
  a.act = act;
  a.out = (float*)out;
  return a;
}

}  // namespace

extern "C" int dagr_spline_conv_block(
    const void* x, const void* nbr, const void* emask, const void* attr,
    const void* W, const void* root, const void* bias, const void* bn_mean,
    const void* bn_var, const void* bn_gamma, const void* bn_beta,
    float bn_eps, const void* skip, const void* lin, const void* sk_mean,
    const void* sk_var, const void* sk_gamma, const void* sk_beta,
    float sk_eps, const void* mask, int M, int K, int Cin, int Cout, int Cs,
    int ks, int act, void* out, void* stream) {
  ConvArgs a = block_args(nbr, emask, W, root, bias, bn_mean, bn_var,
                          bn_gamma, bn_beta, bn_eps, skip, lin, sk_mean,
                          sk_var, sk_gamma, sk_beta, sk_eps, mask, M, K, Cin,
                          Cout, Cs, ks, act, out);
  a.x = (const float*)x;
  a.attr = (const float*)attr;
  return launch_block(a, false, stream);
}

// K7 (see the note on the gathered block above): the fused block over M
// destinations whose K sources are rows of a table x [N, Cin] with
// positions pos_src [N, ps], the destinations' own rows x_root [M, Cin]
// and positions pos_dst [M, pd], each slot's attribute made from the two
// position tables.
extern "C" int dagr_spline_conv_gather_block(
    const void* x, const void* pos_src, const void* pos_dst,
    const void* x_root, const void* nbr, const void* emask, const void* W,
    const void* root, const void* bias, const void* bn_mean,
    const void* bn_var, const void* bn_gamma, const void* bn_beta,
    float bn_eps, const void* skip, const void* lin, const void* sk_mean,
    const void* sk_var, const void* sk_gamma, const void* sk_beta,
    float sk_eps, const void* mask, int M, int K, int Cin, int Cout, int Cs,
    int ks, int act, int ps, int pd, float two_mv, void* out, void* stream) {
  ConvArgs a = block_args(nbr, emask, W, root, bias, bn_mean, bn_var,
                          bn_gamma, bn_beta, bn_eps, skip, lin, sk_mean,
                          sk_var, sk_gamma, sk_beta, sk_eps, mask, M, K, Cin,
                          Cout, Cs, ks, act, out);
  a.x = (const float*)x;
  a.x_root = (const float*)x_root;
  a.pos_src = (const float*)pos_src;
  a.pos_dst = (const float*)pos_dst;
  a.ps = ps;
  a.pd = pd;
  a.two_mv = two_mv;
  return launch_block(a, true, stream);
}

// The split route's conv: out [M, Cout] = A(x_src) @ W + x_root @ root
// (+ bias), x_src [*, Cin] the rows the edges name, x_root [M, Cin] (null
// with root null); W [P, Cin, Cout], root [Cin, Cout], bias [Cout] or
// null; scratch of dagr_spline_conv_scratch floats.
extern "C" int dagr_spline_conv(
    const void* x_src, const void* x_root, const void* nbr, const void* emask,
    const void* attr, const void* W, const void* root, const void* bias,
    int M, int K, int Cin, int Cout, int ks, void* scratch, void* out,
    void* stream) {
  const ChunkB b = chunk_b((const float*)W, (const float*)root, ks * ks, Cin,
                           Cout);
  return launch_split(
      SlotEdges{(const int*)nbr, (const uint8_t*)emask, (const float*)attr, K},
      (const float*)x_src, root ? (const float*)x_root : nullptr, b,
      (const float*)bias, M, Cin, ks, (float*)scratch, (float*)out,
      (cudaStream_t)stream);
}

// Scratch floats of dagr_spline_conv (the partial sums of few row
// tiles); -1 if no tile takes the widths.
extern "C" long long dagr_spline_conv_scratch(int M, int K, int Cin,
                                              int Cout, int ks, int root) {
  return split_scratch(SlotEdges{nullptr, nullptr, nullptr, K}, M, Cin, Cout,
                       ks, root != 0);
}

// Bytes of dynamic shared memory a block of the wide block's kernel
// takes at (Cin, Cout, Cs, ks, K) with its widest chunk (every plan takes
// at most that), or 0 if the kernel does not take these shapes.
extern "C" long long dagr_spline_conv_wide_block_smem(int cin, int cout,
                                                      int cs, int ks,
                                                      int K) {
  WidePlan p;
  return wide_tile(cin, cout, cs, ks, K, cin < kMaxChunk ? cin : kMaxChunk,
                   &p) ? (long long)p.smem : 0;
}

// The wide block's plan over M rows (force_cc, force_cpz: 0 for the
// rule's): info = {cc, cpz, zc, z, scratch floats}; returns 0 if the
// kernel does not take these shapes (or the forced plan), else 1.
extern "C" int dagr_spline_conv_wide_block_plan(int cin, int cout, int cs,
                                                int ks, int K, int M,
                                                int force_cc, int force_cpz,
                                                long long* info) {
  WidePlan p;
  if (!wide_plan(M, cin, cout, cs, ks, K, force_cc, force_cpz, &p))
    return 0;
  info[0] = p.cc;
  info[1] = p.cpz;
  info[2] = p.zc;
  info[3] = p.z;
  info[4] = p.scratch;
  return 1;
}

// The wide eval block (see its note above): the fused block's arguments,
// then the plan's chunk cc and chunks a block cpz (the answer of
// dagr_spline_conv_wide_block_plan) and scratch of its floats.
extern "C" int dagr_spline_conv_wide_block(
    const void* x, const void* nbr, const void* emask, const void* attr,
    const void* W, const void* root, const void* bias, const void* bn_mean,
    const void* bn_var, const void* bn_gamma, const void* bn_beta,
    float bn_eps, const void* skip, const void* lin, const void* sk_mean,
    const void* sk_var, const void* sk_gamma, const void* sk_beta,
    float sk_eps, const void* mask, int M, int K, int Cin, int Cout, int Cs,
    int ks, int act, int cc, int cpz, void* scratch, void* out,
    void* stream) {
  ConvArgs a = block_args(nbr, emask, W, root, bias, bn_mean, bn_var,
                          bn_gamma, bn_beta, bn_eps, skip, lin, sk_mean,
                          sk_var, sk_gamma, sk_beta, sk_eps, mask, M, K, Cin,
                          Cout, Cs, ks, act, out);
  a.x = (const float*)x;
  a.attr = (const float*)attr;
  if (cc < 1 || cpz < 1) return (int)cudaErrorInvalidValue;
  return launch_wide(a, cc, cpz, (float*)scratch, (cudaStream_t)stream);
}

extern "C" long long dagr_source_runs_scratch(int n_edges, int n_src);
extern "C" int dagr_source_runs(const void* nbr, const void* mask,
                                int n_edges, int n_src, void* scratch,
                                void* order, void* start, void* stream);

// Words of W^T and root^T that grad_x reads (each a multiple of 4, so
// that what follows stays 16-byte aligned).
long long transposed_words(int P, int Cin, int Cout) {
  return ((long long)P * Cin * Cout + 3) / 4 * 4
         + ((long long)Cin * Cout + 3) / 4 * 4;
}

// Scratch words of dagr_spline_conv_backward: with grad_x (grad_x = 1),
// W^T and root^T first; after them, each step's in turn: the transposed
// edges' sort (sort = 1: the event level, runs not yet built), grad_x's
// partial sums (grid_nx > 0: a pooled level) and the grad_W partials
// (wgrad = 1); -1 if no tile takes the widths.
extern "C" long long dagr_spline_conv_backward_scratch(
    int M, int K, int Cin, int Cout, int ks, int grid_nx, int sort,
    int grad_x, int wgrad) {
  long long words = sort ? dagr_source_runs_scratch(M * K, M) : 0;
  if (grad_x) {
    const long long w = grid_nx > 0
        ? split_scratch(StencilEdges{nullptr, nullptr, M, K, grid_nx}, M,
                        Cout, Cin, ks, true)
        : split_scratch(RunEdges{nullptr, nullptr, nullptr, K}, M, Cout, Cin,
                        ks, true);
    if (w < 0) return -1;
    words = w > words ? w : words;
  }
  if (wgrad) {
    WgradTile t;
    if (!wgrad_tile(M, K, Cin, Cout, ks, &t)) return -1;
    const long long w = (long long)t.groups * ks * ks * Cin * Cout;
    words = w > words ? w : words;
  }
  return words + (grad_x ? transposed_words(ks * ks, Cin, Cout) : 0);
}

// The backward of dagr_spline_conv with x_src = x_root = x [M, Cin] (the
// training conv), given grad_y [M, Cout]: grad_x [M, Cin] (null: not
// wanted) and grad_W [P, Cin, Cout] (null: not wanted).  grid_nx > 0: a
// pooled level of that grid width (the mirrored stencil, K = 9); else
// the transposed edges order [M*K], start [M + 1], built here first when
// build_runs.  grad_root and grad_bias are the caller's dense products.
extern "C" int dagr_spline_conv_backward(
    const void* x, const void* grad_y, const void* nbr, const void* emask,
    const void* attr, const void* W, const void* root, int M, int K,
    int Cin, int Cout, int ks, int grid_nx, int build_runs, void* order,
    void* start, void* scratch, void* grad_x, void* grad_w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* gy = (const float*)grad_y;
  const int P = ks * ks;
  if (grad_x) {
    // W^T [P, Cout, Cin] and root^T [Cout, Cin]: grad_x's B, rows
    // contiguous
    float* wt = (float*)scratch;
    float* rt = wt + ((long long)P * Cin * Cout + 3) / 4 * 4;
    scratch = wt + transposed_words(P, Cin, Cout);
    const long long nw = (long long)P * Cin * Cout;
    transpose_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(
        (const float*)W, P, Cin, Cout, wt);
    if (root)
      transpose_kernel<<<(Cin * Cout + 255) / 256, 256, 0, st>>>(
          (const float*)root, 1, Cin, Cout, rt);
    const ChunkB b = chunk_b(wt, root ? rt : nullptr, P, Cout, Cin);
    const float* rs = root ? gy : nullptr;
    int err;
    if (grid_nx > 0) {
      err = launch_split(StencilEdges{(const uint8_t*)emask,
                                      (const float*)attr, M, K, grid_nx},
                         gy, rs, b, nullptr, M, Cout, ks, (float*)scratch,
                         (float*)grad_x, st);
    } else {
      if (build_runs) {
        err = dagr_source_runs(nbr, emask, M * K, M, scratch, order, start,
                               stream);
        if (err) return err;
      }
      err = launch_split(RunEdges{(const int*)order, (const int*)start,
                                  (const float*)attr, K},
                         gy, rs, b, nullptr, M, Cout, ks, (float*)scratch,
                         (float*)grad_x, st);
    }
    if (err) return err;
  }
  if (grad_w) {
    WgradTile t;
    if (!wgrad_tile(M, K, Cin, Cout, ks, &t))
      return (int)cudaErrorInvalidValue;
    const long long n = (long long)ks * ks * Cin * Cout;
    if (t.groups == 0) {
      cudaMemsetAsync(grad_w, 0, n * sizeof(float), st);
      return (int)cudaGetLastError();
    }
    float* partial = (float*)scratch;
    const SlotEdges edges{(const int*)nbr, (const uint8_t*)emask,
                          (const float*)attr, K};
    const dim3 grid(t.chunks, t.groups, t.ztiles);
#define DAGR_WGRAD_LAUNCH(NT)                                               \
  split_conv_wgrad_kernel<NT><<<grid, kThreads, t.smem, st>>>(              \
      edges, (const float*)x, gy, M, Cin, Cout, ks, t.cc,                   \
      t.tiles_per_group, t.lda, t.ldg, partial)
    switch (t.nt) {
      case 1: DAGR_WGRAD_LAUNCH(1); break;
      case 2: DAGR_WGRAD_LAUNCH(2); break;
      case 4: DAGR_WGRAD_LAUNCH(4); break;
      case 8: DAGR_WGRAD_LAUNCH(8); break;
      default: DAGR_WGRAD_LAUNCH(16); break;
    }
#undef DAGR_WGRAD_LAUNCH
    wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        partial, t.groups, n, (float*)grad_w);
  }
  return (int)cudaGetLastError();
}
