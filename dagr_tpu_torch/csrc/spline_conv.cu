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
// shared memory; dagr_init sets that limit once, when the library is
// loaded, so a launch inside a CUDA-graph capture sets nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "spline_taps.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kSlab = 128;             // rows of B per cp.async stage
constexpr int kStages = 2;             // B slabs in flight
constexpr int kSmemMax = 232448;       // H100: 227 KB a block, opt-in
constexpr int kMaxK = 16;              // neighbour slots a destination

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
  const float* x;          // [M, Cin] sources; row m is also the root input
  const int* nbr;          // [M, K] global source rows
  const uint8_t* emask;    // [M, K]
  const float* attr;       // [M, K, 2]
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

struct SkipB {
  const float* lin;
  int cs, cout;
  __device__ __forceinline__ const float* at(int k, int n) const {
    return (n < cout && k < cs) ? lin + (size_t)n * cs + k : nullptr;
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

// acc += A [TM, kdim] (shared, row stride lda) @ B [kdim, coutp] in
// 3xTF32, B streamed slab by slab through kStages stages, one commit
// group a slab (empty past the last); slab 0 already issued and
// committed if ``issued``.  Warp w takes m-tile w % MT and n-tiles
// w / MT + j * (8 / MT) over every k-step; with KSPLIT (MT = 1) it takes
// every n-tile but only every 8th k-step (w, w + 8, ...), so no two warps
// split the same A values, and its acc is a partial sum over its
// k-steps.  Ends with every copy landed and a __syncthreads, after
// which A and sB may be reused.
template <int MT, int NTW, bool KSPLIT, class BSrc>
__device__ __forceinline__ void block_gemm(const float* sA, int lda, int kdim,
                                           float* sB, int ldb, int coutp,
                                           const BSrc& b, bool issued,
                                           const float* any,
                                           float acc[NTW][4]) {
  constexpr int NGRP = 8 / MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % MT, grp = warp / MT;
  const int g = lane >> 2, t = lane & 3;
  const int nslab = (kdim + kSlab - 1) / kSlab;
  for (int s = issued ? 1 : 0; s < kStages - 1; ++s) {
    if (s < nslab) load_slab(sB, ldb, coutp, b, s, any);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    // slab s has landed once at most kStages - 2 newer groups are pending
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage it refills was read in iteration s - 1, before the barrier
    if (s + kStages - 1 < nslab)
      load_slab(sB, ldb, coutp, b, s + kStages - 1, any);
    cp_async_commit();
    const float* bs = sB + (s % kStages) * kSlab * ldb;
    const int kend = min(kSlab, kdim - s * kSlab);
    for (int kk = KSPLIT ? 8 * warp : 0; kk < kend; kk += KSPLIT ? 64 : 8) {
      // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float* ar = sA + (mt * 16 + g) * lda + s * kSlab + kk + t;
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
        mma_tf32(acc[j], alo, bhi);
        mma_tf32(acc[j], ahi, blo);
        mma_tf32(acc[j], ahi, bhi);
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

  for (int i = threadIdx.x; i < TM * lda / 4; i += kThreads)
    reinterpret_cast<float4*>(sA)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  {
    // every destination of the tile in one pass: TM groups of
    // min(Cin, kThreads / TM) threads, each over its channels
    const int tpd = Cin < kThreads / TM ? Cin : kThreads / TM;
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
            ax[k] = a.attr[2 * mk];
            ay[k] = a.attr[2 * mk + 1];
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (src[k] >= 0)
            add_edge(row, a.x + (size_t)src[k] * Cin, ax[k], ay[k], a.ks, Cin,
                     lane, tpd);
        }
        for (int c = lane; c < Cin; c += tpd)
          row[pc + c] = a.x[(size_t)m * Cin + c];
      }
    }
  }
  __syncthreads();

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
    const SkipB sb{a.lin, a.Cs, a.Cout};
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
// shapes do not fit
struct Tile {
  int mt, ntw, ka, lda, csp, lds, coutp, ldb;
  size_t smem;
};

bool conv_tile(int cin, int cout, int cs, int ks, int K, Tile* t) {
  if (cin < 1 || cout < 1 || cout > 64 || cs < 0 || K < 0 || K > kMaxK)
    return false;
  t->ka = (ks * ks * cin + cin + 7) / 8 * 8;
  t->lda = t->ka + 4;
  t->csp = (cs + 7) / 8 * 8;
  t->lds = t->csp + 4;
  t->mt = (size_t)64 * t->lda * 4 <= 128 * 1024 ? 4 : 1;
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

}  // namespace

// Sets the dynamic shared-memory limit of every fused-block kernel, once,
// when the library is loaded.
extern "C" int dagr_init(void) {
  const void* kernels[] = {
      (const void*)spline_conv_block_kernel<4, 1, false>,
      (const void*)spline_conv_block_kernel<4, 2, false>,
      (const void*)spline_conv_block_kernel<4, 4, false>,
      (const void*)spline_conv_block_kernel<1, 1, true>,
      (const void*)spline_conv_block_kernel<1, 2, true>,
      (const void*)spline_conv_block_kernel<1, 4, true>,
      (const void*)spline_conv_block_kernel<1, 8, true>};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a block of the fused kernel takes at
// (Cin, Cout, Cs, ks, K), or 0 if it does not take these shapes.
extern "C" long long dagr_spline_conv_block_smem(int cin, int cout, int cs,
                                                 int ks, int K) {
  Tile t;
  return conv_tile(cin, cout, cs, ks, K, &t) ? (long long)t.smem : 0;
}

extern "C" int dagr_spline_conv_block(
    const void* x, const void* nbr, const void* emask, const void* attr,
    const void* W, const void* root, const void* bias, const void* bn_mean,
    const void* bn_var, const void* bn_gamma, const void* bn_beta,
    float bn_eps, const void* skip, const void* lin, const void* sk_mean,
    const void* sk_var, const void* sk_gamma, const void* sk_beta,
    float sk_eps, const void* mask, int M, int K, int Cin, int Cout, int Cs,
    int ks, int act, void* out, void* stream) {
  Tile t;
  if (!conv_tile(Cin, Cout, skip ? Cs : 0, ks, K, &t))
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{(const float*)x, (const int*)nbr, (const uint8_t*)emask,
                   (const float*)attr, (const float*)W, (const float*)root,
                   (const float*)bias,
                   {(const float*)bn_mean, (const float*)bn_var,
                    (const float*)bn_gamma, (const float*)bn_beta, bn_eps},
                   (const float*)skip, (const float*)lin,
                   {(const float*)sk_mean, (const float*)sk_var,
                    (const float*)sk_gamma, (const float*)sk_beta, sk_eps},
                   (const uint8_t*)mask,
                   M, K, Cin, Cout, skip ? Cs : 0, ks, act, (float*)out};
  const int tm = 16 * t.mt;
  const int blocks = (M + tm - 1) / tm;
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
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
