// K4: decode, confidence filter, top-K and class-aware greedy NMS, per
// image, in one launch.
//
// Replaces dagr_tpu/models/dagr.py:149 detect: dagr_tpu/models/head.py:169
// decode_outputs followed by dagr_tpu/ops/nms.py:54 postprocess with its
// :29 nms_mask and :19 iou_xyxy.  Per image: the decode of the raw head
// outputs (xy = (raw + grid) * stride, wh = exp(raw) * stride, sigmoid
// on obj and on each class); boxes xyxy from (cx, cy, w, h); label = the
// first argmax over the classes, score = obj * max(cls), scores under
// conf set to -1; the top K = min(max_out, A) by score, ties broken by
// the lower anchor index (lax.top_k's order; torch.topk on CUDA does not
// promise it, so the order is made here); then greedy NMS at IoU > thr
// over boxes offset by label * (max(W, H) + 1), so boxes of different
// classes never overlap.  Outputs are fixed-size, in score order: boxes,
// max(score, 0), labels, keep.  With no anchor tables the rows come
// decoded (postprocess alone).
//
// What bounds it on an H100: launch latency and one SM's dependent steps.
// The bytes are a few kilobytes and the work K^2 / 2 IoU tests, but an
// image is one block: at DAGR-S (175 anchors) the kernel takes ~13 us,
// and at 4032 anchors with K = 2000 ~0.73 ms, most of it the 2M tests
// and the sweep (chip_smoke.py on an H100 80GB HBM3 at 700 W).  The
// greedy sweep is sequential in the rows; its inner steps are not.
//
// Design: one block of 512 threads per image, no decoded copy in device
// memory.  (1) Each anchor's score from its obj and class logits, as a
// 64-bit key: the score's order bits inverted (descending), then the
// anchor index (ascending), so the keys are distinct and their order is
// the plain version's stable sort.  (2) A bitonic sort of the keys, its
// stages under 32 apart by warp shuffles in registers.  (3) The top K
// rows decoded again from raw (their boxes, labels and, offset by label,
// the boxes NMS compares) and written out.  (4) The suppression bit rows
// among the rows that pass conf (a prefix, as the order is by score): a
// warp per 32 x 32 block of pairs, transposed by ballots, the division
// only for pairs within 1e-6 of the threshold.  (5) One warp sweeps the
// rows 32 at a time, with no barrier: lane L holds the words L, L + 32,
// ... of the removed mask; the owner of word w broadcasts it, the lanes
// resolve its 32 rows by a chain of bit tests over their bits within
// word w (each row's broadcast once), and each later word of the kept
// rows is OR-reduced over the warp into its owner's.  Each table (keys,
// offset boxes, removed mask, suppression rows) lives in shared memory
// while the block's 227 KB hold it, else in a global scratch per image
// that the caller allocates beside the outputs (layout()); nothing is
// capped.
// The decode rounds as ATen's CUDA ops do (expf, 1 / (1 + expf(-x)),
// (raw + grid) * stride as two roundings), the IoU keeps iou_xyxy's op
// order, and the library is built without FMA contraction, so scores,
// boxes and keep decisions at the threshold match the plain version's.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDetectThreads = 512;
constexpr size_t kSmemMax = 232448;   // H100: 227 KB a block, opt-in
constexpr size_t kHeader = 16;        // the block's count of rows over conf

// Where an image's tables live: each in shared memory while the block's
// budget holds it (keys first: the sort reads them most), else at the
// same place in the image's slice of the global scratch.
struct Layout {
  int n2, words;                 // sort size (pow2 >= A, 32), words a row
  size_t off[4];                 // keys, boxes, removed, sup: byte offsets
  bool shared[4];
  size_t smem, scratch;          // bytes: shared a block, scratch an image
};

Layout layout(int A, int K) {
  Layout l{};
  l.n2 = 32;                     // whole warps in the sort's shuffles
  while (l.n2 < A) l.n2 <<= 1;
  l.words = (K + 31) / 32;
  const size_t bytes[4] = {8 * (size_t)l.n2, 16 * (size_t)K,
                           4 * (size_t)l.words,
                           4 * (size_t)K * (size_t)l.words};
  l.smem = kHeader;
  for (int t = 0; t < 4; ++t) {
    const size_t n = (bytes[t] + 15) / 16 * 16;
    l.shared[t] = l.smem + n <= kSmemMax;
    size_t& at = l.shared[t] ? l.smem : l.scratch;
    l.off[t] = at;
    at += n;
  }
  return l;
}

struct DetectArgs {
  const float* raw;       // [B, A, D]: raw head outputs, or decoded rows
  const float* grids;     // [A, 2] (null: decoded rows)
  const float* strides;   // [A]
  int A, D, ncls, K;
  float conf, thr, off_scale;
  float* boxes;           // [B, K, 4]
  float* scores;          // [B, K]
  int* labels;            // [B, K]
  uint8_t* valid;         // [B, K]
  unsigned char* scratch; // [B, layout.scratch bytes]
  Layout l;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Score and label of one row (obj * the first max over the classes).
template <bool DECODE>
__device__ __forceinline__ float score_of(const float* r, int ncls,
                                          int* label) {
  const float obj = DECODE ? sigmoid(r[4]) : r[4];
  float best = DECODE ? sigmoid(r[5]) : r[5];
  int lab = 0;
  for (int c = 1; c < ncls; ++c) {
    const float v = DECODE ? sigmoid(r[5 + c]) : r[5 + c];
    if (v > best) {
      best = v;
      lab = c;
    }
  }
  *label = lab;
  return obj * best;
}

// xyxy box of one row: x0 = cx - w / 2, x1 = x0 + w.
template <bool DECODE>
__device__ __forceinline__ float4 box_of(const float* r, const float* grid,
                                         float stride) {
  float cx = r[0], cy = r[1], w = r[2], h = r[3];
  if (DECODE) {
    cx = (cx + grid[0]) * stride;
    cy = (cy + grid[1]) * stride;
    w = expf(w) * stride;
    h = expf(h) * stride;
  }
  const float x0 = cx - w / 2.f, y0 = cy - h / 2.f;
  return make_float4(x0, y0, x0 + w, y0 + h);
}

// Sorting ascending by this key orders by score descending, then by
// anchor ascending.
__device__ __forceinline__ unsigned long long sort_key(float s, int a) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // ascending in s
  return ((unsigned long long)~u << 32) | (unsigned)a;
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  unsigned u = ~(unsigned)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// Intersection and union of two xyxy boxes, as iou_xyxy computes them.
__device__ __forceinline__ void inter_union(float4 a, float4 b, float* inter,
                                            float* u) {
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  *inter = w * h;
  const float area_a = fmaxf(a.z - a.x, 0.f) * fmaxf(a.w - a.y, 0.f);
  const float area_b = fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
  *u = fmaxf(area_a + area_b - *inter, 1e-12f);
}

// The bitonic stages of merge size k that pair keys j < 32 apart, for
// j = j_hi .. 1, on one key a lane (whole warps): shuffles, no memory.
__device__ __forceinline__ unsigned long long warp_stages(
    unsigned long long x, int e, int k, int j_hi) {
  for (int j = j_hi; j > 0; j >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, j);
    // the lower of the pair keeps the min in an ascending run
    const bool low = ((e & j) == 0) == ((e & k) == 0);
    x = low ? (x < y ? x : y) : (x < y ? y : x);
  }
  return x;
}

template <bool DECODE>
__global__ void __launch_bounds__(kDetectThreads) detect_kernel(DetectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& l = a.l;
  const int b = blockIdx.x;
  unsigned char* image = a.scratch + (size_t)b * l.scratch;
  unsigned char* at[4];
  for (int t = 0; t < 4; ++t) at[t] = (l.shared[t] ? smem : image) + l.off[t];
  unsigned long long* keys = (unsigned long long*)at[0];
  float4* sbox = (float4*)at[1];          // [K] offset boxes, score order
  unsigned* removed = (unsigned*)at[2];   // [words]
  unsigned* sup = (unsigned*)at[3];       // [K, words]
  int* s_nv = (int*)smem;
  const float* raw = a.raw + (size_t)b * a.A * a.D;
  const size_t o = (size_t)b * a.K;

  // 1. the keys
  for (int i = threadIdx.x; i < l.n2; i += blockDim.x) {
    unsigned long long k = ~0ull;         // padding: sorts last
    if (i < a.A) {
      int lab;
      const float s = score_of<DECODE>(raw + (size_t)i * a.D, a.ncls, &lab);
      k = sort_key(s >= a.conf ? s : -1.f, i);
    }
    keys[i] = k;
  }
  for (int w = threadIdx.x; w < l.words; w += blockDim.x) removed[w] = 0u;
  if (threadIdx.x == 0) *s_nv = 0;
  __syncthreads();

  // 2. bitonic sort, ascending: merges up to 32 keys and the stages that
  // pair keys under 32 apart in registers (warp_stages), the others
  // through memory with a barrier each
  for (int e = threadIdx.x; e < l.n2; e += blockDim.x) {
    unsigned long long x = keys[e];
    for (int k = 2; k <= 32; k <<= 1) x = warp_stages(x, e, k, k >> 1);
    keys[e] = x;
  }
  __syncthreads();
  for (int k = 64; k <= l.n2; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < l.n2 / 2; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo | j;
        const unsigned long long x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < l.n2; e += blockDim.x)
      keys[e] = warp_stages(keys[e], e, k, 16);
    __syncthreads();
  }

  // 3. the top K, decoded again from raw
  int nv = 0;
  for (int i = threadIdx.x; i < a.K; i += blockDim.x) {
    const unsigned long long k = keys[i];
    const int r = (int)(unsigned)k;
    const float s = key_score(k);
    const float* row = raw + (size_t)r * a.D;
    int lab;
    score_of<DECODE>(row, a.ncls, &lab);
    const float4 bx = box_of<DECODE>(row, DECODE ? a.grids + 2 * r : nullptr,
                                     DECODE ? a.strides[r] : 0.f);
    reinterpret_cast<float4*>(a.boxes)[o + i] = bx;
    a.scores[o + i] = fmaxf(s, 0.f);
    a.labels[o + i] = lab;
    const float off = (float)lab * a.off_scale;
    sbox[i] = make_float4(bx.x + off, bx.y + off, bx.z + off, bx.w + off);
    if (s >= a.conf) ++nv;
    else a.valid[o + i] = 0;
  }
  if (nv) atomicAdd(s_nv, nv);
  __syncthreads();
  nv = *s_nv;                             // rows 0..nv-1 pass conf
  const int nw = (nv + 31) / 32;

  // 4. suppression bits: word w of row j, bit t for row 32w + t in (j, nv).
  // A warp per block of 32 x 32 pairs: word w (lane L: row i = 32w + L,
  // its box in registers) against the rows j of 32c .. 32c + 31, c <= w:
  // each lane tests its 32 pairs (unrolled, independent), then 32
  // ballots transpose the block into the rows' words.  The test IoU >
  // thr divides only near the threshold: with lo and hi 1e-6 of thr
  // below and above it, inter > hi * union puts the exact quotient more
  // than 8 ulps above thr, so its rounding is > thr, and inter < lo *
  // union more than 8 ulps below (disjoint pairs among them); the rare
  // pairs in between take the division (thr not a normal positive
  // float: all pairs).
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const bool exact = !(a.thr >= FLT_MIN && a.thr <= 1e30f);
  const float lo = exact ? -INFINITY : a.thr * 0.999999f;
  const float hi = exact ? INFINITY : a.thr * 1.000001f;
  for (int q = threadIdx.x >> 5; q < nw * (nw + 1) / 2;
       q += blockDim.x >> 5) {
    int w = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while (w * (w + 1) / 2 > q) --w;
    while ((w + 1) * (w + 2) / 2 <= q) ++w;
    const int c = q - w * (w + 1) / 2, i = 32 * w + lane;
    const float4 bi = sbox[min(i, nv - 1)];
    unsigned col = 0u, near = 0u;         // bit t: row 32c + t against i
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int j = 32 * c + t;
      float inter, u;
      inter_union(sbox[min(j, nv - 1)], bi, &inter, &u);
      const bool ok = i > j && i < nv;
      const bool above = inter > hi * u;
      col |= (unsigned)(ok && above) << t;
      near |= (unsigned)(ok && !above && !(inter < lo * u)) << t;
    }
    unsigned word = 0u;                   // lane t: row 32c + t's word
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned bits = __ballot_sync(full, (col >> t) & 1u);
      if (lane == t) word = bits;
    }
    const int j = 32 * c + lane;
    if (j < nv) sup[(size_t)j * l.words + w] = word;
    __syncwarp();
    for (unsigned m = near; m; m &= m - 1) {
      const int t = __ffs(m) - 1;
      float inter, u;
      inter_union(sbox[32 * c + t], bi, &inter, &u);
      if (inter / u > a.thr)
        atomicOr(&sup[(size_t)(32 * c + t) * l.words + w], 1u << lane);
    }
  }
  __syncthreads();

  // 5. the greedy sweep, one warp, a word of 32 rows at a time: lane L
  // keeps the words L, L + 32, ... of the removed mask; the word's rows
  // are decided by a chain of bit tests over their suppression bits
  // within the word (broadcast), then the kept rows' later words are
  // OR-reduced into their owners'
  if (threadIdx.x >= 32) return;
  for (int w = 0; w < nw; ++w) {
    const int r0 = 32 * w, n = min(32, nv - r0);
    const unsigned diag =
        lane < n ? sup[(size_t)(r0 + lane) * l.words + w] : 0u;
    // rows past nv count as removed
    unsigned m = __shfl_sync(full, lane == (w & 31) ? removed[w] : 0u,
                             w & 31) | (n < 32 ? ~0u << n : 0u);
    unsigned keep = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned d = __shfl_sync(full, diag, t);
      if (!(m & (1u << t))) {
        keep |= 1u << t;
        m |= d;
      }
    }
    if (lane < n) a.valid[o + r0 + lane] = (keep >> lane) & 1u;
    // lane t holds kept row r0 + t's word v; their OR goes to v's owner
    const unsigned* row = sup + (size_t)(r0 + lane) * l.words;
    const bool kept = (keep >> lane) & 1u;
    for (int v = w + 1; v < nw; ++v) {
      const unsigned bits = __reduce_or_sync(full, kept ? row[v] : 0u);
      if (lane == (v & 31)) removed[v] |= bits;
    }
  }
}

}  // namespace

// Raises the dynamic shared-memory limit of the K4 kernels, once, when
// the library is loaded.
extern "C" int dagr_nms_init(void) {
  const void* kernels[] = {(const void*)detect_kernel<true>,
                           (const void*)detect_kernel<false>};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Bytes of global scratch an image needs at A anchors and K rows: the
// tables that do not fit in a block's shared memory.
extern "C" long long dagr_detect_scratch(int A, int K) {
  return (long long)layout(A, K).scratch;
}

// K4 over B images of A rows of D floats: raw head outputs decoded with
// grids [A, 2] and strides [A], or (grids null) decoded rows; writes the
// top K = min(max_out, A) rows' boxes, scores, labels and keep.  scratch:
// B * dagr_detect_scratch(A, K) bytes, 16-byte aligned.
extern "C" int dagr_detect(
    const void* raw, const void* grids, const void* strides, int B, int A,
    int D, int ncls, int K, float conf, float thr, float off_scale,
    void* boxes, void* scores, void* labels, void* valid, void* scratch,
    void* stream) {
  // the sort's size, 2 * A at most, is an int
  if (K < 0 || K > A || A > (1 << 30) || ncls < 1 || D < 5 + ncls)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && K > 0) {
    DetectArgs a{(const float*)raw, (const float*)grids,
                 (const float*)strides, A, D, ncls, K, conf, thr, off_scale,
                 (float*)boxes, (float*)scores, (int*)labels,
                 (uint8_t*)valid, (unsigned char*)scratch, layout(A, K)};
    auto kernel = grids ? detect_kernel<true> : detect_kernel<false>;
    kernel<<<B, kDetectThreads, a.l.smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
