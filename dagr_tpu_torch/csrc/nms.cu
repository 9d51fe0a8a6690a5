// K4: confidence filter, top-K and class-aware greedy NMS, per image.
//
// Replaces dagr_tpu/ops/nms.py:54 postprocess with its :29 nms_mask and
// :19 iou_xyxy (the decode, models/head.py:169 decode_outputs, stays
// elementwise PyTorch).  Per image: boxes xyxy from (cx, cy, w, h),
// label = first argmax over the classes, score = obj * max(cls), scores
// under conf set to -1; the top K = min(max_out, A) by score, ties
// broken by the lower anchor index (lax.top_k's order; torch.topk on
// CUDA does not promise it, so the order is made here); then greedy
// NMS at IoU > thr over boxes offset by label * (max(W, H) + 1), so
// boxes of different classes never overlap.  Outputs are fixed-size,
// in score order: boxes, max(score, 0), labels, keep.
//
// What bounds it on an H100: nothing but launch latency at DAGR's size
// (175 anchors, 175^2 / 2 IoUs per image).  The greedy sweep is
// inherently sequential.
//
// Design: one block per image, everything in shared memory.  The rank
// of each anchor (how many beat it) is counted by one thread per
// anchor, which gives the order with its tie rule in one pass; the
// suppression matrix is built in parallel as bit rows (integer atomicOr
// on shared words, exact); then one thread sweeps the K rows in order,
// OR-ing the rows of kept boxes into a removed mask (registers, K/32
// words).  The IoU uses the same op order as iou_xyxy and the library
// is built without FMA contraction, so keep decisions at the threshold
// match the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAnchors = 384;   // shared memory stays under 48 KB
constexpr int kMaxWords = kMaxAnchors / 32;

__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float w = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]), 0.f);
  const float h = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]), 0.f);
  const float inter = w * h;
  const float area_a = fmaxf(a[2] - a[0], 0.f) * fmaxf(a[3] - a[1], 0.f);
  const float area_b = fmaxf(b[2] - b[0], 0.f) * fmaxf(b[3] - b[1], 0.f);
  return inter / fmaxf(area_a + area_b - inter, 1e-12f);
}

__global__ void nms_kernel(
    const float* __restrict__ pred,   // [B, A, D] decoded (cx, cy, w, h, obj, cls...)
    int A, int D, int ncls, int K, float conf, float thr, float off_scale,
    float* __restrict__ boxes_out,    // [B, K, 4]
    float* __restrict__ scores_out,   // [B, K]
    int* __restrict__ labels_out,     // [B, K]
    uint8_t* __restrict__ valid_out) {  // [B, K]
  extern __shared__ float smem[];
  float* s_score = smem;                        // [A]
  float* s_box = s_score + A;                   // [A, 4]
  float* s_sbox = s_box + 4 * A;                // [K, 4] offset boxes, score order
  int* s_label = (int*)(s_sbox + 4 * K);        // [A]
  int* s_idx = s_label + A;                     // [K]
  uint8_t* s_tv = (uint8_t*)(s_idx + K);        // [K]
  const int words = (K + 31) / 32;
  unsigned* s_sup = (unsigned*)(smem + 6 * A + 5 * K + (K + 3) / 4);  // [K, words]

  const int b = blockIdx.x;
  const float* p = pred + (size_t)b * A * D;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float* r = p + (size_t)a * D;
    const float x0 = r[0] - r[2] / 2.f, y0 = r[1] - r[3] / 2.f;
    s_box[4 * a] = x0;
    s_box[4 * a + 1] = y0;
    s_box[4 * a + 2] = x0 + r[2];
    s_box[4 * a + 3] = y0 + r[3];
    float best = r[5];
    int lab = 0;
    for (int c = 1; c < ncls; ++c) {
      if (r[5 + c] > best) { best = r[5 + c]; lab = c; }
    }
    const float score = r[4] * best;
    s_score[a] = score >= conf ? score : -1.f;
    s_label[a] = lab;
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) s_idx[i] = 0;
  for (int i = threadIdx.x; i < K * words; i += blockDim.x) s_sup[i] = 0u;
  __syncthreads();

  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float sa = s_score[a];
    int rank = 0;
    for (int o = 0; o < A; ++o) {
      const float so = s_score[o];
      rank += (so > sa) || (so == sa && o < a);
    }
    if (rank < K) s_idx[rank] = a;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int a = s_idx[i];
    const float s = s_score[a];
    const int lab = s_label[a];
    const float off = (float)lab * off_scale;
    float* out = boxes_out + ((size_t)b * K + i) * 4;
    for (int c = 0; c < 4; ++c) {
      out[c] = s_box[4 * a + c];
      s_sbox[4 * i + c] = s_box[4 * a + c] + off;
    }
    scores_out[(size_t)b * K + i] = fmaxf(s, 0.f);
    labels_out[(size_t)b * K + i] = lab;
    s_tv[i] = s >= conf;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < K * K; q += blockDim.x) {
    const int j = q / K, i = q - j * K;
    if (j < i && iou(s_sbox + 4 * j, s_sbox + 4 * i) > thr)
      atomicOr(&s_sup[j * words + i / 32], 1u << (i % 32));
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    unsigned removed[kMaxWords];
    for (int w = 0; w < words; ++w) removed[w] = 0u;
    for (int i = 0; i < K; ++i) {
      const bool keep = s_tv[i] && !((removed[i / 32] >> (i % 32)) & 1u);
      if (keep) {
        for (int w = 0; w < words; ++w) removed[w] |= s_sup[i * words + w];
      }
      valid_out[(size_t)b * K + i] = keep;
    }
  }
}

}  // namespace

extern "C" int dagr_nms(
    const void* pred, int B, int A, int D, int ncls, int K, float conf,
    float thr, float off_scale, void* boxes, void* scores, void* labels,
    void* valid, void* stream) {
  if (A > kMaxAnchors || K > A) return (int)cudaErrorInvalidValue;
  const int words = (K + 31) / 32;
  const size_t smem =
      (size_t)(6 * A + 5 * K + (K + 3) / 4 + K * words) * sizeof(float);
  if (B > 0) {
    nms_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
        (const float*)pred, A, D, ncls, K, conf, thr, off_scale,
        (float*)boxes, (float*)scores, (int*)labels, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}
