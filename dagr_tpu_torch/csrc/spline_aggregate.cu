// K2: spline-conv aggregation, g[m, p, c] = sum_k mask * B_p(attr_mk) * x[nbr_mk, c].
//
// Replaces the aggregation half of dagr_tpu/ops/spline.py:242
// spline_conv (impl="node_dot": the basis-weighted batched dot before
// the node-level matmul) and of :145 stencil_spline_conv (its 9-step
// shift-accumulate), with the basis of :34 bilinear_basis / :223
// level_basis recomputed in the kernel.  One kernel serves the event
// level (K = 16 graph slots) and the pooled stencil levels (K = 9
// cells, neighbour table given as explicit global cell ids).  The
// caller then multiplies g [M, P*C] by W [P*C, Cout] with torch.matmul
// (TF32 off) and adds the root and bias terms.
//
// Degree-1 open B-spline on a ks x ks grid: each edge touches at most
// 4 taps, flat tap = kx + ks * ky, weights (1-fy)(1-fx), (1-fy)fx,
// fy(1-fx), fy fx with p = clamp(attr, 0, 1) * (ks - 1),
// bottom = clamp(floor(p), 0, ks - 2), frac = p - bottom.
//
// What bounds it on an H100: memory.  It reads M*K random source rows
// (C floats each) plus the per-edge mask/index/attr, and writes
// M * 25 * C floats; 25*C floats of output per 4*C multiply-adds per
// edge, far below the card's compute-to-bandwidth ratio.  At the event
// level (M = 50k, K = 16, C = 16) that is ~80 MB written and ~50 MB of
// gathers per conv.
//
// Design: a block holds D = 256 / C destinations (one thread per
// (destination, channel)); each thread accumulates its destination's
// 25 taps of its channel in shared memory, so there are no atomics and
// the sum over k runs in slot order.  Source rows are read with
// neighbouring threads on neighbouring channels.  The block's g tile
// is contiguous in global memory in the same [D, P, C] layout as the
// shared buffer, so it is written back as one coalesced copy.  The
// GEMM is left to cuBLAS; fusing it (wgmma on the shared tile) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void spline_aggregate_kernel(
    const float* __restrict__ x,          // [Msrc, C]
    const int* __restrict__ nbr,          // [M, K] global source ids
    const uint8_t* __restrict__ mask,     // [M, K]
    const float* __restrict__ attr,       // [M, K, 2]
    int M, int K, int C, int ks, int tpd, int dpb,
    float* __restrict__ g) {              // [M, ks*ks*C]
  extern __shared__ float sg[];           // [dpb, P, C]
  const int P = ks * ks;
  const int m0 = blockIdx.x * dpb;
  const int nd = min(dpb, M - m0);
  const int tile = nd * P * C;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) sg[i] = 0.f;
  __syncthreads();

  const int d = threadIdx.x / tpd, lane = threadIdx.x - d * tpd;
  if (d < nd) {
    const int m = m0 + d;
    float* acc = sg + (size_t)d * P * C;
    const float kmax = (float)(ks - 1);
    for (int k = 0; k < K; ++k) {
      const size_t mk = (size_t)m * K + k;
      if (!mask[mk]) continue;
      const int src = nbr[mk];
      const float px = fminf(fmaxf(attr[2 * mk], 0.f), 1.f) * kmax;
      const float py = fminf(fmaxf(attr[2 * mk + 1], 0.f), 1.f) * kmax;
      const float bx = fminf(fmaxf(floorf(px), 0.f), kmax - 1.f);
      const float by = fminf(fmaxf(floorf(py), 0.f), kmax - 1.f);
      const float fx = px - bx, fy = py - by;
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      const int t00 = ((int)by * ks + (int)bx) * C;
      const int t10 = t00 + ks * C;
      const float* xs = x + (size_t)src * C;
      for (int c = lane; c < C; c += tpd) {
        const float v = xs[c];
        acc[t00 + c] += w00 * v;
        acc[t00 + C + c] += w01 * v;
        acc[t10 + c] += w10 * v;
        acc[t10 + C + c] += w11 * v;
      }
    }
  }
  __syncthreads();
  float* gout = g + (size_t)m0 * P * C;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) gout[i] = sg[i];
}

}  // namespace

extern "C" int dagr_spline_aggregate(
    const void* x, const void* nbr, const void* mask, const void* attr,
    int M, int K, int C, int ks, void* g, void* stream) {
  const int threads = 256;
  const int tpd = C < threads ? C : threads;
  const int dpb = threads / tpd;
  const size_t smem = (size_t)dpb * ks * ks * C * sizeof(float);
  const int blocks = (M + dpb - 1) / dpb;
  if (blocks > 0) {
    spline_aggregate_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)nbr, (const uint8_t*)mask,
        (const float*)attr, M, K, C, ks, tpd, dpb, (float*)g);
  }
  return (int)cudaGetLastError();
}
