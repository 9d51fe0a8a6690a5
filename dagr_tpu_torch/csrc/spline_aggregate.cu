// K7: the streaming engine's gathered spline-conv aggregation,
// g[m, p, c] = sum_k mask * B_p(attr_mk) * x[nbr_mk, c].
//
// Degree-1 open B-spline on a ks x ks grid (spline_taps.cuh): each edge
// touches at most 4 taps, flat tap = kx + ks * ky.
//
// Replaces dagr_tpu/models/functional.py:109 spline_conv_gather (its
// gathers of the source rows and positions, the attribute and basis, and
// the batched dot before the node-level matmul).  C chunk destinations
// (256 to 1024, or 1) read K = 16 sources each from the 50k-row event
// store.  The edge attribute is made in the kernel from the store's and
// the destinations' positions, so no [C, K, 2] table is written; the
// taps then go through the same add_edge as K2's split and fused
// convs (spline_conv.cu).  Bound by the latency
// of the C*K scattered source rows (a 1024-event chunk at Cin = 16 is
// 1 MB of gathers and 1.6 MB of output); at C = 1 one block does it.
// Design: a block holds D = 256 / C destinations (one thread per
// (destination, channel)); each thread accumulates its destination's 25
// taps of its channel in shared memory, slots in order, no atomics; the
// block's g tile is contiguous in global memory in the same [D, P, C]
// layout, so it is written back as one coalesced copy.  The caller
// multiplies g by W with torch.matmul (TF32 off).
#include <cuda_runtime.h>
#include <stdint.h>

#include "spline_taps.cuh"

namespace {

// The block's [nd, P, C] tile in shared memory, zeroed; its global tile
// is the same layout, contiguous, so it is written back as one copy.
__device__ __forceinline__ int zero_tile(float* sg, int m0, int M, int dpb,
                                         int P, int C) {
  const int nd = min(dpb, M - m0);
  const int tile = nd * P * C;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) sg[i] = 0.f;
  __syncthreads();
  return nd;
}

__device__ __forceinline__ void store_tile(const float* sg, float* g, int m0,
                                           int nd, int P, int C) {
  __syncthreads();
  float* gout = g + (size_t)m0 * P * C;
  for (int i = threadIdx.x; i < nd * P * C; i += blockDim.x) gout[i] = sg[i];
}

// M destinations whose sources are rows of a global table, with the edge attribute
// clip((pos_src - pos_dst) / (2 max_value) + 0.5, 0, 1) made here from
// the positions instead of read from an [M, K, 2] table.
__global__ void spline_aggregate_gather_kernel(
    const float* __restrict__ x,          // [N, C] source table
    const float* __restrict__ pos,        // [N, pos_stride] (x, y, ...)
    const float* __restrict__ dst_pos,    // [M, dst_stride]
    const int* __restrict__ nbr,          // [M, K] table rows
    const uint8_t* __restrict__ mask,     // [M, K]
    int M, int K, int C, int ks, int tpd, int dpb, int pos_stride,
    int dst_stride, float two_mv,
    float* __restrict__ g) {              // [M, ks*ks*C]
  extern __shared__ float sg[];
  const int P = ks * ks;
  const int m0 = blockIdx.x * dpb;
  const int nd = zero_tile(sg, m0, M, dpb, P, C);
  const int d = threadIdx.x / tpd, lane = threadIdx.x - d * tpd;
  if (d < nd) {
    const int m = m0 + d;
    float* acc = sg + (size_t)d * P * C;
    const float dx = dst_pos[(size_t)m * dst_stride];
    const float dy = dst_pos[(size_t)m * dst_stride + 1];
    for (int k = 0; k < K; ++k) {
      const size_t mk = (size_t)m * K + k;
      if (!mask[mk]) continue;
      const int src = nbr[mk];
      const float* ps = pos + (size_t)src * pos_stride;
      add_edge(acc, x + (size_t)src * C, (ps[0] - dx) / two_mv + 0.5f,
               (ps[1] - dy) / two_mv + 0.5f, ks, C, lane, tpd);
    }
  }
  store_tile(sg, g, m0, nd, P, C);
}

// threads per destination and destinations per block for C channels
__host__ __forceinline__ void tile_shape(int C, int threads, int* tpd,
                                         int* dpb) {
  *tpd = C < threads ? C : threads;
  *dpb = threads / *tpd;
}

}  // namespace

extern "C" int dagr_spline_aggregate_gather(
    const void* x, const void* pos, const void* dst_pos, const void* nbr,
    const void* mask, int M, int K, int C, int ks, int pos_stride,
    int dst_stride, float two_mv, void* g, void* stream) {
  const int threads = 256;
  int tpd, dpb;
  tile_shape(C, threads, &tpd, &dpb);
  const size_t smem = (size_t)dpb * ks * ks * C * sizeof(float);
  const int blocks = (M + dpb - 1) / dpb;
  if (blocks > 0) {
    spline_aggregate_gather_kernel<<<blocks, threads, smem,
                                     (cudaStream_t)stream>>>(
        (const float*)x, (const float*)pos, (const float*)dst_pos,
        (const int*)nbr, (const uint8_t*)mask, M, K, C, ks, tpd, dpb,
        pos_stride, dst_stride, two_mv, (float*)g);
  }
  return (int)cudaGetLastError();
}
