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
// (TF32 off) and adds the root and bias terms.  This is the training
// route (autograd needs g) and the multi-stream server's two event
// convs; an eval conv block runs spline_conv.cu instead, which builds
// g in shared memory and never writes it.
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
// GEMM is left to cuBLAS on this route.
//
// K7: the streaming engine's gathered aggregation.  Replaces
// dagr_tpu/models/functional.py:109 spline_conv_gather (its gathers of
// the source rows and positions, the attribute and basis, and the
// batched dot before the node-level matmul).  C chunk destinations
// (256 to 1024, or 1) read K = 16 sources each from the 50k-row event
// store.  The edge attribute is made in the kernel from the store's and
// the destinations' positions, so no [C, K, 2] table is written; the
// taps then go through the same add_edge as K2.  Bound by the latency
// of the C*K scattered source rows (a 1024-event chunk at Cin = 16 is
// 1 MB of gathers and 1.6 MB of output); at C = 1 one block does it.
//
// K9a: the backward of K2 for training, grad_x = A^T grad_g.  Replaces
// what jax.grad derives from dagr_tpu/ops/spline.py:242 spline_conv and
// :145 stencil_spline_conv (the scatter-add transpose of their source
// gathers): grad_x[s, c] = sum over edges (m, k) with nbr = s of
// mask * sum_p B_p(attr_mk) * grad_g[m, p, c].  The caller gives the
// transposed CSR of the level's masked edges (edge ids stable-sorted by
// source: order, start).  What bounds it on an H100: memory.  It reads
// the grad_g taps its edges touch (4 of C floats per edge, at most the
// M * 25 * C floats of grad_g) and writes n_src * C floats: at the event
// level of a batch of 8 (400k destinations, C = 16) at most 640 MB read
// and 26 MB written.  Design:
// a group of tpr = min(32, pow2 >= C) lanes per source row, lanes over
// channels; the group walks the row's edges in edge order, recomputes
// each edge's 4 taps with K2's edge_taps and sums them in registers, then
// writes its grad_x row once.  No atomics, so the sum order is fixed and
// the result deterministic (F4); a row without edges gets 0.
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
  const int nd = zero_tile(sg, m0, M, dpb, P, C);
  const int d = threadIdx.x / tpd, lane = threadIdx.x - d * tpd;
  if (d < nd) {
    const int m = m0 + d;
    float* acc = sg + (size_t)d * P * C;
    for (int k = 0; k < K; ++k) {
      const size_t mk = (size_t)m * K + k;
      if (!mask[mk]) continue;
      add_edge(acc, x + (size_t)nbr[mk] * C, attr[2 * mk], attr[2 * mk + 1],
               ks, C, lane, tpd);
    }
  }
  store_tile(sg, g, m0, nd, P, C);
}

// K7: the same aggregation for M destinations whose sources are rows of
// a global table, with the edge attribute
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

// K9a: grad_x of n_src source rows; tpr lanes per row, rows_pb rows per
// block.  Edge e = order[j] is slot e % K of destination e / K.
__global__ void spline_aggregate_backward_kernel(
    const float* __restrict__ grad_g,     // [M, ks*ks*C]
    const float* __restrict__ attr,       // [M, K, 2]
    const int* __restrict__ order,        // [M*K] edge ids by source
    const int* __restrict__ start,        // [n_src + 1]
    int n_src, int K, int C, int ks, int tpr, int rows_pb,
    float* __restrict__ grad_x) {         // [n_src, C]
  const int r = threadIdx.x / tpr, lane = threadIdx.x - r * tpr;
  const int row = blockIdx.x * rows_pb + r;
  if (row >= n_src) return;
  const int st = start[row], en = start[row + 1];
  const size_t PC = (size_t)ks * ks * C;
  for (int c = lane; c < C; c += tpr) {
    float acc = 0.f;
    for (int j = st; j < en; ++j) {
      const int e = order[j];
      const Taps t = edge_taps(attr[2 * (size_t)e], attr[2 * (size_t)e + 1],
                               ks, C);
      const float* gg = grad_g + (size_t)(e / K) * PC + c;
      float v = t.w00 * gg[t.t00];
      v += t.w01 * gg[t.t00 + C];
      v += t.w10 * gg[t.t10];
      v += t.w11 * gg[t.t10 + C];
      acc += v;
    }
    grad_x[(size_t)row * C + c] = acc;
  }
}

// threads per destination and destinations per block for C channels
__host__ __forceinline__ void tile_shape(int C, int threads, int* tpd,
                                         int* dpb) {
  *tpd = C < threads ? C : threads;
  *dpb = threads / *tpd;
}

}  // namespace

extern "C" int dagr_spline_aggregate(
    const void* x, const void* nbr, const void* mask, const void* attr,
    int M, int K, int C, int ks, void* g, void* stream) {
  const int threads = 256;
  int tpd, dpb;
  tile_shape(C, threads, &tpd, &dpb);
  const size_t smem = (size_t)dpb * ks * ks * C * sizeof(float);
  const int blocks = (M + dpb - 1) / dpb;
  if (blocks > 0) {
    spline_aggregate_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)nbr, (const uint8_t*)mask,
        (const float*)attr, M, K, C, ks, tpd, dpb, (float*)g);
  }
  return (int)cudaGetLastError();
}

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

extern "C" int dagr_spline_aggregate_backward(
    const void* grad_g, const void* attr, const void* order,
    const void* start, int n_src, int K, int C, int ks, void* grad_x,
    void* stream) {
  const int threads = 256;
  int tpr = 1;
  while (tpr < C && tpr < 32) tpr *= 2;
  const int rows_pb = threads / tpr;
  const int blocks = (n_src + rows_pb - 1) / rows_pb;
  if (blocks > 0 && C > 0) {
    spline_aggregate_backward_kernel<<<blocks, threads, 0,
                                       (cudaStream_t)stream>>>(
        (const float*)grad_g, (const float*)attr, (const int*)order,
        (const int*)start, n_src, K, C, ks, tpr, rows_pb, (float*)grad_x);
  }
  return (int)cudaGetLastError();
}
