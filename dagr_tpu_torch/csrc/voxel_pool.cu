// K3: voxel-grid graph pooling onto a dense ny x nx cell table.
//
// Replaces dagr_tpu/ops/pool.py:46 pool_graph (its segment_sum /
// segment_max reductions and the stencil adjacency built from the fine
// edges), used by :212 pool_nodeset.  Per cell: the count of valid
// nodes, the max (or mean) of their features, their mean position
// with x, y floored to pixel centres as floor((mean + 1e-5) * W) / W,
// the max timestamp, and the 9-slot stencil adjacency pooled from the
// fine edges (self loops and out-of-stencil edges dropped), masked to
// in-frame, non-empty source and destination cells.
//
// What bounds it on an H100: latency, not bandwidth.  The fine level
// is at most 50k nodes x 16 floats (3.2 MB), read once; the long pole
// is the most crowded cell, whose nodes one warp reduces in order.
//
// Design: the floor in the pooled position flips if the position sum
// rounds differently, so no float atomics are used.  Three launches:
//   1. per fine node (one thread each): its cell id and the 9-bit mask
//      of its valid in-stencil, non-self edges (from nbr_dpos at the
//      event level, from the sources' own positions otherwise);
//   (the caller stable-sorts the cell ids: torch.sort + searchsorted)
//   2. per cell (one warp each): walk the cell's nodes in index order;
//      lanes own feature channels, so every float sum runs in node
//      index order, the same order as the plain PyTorch version's
//      index_add_ on the CPU (bit-equal results); the max, the count
//      and the OR of the edge masks do not depend on order;
//   3. per (cell, stencil slot) (one thread each): the coarse
//      neighbour id and mask adj & in-frame & source non-empty &
//      destination non-empty (& t_max(dst) > t_max(src) when asked).
// Divisions by W and H are reciprocal multiplies, as XLA compiles the
// JAX package's divisions by those constants.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int cell_coord(float p, int n) {
  const float q = fminf(fmaxf(p, 0.f), 0.9999999f);
  return min(max((int)(q * (float)n), 0), n - 1);
}

__global__ void pool_nodes_kernel(
    const float* __restrict__ pos,        // [M, 3]
    const uint8_t* __restrict__ mask,     // [M]
    const uint8_t* __restrict__ nbr_mask, // [M, K]
    const float* __restrict__ nbr_dpos,   // [M, K, 2] or null
    const int* __restrict__ nbr,          // [M, K] global ids (if no dpos)
    int M, int N, int K, int ny, int nx, int pad_seg, int W, int H,
    float inv_w, float inv_h, int* __restrict__ seg, int* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int ncells = ny * nx;
  const int b = i / N;
  const int cx = cell_coord(pos[3 * i], nx);
  const int cy = cell_coord(pos[3 * i + 1], ny);
  if (!mask[i]) {
    seg[i] = pad_seg;   // past every cell: sorts last
    bits[i] = 0;
    return;
  }
  seg[i] = b * ncells + cx + nx * cy;
  int out = 0;
  float xd = 0.f, yd = 0.f;
  if (nbr_dpos) {
    xd = floorf(pos[3 * i] * (float)W + 1e-3f);
    yd = floorf(pos[3 * i + 1] * (float)H + 1e-3f);
  }
  for (int k = 0; k < K; ++k) {
    const size_t ik = (size_t)i * K + k;
    if (!nbr_mask[ik]) continue;
    int sx, sy;
    if (nbr_dpos) {
      const float fx = (xd + rintf(nbr_dpos[2 * ik] * (float)W)) * inv_w;
      const float fy = (yd + rintf(nbr_dpos[2 * ik + 1] * (float)H)) * inv_h;
      sx = cell_coord(fx, nx);
      sy = cell_coord(fy, ny);
    } else {
      const int s = nbr[ik];
      if (!mask[s]) continue;
      sx = cell_coord(pos[3 * s], nx);
      sy = cell_coord(pos[3 * s + 1], ny);
    }
    const int dx = sx - cx, dy = sy - cy;
    if (dx < -1 || dx > 1 || dy < -1 || dy > 1 || (dx == 0 && dy == 0)) continue;
    out |= 1 << ((dy + 1) * 3 + (dx + 1));
  }
  bits[i] = out;
}

__global__ void pool_cells_kernel(
    const int* __restrict__ order,        // [M] nodes sorted by cell
    const int* __restrict__ cell_start,   // [B*ncells + 1]
    const float* __restrict__ feat,       // [M, C]
    const float* __restrict__ pos,        // [M, 3]
    const int* __restrict__ bits,         // [M]
    int n_cells_total, int C, int mean, int W, int H, float inv_w,
    float inv_h, float* __restrict__ pooled, float* __restrict__ pos_out,
    uint8_t* __restrict__ cmask, float* __restrict__ tmax,
    int* __restrict__ adj) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_cells_total) return;
  const int st = cell_start[warp], en = cell_start[warp + 1];
  const int count = en - st;
  const float denom = (float)max(count, 1);
  for (int c = lane; c < C; c += 32) {
    float acc = mean ? 0.f : -FLT_MAX;
    for (int j = st; j < en; ++j) {
      const float v = feat[(size_t)order[j] * C + c];
      if (mean) acc += v; else acc = v > acc ? v : acc;
    }
    float r;
    if (mean) r = acc / denom;
    else r = count > 0 ? acc : 0.f;
    pooled[(size_t)warp * C + c] = r;
  }
  if (lane < 3) {
    float s = 0.f;
    for (int j = st; j < en; ++j) s += pos[3 * order[j] + lane];
    float r = s / denom;
    if (lane == 0) r = floorf((r + 1e-5f) * (float)W) * inv_w;
    if (lane == 1) r = floorf((r + 1e-5f) * (float)H) * inv_h;
    pos_out[3 * warp + lane] = count > 0 ? r : 0.f;
  } else if (lane == 3) {
    float t = -INFINITY;
    for (int j = st; j < en; ++j) t = fmaxf(t, pos[3 * order[j] + 2]);
    tmax[warp] = t;
    cmask[warp] = count > 0;
  } else if (lane == 4) {
    int o = 0;
    for (int j = st; j < en; ++j) o |= bits[order[j]];
    adj[warp] = o;
  }
}

__global__ void pool_stencil_kernel(
    const uint8_t* __restrict__ cmask, const float* __restrict__ tmax,
    const int* __restrict__ adj, int n_cells_total, int ny, int nx,
    int temporal, int* __restrict__ nbr_out, uint8_t* __restrict__ mask_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cells_total * 9) return;
  const int cg = idx / 9, o = idx - cg * 9;
  const int ncells = ny * nx;
  const int b = cg / ncells, c = cg - b * ncells;
  const int xs = c % nx + (o % 3 - 1), ys = c / nx + (o / 3 - 1);
  const bool inb = xs >= 0 && xs < nx && ys >= 0 && ys < ny;
  const int lin = xs + nx * ys;
  nbr_out[idx] = min(max(lin, 0), ncells - 1);
  bool ok = inb && ((adj[cg] >> o) & 1) && cmask[cg];
  if (ok) {
    const int src = b * ncells + lin;
    ok = cmask[src] && (!temporal || tmax[cg] > tmax[src]);
  }
  mask_out[idx] = ok;
}

}  // namespace

extern "C" int dagr_voxel_pool_nodes(
    const void* pos, const void* mask, const void* nbr_mask,
    const void* nbr_dpos, const void* nbr, int M, int N, int K, int ny,
    int nx, int pad_seg, int W, int H, float inv_w, float inv_h, void* seg,
    void* bits, void* stream) {
  const int threads = 256;
  const int blocks = (M + threads - 1) / threads;
  if (blocks > 0) {
    pool_nodes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const uint8_t*)mask, (const uint8_t*)nbr_mask,
        (const float*)nbr_dpos, (const int*)nbr, M, N, K, ny, nx, pad_seg,
        W, H, inv_w, inv_h, (int*)seg, (int*)bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int dagr_voxel_pool_cells(
    const void* order, const void* cell_start, const void* feat,
    const void* pos, const void* bits, int B, int ny, int nx, int C,
    int mean, int temporal, int W, int H, float inv_w, float inv_h,
    void* pooled, void* pos_out, void* cmask, void* tmax, void* adj,
    void* nbr_out, void* mask_out, void* stream) {
  const int total = B * ny * nx;
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) {
    const int threads = 256;   // 8 warps, one cell each
    pool_cells_kernel<<<(total + 7) / 8, threads, 0, s>>>(
        (const int*)order, (const int*)cell_start, (const float*)feat,
        (const float*)pos, (const int*)bits, total, C, mean, W, H, inv_w,
        inv_h, (float*)pooled, (float*)pos_out, (uint8_t*)cmask,
        (float*)tmax, (int*)adj);
    pool_stencil_kernel<<<(total * 9 + threads - 1) / threads, threads, 0, s>>>(
        (const uint8_t*)cmask, (const float*)tmax, (const int*)adj, total,
        ny, nx, temporal, (int*)nbr_out, (uint8_t*)mask_out);
  }
  return (int)cudaGetLastError();
}
