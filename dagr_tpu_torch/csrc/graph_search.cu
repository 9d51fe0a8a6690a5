// K1: event-graph neighbour search.
//
// Replaces dagr_tpu/graph/build.py:109 build_graph (its sort-merge join
// `sort_core` and the packed-slab FIFO path over graph/slab.py).  Same
// contract as the reference CUDA kernels, captured by the numpy oracle
// dagr_tpu/graph/reference.py: for each valid event e, slot 0 is e
// itself; then up to K-1 older events (index < e), taken cell by cell
// in spiral order over the (2R+1)^2 pixels around e, newest first
// within a pixel, with t_e - t_src <= dt (inclusive).  At each pixel
// only the newest Q events of the whole window are visible (the
// reference inserts the window into its per-pixel FIFO before it
// searches).
//
// What bounds it on an H100: latency of dependent global loads.  Each
// event reads, per spiral cell, its pixel's run bounds and then binary
// searches the run; 81 cells x (2 + log2 run) scattered 4-byte loads,
// with almost no arithmetic.  The working set (run tables 2 x 4 x B*H*W
// bytes, order and positions 16 x B*N bytes: ~1.5 MB at B=1) stays in
// the 50 MB L2, so the loads are L2 hits, not HBM traffic.
//
// Design: the pixel-major stable order and the per-pixel run offsets
// (CSR) are made by the caller (torch.sort + searchsorted), so a pixel's
// events are one contiguous run in index (= time) order.  One thread
// per event walks the spiral: a binary search finds the run entries
// older than e, the queue cap is the run's last Q entries, and the walk
// goes newest-first and stops at the first entry older than dt (the
// window is time-sorted, so every older entry is out too) or at K-1
// picks.  The selection is exact in one pass: no FIFO depth limit and
// no fallback, unlike the TPU's slab path.  The (dx/W, dy/H) of each
// spiral cell comes from a host table, so the float division is the
// same one the plain PyTorch version uses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void graph_search_kernel(
    const int* __restrict__ pos,          // [M, 3] (x, y, t)
    const uint8_t* __restrict__ mask,     // [M]
    const int* __restrict__ order,        // [M] pixel-major stable order
    const int* __restrict__ run_start,    // [B*H*W + 1]
    const int* __restrict__ spiral,       // [S, 2] (dx, dy)
    const float* __restrict__ spiral_dpos,// [S, 2] (dx/W, dy/H)
    float fill_dx, float fill_dy,
    int M, int N, int W, int H, int S, int K, int Q, int dt,
    int* __restrict__ nbr,                // [M, K]
    uint8_t* __restrict__ nbr_mask,       // [M, K]
    float* __restrict__ nbr_dpos) {       // [M, K, 2]
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M) return;
  const int b = e / N;
  int* out = nbr + (size_t)e * K;
  uint8_t* om = nbr_mask + (size_t)e * K;
  float* od = nbr_dpos + (size_t)e * K * 2;
  out[0] = e - b * N;
  om[0] = mask[e];
  od[0] = 0.f;
  od[1] = 0.f;
  int n = 1;
  if (mask[e]) {
    const int x = pos[3 * e], y = pos[3 * e + 1], t = pos[3 * e + 2];
    const int base = b * H * W;
    for (int s = 0; s < S && n < K; ++s) {
      const int dx = spiral[2 * s], dy = spiral[2 * s + 1];
      const int xn = x + dx, yn = y + dy;
      if (xn < 0 || xn >= W || yn < 0 || yn >= H) continue;
      const int p = base + yn * W + xn;
      const int st = run_start[p], en = run_start[p + 1];
      if (st == en) continue;
      const int lo = max(st, en - Q);
      // hi = first run position holding an event not older than e
      int a = st, z = en;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (order[mid] < e) a = mid + 1; else z = mid;
      }
      for (int j = a - 1; j >= lo && n < K; --j) {
        const int src = order[j];
        if (t - pos[3 * src + 2] > dt) break;
        out[n] = src - b * N;
        om[n] = 1;
        od[2 * n] = spiral_dpos[2 * s];
        od[2 * n + 1] = spiral_dpos[2 * s + 1];
        ++n;
      }
    }
  }
  for (; n < K; ++n) {
    out[n] = 0;
    om[n] = 0;
    od[2 * n] = fill_dx;
    od[2 * n + 1] = fill_dy;
  }
}

}  // namespace

extern "C" int dagr_graph_search(
    const void* pos, const void* mask, const void* order,
    const void* run_start, const void* spiral,
    const void* spiral_dpos, float fill_dx, float fill_dy,
    int M, int N, int W, int H, int S, int K, int Q, int dt,
    void* nbr, void* nbr_mask, void* nbr_dpos, void* stream) {
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  if (blocks > 0) {
    graph_search_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const uint8_t*)mask, (const int*)order,
        (const int*)run_start, (const int*)spiral,
        (const float*)spiral_dpos, fill_dx, fill_dy, M, N, W, H, S, K, Q,
        dt, (int*)nbr, (uint8_t*)nbr_mask, (float*)nbr_dpos);
  }
  return (int)cudaGetLastError();
}
