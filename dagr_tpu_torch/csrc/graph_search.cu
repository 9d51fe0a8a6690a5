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
//
// K6: the streaming engine's chunk-against-store search.  Replaces
// dagr_tpu/graph/build.py:389 search_edges_into_store.  The same
// contract for C query events against an N-slot event store that
// already holds them (insert-then-search): older means a smaller
// virtual id (vid), not an earlier slot, because the ring store reuses
// slots; the queue cap is the pixel run's last Q store entries, newer
// ones included.  Store slots are returned, with no self slot.  The
// caller sorts the store by (pixel, vid) every step (an int64 key;
// torch.sort + searchsorted, 50k keys), so each pixel's run is in vid
// order, which is time order; one thread per query walks the spiral
// through the same helper as K1, binary-searching each run for
// vid < q_vid.  No store time sentinel: dead slots sort past the last
// pixel.  Bound like K1 by dependent L2 loads, for C (256 to 1024)
// threads only, so a step launches too few threads to fill the card;
// a persistent per-pixel FIFO that saves the per-step sort is later
// work.
//
// K8 search: the multi-stream server's chunk against its event rings.
// Replaces dagr_tpu/streaming/serve.py:406 _search_sort (the insert /
// expire / query lex merge join, its queue-cap gather) and the picks of
// dagr_tpu/graph/build.py:67 _select_first_k.  K6's contract over S
// lockstep streams: the rings hold the last NR events of each stream
// (slot s*NR + vid % NR), every stream's chunk carries the same vids, so
// the pixel is folded with the stream (s*H*W + pixel) and a query only
// walks its own stream's runs (base = s*H*W).  Each pick also returns
// its spiral index, from which the caller takes the edge's (dx/W, dy/H).
// The caller sorts the S*NR ring slots on the int64 key
// folded pixel * 2^31 + vid and takes the run offsets over S*H*W + 1
// pixels (torch.sort + searchsorted).  Bound like K6 by dependent L2
// loads (the ring tables, 12 bytes a slot, and the 4.9 MB run table at
// S=8 fit the 50 MB L2); S*C threads (8192 at S=8, chunk 1024) fill the
// card better than K6's C.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The spiral walk shared by K1, K6 and K8.  Appends to slots n.. of one
// event's row the older events (older(slot) true) of each in-frame
// spiral cell's run, newest first, at most the run's last Q entries,
// while t - time_of(src) <= dt, until the row holds K entries; returns
// the new count.  The run's entries must be in time order, older ones
// first.
template <class TimeOf, class Older, class Emit>
__device__ __forceinline__ int spiral_walk(
    int x, int y, int t, int base, int W, int H, TimeOf time_of,
    const int* __restrict__ order, const int* __restrict__ run_start,
    const int* __restrict__ spiral, int S, int K, int Q, int dt, int n,
    Older older, Emit emit) {
  for (int s = 0; s < S && n < K; ++s) {
    const int xn = x + spiral[2 * s], yn = y + spiral[2 * s + 1];
    if (xn < 0 || xn >= W || yn < 0 || yn >= H) continue;
    const int p = base + yn * W + xn;
    const int st = run_start[p], en = run_start[p + 1];
    if (st == en) continue;
    const int lo = max(st, en - Q);
    // first run position holding an entry that is not older
    int a = st, z = en;
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (older(order[mid])) a = mid + 1; else z = mid;
    }
    for (int j = a - 1; j >= lo && n < K; --j) {
      const int src = order[j];
      if (t - time_of(src) > dt) break;
      emit(n, src, s);
      ++n;
    }
  }
  return n;
}

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
    n = spiral_walk(
        pos[3 * e], pos[3 * e + 1], pos[3 * e + 2], b * H * W, W, H,
        [=](int o) { return pos[3 * o + 2]; }, order, run_start, spiral, S,
        K, Q, dt, n,
        [=](int o) { return o < e; },
        [=](int i, int src, int s) {
          out[i] = src - b * N;
          om[i] = 1;
          od[2 * i] = spiral_dpos[2 * s];
          od[2 * i + 1] = spiral_dpos[2 * s + 1];
        });
  }
  for (; n < K; ++n) {
    out[n] = 0;
    om[n] = 0;
    od[2 * n] = fill_dx;
    od[2 * n + 1] = fill_dy;
  }
}

// K6: C query events against an N-slot store that already holds them.
// Older means a smaller virtual id (vid; the slot itself when the store
// is append-only, store_vid == null).  Row q gets up to K store slots.
__global__ void graph_search_store_kernel(
    const int* __restrict__ store_pos,    // [N, 3] (x, y, t)
    const int* __restrict__ store_vid,    // [N] or null: vid == slot
    const int* __restrict__ order,        // [N] slots by (pixel, vid)
    const int* __restrict__ run_start,    // [H*W + 1]
    const int* __restrict__ q_pos,        // [C, 3]
    const int* __restrict__ q_vid,        // [C]
    const uint8_t* __restrict__ q_valid,  // [C]
    const int* __restrict__ spiral,       // [S, 2]
    int C, int W, int H, int S, int K, int Q, int dt,
    int* __restrict__ nbr,                // [C, K]
    uint8_t* __restrict__ nbr_mask) {     // [C, K]
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= C) return;
  int* out = nbr + (size_t)q * K;
  uint8_t* om = nbr_mask + (size_t)q * K;
  int n = 0;
  if (q_valid[q]) {
    const int v = q_vid[q];
    n = spiral_walk(
        q_pos[3 * q], q_pos[3 * q + 1], q_pos[3 * q + 2], 0, W, H,
        [=](int o) { return store_pos[3 * o + 2]; }, order, run_start,
        spiral, S, K, Q, dt, n,
        [=](int o) { return (store_vid ? store_vid[o] : o) < v; },
        [=](int i, int src, int) {
          out[i] = src;
          om[i] = 1;
        });
  }
  for (; n < K; ++n) {
    out[n] = 0;
    om[n] = 0;
  }
}

// K8: E = S*C query events (stream-major, query q in stream q / C)
// against the S*NR-slot rings that already hold them.  Row q gets up to
// K ring slots, their mask and their spiral indices.
__global__ void serve_search_kernel(
    const int* __restrict__ ring_t,       // [S*NR] event time per slot
    const int* __restrict__ ring_vid,     // [S*NR] vid per slot
    const int* __restrict__ order,        // [S*NR] slots by (folded pixel, vid)
    const int* __restrict__ run_start,    // [S*H*W + 1]
    const int* __restrict__ q_pos,        // [E, 3]
    const int* __restrict__ q_vid,        // [C], the same in every stream
    const uint8_t* __restrict__ q_valid,  // [E]
    const int* __restrict__ spiral,       // [NS, 2]
    int E, int C, int W, int H, int NS, int K, int Q, int dt,
    int* __restrict__ nbr,                // [E, K]
    uint8_t* __restrict__ nbr_mask,       // [E, K]
    int* __restrict__ nbr_spiral) {       // [E, K]
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= E) return;
  int* out = nbr + (size_t)q * K;
  uint8_t* om = nbr_mask + (size_t)q * K;
  int* os = nbr_spiral + (size_t)q * K;
  int n = 0;
  if (q_valid[q]) {
    const int v = q_vid[q % C];
    n = spiral_walk(
        q_pos[3 * q], q_pos[3 * q + 1], q_pos[3 * q + 2], (q / C) * W * H, W,
        H, [=](int o) { return ring_t[o]; }, order, run_start, spiral, NS, K,
        Q, dt, n, [=](int o) { return ring_vid[o] < v; },
        [=](int i, int src, int s) {
          out[i] = src;
          om[i] = 1;
          os[i] = s;
        });
  }
  for (; n < K; ++n) {
    out[n] = 0;
    om[n] = 0;
    os[n] = 0;
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

extern "C" int dagr_graph_search_store(
    const void* store_pos, const void* store_vid, const void* order,
    const void* run_start, const void* q_pos, const void* q_vid,
    const void* q_valid, const void* spiral, int C, int W, int H, int S,
    int K, int Q, int dt, void* nbr, void* nbr_mask, void* stream) {
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  if (blocks > 0) {
    graph_search_store_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)store_pos, (const int*)store_vid, (const int*)order,
        (const int*)run_start, (const int*)q_pos, (const int*)q_vid,
        (const uint8_t*)q_valid, (const int*)spiral, C, W, H, S, K, Q, dt,
        (int*)nbr, (uint8_t*)nbr_mask);
  }
  return (int)cudaGetLastError();
}

extern "C" int dagr_serve_search(
    const void* ring_t, const void* ring_vid, const void* order,
    const void* run_start, const void* q_pos, const void* q_vid,
    const void* q_valid, const void* spiral, int E, int C, int W, int H,
    int NS, int K, int Q, int dt, void* nbr, void* nbr_mask,
    void* nbr_spiral, void* stream) {
  const int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  if (blocks > 0) {
    serve_search_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)ring_t, (const int*)ring_vid, (const int*)order,
        (const int*)run_start, (const int*)q_pos, (const int*)q_vid,
        (const uint8_t*)q_valid, (const int*)spiral, E, C, W, H, NS, K, Q,
        dt, (int*)nbr, (uint8_t*)nbr_mask, (int*)nbr_spiral);
  }
  return (int)cudaGetLastError();
}
