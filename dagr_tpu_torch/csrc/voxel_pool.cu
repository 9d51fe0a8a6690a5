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
// is at most 50k nodes x 16 floats (3.2 MB) a window, read once; the
// long poles are the launches and the most crowded cell (400-640 of a
// DSEC window's 45k events), whose position sums must run in node order.
//
// Design: the floor in the pooled position flips if the position sum
// rounds differently, so no float atomics are used.  One C entry,
// dagr_voxel_pool, and no host op between its launches:
//   1. nodes (a thread each): each node's cell id (invalid nodes go to
//      the pad cell B*ny*nx, past the last) and the 9-bit mask of its
//      valid in-stencil, non-self edges (from nbr_dpos at the event
//      level, else from the sources' own positions, the sample's base
//      added to the local neighbour ids here);
//   2. K1's radix sort of the node -> cell map (graph_search.cu's
//      dagr_cell_sort: stable, one pass under 1024 cells and two up to
//      2^20), and cell_start[g], the first sorted position whose cell is
//      >= g, by a binary search per cell (dagr_run_starts).  So order and
//      cell_start are bit-equal to a stable sort by cell id
//      (graph/build.py sorted_runs), at any grid.  The sort's work
//      follows the nodes, not cells x tiles: a one-digit counting sort
//      with each tile's histogram in shared memory (6 launches a pooling
//      against 10) took 0.4005-0.4077 ms of device time over a DAGR-S
//      window's 4 poolings against this route's 0.3775-0.3778, and
//      0.2207 ms against 0.1424 at 96 x 128 cells (an H100 80GB HBM3 at
//      700 W, chip_smoke.py --compare and its P2 phase);
//   3. the cell pass: a block per group of consecutive cells, whose rows
//      are one range of the sorted order, shared by the block's threads
//      whatever the cells' sizes, so a crowded cell is read by a block and
//      not walked by one warp an L2 round trip a row.  The range is staged
//      in shared memory a tile at a time (each thread loads its rows'
//      nodes, then copies their features, positions and edge bits with
//      cp.async, every copy in flight at once).  Then one walker a (cell,
//      channel), a (cell, coordinate) and a cell (max time, OR of the edge
//      bits) adds its cell's rows of the tile in node order, its value
//      carried over tiles, so every float sum (positions; the mean's
//      features) runs from zero in the order of the plain PyTorch
//      version's index_add_ on the CPU.  Max, OR and, for training (a ties
//      pointer given), the exact (max, members equal to it) pair written
//      for K9b are order-free and walk the same way; a crowded block's
//      length is its node-order position walk, a few cycles a row, which
//      splitting them over rows would not shorten.  The shape
//      (cell_pass_plan) was fitted on an H100 over 1-16 cells a block,
//      64-512 threads and 32-1024 rows a tile at the benchmark's
//      poolings.  A DSEC window's first pooling (runs of up to 400-640
//      rows) takes 13-16 us, against 163-236 us with a warp a cell (an
//      H100 80GB HBM3 at 700 W);
//   4. per (cell, stencil slot) (one thread each): the coarse neighbour
//      id and mask adj & in-frame & source non-empty & destination
//      non-empty (& t_max(dst) > t_max(src) when asked).
// Divisions by W and H are reciprocal multiplies, as XLA compiles the
// JAX package's divisions by those constants.  Step 1's node -> cell map
// (seg) is an output: K9b reads it.
//
// K8, level 1 of the multi-stream server's ring window.  Replaces the
// sliding-window update of dagr_tpu/streaming/serve.py:1223-1308: the C
// slots a chunk overwrites leave the cell counts and position sums, the
// chunk's rows enter them, tmax is a running max, and adj_death[cell, o]
// becomes the max source vid over the chunk's edges into stencil offset o
// (an edge is alive while its source still holds its ring slot).  S
// streams fold into the cell id (s*G1 + cell).  dagr_tpu writes the sums
// as (state - sub) + add, each of sub and add taken per cell in slot
// order from zero; any other order can flip the pooled floor (F4), so no
// float atomics.  One C entry, dagr_serve_ring_update, takes the evicted
// and the new cells apart and sorts the 2*S*C rows by cell itself
// (evicted first, then new, each in row order: a stable sort of the
// positions 0..2E-1 keyed in place), with no torch op around it, no
// allocation and no host synchronisation (capturable in a CUDA graph):
//   - up to kCellBlockKeys rows (the S=1 ring step of 256 has 512), one
//     launch of a warp per row: each block of 32 warps sorts all the
//     (cell << 32 | row) words itself in shared memory (a bitonic sort
//     of a few kilobytes, repeated by every block in place of a second
//     launch and a scratch buffer), then each warp takes one sorted
//     position;
//   - beyond, K1's radix sort (graph_search.cu's dagr_cell_sort, 2
//     passes up to 2^20 cells) and one launch of a warp per sorted
//     position.
// Work is in proportion to the rows, not to the S*G1 cells, and no
// warp walks more than one run: a new row's warp takes its edge slots
// over the lanes into adj_death (a warp max per stencil offset, then an
// integer atomicMax: exact in any order); the warp at a run's first
// position reads the run 32 rows at a time (lanes load the rows'
// positions) and lanes 0-2 add them in row order from shuffles (sub
// over the evicted, add over the new, each from zero), with the count
// and a warp max of the new rows' times.  Bound by launch latency: a
// few kilobytes.
//
// K10: the grow window's level-1 update (the streaming engine's and the
// multi-stream server's, S streams folded as above).  Replaces the
// segment_max / segment_sum update of dagr_tpu/streaming/engine.py:247-284:
// per cell the count, the feature max, the position sum, the max time,
// and the stencil adjacency OR-ed in from the chunk's new edges.  The
// same trap as K3: the chunk's position sum is taken per cell in row
// order, from zero, and added to the state once (F4).  K10 is the ring
// update's second client, with no evicted rows: one C entry,
// dagr_stream_accumulate, sorts the Cn rows by cell itself (one launch
// of the per-block sort up to kCellBlockKeys rows: the engine's chunks
// of 1, 256 and 1024; K1's radix sort and one launch beyond: the S=8
// server's 8192), and a row's warp adds its C channels into the cell's
// max with integer atomics on the float's bits (as the cell max below:
// exact, order-free, +0 above -0) and its edge slots' 9 stencil bits (a
// warp OR, then idempotent stores of 1 into adj); the run's first warp
// adds the positions in row order, the count and the time max.  The
// work follows the rows, not the 2240 (S=8: 17,920) cells, and no warp
// walks a crowded cell's rows for their features or edges.  Bound by
// launch latency: a 1024-row chunk is 0.2 MB of features, edges and
// positions.
//
// K8, the ring's feature max.  Replaces dagr_tpu/streaming/serve.py:
// 1361-1376, the segment max of the live x2 ring per level-1 cell, which
// max pooling cannot keep incrementally (an evicted event cannot leave a
// max).  Bound by reading the ring once: S*NR*C1*4 bytes (3.2 MB at S=1,
// NR 50176, C1 16), 1 us at 3.35 TB/s.  A max does not depend on the
// order of its operands, so no sort and no per-cell walk.  One
// cooperative launch of a grid-stride kernel, as many blocks as the card
// holds at once: every thread fills its share of the output with
// -FLT_MAX, the grid synchronises (grid.sync), and each thread then
// takes (row, channel) elements, neighbouring threads on neighbouring
// channels, into their cell with an integer atomic on the float's bits:
// a signed atomicMax for a value whose sign bit is clear (non-negative
// floats order as their bits), an unsigned atomicMin for one whose sign
// bit is set (negative floats order inversely to their bits), and any
// non-negative value's bits beat any negative one's under both.  Exact
// and deterministic (+0 above -0), not a float atomic, and no encode or
// decode pass.
//
// K9b: the backward of K3's pooled features for training.  Replaces what
// jax.grad derives from the segment_max / segment_sum of
// dagr_tpu/ops/pool.py:100-117: for max, JAX's scatter-max rule splits a
// cell's gradient evenly among the members tied at the max, per channel
// (grad * (1 / ties)); for mean, grad / count.  Bound by memory: it reads
// each row's cell and, for max, its features, and writes grad_feat once
// (at the first pooling of a batch of 8, 400k x 16 floats: 26 MB each
// way); the per-cell tables it gathers (grad_pooled, the pooled max, the
// tie counts: ~1 MB) stay in L2.  Design: one element-parallel pass, a
// thread per 4 consecutive channels of a row (16-byte loads and stores
// where C % 4 == 0 and the pointers allow; else one channel), in
// row-major order, so no cell's size sets the kernel's length.  A row's
// cell is K3's step-1 map (seg), the tie counts come from K3's cell pass
// (computed in the forward), the mean's count from cell_start.  Rows in
// no cell get 0 from the kernel: grad_feat is written whole, one launch
// a call.  Exact arithmetic, so it is bit-equal to its twin.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int cell_coord(float p, int n) {
  const float q = fminf(fmaxf(p, 0.f), 0.9999999f);
  return min(max((int)(q * (float)n), 0), n - 1);
}

// K3 step 1: a thread per node of the B samples' M = B*N.
__global__ void pool_nodes_kernel(
    const float* __restrict__ pos,        // [M, 3]
    const uint8_t* __restrict__ mask,     // [M]
    const uint8_t* __restrict__ nbr_mask, // [M, K]
    const float* __restrict__ nbr_dpos,   // [M, K, 2] or null
    const int* __restrict__ nbr,          // [M, K] ids within the sample
    int M, int N, int K, int ny, int nx, int n_cells_total, int W, int H,
    float inv_w, float inv_h, int* __restrict__ seg, int* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int ncells = ny * nx, b = i / N;
  const int cx = cell_coord(pos[3 * i], nx);
  const int cy = cell_coord(pos[3 * i + 1], ny);
  if (!mask[i]) {
    seg[i] = n_cells_total;   // past every cell: sorts last
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
      const int s = b * N + nbr[ik];
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

// K3 step 3: a block per `cells` consecutive cells, its threads over
// their rows; see the file's note.  With TIES, ties [n_cells_total, C]
// gets the members equal to each channel's max.  Dynamic shared memory:
// cell_pass_smem(cells, tile, C) bytes; tile <= kCellRows * blockDim.x.
constexpr int kCellRows = 4;   // rows a thread stages a tile

template <bool TIES>
__global__ void pool_cells_kernel(
    const int* __restrict__ order,        // [M] nodes sorted by cell
    const int* __restrict__ cell_start,   // [B*ncells + 1]
    const float* __restrict__ feat,       // [M, C]
    const float* __restrict__ pos,        // [M, 3]
    const int* __restrict__ bits,         // [M]
    int n_cells_total, int C, int mean, int vec, int cells, int tile,
    int W, int H, float inv_w, float inv_h, float* __restrict__ pooled,
    float* __restrict__ pos_out, uint8_t* __restrict__ cmask,
    float* __restrict__ tmax, int* __restrict__ adj, int* __restrict__ ties) {
  extern __shared__ __align__(16) float smem[];
  float* s_feat = smem;                             // [tile, C]
  float* s_pos = s_feat + tile * C;                 // [tile, 3]
  int* s_bits = (int*)(s_pos + 3 * tile);           // [tile]
  int* s_start = s_bits + tile;                     // [cells + 1]
  float* s_acc = (float*)(s_start + cells + 1);     // [cells, C]
  int* s_cnt = (int*)(s_acc + cells * C);           // [cells, C]
  float* s_sum = (float*)(s_cnt + cells * C);       // [cells, 3]
  float* s_tmax = s_sum + 3 * cells;                // [cells]
  int* s_or = (int*)(s_tmax + cells);               // [cells]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g0 = blockIdx.x * cells;
  const int nc = min(cells, n_cells_total - g0);
  // the block's rows, r0 to r1, read by every thread: no barrier before
  // the first tile's loads
  const int r0 = cell_start[g0], r1 = cell_start[g0 + nc];
  for (int k = tid; k <= nc; k += nt) s_start[k] = cell_start[g0 + k];
  for (int e = tid; e < nc * C; e += nt) {
    s_acc[e] = mean ? 0.f : -FLT_MAX;
    s_cnt[e] = 0;
  }
  for (int e = tid; e < 3 * nc; e += nt) s_sum[e] = 0.f;
  for (int k = tid; k < nc; k += nt) {
    s_tmax[k] = -INFINITY;
    s_or[k] = 0;
  }
  if (r0 == r1) __syncthreads();       // no tile: the outputs' barrier
  // a cell's walkers: its C channels, its 3 coordinates, and one for the
  // max time and the OR of the edge bits
  const int per = C + 4;
  for (int j0 = r0; j0 < r1; j0 += tile) {
    const int n = min(tile, r1 - j0);
    // a thread's rows of the tile: their nodes, then every copy of their
    // features, positions and edge bits in flight at once
    int node[kCellRows];
#pragma unroll
    for (int q = 0; q < kCellRows; ++q) {
      const int i = tid + q * nt;
      node[q] = i < n ? order[j0 + i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kCellRows; ++q) {
      const int i = tid + q * nt;
      if (i >= n) break;
      const size_t o = (size_t)node[q];
      if (vec) {
        for (int c = 0; c < C; c += 4)
          __pipeline_memcpy_async(s_feat + i * C + c, feat + o * C + c, 16);
      } else {
        for (int c = 0; c < C; ++c)
          __pipeline_memcpy_async(s_feat + i * C + c, feat + o * C + c, 4);
      }
      for (int d = 0; d < 3; ++d)
        __pipeline_memcpy_async(s_pos + 3 * i + d, pos + 3 * o + d, 4);
      __pipeline_memcpy_async(s_bits + i, bits + o, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // each walker adds the tile's rows of its cell in node order
    for (int w = tid; w < nc * per; w += nt) {
      const int k = w / per, m = w - k * per;
      const int a = max(s_start[k], j0) - j0;
      const int b = min(s_start[k + 1], j0 + n) - j0;
      if (a >= b) continue;
      if (m < C) {
        const float* f = s_feat + m;
        float acc = s_acc[k * C + m];
        if (mean) {
          for (int i = a; i < b; ++i) acc += f[i * C];
        } else if (TIES) {
          int cnt = s_cnt[k * C + m];
          for (int i = a; i < b; ++i) {
            const float v = f[i * C];
            cnt = v > acc ? 1 : cnt + (v == acc);
            acc = fmaxf(acc, v);
          }
          s_cnt[k * C + m] = cnt;
        } else {
          for (int i = a; i < b; ++i) acc = fmaxf(acc, f[i * C]);
        }
        s_acc[k * C + m] = acc;
      } else if (m < C + 3) {
        const int d = m - C;
        float acc = s_sum[3 * k + d];
        for (int i = a; i < b; ++i) acc += s_pos[3 * i + d];
        s_sum[3 * k + d] = acc;
      } else {
        float t = s_tmax[k];
        int ob = s_or[k];
        for (int i = a; i < b; ++i) {
          t = fmaxf(t, s_pos[3 * i + 2]);
          ob |= s_bits[i];
        }
        s_tmax[k] = t;
        s_or[k] = ob;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nc * C; e += nt) {
    const int count = s_start[e / C + 1] - s_start[e / C];
    const size_t o = (size_t)g0 * C + e;
    pooled[o] = mean ? s_acc[e] / (float)max(count, 1)
                     : count > 0 ? s_acc[e] : 0.f;
    if (TIES) ties[o] = s_cnt[e];
  }
  for (int e = tid; e < 3 * nc; e += nt) {
    const int k = e / 3, d = e - 3 * k;
    const int count = s_start[k + 1] - s_start[k];
    float m = s_sum[e] / (float)max(count, 1);
    if (d == 0) m = floorf((m + 1e-5f) * (float)W) * inv_w;
    if (d == 1) m = floorf((m + 1e-5f) * (float)H) * inv_h;
    pos_out[3 * (size_t)g0 + e] = count > 0 ? m : 0.f;
  }
  for (int k = tid; k < nc; k += nt) {
    tmax[g0 + k] = s_tmax[k];
    cmask[g0 + k] = s_start[k + 1] > s_start[k];
    adj[g0 + k] = s_or[k];
  }
}

// K3 step 3's shape: `cells` a block, `threads` a block and `tile` rows
// staged at a time, in `smem` bytes of dynamic shared memory.
struct CellPass {
  int cells, threads, tile;
  size_t smem;
};

size_t cell_pass_smem(int cells, int tile, int C) {
  return 4 * ((size_t)tile * (C + 4) + cells + 1 + (size_t)cells * (2 * C + 5));
}

// The cell pass's shape at C channels, G cells and M nodes (the file's
// note): an event level, more than 8 nodes a cell, stages 256 rows a
// tile, a pooled level 32; a cell a block up to 16,384 and 2,048 cells,
// 8 beyond.  A tile shrinks to keep a block within 48 KB of shared
// memory; tile 0: C too wide for it.
CellPass cell_pass_plan(int C, int G, long long M) {
  const bool runs = M > 8ll * G;
  CellPass p{G > (runs ? 16384 : 2048) ? 8 : 1, 128, runs ? 256 : 32, 0};
  while (p.tile > 1 && cell_pass_smem(p.cells, p.tile, C) > 48 * 1024)
    p.tile >>= 1;
  if (cell_pass_smem(p.cells, p.tile, C) > 48 * 1024) p.tile = 0;
  p.smem = cell_pass_smem(p.cells, p.tile, C);
  return p;
}

// K8's ring update and K10: a level-1 update by one chunk; see the
// file's note.  Sorted position p holds row(p) of cell(p): rows < n_ev
// leave their cells (the slots a ring chunk evicts: their stored cell and
// position; none in K10), rows >= n_ev are the chunk's events (row -
// n_ev) and enter them.
constexpr int kCellBlockKeys = 2048;  // keys up to this: the per-block sort
constexpr int kCellBlockThreads = 1024;

struct CellArgs {
  const float* ev_pos;    // [n_ev, 3]
  const float* pos;       // [E, 3]
  const int* nbr;         // [E, K] store or ring slots of the edges
  const uint8_t* nbr_mask;  // [E, K]
  const int* cells;       // [N] cell per slot (ncells: none)
  const int* vid;         // [N] vid per slot (the ring)
  const float* feat;      // [E, C] (K10)
  int n_ev, ncells, nx, K, C;
  int* cell_cnt;
  float* pos_sum;
  float* tmax;
  int* adj_death;         // [ncells, 9] (the ring)
  uint8_t* adj;           // [ncells, 9] (K10)
  float* cell_max;        // [ncells, C] (K10)
};

// The per-block sort's words, (cell << 32 | row) in shared memory.
struct SharedRuns {
  const unsigned long long* w;
  __device__ int cell(int p) const { return (int)(w[p] >> 32); }
  __device__ int row(int p) const { return (int)(w[p] & 0xffffffffu); }
};

// The radix path's sorted cells and rows in device memory.
struct GlobalRuns {
  const int* keys;
  const int* order;
  __device__ int cell(int p) const { return keys[p]; }
  __device__ int row(int p) const { return order[p]; }
};

// The stencil offset of the edge from slot src into `cell` (at cx, cy),
// or -1: no cell, out of the stencil, or the self offset.
__device__ __forceinline__ int edge_offset(int src, int cx, int cy,
                                           const CellArgs& a) {
  const int sc = a.cells[src];
  if (sc >= a.ncells) return -1;
  const int dx = sc % a.nx - cx, dy = sc / a.nx - cy;
  if (dx < -1 || dx > 1 || dy < -1 || dy > 1 || (dx == 0 && dy == 0))
    return -1;
  return (dy + 1) * 3 + (dx + 1);
}

// max(*dst, v) on the float's bits, exact in any order (+0 above -0): a
// signed atomicMax for a value whose sign bit is clear (non-negative
// floats order as their bits), an unsigned atomicMin for one whose sign
// bit is set (negative floats order inversely to their bits); any
// non-negative value's bits beat any negative one's under both.
__device__ __forceinline__ void atomic_max_float(float* dst, float v) {
  const int b = __float_as_int(v);
  if (b >= 0) {
    atomicMax(reinterpret_cast<int*>(dst), b);
  } else {
    atomicMin(reinterpret_cast<unsigned*>(dst), (unsigned)b);
  }
}

// What a new row contributes in the ring: adj_death[cell, o] = max(source
// vid) over its edges at stencil offset o (a warp max per offset, then an
// integer atomicMax: exact in any order).
struct RingRow {
  __device__ void operator()(int cell, int row, const CellArgs& a,
                             int lane) const {
    const int cx = cell % a.nx, cy = cell / a.nx;
    int best[9];
#pragma unroll
    for (int o = 0; o < 9; ++o) best[o] = INT_MIN;
    for (int k = lane; k < a.K; k += 32) {
      const size_t rk = (size_t)row * a.K + k;
      if (!a.nbr_mask[rk]) continue;
      const int src = a.nbr[rk];
      const int o = edge_offset(src, cx, cy, a);
      if (o < 0) continue;
      const int v = a.vid[src];
#pragma unroll
      for (int i = 0; i < 9; ++i)
        if (i == o) best[i] = max(best[i], v);
    }
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      const int m = __reduce_max_sync(0xffffffffu, best[o]);
      if (lane == o && m != INT_MIN) atomicMax(a.adj_death + 9 * cell + o, m);
    }
  }
};

// What a new row contributes in K10: its C feature channels into the
// cell's max (lanes over channels, atomic_max_float), and its edges'
// stencil offsets into adj (a warp OR of the 9 bits, then idempotent
// stores of 1).
struct GrowRow {
  __device__ void operator()(int cell, int row, const CellArgs& a,
                             int lane) const {
    const float* f = a.feat + (size_t)row * a.C;
    float* m = a.cell_max + (size_t)cell * a.C;
    for (int c = lane; c < a.C; c += 32) atomic_max_float(m + c, f[c]);
    const int cx = cell % a.nx, cy = cell / a.nx;
    int bits = 0;
    for (int k = lane; k < a.K; k += 32) {
      const size_t rk = (size_t)row * a.K + k;
      if (!a.nbr_mask[rk]) continue;
      const int o = edge_offset(a.nbr[rk], cx, cy, a);
      if (o >= 0) bits |= 1 << o;
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane < 9 && ((bits >> lane) & 1)) a.adj[9 * cell + lane] = 1;
  }
};

// One warp: the count, position sums and time max of `cell`, whose run
// of the n sorted rows starts at position st (and ends at the first
// position of another cell).
template <class Runs>
__device__ void run_sums(const Runs& runs, int st, int n, int cell,
                         const CellArgs& a, int lane) {
  const unsigned full = 0xffffffffu;
  int en = 0;
  if (lane == 0) {            // the cells are sorted: a binary search
    int lo = st + 1, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (runs.cell(mid) == cell) lo = mid + 1; else hi = mid;
    }
    en = lo;
  }
  en = __shfl_sync(full, en, 0);
  // 32 rows at a time: each lane loads a row's position; lanes 0-2 add
  // their coordinate of every row in row order (evicted rows into sub,
  // new ones into add, each from zero); the time max of the new rows
  float sub = 0.f, add = 0.f, tm = -INFINITY;
  int n_ev = 0;
  for (int j0 = st; j0 < en; j0 += 32) {
    const int m = min(32, en - j0);
    int row = 0;
    float px = 0.f, py = 0.f, pt = 0.f;
    if (lane < m) {
      row = runs.row(j0 + lane);
      const float* q = row < a.n_ev ? a.ev_pos + 3 * (size_t)row
                                    : a.pos + 3 * (size_t)(row - a.n_ev);
      px = q[0];
      py = q[1];
      pt = q[2];
      if (row >= a.n_ev) tm = fmaxf(tm, pt);
    }
    const unsigned evicted = __ballot_sync(full, lane < m && row < a.n_ev);
    n_ev += __popc(evicted);
    for (int q = 0; q < m; ++q) {
      const float x = __shfl_sync(full, px, q);
      const float y = __shfl_sync(full, py, q);
      const float t = __shfl_sync(full, pt, q);
      const float v = lane == 0 ? x : lane == 1 ? y : t;
      if ((evicted >> q) & 1) sub += v; else add += v;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    tm = fmaxf(tm, __shfl_xor_sync(full, tm, off));
  if (lane < 3) {
    float* p = a.pos_sum + 3 * (size_t)cell + lane;
    *p = (*p - sub) + add;    // K10: sub is 0, and (s - 0) + add == s + add
  } else if (lane == 3) {
    a.tmax[cell] = fmaxf(a.tmax[cell], tm);
    a.cell_cnt[cell] += (en - st) - 2 * n_ev;
  }
}

// One warp's share of the update at sorted position j: its row's
// contribution if it is a new row, and the run's sums if j starts a
// cell's run.
template <class Row, class Runs>
__device__ void position_update(const Runs& runs, int j, int n,
                                const CellArgs& a, int lane) {
  const int cell = runs.cell(j);
  if (cell >= a.ncells) return;           // rows of no cell sort last
  const int row = runs.row(j);
  if (row >= a.n_ev) Row()(cell, row - a.n_ev, a, lane);
  if (j == 0 || runs.cell(j - 1) != cell) run_sums(runs, j, n, cell, a, lane);
}

// Up to kCellBlockKeys rows: every block sorts all n of them in shared
// memory (position i < n_ev is evicted row i, cell ev_cell[i]; n_ev + i
// new row i, cell cell[i]; a cell outside [0, ncells) sorts as ncells,
// after every cell), then its warps take a sorted position each.  n2: n
// rounded up to a power of 2; n2 words of dynamic shared memory.
template <class Row>
__global__ void __launch_bounds__(kCellBlockThreads) cell_update_block_kernel(
    const int* __restrict__ ev_cell, const int* __restrict__ cell, int n,
    int n2, CellArgs a) {
  extern __shared__ unsigned long long w[];
  for (int i = threadIdx.x; i < n2; i += kCellBlockThreads) {
    unsigned long long key = ~0ull;       // padding: past every row
    if (i < n) {
      const int v = i < a.n_ev ? ev_cell[i] : cell[i - a.n_ev];
      const unsigned c = (unsigned)v < (unsigned)a.ncells ? v : a.ncells;
      key = ((unsigned long long)c << 32) | (unsigned)i;
    }
    w[i] = key;
  }
  __syncthreads();
  // bitonic sort of the distinct words: stable by row within a cell
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kCellBlockThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = w[i], y = w[ixj];
          if ((x > y) == ((i & k) == 0)) {
            w[i] = y;
            w[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  const int j = blockIdx.x * (kCellBlockThreads / 32) + (threadIdx.x >> 5);
  if (j < n)
    position_update<Row>(SharedRuns{w}, j, n, a, threadIdx.x & 31);
}

// The radix path: a warp per sorted position.
template <class Row>
__global__ void cell_update_runs_kernel(const int* __restrict__ keys,
                                        const int* __restrict__ order, int n,
                                        CellArgs a) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (j < n)
    position_update<Row>(GlobalRuns{keys, order}, j, n, a, threadIdx.x & 31);
}

// K8: the feature max of each cell over its rows; -FLT_MAX for a cell
// without rows.  Launched cooperatively (grid.sync between the fill and
// the max); see the file's note.
constexpr int kCellMaxThreads = 256;

__global__ void __launch_bounds__(kCellMaxThreads) cell_max_kernel(
    const int* __restrict__ cells,        // [N] cell per row (ncells: none)
    const float* __restrict__ feat,       // [N, C]
    size_t n_in, int ncells, int C, float* __restrict__ out,  // [ncells, C]
    size_t n_out) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t i = first; i < n_out; i += stride) out[i] = -FLT_MAX;
  cooperative_groups::this_grid().sync();
  for (size_t i = first; i < n_in; i += stride) {
    const int cell = cells[i / C];
    if (cell < 0 || cell >= ncells) continue;
    atomic_max_float(out + (size_t)cell * C + i % C, feat[i]);
  }
}

// K9b: a thread per V consecutive channels (V = 4: 16-byte accesses,
// C % 4 == 0 and aligned pointers) of the M x C grad_feat, row-major.
template <int V>
struct Vec {
  float f[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* __restrict__ p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.f[0] = q.x;
    r.f[1] = q.y;
    r.f[2] = q.z;
    r.f[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.f[i] = p[i];
  }
  return r;
}

template <int V>
__global__ void pool_backward_kernel(
    const int* __restrict__ seg,          // [M] cell per row, G: none
    const int* __restrict__ cell_start,   // [G + 1] (mean: the counts)
    const int* __restrict__ ties,         // [G, C] (max)
    const float* __restrict__ grad_pooled,  // [G, C]
    const float* __restrict__ feat,       // [M, C] (max)
    const float* __restrict__ pooled,     // [G, C] (max)
    size_t n_vec, int C, int G, int mean, float* __restrict__ grad_feat) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const size_t e = t * V, row = e / C;
  const int g = seg[row];
  Vec<V> out;
#pragma unroll
  for (int i = 0; i < V; ++i) out.f[i] = 0.f;
  if (g < G) {
    const size_t pc = (size_t)g * C + (e - row * C);
    const Vec<V> gp = load_vec<V>(grad_pooled + pc);
    if (mean) {
      const float count = (float)(cell_start[g + 1] - cell_start[g]);
#pragma unroll
      for (int i = 0; i < V; ++i) out.f[i] = gp.f[i] / count;
    } else {
      const Vec<V> f = load_vec<V>(feat + e), m = load_vec<V>(pooled + pc);
      int n[V];
      if constexpr (V == 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(ties + pc));
        n[0] = q.x;
        n[1] = q.y;
        n[2] = q.z;
        n[3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) n[i] = ties[pc + i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i)
        out.f[i] = f.f[i] == m.f[i] ? gp.f[i] * (1.f / (float)n[i]) : 0.f;
    }
  }
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(grad_feat + e) =
        make_float4(out.f[0], out.f[1], out.f[2], out.f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) grad_feat[e + i] = out.f[i];
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

extern "C" long long dagr_cell_sort_scratch(int n, int n_ids);
extern "C" int dagr_cell_sort(const void* a, int na, const void* b, int n,
                              int n_ids, void* scratch, void* keys_s,
                              void* order, void* stream);
extern "C" int dagr_run_starts(const void* keys_s, int n, int n_ids,
                               void* run_start, void* stream);

// Scratch words dagr_voxel_pool needs, G = B*ny*nx: bits [M], the radix
// sort's scratch, its sorted cells [M] and adj [G].
extern "C" long long dagr_voxel_pool_scratch(int B, int N, int ny, int nx) {
  const long long M = (long long)B * N, G = (long long)B * ny * nx;
  return M + dagr_cell_sort_scratch((int)M, (int)G) + M + G;
}

// K3: the pooling of B samples of N nodes onto ny x nx cells, with the
// stable cell runs order [M] and cell_start [G + 1], each node's cell
// seg [M] (G: none) and, if ties is not null (max only), the members
// equal to each (cell, channel)'s max, ties [G, C], for K9b.
extern "C" int dagr_voxel_pool(
    const void* feat, const void* pos, const void* mask, const void* nbr_mask,
    const void* nbr_dpos, const void* nbr, int B, int N, int K, int C,
    int ny, int nx, int mean, int temporal, int W, int H, float inv_w,
    float inv_h, void* order, void* cell_start, void* seg_out, void* ties,
    void* scratch, void* pooled, void* pos_out, void* cmask, void* tmax,
    void* nbr_out, void* mask_out, void* stream) {
  // ids of nodes and of (cell, stencil slot) pairs are ints
  if ((long long)B * N > INT_MAX || 9ll * B * ny * nx > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = B * ny * nx, M = B * N;
  const CellPass plan = cell_pass_plan(C, G, M);
  if (plan.tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* seg = (int*)seg_out;
  int* bits = (int*)scratch;
  int* sort = bits + M;
  int* keys_s = sort + dagr_cell_sort_scratch(M, G);
  int* adj = keys_s + M;
  if (M > 0) {
    pool_nodes_kernel<<<(M + 255) / 256, 256, 0, s>>>(
        (const float*)pos, (const uint8_t*)mask, (const uint8_t*)nbr_mask,
        (const float*)nbr_dpos, (const int*)nbr, M, N, K, ny, nx, G, W, H,
        inv_w, inv_h, seg, bits);
  }
  int err = dagr_cell_sort(nullptr, 0, seg, M, G, sort, keys_s, order, s);
  if (err == 0) err = dagr_run_starts(keys_s, M, G + 1, cell_start, s);
  if (err != 0) return err;
  if (G > 0) {
    auto cells = mean || !ties ? pool_cells_kernel<false>
                               : pool_cells_kernel<true>;
    const int vec = C % 4 == 0 && (uintptr_t)feat % 16 == 0;
    cells<<<(G + plan.cells - 1) / plan.cells, plan.threads, plan.smem, s>>>(
        (const int*)order, (const int*)cell_start, (const float*)feat,
        (const float*)pos, bits, G, C, mean, vec, plan.cells, plan.tile, W,
        H, inv_w, inv_h, (float*)pooled, (float*)pos_out, (uint8_t*)cmask,
        (float*)tmax, adj, (int*)ties);
    const int threads = 256;
    pool_stencil_kernel<<<(G * 9 + threads - 1) / threads, threads, 0, s>>>(
        (const uint8_t*)cmask, (const float*)tmax, adj, G, ny, nx, temporal,
        (int*)nbr_out, (uint8_t*)mask_out);
  }
  return (int)cudaGetLastError();
}

namespace {

// Scratch words of a level-1 update over n sorted keys and ncells cells:
// none for the per-block sort; else the radix sort's, its sorted cells
// and rows.
long long cell_update_scratch(int n, int ncells) {
  return n <= kCellBlockKeys ? 0 : dagr_cell_sort_scratch(n, ncells) + 2ll * n;
}

// The n keys (a.n_ev evicted rows of cells ev_cell, then the new rows of
// cells cell) sorted and updated: one launch up to kCellBlockKeys, else
// the radix sort's six launches and one.
template <class Row>
int cell_update(const int* ev_cell, const int* cell, int n, const CellArgs& a,
                void* scratch, cudaStream_t s) {
  if (n == 0 || a.ncells == 0) return (int)cudaGetLastError();
  if (n <= kCellBlockKeys) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    const int per_block = kCellBlockThreads / 32;
    cell_update_block_kernel<Row><<<(n + per_block - 1) / per_block,
                                     kCellBlockThreads,
                                     n2 * sizeof(unsigned long long), s>>>(
        ev_cell, cell, n, n2, a);
  } else {
    int* keys_s = (int*)scratch + dagr_cell_sort_scratch(n, a.ncells);
    int* order = keys_s + n;
    const int err = dagr_cell_sort(ev_cell, a.n_ev, cell, n, a.ncells,
                                   scratch, keys_s, order, s);
    if (err != 0) return err;
    cell_update_runs_kernel<Row><<<(n + 7) / 8, 256, 0, s>>>(keys_s, order,
                                                             n, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch words of dagr_stream_accumulate at Cn rows over ncells cells.
extern "C" long long dagr_stream_accumulate_scratch(int Cn, int ncells) {
  return cell_update_scratch(Cn, ncells);
}

// K10 (see the file's note): the Cn chunk rows sorted by cell and added
// to the level-1 state in place.
extern "C" int dagr_stream_accumulate(
    const void* cell, const void* feat, const void* pos, const void* nbr,
    const void* nbr_mask, const void* cells, int Cn, int ncells, int nx,
    int C, int K, void* cell_cnt, void* cell_max, void* pos_sum, void* tmax,
    void* adj, void* scratch, void* stream) {
  CellArgs a{};
  a.pos = (const float*)pos;
  a.nbr = (const int*)nbr;
  a.nbr_mask = (const uint8_t*)nbr_mask;
  a.cells = (const int*)cells;
  a.feat = (const float*)feat;
  a.ncells = ncells;
  a.nx = nx;
  a.K = K;
  a.C = C;
  a.cell_cnt = (int*)cell_cnt;
  a.pos_sum = (float*)pos_sum;
  a.tmax = (float*)tmax;
  a.adj = (uint8_t*)adj;
  a.cell_max = (float*)cell_max;
  return cell_update<GrowRow>(nullptr, (const int*)cell, Cn, a, scratch,
                              (cudaStream_t)stream);
}

// Scratch words of dagr_serve_ring_update at E rows a chunk over ncells
// cells (2E keys).
extern "C" long long dagr_serve_ring_update_scratch(int E, int ncells) {
  return cell_update_scratch(2 * E, ncells);
}

// K8's ring update (see the file's note): the E evicted and E new rows
// sorted by cell and the state updated in place.
extern "C" int dagr_serve_ring_update(
    const void* ev_cell, const void* cell, const void* ev_pos,
    const void* pos, const void* nbr, const void* nbr_mask,
    const void* cells, const void* vid, int E, int ncells, int nx, int K,
    void* cell_cnt, void* pos_sum, void* tmax, void* adj_death,
    void* scratch, void* stream) {
  CellArgs a{};
  a.ev_pos = (const float*)ev_pos;
  a.pos = (const float*)pos;
  a.nbr = (const int*)nbr;
  a.nbr_mask = (const uint8_t*)nbr_mask;
  a.cells = (const int*)cells;
  a.vid = (const int*)vid;
  a.n_ev = E;
  a.ncells = ncells;
  a.nx = nx;
  a.K = K;
  a.cell_cnt = (int*)cell_cnt;
  a.pos_sum = (float*)pos_sum;
  a.tmax = (float*)tmax;
  a.adj_death = (int*)adj_death;
  return cell_update<RingRow>((const int*)ev_cell, (const int*)cell, 2 * E,
                              a, scratch, (cudaStream_t)stream);
}

extern "C" int dagr_cell_max(
    const void* cells, const void* feat, int N, int ncells, int C, void* out,
    void* stream) {
  size_t n_out = (size_t)ncells * C, n_in = (size_t)N * C;
  if (n_out == 0) return (int)cudaGetLastError();
  // a cooperative grid must fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cell_max_kernel, kCellMaxThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const size_t want =
      ((n_in > n_out ? n_in : n_out) + kCellMaxThreads - 1) / kCellMaxThreads;
  const size_t most = (size_t)sms * per_sm;
  const unsigned blocks = (unsigned)(want < most ? want : most);
  const int* cells_p = (const int*)cells;
  const float* feat_p = (const float*)feat;
  float* out_p = (float*)out;
  void* args[] = {&cells_p, &feat_p, &n_in, &ncells, &C, &out_p, &n_out};
  err = cudaLaunchCooperativeKernel((const void*)cell_max_kernel, blocks,
                                    kCellMaxThreads, args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K9b over M rows of C channels and G cells; ties and pooled only for
// max, feat may be null for mean.
extern "C" int dagr_voxel_pool_backward(
    const void* seg, const void* cell_start, const void* ties,
    const void* grad_pooled, const void* feat, const void* pooled, int M,
    int G, int C, int mean, void* grad_feat, void* stream) {
  const size_t n = (size_t)M * C;
  if (n == 0) return (int)cudaGetLastError();
  const void* ptrs[] = {ties, grad_pooled, feat, pooled, grad_feat};
  bool v4 = C % 4 == 0;
  for (const void* p : ptrs) v4 = v4 && (uintptr_t)p % 16 == 0;
  const int threads = 256;
  const size_t n_vec = v4 ? n / 4 : n;
  const unsigned blocks = (unsigned)((n_vec + threads - 1) / threads);
  auto kernel = v4 ? pool_backward_kernel<4> : pool_backward_kernel<1>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)seg, (const int*)cell_start, (const int*)ties,
      (const float*)grad_pooled, (const float*)feat, (const float*)pooled,
      n_vec, C, G, mean, (float*)grad_feat);
  return (int)cudaGetLastError();
}
