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
// What bounds it on an H100: latency, of dependent loads and of
// launches.  Each event reads, per spiral cell, its pixel's run bounds
// and binary-searches the run, with almost no arithmetic; the working
// set (the run table, 4 x (B*H*W + 1) bytes, and the sorted order and
// times, 8 x B*N bytes: ~0.7 MB at B=1) stays in the 50 MB L2.  The
// bytes the function must move are its inputs and outputs (~11 MB at
// B=1, N=50k, K=16): ~3 us.
//
// Design: one C entry, dagr_graph_search, does the whole graph with no
// host op between its launches, no allocation (the caller passes one
// scratch buffer, sized by dagr_graph_search_scratch) and no host
// synchronisation, so it can be captured in a CUDA graph:
//   1. the events' pixel-major stable order, by an LSD radix sort of the
//      pixel id b*H*W + y*W + x (invalid events B*H*W, past the last
//      pixel): 17 bits at B=1, 20 at B=8, so 2 passes of <= 10 bits.
//      Each pass is K3's counting sort with digits in place of cells: a
//      per-tile histogram in shared memory; one block scanning the
//      (digit, tile) counts in digit-major order; a stable scatter (a
//      warp per 256 keys of a tile, each warp's offsets from its digit
//      counts, equal digits ranked with __match_any_sync).  Index order
//      within a pixel is time order (events are time-sorted per sample),
//      and the last pass also writes the sorted events' times.  The sort
//      takes any int key and the index it sorts through a functor (K6
//      and K8 sort store slots with it, K8's ring update its rows by
//      cell through dagr_cell_sort);
//   2. run_start[p] for every pixel id p <= B*H*W: a binary search of the
//      sorted keys per pixel (empty pixels included);
//   3. a warp per event: lanes take the spiral cells in rounds of 32.  A
//      lane finds its cell's slice [lo, hi) of the pixel's run by two
//      binary searches: hi ends the entries older than e, lo is the
//      larger of the queue cap (the run's last Q entries) and the first
//      entry within dt.  A warp inclusive scan of the counts in spiral
//      order places each lane's picks (newest first) in shared memory;
//      the warp stops after the round that fills K-1.  Lanes 0..K-1 then
//      write the row's nbr, nbr_mask and nbr_dpos with coalesced stores.
// This is the formulation of the plain PyTorch version (build_graph_plain
// with _pick_from_runs), so the two agree bit for bit.  The selection is
// exact in one pass: no FIFO depth limit and no fallback, unlike the
// TPU's slab path.  The (dx/W, dy/H) of each spiral cell comes from a
// host table (dx * f32(1/W), as XLA compiles the JAX package's division),
// never from a division here.
//
// K6: the streaming engine's chunk-against-store search.  Replaces
// dagr_tpu/graph/build.py:389 search_edges_into_store.  The same
// contract for C query events against an N-slot event store that
// already holds them (insert-then-search): older means a smaller
// virtual id (vid), not an earlier slot, because the ring store reuses
// slots; the queue cap is the pixel run's last Q store entries, newer
// ones included.  Store slots are returned, with no self slot.
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
//
// K6 and K8 are K1's three steps over store slots, one C entry each
// (dagr_graph_search_store, dagr_serve_search), with no host op between
// launches, no allocation and no host synchronisation:
//   1. the slots by (pixel, vid), by K1's radix sort of the pixel alone
//      (17 bits for the store at 240x320, 20 for S=8 folded rings; 2
//      passes) over the slots enumerated in vid order, so that the
//      stable sort leaves each pixel's run in vid order, which is time
//      order.  The append-only store (no vid table) enumerates its slots
//      in order: vid == slot.  A ring of NR slots (the engine's ring
//      store, N slots; each of the server's S rings) holds live vids in
//      one window of NR consecutive values whose slot is vid mod NR
//      (streaming/engine.py's slot = vid % N, streaming/serve.py's
//      slots n0 % NR with NR a multiple of the chunk): one block finds
//      the newest vid of all slots, and position k of a ring is the slot
//      of vid newest - NR + 1 + k.  A slot whose vid is not that one
//      (never written, or a caller that breaks the window) sorts as
//      dead, past the last pixel, with the slots that hold no event, so
//      a broken window loses edges but reads nothing out of bounds.
//      The last pass writes the sorted slots' times and vids beside
//      their order, so the search reads contiguous arrays;
//   2. the run table over H*W + 1 (S*H*W + 1) pixel ids, as K1's;
//   3. a warp per query, as K1's search, with "older" meaning a sorted
//      vid below the query's: lanes take spiral cells in rounds of 32,
//      two binary searches per cell, a warp scan places the picks, lanes
//      0..K-1 store the row (and K8's spiral indices) coalesced.
// Bound like K1 by dependent L2 loads and by launches: the store's
// tables (16 bytes a slot after the sort) and the 4.9 MB run table of
// S=8 folded rings stay in the 50 MB L2; the bytes the function must
// move (~0.7 MB for K6 at C=1024, ~2 MB for K8 at S=8) take under a
// microsecond.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// ---- step 1: a stable LSD radix sort of int keys ------------------------

constexpr int kSortTile = 2048;           // keys per tile
constexpr int kSortThreads = 256;         // 8 warps, 256 keys of a tile each
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxDigitBits = 10;         // <= 1024 digits a pass

// A sort's first pass reads key(i) and the index it sorts, index(i), of
// position i through a functor; later passes read the previous pass's
// output.

// K1's key: the pixel id b*H*W + y*W + x, B*H*W for an invalid event.
struct PixelKey {
  const int* pos;
  const uint8_t* mask;
  int N, W, HW, invalid;
  __device__ int operator()(int i) const {
    return mask[i] ? (i / N) * HW + pos[3 * i + 1] * W + pos[3 * i] : invalid;
  }
  __device__ int index(int i) const { return i; }
};

// K6 and K8: the slots of rings of NR slots enumerated in vid order (see
// the file's note).  win = {the slot of the window's first vid, the
// newest vid}, from vid_window_kernel.  Without a vid table the slot
// is the position (vid == slot).
struct VidOrder {
  const int* vid;
  const int* win;
  int NR;
  __device__ int slot(int j) const {
    if (!vid) return j;
    const int r = j / NR;
    int s = win[0] + (j - r * NR);
    if (s >= NR) s -= NR;
    return r * NR + s;
  }
  // whether slot s, at position j, holds the vid the window puts there
  __device__ bool holds(int j, int s) const {
    return !vid ||
           (long long)vid[s] == (long long)win[1] - (NR - 1) + (j % NR);
  }
};

// K6's key: the store slot's pixel y*W + x; H*W (dead) for a slot that is
// not valid, lies outside the frame or is not where the window puts it.
struct StoreKey {
  VidOrder ord;
  const int* pos;
  const uint8_t* valid;
  int W, dead;
  __device__ int operator()(int j) const {
    const int s = ord.slot(j);
    if (!valid[s] || !ord.holds(j, s)) return dead;
    const unsigned p = (unsigned)(pos[3 * s + 1] * W + pos[3 * s]);
    return p < (unsigned)dead ? (int)p : dead;
  }
  __device__ int index(int j) const { return ord.slot(j); }
};

// K8's key: the ring slot's folded pixel; S*H*W (dead) for a slot that
// holds no event or is not where the window puts it.
struct RingKey {
  VidOrder ord;
  const int* pix;
  int dead;
  __device__ int operator()(int j) const {
    const int s = ord.slot(j);
    const unsigned p = (unsigned)pix[s];
    return p < (unsigned)dead && ord.holds(j, s) ? (int)p : dead;
  }
  __device__ int index(int j) const { return ord.slot(j); }
};

// a later pass's key and index: the previous pass's output
struct ArrayKey {
  const int* keys;
  const int* idx;
  __device__ int operator()(int i) const { return keys[i]; }
  __device__ int index(int i) const { return idx[i]; }
};

// What the last pass writes beside each sorted key and index i: the time
// t_src[t_stride * i] into t_out and, with vid_out, the vid vid_src[i]
// (i itself without vid_src).
struct Payload {
  const int* t_src;
  int t_stride;
  const int* vid_src;
  int* t_out;
  int* vid_out;
};

// The newest vid of n slots and the slot of the first vid of its window
// of NR, (newest + 1) mod NR, into win; one block.
__global__ void __launch_bounds__(1024) vid_window_kernel(
    const int* __restrict__ vid, int n, int NR, int* __restrict__ win) {
  __shared__ int warp_max[32];
  int m = INT_MIN;
  for (int i = threadIdx.x; i < n; i += 1024) m = max(m, vid[i]);
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  m = __reduce_max_sync(0xffffffffu, warp_max[threadIdx.x]);
  if (threadIdx.x == 0) {
    long long first = ((long long)m + 1) % NR;
    if (first < 0) first += NR;
    win[0] = (int)first;
    win[1] = m;
  }
}

// The passes of a sort of keys in [0, max_key]: digits of `bits` bits.
struct SortPlan {
  int passes, bits;
};

SortPlan sort_plan(long long max_key) {
  int total = 1;
  while (total < 31 && (1ll << total) <= max_key) ++total;
  const int passes = (total + kMaxDigitBits - 1) / kMaxDigitBits;
  return {passes, (total + passes - 1) / passes};
}

// A pass, step a: a block per tile of Tile keys, the tile's digit counts
// at hist[tile * D + digit].
template <class KeyOf, int Tile = kSortTile>
__global__ void __launch_bounds__(kSortThreads) radix_hist_kernel(
    KeyOf key_of, int M, int shift, int D, int* __restrict__ hist) {
  __shared__ int h[1 << kMaxDigitBits];
  for (int d = threadIdx.x; d < D; d += kSortThreads) h[d] = 0;
  __syncthreads();
  const int lo = blockIdx.x * Tile, hi = min(M, lo + Tile);
  for (int i = lo + threadIdx.x; i < hi; i += kSortThreads)
    atomicAdd(&h[(key_of(i) >> shift) & (D - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads)
    hist[(size_t)blockIdx.x * D + d] = h[d];
}

// A pass, step b: one block of 1024 threads, thread d for digit d; each
// (tile, digit) count becomes the position of the tile's first key of
// that digit: the keys of smaller digits, then of the digit's earlier
// tiles.
__global__ void __launch_bounds__(1024) radix_scan_kernel(
    int tiles, int D, int* __restrict__ hist) {
  __shared__ int warp_sum[32];
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  int own = 0;
  if (d < D)
    for (int t = 0; t < tiles; ++t) own += hist[(size_t)t * D + d];
  int inc = own;                          // inclusive scan in the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_sum[lane] = w;                   // inclusive over warps
  }
  __syncthreads();
  if (d >= D) return;
  int run = inc - own + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int t = 0; t < tiles; ++t) {
    int* c = hist + (size_t)t * D + d;
    const int v = *c;
    *c = run;
    run += v;
  }
}

// A pass, step c: a block per tile, a warp per Tile / 8 keys of it (256
// at K1's tile), in index order.  Each warp counts its digits, the warps' counts become their
// offsets (the tile's position from step b, then the earlier warps'),
// and each warp writes its keys 32 at a time: a lane's rank among the
// equal digits below it (__match_any_sync) keeps the sort stable.  Writes
// the sorted keys, their indices and, on the last pass, the payload.
template <class KeyOf, int Tile = kSortTile>
__global__ void __launch_bounds__(kSortThreads) radix_scatter_kernel(
    KeyOf key_of, int M, int shift, int D, const int* __restrict__ hist,
    int* __restrict__ keys_out, int* __restrict__ idx_out,
    Payload pay) {
  __shared__ int wrun[kSortWarps][1 << kMaxDigitBits];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSortWarps * D; i += kSortThreads)
    wrun[i / D][i % D] = 0;
  __syncthreads();
  const int lo = blockIdx.x * Tile + warp * (Tile / kSortWarps);
  const int hi = min(M, lo + Tile / kSortWarps);
  for (int i = lo + lane; i < hi; i += 32)
    atomicAdd(&wrun[warp][(key_of(i) >> shift) & (D - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads) {
    int run = hist[(size_t)blockIdx.x * D + d];
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = wrun[w][d];
      wrun[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool active = i < hi;
    int key = 0, digit = -1;              // inactive lanes: no digit
    if (active) {
      key = key_of(i);
      digit = (key >> shift) & (D - 1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & below);
    if (active) {
      const int dst = wrun[warp][digit] + rank;
      const int idx = key_of.index(i);
      keys_out[dst] = key;
      idx_out[dst] = idx;
      if (pay.t_out) pay.t_out[dst] = pay.t_src[(size_t)pay.t_stride * idx];
      if (pay.vid_out) pay.vid_out[dst] = pay.vid_src ? pay.vid_src[idx] : idx;
    }
    __syncwarp();
    if (active && rank == 0) wrun[warp][digit] += __popc(peers);
    __syncwarp();
  }
}

// Scratch words of a sort of M keys in [0, max_key]: keys and indices
// of the passes between, and the (tile, digit) counts.
template <int Tile = kSortTile>
long long sort_scratch(int M, long long max_key) {
  const long long tiles = (M + Tile - 1) / Tile;
  return 2ll * M + tiles * (1ll << sort_plan(max_key).bits);
}

// One pass: steps a, b and c on the digit at `shift`.
template <int Tile, class KeyOf>
void radix_pass(KeyOf key_of, int M, int shift, int D, int* hist,
                int* keys_out, int* idx_out, Payload pay,
                cudaStream_t st) {
  const int tiles = (M + Tile - 1) / Tile;
  if (tiles == 0) return;
  radix_hist_kernel<KeyOf, Tile><<<tiles, kSortThreads, 0, st>>>(
      key_of, M, shift, D, hist);
  radix_scan_kernel<<<1, 1024, 0, st>>>(tiles, D, hist);
  radix_scatter_kernel<KeyOf, Tile><<<tiles, kSortThreads, 0, st>>>(
      key_of, M, shift, D, hist, keys_out, idx_out, pay);
}

// The passes of the sort, launched in order on one stream: the keys of
// positions 0..M-1, in [0, max_key], into (keys_s, order), with the
// payload of the sorted indices; sort_scratch<Tile>(M, max_key) words of
// scratch.
template <int Tile = kSortTile, class KeyOf>
void radix_sort(KeyOf key_of, int M, long long max_key, Payload pay,
                int* scratch, int* keys_s, int* order, cudaStream_t st) {
  const SortPlan plan = sort_plan(max_key);
  const int D = 1 << plan.bits;
  const Payload none{};
  int* hist = scratch + 2 * (size_t)M;
  // ping-pong through the scratch so that the last pass writes keys_s
  // and order
  int* keys[2] = {keys_s, scratch};
  int* idx[2] = {order, scratch + M};
  int out = (plan.passes - 1) & 1;         // the first pass's buffers
  radix_pass<Tile>(key_of, M, 0, D, hist, keys[out], idx[out],
                   plan.passes == 1 ? pay : none, st);
  for (int p = 1; p < plan.passes; ++p) {
    out ^= 1;
    radix_pass<Tile>(ArrayKey{keys[out ^ 1], idx[out ^ 1]}, M,
                     p * plan.bits, D, hist, keys[out], idx[out],
                     p == plan.passes - 1 ? pay : none, st);
  }
}

// ---- step 2: run_start[p] = the first sorted position whose key is >= p,
// for p = 0..n_ids - 1.
__global__ void run_start_kernel(const int* __restrict__ keys_s, int M,
                                 int n_ids, int* __restrict__ run_start) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_ids) return;
  int a = 0, z = M;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (keys_s[mid] < p) a = mid + 1; else z = mid;
  }
  run_start[p] = a;
}

// ---- step 3: a warp per query -------------------------------------------

constexpr int kSearchWarps = 8;

// One query's picks, by its warp (see the file's note): the query at
// (x, y, t) walks the runs of pixels base + y'*W + x'; older(m) says
// whether sorted position m holds an entry older than the query (those
// come first in a run).  Writes up to `room` picks, newest first within
// a cell, as (order[m], spiral cell) pairs into mine; returns how many
// (the same in every lane).
template <class Older>
__device__ int warp_picks(int x, int y, int t, int base, Older older,
                          const int* __restrict__ ts,
                          const int* __restrict__ order,
                          const int* __restrict__ run_start,
                          const int* __restrict__ spiral, int W, int H,
                          int S, int room, int Q, int dt, int* mine) {
  const int lane = threadIdx.x & 31;
  int n = 0;                              // picks placed so far
  for (int s0 = 0; s0 < S && n < room; s0 += 32) {
    const int s = s0 + lane;
    int cnt = 0, hi = 0;
    if (s < S) {
      const int xn = x + spiral[2 * s], yn = y + spiral[2 * s + 1];
      if (xn >= 0 && xn < W && yn >= 0 && yn < H) {
        const int p = base + yn * W + xn;
        const int st = run_start[p], en = run_start[p + 1];
        // hi: the first run position holding an entry not older
        int a = st, z = en;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (older(mid)) a = mid + 1; else z = mid;
        }
        hi = a;
        // lo: the first position of the last Q within dt of t
        a = max(st, en - Q);
        z = hi;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (t - ts[mid] > dt) a = mid + 1; else z = mid;
        }
        cnt = hi - a;
        if (cnt < 0) cnt = 0;
      }
    }
    int inc = cnt;                        // inclusive scan in spiral order
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += v;
    }
    const int first = n + inc - cnt;      // this cell's first pick
    for (int k = first; k < room && k < first + cnt; ++k) {
      mine[2 * k] = order[hi - 1 - (k - first)];
      mine[2 * k + 1] = s;
    }
    n = min(room, n + __shfl_sync(0xffffffffu, inc, 31));
  }
  __syncwarp();
  return n;
}

// K1: a warp per event; slot 0 is the event itself.
__global__ void __launch_bounds__(kSearchWarps * 32) graph_search_kernel(
    const int* __restrict__ pos,          // [M, 3] (x, y, t)
    const uint8_t* __restrict__ mask,     // [M]
    const int* __restrict__ order,        // [M] pixel-major stable order
    const int* __restrict__ ts,           // [M] times in that order
    const int* __restrict__ run_start,    // [B*H*W + 1]
    const int* __restrict__ spiral,       // [S, 2] (dx, dy)
    const float* __restrict__ spiral_dpos,// [S, 2] (dx/W, dy/H)
    float fill_dx, float fill_dy,
    int M, int N, int W, int H, int S, int K, int Q, int dt,
    int* __restrict__ nbr,                // [M, K]
    uint8_t* __restrict__ nbr_mask,       // [M, K]
    float* __restrict__ nbr_dpos) {       // [M, K, 2]
  extern __shared__ int picks[];          // [warps][K - 1][2]: (src, cell)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kSearchWarps + warp;
  if (e >= M) return;                     // the whole warp
  int* mine = picks + (size_t)warp * 2 * K;
  const int b = e / N;
  const bool valid = mask[e];
  int n = 0;
  if (valid)
    n = warp_picks(pos[3 * e], pos[3 * e + 1], pos[3 * e + 2], b * H * W,
                   [=](int m) { return order[m] < e; }, ts, order,
                   run_start, spiral, W, H, S, K - 1, Q, dt, mine);
  const size_t row = (size_t)e * K;
  for (int k = lane; k < K; k += 32) {
    int src = 0;
    uint8_t m = 0;
    float2 d = make_float2(fill_dx, fill_dy);
    if (k == 0) {
      src = e - b * N;
      m = valid;
      d = make_float2(0.f, 0.f);
    } else if (k - 1 < n) {
      const int c = mine[2 * (k - 1) + 1];
      src = mine[2 * (k - 1)] - b * N;
      m = 1;
      d = make_float2(spiral_dpos[2 * c], spiral_dpos[2 * c + 1]);
    }
    nbr[row + k] = src;
    nbr_mask[row + k] = m;
    reinterpret_cast<float2*>(nbr_dpos)[row + k] = d;
  }
}

// K6 and K8: a warp per query, E = rings * C queries (ring-major): query
// q searches ring q / C's runs with vid q_vid[q % C].  Row q gets up to K
// slots, their mask and, with nbr_spiral, their spiral indices; 0 where
// unfilled.
__global__ void __launch_bounds__(kSearchWarps * 32) store_search_kernel(
    const int* __restrict__ vid_s,        // [n] vids in (pixel, vid) order
    const int* __restrict__ ts,           // [n] times in that order
    const int* __restrict__ order,        // [n] slots in that order
    const int* __restrict__ run_start,    // [rings*H*W + 1]
    const int* __restrict__ q_pos,        // [E, 3] (x, y, t)
    const int* __restrict__ q_vid,        // [C], the same in every ring
    const uint8_t* __restrict__ q_valid,  // [E]
    const int* __restrict__ spiral,       // [S, 2]
    int E, int C, int W, int H, int S, int K, int Q, int dt,
    int* __restrict__ nbr,                // [E, K]
    uint8_t* __restrict__ nbr_mask,       // [E, K]
    int* __restrict__ nbr_spiral) {       // [E, K] or null
  extern __shared__ int picks[];          // [warps][K][2]: (slot, cell)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kSearchWarps + warp;
  if (q >= E) return;                     // the whole warp
  int* mine = picks + (size_t)warp * 2 * K;
  int n = 0;
  if (q_valid[q]) {
    const int v = q_vid[q % C];
    n = warp_picks(q_pos[3 * q], q_pos[3 * q + 1], q_pos[3 * q + 2],
                   (q / C) * H * W, [=](int m) { return vid_s[m] < v; }, ts,
                   order, run_start, spiral, W, H, S, K, Q, dt, mine);
  }
  const size_t row = (size_t)q * K;
  for (int k = lane; k < K; k += 32) {
    const bool hit = k < n;
    nbr[row + k] = hit ? mine[2 * k] : 0;
    nbr_mask[row + k] = hit;
    if (nbr_spiral) nbr_spiral[row + k] = hit ? mine[2 * k + 1] : 0;
  }
}

// The scratch of K6 and K8 over n slots and n_pix pixel ids: the sort's,
// the vid window, the sorted keys, slots, times and vids, the run table.
struct StoreScratch {
  int *sort, *win, *keys_s, *order, *ts, *vid_s, *run_start;
  StoreScratch(void* p, int n, long long n_pix) {
    sort = (int*)p;
    win = sort + sort_scratch(n, n_pix);
    keys_s = win + 2;
    order = keys_s + n;
    ts = order + n;
    vid_s = ts + n;
    run_start = vid_s + n;
  }
};

// Steps 1-3 of K6 and K8 over n slots in rings of NR (vid: the slots'
// vids, or null when vid == slot), pixel keys in [0, n_pix] from key,
// slot times t_src[t_stride * slot].
template <class KeyOf>
void search_store_runs(KeyOf key, const StoreScratch& sc, const int* vid,
                       const int* t_src, int t_stride, int n, int NR,
                       int n_pix, const void* q_pos, const void* q_vid,
                       const void* q_valid, const void* spiral, int E, int C,
                       int W, int H, int S, int K, int Q, int dt, void* nbr,
                       void* nbr_mask, void* nbr_spiral, cudaStream_t st) {
  if (vid) vid_window_kernel<<<1, 1024, 0, st>>>(vid, n, NR, sc.win);
  radix_sort(key, n, n_pix, Payload{t_src, t_stride, vid, sc.ts, sc.vid_s},
             sc.sort, sc.keys_s, sc.order, st);
  const int n_ids = n_pix + 1;
  run_start_kernel<<<(n_ids + 255) / 256, 256, 0, st>>>(sc.keys_s, n, n_ids,
                                                        sc.run_start);
  store_search_kernel<<<(E + kSearchWarps - 1) / kSearchWarps,
                        kSearchWarps * 32, kSearchWarps * 2 * K * sizeof(int),
                        st>>>(
      sc.vid_s, sc.ts, sc.order, sc.run_start, (const int*)q_pos,
      (const int*)q_vid, (const uint8_t*)q_valid, (const int*)spiral, E, C, W,
      H, S, K, Q, dt, (int*)nbr, (uint8_t*)nbr_mask, (int*)nbr_spiral);
}

// The transposed edges of a spline conv's level (spline_conv.cu's
// backward): edge e = m*K + k keyed by its source row nbr[e], n_src (past
// the last row) where it is masked off.  The sort is stable, so each
// source's run lists its edges in edge order.  A tile of 16384 keys keeps
// the one scanning block's loop short at the 6.4M edges of a batch of 8
// (391 tiles) and the 51M of a batch of 64.
constexpr int kEdgeSortTile = 16384;

struct SourceKey {
  const int* nbr;
  const uint8_t* mask;
  int n_src;
  __device__ int operator()(int e) const {
    const unsigned s = (unsigned)nbr[e];
    return mask[e] && s < (unsigned)n_src ? (int)s : n_src;
  }
  __device__ int index(int e) const { return e; }
};

// Cell keys read in place from two arrays, a [na] and then b [n - na]
// (K8's ring update, voxel_pool.cu: the evicted slots' cells, then the
// chunk's); a key outside [0, n_ids) sorts as n_ids, past every cell.
struct TwoPartKey {
  const int* a;
  const int* b;
  int na, n_ids;
  __device__ int operator()(int i) const {
    const int v = i < na ? a[i] : b[i - na];
    return (unsigned)v < (unsigned)n_ids ? v : n_ids;
  }
  __device__ int index(int i) const { return i; }
};

}  // namespace

// Scratch words of dagr_cell_sort over n keys in [0, n_ids].
extern "C" long long dagr_cell_sort_scratch(int n, int n_ids) {
  return sort_scratch(n, n_ids);
}

// The stable sort of positions 0..n-1 by cell, position i's cell being
// a[i] for i < na and b[i - na] after (n_ids: none, sorted last): the
// sorted cells keys_s [n] and positions order [n], by K1's radix sort (2
// passes up to 2^20 cells); launched on the caller's stream, no
// allocation, no host synchronisation.
extern "C" int dagr_cell_sort(const void* a, int na, const void* b, int n,
                              int n_ids, void* scratch, void* keys_s,
                              void* order, void* stream) {
  radix_sort(TwoPartKey{(const int*)a, (const int*)b, na, n_ids}, n, n_ids,
             Payload{}, (int*)scratch, (int*)keys_s, (int*)order,
             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// run_start [n_ids] of n sorted keys keys_s (dagr_cell_sort's): the first
// sorted position whose key is >= p, for p = 0..n_ids - 1; launched on
// the caller's stream.
extern "C" int dagr_run_starts(const void* keys_s, int n, int n_ids,
                               void* run_start, void* stream) {
  run_start_kernel<<<(n_ids + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)keys_s, n, n_ids, (int*)run_start);
  return (int)cudaGetLastError();
}

// Scratch words of dagr_source_runs over n_edges edges and n_src sources:
// the sort's and its sorted keys.
extern "C" long long dagr_source_runs_scratch(int n_edges, int n_src) {
  return sort_scratch<kEdgeSortTile>(n_edges, n_src) + n_edges;
}

// The transposed CSR of n_edges = M*K edges (nbr, mask [M*K]) over n_src
// source rows: order [n_edges], the edge ids stable-sorted by source
// (masked edges last), and start [n_src + 1], source s's edges being
// order[start[s] .. start[s+1]).  K1's radix sort (2 passes of <= 10 bits
// up to 2^20 sources, 3 up to 2^30) and run table; launched on the
// caller's stream by dagr_spline_conv_backward (spline_conv.cu), no
// allocation, no host synchronisation.
extern "C" int dagr_source_runs(const void* nbr, const void* mask,
                                int n_edges, int n_src, void* scratch,
                                void* order, void* start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* keys_s = (int*)scratch + sort_scratch<kEdgeSortTile>(n_edges, n_src);
  radix_sort<kEdgeSortTile>(
      SourceKey{(const int*)nbr, (const uint8_t*)mask, n_src}, n_edges,
      n_src, Payload{}, (int*)scratch, keys_s, (int*)order, st);
  const int n_ids = n_src + 1;
  run_start_kernel<<<(n_ids + 255) / 256, 256, 0, st>>>(keys_s, n_edges,
                                                        n_ids, (int*)start);
  return (int)cudaGetLastError();
}

// Scratch words dagr_graph_search needs for B samples of N events on a
// W x H frame: the sort's, its sorted keys, order and times, and the run
// table.
extern "C" long long dagr_graph_search_scratch(int B, int N, int W, int H) {
  const long long M = (long long)B * N, n_pix = (long long)B * W * H;
  return sort_scratch((int)M, n_pix) + 3 * M + n_pix + 1;
}

// K1: the graph of B samples of N events, outputs [B*N, K] (nbr,
// nbr_mask) and [B*N, K, 2] (nbr_dpos).
extern "C" int dagr_graph_search(
    const void* pos, const void* mask, const void* spiral,
    const void* spiral_dpos, float fill_dx, float fill_dy, int B, int N,
    int W, int H, int S, int K, int Q, int dt, void* scratch, void* nbr,
    void* nbr_mask, void* nbr_dpos, void* stream) {
  const int M = B * N, HW = W * H;
  if (M == 0 || K < 1) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_pix = (long long)B * HW;
  int* keys_s = (int*)scratch + sort_scratch(M, n_pix);
  int* order = keys_s + M;
  int* ts = order + M;
  int* run_start = ts + M;
  const PixelKey key{(const int*)pos, (const uint8_t*)mask, N, W, HW,
                     (int)n_pix};
  radix_sort(key, M, n_pix, Payload{(const int*)pos + 2, 3, nullptr, ts,
                                    nullptr},
             (int*)scratch, keys_s, order, st);
  const int n_ids = (int)n_pix + 1;
  run_start_kernel<<<(n_ids + 255) / 256, 256, 0, st>>>(keys_s, M, n_ids,
                                                        run_start);
  graph_search_kernel<<<(M + kSearchWarps - 1) / kSearchWarps,
                        kSearchWarps * 32, kSearchWarps * 2 * K * sizeof(int),
                        st>>>(
      (const int*)pos, (const uint8_t*)mask, order, ts, run_start,
      (const int*)spiral, (const float*)spiral_dpos, fill_dx, fill_dy, M, N,
      W, H, S, K, Q, dt, (int*)nbr, (uint8_t*)nbr_mask, (float*)nbr_dpos);
  return (int)cudaGetLastError();
}

// Scratch words of K6 (n = N store slots, n_pix = H*W) and K8 (n = S*NR
// ring slots, n_pix = S*H*W).
extern "C" long long dagr_store_search_scratch(int n, long long n_pix) {
  return sort_scratch(n, n_pix) + 2 + 4ll * n + n_pix + 1;
}

// K6: C queries against an N-slot store; store_vid null: vid == slot
// (append-only), else one ring of N slots; S spiral cells.  Outputs
// [C, K].
extern "C" int dagr_graph_search_store(
    const void* store_pos, const void* store_valid, const void* store_vid,
    const void* q_pos, const void* q_vid, const void* q_valid,
    const void* spiral, int N, int C, int W, int H, int S, int K, int Q,
    int dt, void* scratch, void* nbr, void* nbr_mask, void* stream) {
  if (C == 0 || K < 1) return (int)cudaGetLastError();
  const int HW = W * H;
  const StoreScratch sc(scratch, N, HW);
  const int* vid = (const int*)store_vid;
  const StoreKey key{VidOrder{vid, sc.win, N}, (const int*)store_pos,
                     (const uint8_t*)store_valid, W, HW};
  search_store_runs(key, sc, vid, (const int*)store_pos + 2, 3, N, N, HW,
                    q_pos, q_vid, q_valid, spiral, C, C, W, H, S, K, Q, dt,
                    nbr, nbr_mask, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K8: n_streams lockstep chunks of C queries against as many rings of
// NR slots; S spiral cells.  Outputs [n_streams*C, K].
extern "C" int dagr_serve_search(
    const void* ring_pix, const void* ring_t, const void* ring_vid,
    const void* q_pos, const void* q_vid, const void* q_valid,
    const void* spiral, int n_streams, int NR, int C, int W, int H, int S,
    int K, int Q, int dt, void* scratch, void* nbr, void* nbr_mask,
    void* nbr_spiral, void* stream) {
  const int E = n_streams * C;
  if (E == 0 || K < 1) return (int)cudaGetLastError();
  const int n = n_streams * NR, n_pix = n_streams * W * H;
  const StoreScratch sc(scratch, n, n_pix);
  const int* vid = (const int*)ring_vid;
  const RingKey key{VidOrder{vid, sc.win, NR}, (const int*)ring_pix, n_pix};
  search_store_runs(key, sc, vid, (const int*)ring_t, 1, n, NR, n_pix,
                    q_pos, q_vid, q_valid, spiral, E, C, W, H, S, K, Q, dt,
                    nbr, nbr_mask, nbr_spiral, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
