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
//      takes any int key through a functor, so K6's and K8's searches
//      can later sort (pixel, vid) keys with it;
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

// The spiral walk of K6 and K8 (a thread per query).  Appends to slots n.. of one
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

// ---- K1 step 1: a stable LSD radix sort of int keys ---------------------

constexpr int kSortTile = 2048;           // keys per tile
constexpr int kSortThreads = 256;         // 8 warps, 256 keys of a tile each
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxDigitBits = 10;         // <= 1024 digits a pass

// K1's key: the pixel id b*H*W + y*W + x, B*H*W for an invalid event.
struct PixelKey {
  const int* pos;
  const uint8_t* mask;
  int N, W, HW, invalid;
  __device__ int operator()(int i) const {
    return mask[i] ? (i / N) * HW + pos[3 * i + 1] * W + pos[3 * i] : invalid;
  }
};

// a later pass's key: the previous pass's sorted keys
struct ArrayKey {
  const int* keys;
  __device__ int operator()(int i) const { return keys[i]; }
};

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

// A pass, step a: a block per tile, the tile's digit counts at
// hist[tile * D + digit].
template <class KeyOf>
__global__ void __launch_bounds__(kSortThreads) radix_hist_kernel(
    KeyOf key_of, int M, int shift, int D, int* __restrict__ hist) {
  __shared__ int h[1 << kMaxDigitBits];
  for (int d = threadIdx.x; d < D; d += kSortThreads) h[d] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kSortTile, hi = min(M, lo + kSortTile);
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

// A pass, step c: a block per tile, a warp per 256 keys of it, in index
// order.  Each warp counts its digits, the warps' counts become their
// offsets (the tile's position from step b, then the earlier warps'),
// and each warp writes its keys 32 at a time: a lane's rank among the
// equal digits below it (__match_any_sync) keeps the sort stable.  Writes
// the sorted keys and, for each, its original index (idx_in of the
// previous pass, or the position itself on the first); with t_out, also
// its time pos[3 * index + 2].
template <class KeyOf>
__global__ void __launch_bounds__(kSortThreads) radix_scatter_kernel(
    KeyOf key_of, const int* __restrict__ idx_in, int M, int shift, int D,
    const int* __restrict__ hist, int* __restrict__ keys_out,
    int* __restrict__ idx_out, const int* __restrict__ pos,
    int* __restrict__ t_out) {
  __shared__ int wrun[kSortWarps][1 << kMaxDigitBits];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSortWarps * D; i += kSortThreads)
    wrun[i / D][i % D] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kSortTile + warp * (kSortTile / kSortWarps);
  const int hi = min(M, lo + kSortTile / kSortWarps);
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
      const int idx = idx_in ? idx_in[i] : i;
      keys_out[dst] = key;
      idx_out[dst] = idx;
      if (t_out) t_out[dst] = pos[3 * idx + 2];
    }
    __syncwarp();
    if (active && rank == 0) wrun[warp][digit] += __popc(peers);
    __syncwarp();
  }
}

// The passes of the sort, launched in order on one stream: keys of
// key_of(0..M-1) in [0, max_key] into (keys_s, order) with the times of
// the sorted events in ts.  Scratch: keys and indices of the passes
// between, and the (tile, digit) counts; sort_scratch(M, max_key) words.
long long sort_scratch(int M, long long max_key) {
  const long long tiles = (M + kSortTile - 1) / kSortTile;
  return 2ll * M + tiles * (1ll << sort_plan(max_key).bits);
}

// One pass: steps a, b and c on the digit at `shift`.
template <class KeyOf>
void radix_pass(KeyOf key_of, const int* idx_in, int M, int shift, int D,
                int* hist, int* keys_out, int* idx_out, const int* pos,
                int* t_out, cudaStream_t st) {
  const int tiles = (M + kSortTile - 1) / kSortTile;
  radix_hist_kernel<<<tiles, kSortThreads, 0, st>>>(key_of, M, shift, D,
                                                   hist);
  radix_scan_kernel<<<1, 1024, 0, st>>>(tiles, D, hist);
  radix_scatter_kernel<<<tiles, kSortThreads, 0, st>>>(
      key_of, idx_in, M, shift, D, hist, keys_out, idx_out, pos, t_out);
}

template <class KeyOf>
void radix_sort(KeyOf key_of, int M, long long max_key, const int* pos,
                int* scratch, int* keys_s, int* order, int* ts,
                cudaStream_t st) {
  const SortPlan plan = sort_plan(max_key);
  const int D = 1 << plan.bits;
  int* hist = scratch + 2 * (size_t)M;
  // ping-pong through the scratch so that the last pass writes keys_s
  // and order
  int* keys[2] = {keys_s, scratch};
  int* idx[2] = {order, scratch + M};
  int out = (plan.passes - 1) & 1;         // the first pass's buffers
  radix_pass(key_of, nullptr, M, 0, D, hist, keys[out], idx[out], pos,
             plan.passes == 1 ? ts : nullptr, st);
  for (int p = 1; p < plan.passes; ++p) {
    out ^= 1;
    radix_pass(ArrayKey{keys[out ^ 1]}, idx[out ^ 1], M, p * plan.bits, D,
               hist, keys[out], idx[out], pos,
               p == plan.passes - 1 ? ts : nullptr, st);
  }
}

// K1 step 2: run_start[p] = the first sorted position whose key is >= p,
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

// K1 step 3: a warp per event; see the file's note.
constexpr int kSearchWarps = 8;

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
  int n = 0;                              // picks placed so far
  if (valid) {
    const int x = pos[3 * e], y = pos[3 * e + 1], t = pos[3 * e + 2];
    const int base = b * H * W;
    for (int s0 = 0; s0 < S && n < K - 1; s0 += 32) {
      const int s = s0 + lane;
      int cnt = 0, hi = 0;
      if (s < S) {
        const int xn = x + spiral[2 * s], yn = y + spiral[2 * s + 1];
        if (xn >= 0 && xn < W && yn >= 0 && yn < H) {
          const int p = base + yn * W + xn;
          const int st = run_start[p], en = run_start[p + 1];
          // hi: the first run position holding an event not older than e
          int a = st, z = en;
          while (a < z) {
            const int mid = (a + z) >> 1;
            if (order[mid] < e) a = mid + 1; else z = mid;
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
      int inc = cnt;                      // inclusive scan in spiral order
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
      }
      const int first = n + inc - cnt;    // this cell's first pick
      for (int k = first; k < K - 1 && k < first + cnt; ++k) {
        mine[2 * k] = order[hi - 1 - (k - first)];
        mine[2 * k + 1] = s;
      }
      n = min(K - 1, n + __shfl_sync(0xffffffffu, inc, 31));
    }
  }
  __syncwarp();
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
  radix_sort(key, M, n_pix, (const int*)pos, (int*)scratch, keys_s, order,
             ts, st);
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
