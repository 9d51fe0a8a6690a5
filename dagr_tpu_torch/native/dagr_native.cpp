// Native host-side loops of the data pipeline (dagr_tpu_torch.native).
//
// The reference implements its sequential per-event host loops in
// numba-JITed Python (reference: scripts/downsample_events.py:109-124,
// src/dagr/data/augment.py:13-36); the loops are inherently sequential
// (a running polarity accumulator per cell), so they live in C++ with a
// ctypes interface.  The same source as dagr_tpu's native library; the
// port builds its own copy with g++ at first use
// (dagr_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// Polarity-accumulator 2x2 downsample filter
// (reference: downsample_events.py:109-124, _filter_events_resize).
// x, y: event pixel coords; p: polarity in {-1, +1} (float);
// change_map: [H_out * W_out] running accumulator (carried across
// chunks); mask_out: 1 where the event passes through.
void filter_events_resize(
    const int64_t* x, const int64_t* y, const float* p, int64_t n,
    float* change_map, int64_t w_out, int64_t fx, int64_t fy,
    uint8_t* mask_out)
{
    const float inv = 1.0f / static_cast<float>(fx * fy);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t xl = x[i] / fx;
        const int64_t yl = y[i] / fy;
        float& cell = change_map[yl * w_out + xl];
        cell += p[i] * inv;
        if (std::fabs(cell) >= 1.0f) {
            mask_out[i] = 1;
            cell -= p[i];
        } else {
            mask_out[i] = 0;
        }
    }
}

// Bilinear polarity-accumulator subsampling used by RandomZoom when
// zooming out (reference: augment.py:13-36, _add_event/_subsample).
// pos_x/pos_y: float event positions (already zoomed); p: polarity;
// count: [(H+1) * (W+1)] accumulator; threshold = 1/zoom^2.
// out_x/out_y receive the snapped integer position of emitted events.
void subsample_zoom(
    const double* pos_x, const double* pos_y, const float* p, int64_t n,
    float* count, int64_t w_plus1, float threshold,
    uint8_t* mask_out, int16_t* out_x, int16_t* out_y)
{
    for (int64_t i = 0; i < n; ++i) {
        const double xi = pos_x[i];
        const double yi = pos_y[i];
        const float pi = p[i];
        mask_out[i] = 0;
        const int64_t x0 = static_cast<int64_t>(xi);
        const int64_t y0 = static_cast<int64_t>(yi);
        for (int dx = 0; dx <= 1; ++dx) {
            for (int dy = 0; dy <= 1; ++dy) {
                const int64_t xl = x0 + dx;
                const int64_t yl = y0 + dy;
                float& cell = count[yl * w_plus1 + xl];
                cell += pi
                    * (1.0f - std::fabs(static_cast<float>(xi - xl)))
                    * (1.0f - std::fabs(static_cast<float>(yi - yl)));
                const float pol = cell > 0.0f ? 1.0f : -1.0f;
                if (pol * cell > threshold) {
                    cell -= pol * threshold;
                    mask_out[i] = 1;
                    out_x[i] = static_cast<int16_t>(xl);
                    out_y[i] = static_cast<int16_t>(yl);
                }
            }
        }
    }
}

// Per-pixel FIFO queue insertion + spiral edge search — a CPU oracle
// of the reference CUDA kernels (reference: graph/ev_graph.cu:15-128,
// 169-276) used for fast host-side verification and CPU-only
// deployments.  Events must arrive time-sorted.  queue: [H*W*Q] slot
// table of event indices (-1 empty, newest at depth 0).
void insert_and_search(
    const int32_t* ex, const int32_t* ey, const int32_t* et, int64_t n,
    int64_t base_index,
    int32_t* queue, int64_t width, int64_t height, int64_t q_depth,
    const int32_t* all_t,            // timestamps indexed by event id
    int64_t radius, int64_t delta_t, int64_t max_neighbors,
    int32_t* nbr_out, uint8_t* nbr_mask_out)   // [n * max_neighbors]
{
    // insert all events first (reference inserts the batch, then
    // searches: graph/utils.py:6-23)
    for (int64_t i = 0; i < n; ++i) {
        int32_t* col = queue + (ey[i] * width + ex[i]) * q_depth;
        std::memmove(col + 1, col, (q_depth - 1) * sizeof(int32_t));
        col[0] = static_cast<int32_t>(base_index + i);
    }
    for (int64_t i = 0; i < n; ++i) {
        const int64_t self = base_index + i;
        int64_t k = 0;
        nbr_out[i * max_neighbors + k] = static_cast<int32_t>(self);
        nbr_mask_out[i * max_neighbors + k] = 1;
        ++k;
        // outward square spiral (reference: graph/spiral.h)
        int64_t sx = 0, sy = 0, layer = 1, leg = 0;
        const int64_t steps = (2 * radius + 1) * (2 * radius + 1);
        for (int64_t s = 0; s < steps && k < max_neighbors; ++s) {
            if (s > 0) {
                switch (leg) {
                    case 0: ++sx; if (sx == layer) leg = 1; break;
                    case 1: ++sy; if (sy == layer) leg = 2; break;
                    case 2: --sx; if (-sx == layer) leg = 3; break;
                    default: --sy; if (-sy == layer) { leg = 0; ++layer; }
                }
            }
            const int64_t xn = ex[i] + sx;
            const int64_t yn = ey[i] + sy;
            if (xn < 0 || xn >= width || yn < 0 || yn >= height) continue;
            const int32_t* col = queue + (yn * width + xn) * q_depth;
            for (int64_t q = 0; q < q_depth && k < max_neighbors; ++q) {
                const int32_t idx = col[q];
                if (idx < 0) break;
                if (idx >= self) continue;        // only older sources
                const int64_t dt = et[i] - all_t[idx];
                if (dt > delta_t) continue;
                nbr_out[i * max_neighbors + k] = idx;
                nbr_mask_out[i * max_neighbors + k] = 1;
                ++k;
            }
        }
        for (; k < max_neighbors; ++k) {
            nbr_out[i * max_neighbors + k] = 0;
            nbr_mask_out[i * max_neighbors + k] = 0;
        }
    }
}

}  // extern "C"
