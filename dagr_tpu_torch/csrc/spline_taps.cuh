// The degree-1 bilinear taps of one spline-conv edge, shared by the fused
// block (K2's and K7's gathered form), the split-route conv and its
// backward (spline_conv.cu).
#pragma once

namespace {

// The 4 non-zero bilinear taps of an edge with attribute (ax, ay): the
// offsets t00 (tap (bx, by)) and t10 (tap (bx, by + 1)) of a [P, C] tile,
// t00 + C and t10 + C their x + 1 neighbours, and the weights.
struct Taps {
  int t00, t10;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Taps edge_taps(float ax, float ay, int ks, int C) {
  const float kmax = (float)(ks - 1);
  const float px = fminf(fmaxf(ax, 0.f), 1.f) * kmax;
  const float py = fminf(fmaxf(ay, 0.f), 1.f) * kmax;
  const float bx = fminf(fmaxf(floorf(px), 0.f), kmax - 1.f);
  const float by = fminf(fmaxf(floorf(py), 0.f), kmax - 1.f);
  const float fx = px - bx, fy = py - by;
  Taps t;
  t.w00 = (1.f - fy) * (1.f - fx);
  t.w01 = (1.f - fy) * fx;
  t.w10 = fy * (1.f - fx);
  t.w11 = fy * fx;
  t.t00 = ((int)by * ks + (int)bx) * C;
  t.t10 = t.t00 + ks * C;
  return t;
}

// Adds one edge (source row xs, attribute (ax, ay)) into a destination's
// [P, C] tap tile: this thread's channels lane, lane + tpd, ...
__device__ __forceinline__ void add_edge(
    float* acc, const float* __restrict__ xs, float ax, float ay, int ks,
    int C, int lane, int tpd) {
  const Taps t = edge_taps(ax, ay, ks, C);
  for (int c = lane; c < C; c += tpd) {
    const float v = xs[c];
    acc[t.t00 + c] += t.w00 * v;
    acc[t.t00 + C + c] += t.w01 * v;
    acc[t.t10 + c] += t.w10 * v;
    acc[t.t10 + C + c] += t.w11 * v;
  }
}

}  // namespace
