// The pair arithmetic of the physics and disc-eye kernels, shared by the
// single-device kernels (boids.cu, disc_eye.cu) and the RDMA ring
// (rdma_ring.cu), so that a ring hop's partial rounds exactly as the
// single-device kernel's; and the disc eyes' two culls (the frustum test
// without a divide and the pixel span of a footprint), which disc_eye.cu
// and the RDMA ring's eye share. The gravity pair is gravity_tile.cuh's,
// with `reciprocal` (rcp.approx and a Newton step, within an ulp of the
// IEEE divide), which gravity_vjp.cu's pullback takes too. Every function
// makes its products and sums in the plain PyTorch versions' order; the
// kernels are built with -fmad=false, so none is contracted.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// 1 / d2 for d2 > 0: with APPROX the fast divide; else rcp.approx (MUFU,
// within 1 ulp) plus one Newton step in explicit fma, which -fmad=false
// leaves alone: as accurate as the IEEE divide's reciprocal within an ulp,
// without its slow-path branch (d2 >= bias > 0 never takes it). A d2 of
// 1e34 (the ring's far sentinels) gives 1e-34, a normal number.
template <bool APPROX>
__device__ __forceinline__ float reciprocal(float d2) {
  if (APPROX) return __fdividef(1.0f, d2);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d2));
  return __fmaf_rn(r, __fmaf_rn(-d2, r, 1.0f), r);
}

// The raw flocking-rule sums of agent i (physics.dense.boids_partials_cross);
// counts as ints, so they are exact.
struct BoidsSums {
  float s1x = 0.f, s1y = 0.f;  // cohesion: sum of x_j
  float rx = 0.f, ry = 0.f;    // separation: -sum (x_j - x_i)
  float s3x = 0.f, s3y = 0.f;  // alignment: sum of v_j
  int c1 = 0, c3 = 0;          // cohesion and alignment counts
};

// One pair (i, j != i) of the three rules; thresholds squared. Without
// `alignment` the alignment sums stay zero (BoidsConfig.global_alignment).
__device__ __forceinline__ void boids_pair(float2 xi, float2 vi, float2 xj, float2 vj,
                                           float coh_sq, float sep_sq, float ali_sq,
                                           bool alignment, BoidsSums& s) {
  const float dx = xj.x - xi.x;
  const float dy = xj.y - xi.y;
  const float d2 = dx * dx + dy * dy;
  if (d2 < coh_sq) {
    s.s1x += xj.x;
    s.s1y += xj.y;
    ++s.c1;
  }
  if (d2 < sep_sq) {
    s.rx -= dx;
    s.ry -= dy;
  }
  if (alignment) {
    const float dvx = vj.x - vi.x;
    const float dvy = vj.y - vi.y;
    if (dvx * dvx + dvy * dvy < ali_sq) {
      s.s3x += vj.x;
      s.s3y += vj.y;
      ++s.c3;
    }
  }
}

// Target x_j in the frame of the eye at p_e with unit heading d_e: forward
// depth f, whether near < f < far, and the footprint centre u_c = l / ft in
// NDC, where l = rel . (d_e.y, -d_e.x) and ft = (f if in depth, else 1) *
// tan(hfov/2) (returned: both eyes derive the footprint's half-width from it).
__device__ __forceinline__ bool disc_project(float2 pe, float2 de, float2 xj, float near_plane,
                                             float far_plane, float tan_half_fov, float& f,
                                             float& uc, float& ft) {
  const float rx = xj.x - pe.x;
  const float ry = xj.y - pe.y;
  f = rx * de.x + ry * de.y;
  const float l = rx * de.y - ry * de.x;
  const bool in_depth = (f > near_plane) && (f < far_plane);
  ft = (in_depth ? f : 1.0f) * tan_half_fov;
  uc = l / ft;
  return in_depth;
}

// Slack of the pixel span, relative to |uc| + reach + 1: far above the few
// roundings of either eye's exact test, of the pixel centres and of the
// span's own arithmetic, each a few ulps of those magnitudes
// (ops/raycast.py::RANGE_SLACK); and the relative slack of the frustum test
// without a divide (ops/raycast.py::FRUSTUM_SLACK).
constexpr float DISC_RANGE_SLACK = 1.0f / 65536.0f;
constexpr float DISC_FRUSTUM_SLACK = 1.0f / 1048576.0f;

// Whether the disc at xj may be visible from the eye at (pe, de), without a
// divide: f and l as disc_project makes them, near < f < far, and |l| within
// (f t + r)(1 + DISC_FRUSTUM_SLACK), which a footprint reaching a pixel
// centre of (-1, 1) implies whatever the roundings of either eye's exact
// test (a few ulps against 2^-20). ops/raycast.py::disc_maybe_visible
// computes the same expressions.
__device__ __forceinline__ bool disc_may_be_visible(float2 pe, float2 de, float2 xj,
                                                    float near_plane, float far_plane,
                                                    float tan_half_fov, float radius) {
  const float rx = xj.x - pe.x;
  const float ry = xj.y - pe.y;
  const float f = rx * de.x + ry * de.y;
  const float l = rx * de.y - ry * de.x;
  return f > near_plane && f < far_plane &&
         fabsf(l) <= (f * tan_half_fov + radius) * (1.0f + DISC_FRUSTUM_SLACK);
}

// Pixels [lo, hi] of a w-pixel line whose centres may lie within `reach` of
// a footprint centred at uc, and the distance reach_plus from uc within
// which such a centre lies: reach plus DISC_RANGE_SLACK of |uc| + reach + 1;
// the span is widened by an eighth of a pixel (0.25/W) more. inv_width is
// 1/W, half_width W/2. ops/raycast.py::pixel_span computes the same
// expressions.
__device__ __forceinline__ void pixel_span(float uc, float reach, float inv_width,
                                           float half_width, int w, int& lo, int& hi,
                                           float& reach_plus) {
  reach_plus = reach + (fabsf(uc) + reach + 1.0f) * DISC_RANGE_SLACK;
  const float r = reach_plus + 0.25f * inv_width;
  const float lo_f = (uc - r + 1.0f) * half_width - 0.5f;
  const float hi_f = (uc + r + 1.0f) * half_width - 0.5f;
  lo = max(0, (int)ceilf(fmaxf(lo_f, -1.0f)));
  hi = min(w - 1, (int)floorf(fminf(hi_f, (float)w)));
}

}  // namespace
