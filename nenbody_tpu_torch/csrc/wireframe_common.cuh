// The wireframe sprite's geometry, shared by the eye (wireframe_eye.cu) and
// its pullback (wireframe_eye_bwd.cu).
//
// sprite_view and slab_interval are templates on the scalar type, both
// kernels instantiate them on float; edge_slab and edge_depth are the
// forward's per-edge clip and per-pixel test. The pullback runs this same
// float code for its primal before its written-out reverse sweep, built
// with the same -fmad=false, so it takes every branch (near clip, slab
// clip, hit, edge tie, coverage) on the forward's values, as the plain
// version (nenbody_tpu_torch/vision/render.py: sprite_view, edge_fragment)
// takes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float OFF_SCREEN = 4.0f;  // sentinel u outside [-1, 1]

// sprite verts (src/main.rs:130-139) and per-edge (uv_a, uv_b - uv_a)
__constant__ float c_vx[3] = {-1.0f, 1.0f, -1.0f};
__constant__ float c_vy[3] = {-1.0f, 0.0f, 1.0f};
__constant__ float c_uv[3][4] = {
    {0.0f, 0.0f, 0.0f, 1.0f},    // edge (0, 1)
    {0.0f, 1.0f, 1.0f, 0.0f},    // edge (1, 2)
    {1.0f, 1.0f, -1.0f, -1.0f},  // edge (2, 0)
};

struct WireframeParams {
  float tan_half_fov;
  float near_plane;
  float far_plane;
  float radius;
  float hp;      // 1/W, the NDC half-width of a pixel
  float two_hp;  // 2/W
  float background;
  float albedo;
  int antialias;
};

// NDC centre of pixel p of a w-pixel line (camera.pixel_centers_for_width).
__device__ __forceinline__ float pixel_center(int p, int w) {
  return 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
}

__device__ __forceinline__ float value(float a) { return a; }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float clamp_min(float a, float lo) { return fmaxf(a, lo); }

// The 3 verts of the sprite at (px, py) turned to its unit heading (cth, sth),
// in the frame of the eye at (ex, ey) looking along (dx, dy): forward f and
// lateral l (right = (dy, -dx)).
template <typename T>
__device__ __forceinline__ void sprite_view(const T& ex, const T& ey, const T& dx, const T& dy,
                                            const T& px, const T& py, const T& cth, const T& sth,
                                            const WireframeParams& q, T f[3], T l[3]) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float vxr = c_vx[v] * q.radius;
    const float vyr = c_vy[v] * q.radius;
    const T relx = (px + (vxr * cth - vyr * sth)) - ex;
    const T rely = (py + (vxr * sth + vyr * cth)) - ey;
    f[v] = relx * dx + rely * dy;
    l[v] = relx * dy - rely * dx;
  }
}

template <typename T>
struct Slab {
  T tau_lo, tau_hi;  // the edge's tau range clipped to the [near, far] slab
  T e_lo, e_hi;      // its u-interval read off the clipped endpoints
  bool valid;        // a live edge with a non-empty clipped range
  bool a_lo;         // e_lo is the tau_lo end's u (u_a <= u_b)
};

// One edge's slab clip (render.edge_fragment's antialias prologue).
template <typename T>
__device__ __forceinline__ Slab<T> slab_interval(const T& fa, const T& la, const T& df,
                                                 const T& dl, bool live,
                                                 const WireframeParams& q) {
  const bool big = fabsf(value(df)) > 1e-30f;
  const T safe_df = big ? df : T(1e-30f);
  const T t_near = (q.near_plane - fa) / safe_df;
  const T t_far = (q.far_plane - fa) / safe_df;
  const T tau_lo = big ? vmax(vmin(t_near, t_far), T(0.0f)) : T(0.0f);
  const T tau_hi = big ? vmin(vmax(t_near, t_far), T(1.0f)) : T(1.0f);
  const bool in_slab = (value(fa) > q.near_plane) && (value(fa) < q.far_plane);
  const bool valid = live && (big ? (value(tau_lo) < value(tau_hi)) : in_slab);
  const T f_lo = valid ? fa + tau_lo * df : T(1.0f);
  const T f_hi = valid ? fa + tau_hi * df : T(1.0f);
  const T u_a = (la + tau_lo * dl) / (q.tan_half_fov * clamp_min(f_lo, 1e-30f));
  const T u_b = (la + tau_hi * dl) / (q.tan_half_fov * clamp_min(f_hi, 1e-30f));
  return Slab<T>{tau_lo, tau_hi, vmin(u_a, u_b), vmax(u_a, u_b), valid,
                 value(u_a) <= value(u_b)};
}

// slab_interval's result (wireframe_common.cuh) with half its divides where
// both ends of the edge lie strictly inside the slab, as under spread
// spawns nearly every visible edge does: f_a and f_a + df inside (near,
// far) make near - f_a and far - f_a put both clip parameters outside [0,
// 1] (IEEE rounding is monotonic), so tau_lo = 0 and tau_hi = 1 exactly, the
// edge is valid, and the u-interval is read off the two ends with
// slab_interval's own expressions, bit for bit.
__device__ __forceinline__ Slab<float> edge_slab(float fa, float la, float df, float dl,
                                                 bool live, const WireframeParams& q) {
  const float tau_lo = 0.0f, tau_hi = 1.0f;
  const float f_lo = fa + tau_lo * df;
  const float f_hi = fa + tau_hi * df;
  if (live && fa > q.near_plane && fa < q.far_plane && f_hi > q.near_plane &&
      f_hi < q.far_plane) {
    const float u_a = (la + tau_lo * dl) / (q.tan_half_fov * clamp_min(f_lo, 1e-30f));
    const float u_b = (la + tau_hi * dl) / (q.tan_half_fov * clamp_min(f_hi, 1e-30f));
    return Slab<float>{tau_lo, tau_hi, fminf(u_a, u_b), fmaxf(u_a, u_b), true, u_a <= u_b};
  }
  return slab_interval(fa, la, df, dl, live, q);
}

// The plain per-pixel test of one edge, g = (f_a, l_a, df, dl) and sl its
// slab clip as edge_pixel_range packs it, at the pixel centre u_p: the
// fragment's depth, +inf on a miss (render.edge_fragment's
// expressions; without antialias the divide is skipped where tau = num/den
// is outside [0, 1] by its operands' signs and sizes, which cannot hit).
__device__ __forceinline__ float edge_depth(const float4& g, const float4& sl, float u_p,
                                            const WireframeParams& q, float* tau_out) {
  float tau, fk;
  bool hit;
  if (q.antialias) {
    if (!(sl.w > u_p - q.hp && sl.z < u_p + q.hp)) return INFINITY;  // no coverage
    const float utc = fminf(fmaxf(u_p, sl.z), sl.w) * q.tan_half_fov;
    const float num = utc * g.x - g.y;
    const float den = g.w - utc * g.z;
    if (!(fabsf(den) > 1e-12f)) return INFINITY;  // edge parallel to the ray
    tau = fminf(fmaxf(num / den, sl.x), sl.y);
    fk = g.x + tau * g.z;
    hit = fk < q.far_plane;
  } else {
    const float ut = u_p * q.tan_half_fov;
    const float num = ut * g.x - g.y;
    const float den = g.w - ut * g.z;
    if (!(fabsf(den) > 1e-12f)) return INFINITY;
    // tau = num/den outside [0, 1] without the divide: opposite signs with
    // |num| > |den| 2^-60 give tau <= -2^-60; |num| > fl(|den| (1 + 2^-22))
    // >= |den| (1 + 2^-23) gives |tau| >= 1 + 2^-23
    const float an = fabsf(num), ad = fabsf(den);
    if (((num < 0.f) != (den < 0.f) && an > ad * 0x1p-60f) || an > ad * (1.0f + 0x1p-22f))
      return INFINITY;
    tau = num / den;
    fk = g.x + tau * g.z;
    hit = tau >= 0.f && tau <= 1.f && fk > q.near_plane && fk < q.far_plane;
  }
  if (tau_out) *tau_out = tau;
  return hit ? fk : INFINITY;
}

}  // namespace
