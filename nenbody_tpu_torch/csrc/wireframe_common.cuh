// The wireframe sprite's geometry, shared by the eye (wireframe_eye.cu) and
// its pullback (wireframe_eye_bwd.cu).
//
// The functions are templates on the scalar type: float in the forward, and
// a forward-mode dual number (a value and its derivatives along the inputs)
// in the pullback. Both instantiations make the same value computations in
// the same order, built with the same -fmad=false, so the pullback takes
// every branch (near clip, slab clip, hit, edge tie, coverage) exactly as the
// forward and its plain version (nenbody_tpu_torch/vision/render.py:
// sprite_view, edge_fragment) take it.

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
  return Slab<T>{tau_lo, tau_hi, vmin(u_a, u_b), vmax(u_a, u_b), valid};
}

}  // namespace
