// The pair arithmetic of the physics and disc-eye kernels, shared by the
// single-device kernels (gravity.cu, boids.cu, boids_partials.cu,
// disc_eye.cu) and the RDMA ring (rdma_ring.cu), so that a ring hop's
// partial rounds exactly as the single-device kernel's. Every function
// makes its products and sums in the plain PyTorch versions' order; the
// kernels are built with -fmad=false, so none is contracted.

#pragma once

#include <cuda_runtime.h>

namespace {

// Gravity of x_j on x_i, unscaled: (gx, gy) += (x_j - x_i) / (|x_j - x_i|^2 + bias).
__device__ __forceinline__ void gravity_pair(float2 xi, float2 xj, float bias, int approx,
                                             float& gx, float& gy) {
  const float dx = xj.x - xi.x;
  const float dy = xj.y - xi.y;
  const float d2 = dx * dx + dy * dy + bias;
  const float w = approx ? __fdividef(1.0f, d2) : 1.0f / d2;
  gx += dx * w;
  gy += dy * w;
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

}  // namespace
