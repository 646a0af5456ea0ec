// Fused flocking (boids) rules on Hopper.
//
// Replaces nenbody_tpu/ops/boids.py::_boids_kernel (the Pallas TPU kernel).
// For every agent i of env b, over all j != i (self excluded by index):
//   cohesion:   sum and count of x_j with |x_j - x_i|^2 < cohesion_dist_sq
//   separation: -sum (x_j - x_i)     with |x_j - x_i|^2 < separation_dist^2
//   alignment:  sum and count of v_j with |v_j - v_i|^2 < alignment_dist^2
// then the guarded means and the weighted sum give the REPLACEMENT velocity
// before the speed clamp (nenbody_tpu_torch/physics/dense.py::boids_accels).
// With skip_alignment the alignment partials stay zero; the caller adds the
// O(N) global velocity mean (BoidsConfig.global_alignment).
//
// What bounds it: the fp32 and predicate pipes (about 24 operations per
// pair, no divide), against 16 bytes of position and velocity per j shared
// by the block. Design: one thread per i holds the eight accumulators in
// registers (counts as ints, so they are exact); j-tiles of positions and
// velocities are staged in shared memory; a batch of envs rides blockIdx.y;
// ragged tails are masked by bounds. Built with -fmad=false: the masks are
// threshold tests, and a contracted d^2 would flip pairs at the boundary
// against the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void boids_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                             float2* __restrict__ out, int n, float coh_sq, float sep_sq,
                             float ali_sq, float coh_scale, float sep_scale, float ali_scale,
                             int skip_alignment) {
  __shared__ float2 tp[TILE];
  __shared__ float2 tv[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const float2* pb = pos + (long long)b * n;
  const float2* vb = vel + (long long)b * n;
  float2 xi = make_float2(0.f, 0.f), vi = make_float2(0.f, 0.f);
  if (i < n) {
    xi = pb[i];
    vi = vb[i];
  }
  float s1x = 0.f, s1y = 0.f, rx = 0.f, ry = 0.f, s3x = 0.f, s3y = 0.f;
  int c1 = 0, c3 = 0;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int jl = j0 + threadIdx.x;
    if (jl < n) {
      tp[threadIdx.x] = pb[jl];
      tv[threadIdx.x] = vb[jl];
    }
    __syncthreads();
    const int cnt = min(TILE, n - j0);
    for (int k = 0; k < cnt; ++k) {
      if (j0 + k == i) continue;
      const float2 xj = tp[k];
      const float dx = xj.x - xi.x;
      const float dy = xj.y - xi.y;
      const float d2 = dx * dx + dy * dy;
      if (d2 < coh_sq) {
        s1x += xj.x;
        s1y += xj.y;
        ++c1;
      }
      if (d2 < sep_sq) {
        rx -= dx;
        ry -= dy;
      }
      if (!skip_alignment) {
        const float2 vj = tv[k];
        const float dvx = vj.x - vi.x;
        const float dvy = vj.y - vi.y;
        if (dvx * dvx + dvy * dvy < ali_sq) {
          s3x += vj.x;
          s3y += vj.y;
          ++c3;
        }
      }
    }
    __syncthreads();
  }
  if (i < n) {
    // guarded means (the reference divides only when the count is > 0)
    const float cx = c1 > 0 ? s1x / (float)c1 : s1x;
    const float cy = c1 > 0 ? s1y / (float)c1 : s1y;
    const float ax = c3 > 0 ? s3x / (float)c3 : s3x;
    const float ay = c3 > 0 ? s3y / (float)c3 : s3y;
    out[(long long)b * n + i] = make_float2(cx * coh_scale + rx * sep_scale + ax * ali_scale,
                                            cy * coh_scale + ry * sep_scale + ay * ali_scale);
  }
}

}  // namespace

// pos, vel, out: [B, N, 2] fp32, contiguous. Thresholds are squared.
// Returns cudaGetLastError() after the launch.
extern "C" int nbt_boids_velocity(const void* pos, const void* vel, void* out, int batch, int n,
                                  float coh_sq, float sep_sq, float ali_sq, float coh_scale,
                                  float sep_scale, float ali_scale, int skip_alignment,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    dim3 grid((n + TILE - 1) / TILE, batch);
    boids_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos), static_cast<const float2*>(vel),
        static_cast<float2*>(out), n, coh_sq, sep_sq, ali_sq, coh_scale, sep_scale, ali_scale,
        skip_alignment);
  }
  return static_cast<int>(cudaGetLastError());
}
