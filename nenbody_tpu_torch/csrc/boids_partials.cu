// Cross-block flocking (boids) rule sums on Hopper: one ring hop's partial.
//
// Replaces nenbody_tpu/ops/boids.py::_boids_partials_kernel (the Pallas TPU
// kernel the agent-axis ring runs on every hop). For every agent i of the
// i-block of env b, over the j-block's agents j:
//   cohesion:   sum and count of x_j with |x_j - x_i|^2 < cohesion_dist_sq
//   separation: -sum (x_j - x_i)     with |x_j - x_i|^2 < separation_dist^2
//   alignment:  sum and count of v_j with |v_j - v_i|^2 < alignment_dist^2
// written raw: the eight accumulators (sum1 x/y, cnt1, repel x/y, sum3 x/y,
// cnt3), additive across j-blocks, as physics.dense.boids_partials_cross
// returns them. The ring adds one partial per hop and applies
// boids_finalize once. With exclude_diagonal (ring hop 0, where a shard meets
// its own block) the pair i == j is masked by index, never by position. The
// ring pads the agent axis with far sentinels (1e17): |x_j - x_i|^2 = 1e34
// still fits in fp32 and fails every threshold, so padded agents stay inert.
//
// What bounds it: the fp32 and predicate pipes, about 22 operations per pair
// and no divide, against 16 bytes of position and velocity per j shared by
// the block. Design: boids.cu's pair loop. One thread per i holds the eight
// accumulators in registers (counts as ints, so they are exact); j-tiles of
// positions and velocities are staged in shared memory; a batch of envs
// rides blockIdx.y; ragged tails are masked by bounds. Built with
// -fmad=false: the masks are threshold tests, and a contracted d^2 would flip
// pairs at the boundary against the plain PyTorch version.

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int TILE = 256;

__global__ void boids_partials_kernel(const float2* __restrict__ pos_i,
                                      const float2* __restrict__ vel_i,
                                      const float2* __restrict__ pos_j,
                                      const float2* __restrict__ vel_j, float2* __restrict__ sum1,
                                      float* __restrict__ cnt1, float2* __restrict__ repel,
                                      float2* __restrict__ sum3, float* __restrict__ cnt3, int n,
                                      int m, float coh_sq, float sep_sq, float ali_sq,
                                      int exclude_diagonal) {
  __shared__ float2 tp[TILE];
  __shared__ float2 tv[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const float2* pj = pos_j + (long long)b * m;
  const float2* vj = vel_j + (long long)b * m;
  float2 xi = make_float2(0.f, 0.f), vi = make_float2(0.f, 0.f);
  if (i < n) {
    xi = pos_i[(long long)b * n + i];
    vi = vel_i[(long long)b * n + i];
  }
  const int skip = exclude_diagonal ? i : -1;
  BoidsSums s;
  for (int j0 = 0; j0 < m; j0 += TILE) {
    const int jl = j0 + threadIdx.x;
    if (jl < m) {
      tp[threadIdx.x] = pj[jl];
      tv[threadIdx.x] = vj[jl];
    }
    __syncthreads();
    const int cnt = min(TILE, m - j0);
    for (int k = 0; k < cnt; ++k) {
      if (j0 + k == skip) continue;
      boids_pair(xi, vi, tp[k], tv[k], coh_sq, sep_sq, ali_sq, true, s);
    }
    __syncthreads();
  }
  if (i < n) {
    const long long o = (long long)b * n + i;
    sum1[o] = make_float2(s.s1x, s.s1y);
    cnt1[o] = (float)s.c1;
    repel[o] = make_float2(s.rx, s.ry);
    sum3[o] = make_float2(s.s3x, s.s3y);
    cnt3[o] = (float)s.c3;
  }
}

}  // namespace

// pos_i, vel_i [B, N, 2]; pos_j, vel_j [B, M, 2]; sum1, repel, sum3 [B, N, 2];
// cnt1, cnt3 [B, N]; all fp32, contiguous. Thresholds are squared. Returns
// cudaGetLastError() after the launch.
extern "C" int nbt_boids_partials(const void* pos_i, const void* vel_i, const void* pos_j,
                                  const void* vel_j, void* sum1, void* cnt1, void* repel,
                                  void* sum3, void* cnt3, int batch, int n, int m, float coh_sq,
                                  float sep_sq, float ali_sq, int exclude_diagonal,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    dim3 grid((n + TILE - 1) / TILE, batch);
    boids_partials_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos_i), static_cast<const float2*>(vel_i),
        static_cast<const float2*>(pos_j), static_cast<const float2*>(vel_j),
        static_cast<float2*>(sum1), static_cast<float*>(cnt1), static_cast<float2*>(repel),
        static_cast<float2*>(sum3), static_cast<float*>(cnt3), n, m, coh_sq, sep_sq, ali_sq,
        exclude_diagonal);
  }
  return static_cast<int>(cudaGetLastError());
}
