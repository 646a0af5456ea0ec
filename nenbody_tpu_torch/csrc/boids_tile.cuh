// The boids pair loop over a range of j staged through shared memory,
// shared by boids.cu (the fused rules and the ring's partials) and
// rdma_ring.cu (a hop of the RDMA ring's boids), so that the three sum the
// same pairs in the same order with the same code.
//
// A block of T threads, each holding R bodies (x_i, v_i) and their
// pair_math.cuh::BoidsSums in registers, walks the j range in tiles of T
// (x_j, v_j) staged in shared memory; the next tile is prefetched into
// registers while the current one is summed, and full tiles are unrolled.
// `A` holds the squared thresholds (coh_sq, sep_sq, ali_sq) and `alignment`
// (0: the alignment sums stay zero); `load(j)` returns (x_j, v_j) as a
// float4. With SKIP, the pair j == skip[r] is masked for body r (its own
// index, or -1 for none); without, no index is compared.

#pragma once

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

// One j against the R bodies of a thread.
template <int R, bool SKIP, class A>
__device__ __forceinline__ void pair_all(const float2 (&xi)[R], const float2 (&vi)[R],
                                         const int (&skip)[R], int j, float4 xv, const A& a,
                                         BoidsSums (&s)[R]) {
  const float2 xj = make_float2(xv.x, xv.y);
  const float2 vj = make_float2(xv.z, xv.w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!SKIP || j != skip[r]) {
      boids_pair(xi[r], vi[r], xj, vj, a.coh_sq, a.sep_sq, a.ali_sq, a.alignment != 0, s[r]);
    }
  }
}

// Add the pairs of j in [j_begin, j_end) to s. `tile` holds T float4 in
// shared memory; T is blockDim.x, and every thread of the block calls this
// (it meets the block's barriers).
template <int R, bool SKIP, class A, class Load>
__device__ __forceinline__ void sum_j_range(float4* tile, int T, const Load& load, int j_begin,
                                            int j_end, const float2 (&xi)[R],
                                            const float2 (&vi)[R], const int (&skip)[R],
                                            const A& a, BoidsSums (&s)[R]) {
  const int t = threadIdx.x;
  float4 next = j_begin + t < j_end ? load(j_begin + t) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = j_begin; j0 < j_end; j0 += T) {
    __syncthreads();
    tile[t] = next;
    __syncthreads();
    if (j0 + T + t < j_end) next = load(j0 + T + t);
    if (j0 + T <= j_end) {
#pragma unroll 8
      for (int k = 0; k < T; ++k) pair_all<R, SKIP>(xi, vi, skip, j0 + k, tile[k], a, s);
    } else {
      for (int k = 0; k < j_end - j0; ++k) pair_all<R, SKIP>(xi, vi, skip, j0 + k, tile[k], a, s);
    }
  }
}

}  // namespace
