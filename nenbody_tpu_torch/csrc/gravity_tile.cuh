// The gravity pair loop over a range of j staged through shared memory,
// shared by gravity.cu (all-pairs gravity) and rdma_ring.cu (a hop of the
// RDMA ring's gravity), so that both sum the same pairs in the same order
// with the same code.
//
// A block of T threads, each holding R bodies x_i and their unscaled sums
// (gx, gy) in registers (register blocking: each x_j read from shared memory
// feeds R pairs, and the R reciprocals are independent, so their latency
// overlaps), walks the j range in tiles of T positions staged in shared
// memory: one coalesced load a thread, the next tile prefetched into a
// register while the current one is summed; a full tile runs an unrolled
// loop of constant trip count, the ragged tail a masked one. `load(j)`
// returns x_j (a plain load for gravity.cu, __ldcg through L2 for the
// ring's comm slots).

#pragma once

#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

// (gx, gy) += (x_j - x_i) / (|x_j - x_i|^2 + bias), the plain version's
// products and sums in its order (-fmad=false: 12 fp32 instructions with
// the Newton step, and one MUFU reciprocal); with FMA the squared distance
// and the two accumulations are explicit fma, as gravity_vjp.cu's pair
// (8 and the MUFU), which round otherwise.
template <bool APPROX, bool FMA>
__device__ __forceinline__ void gravity_pair(float2 xi, float2 xj, float bias, float& gx,
                                             float& gy) {
  const float dx = xj.x - xi.x;
  const float dy = xj.y - xi.y;
  if (FMA) {
    const float w = reciprocal<APPROX>(__fmaf_rn(dx, dx, __fmaf_rn(dy, dy, bias)));
    gx = __fmaf_rn(dx, w, gx);
    gy = __fmaf_rn(dy, w, gy);
  } else {
    const float d2 = dx * dx + dy * dy + bias;
    const float w = reciprocal<APPROX>(d2);
    gx += dx * w;
    gy += dy * w;
  }
}

// Add the pairs of j in [j_begin, j_end) to (gx, gy), in j order. `tile`
// holds T float2 in shared memory; T is blockDim.x, and every thread of the
// block calls this (it meets the block's barriers).
template <int T, int R, bool APPROX, bool FMA, class Load>
__device__ __forceinline__ void gravity_j_range(float2* tile, const Load& load, int j_begin,
                                                int j_end, const float2 (&xi)[R], float bias,
                                                float (&gx)[R], float (&gy)[R]) {
  const int t = threadIdx.x;
  float2 next = j_begin + t < j_end ? load(j_begin + t) : make_float2(0.f, 0.f);
  for (int j0 = j_begin; j0 < j_end; j0 += T) {
    __syncthreads();
    tile[t] = next;
    __syncthreads();
    if (j0 + T + t < j_end) next = load(j0 + T + t);
    if (j0 + T <= j_end) {
#pragma unroll 32
      for (int k = 0; k < T; ++k) {
        const float2 xj = tile[k];
#pragma unroll
        for (int r = 0; r < R; ++r) gravity_pair<APPROX, FMA>(xi[r], xj, bias, gx[r], gy[r]);
      }
    } else {
      for (int k = 0; k < j_end - j0; ++k) {
        const float2 xj = tile[k];
#pragma unroll
        for (int r = 0; r < R; ++r) gravity_pair<APPROX, FMA>(xi[r], xj, bias, gx[r], gy[r]);
      }
    }
  }
}

}  // namespace
