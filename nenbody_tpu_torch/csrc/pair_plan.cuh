// The launch plan of the all-pairs physics kernels (gravity.cu, boids.cu and
// its ring partials, gravity_vjp.cu):
// T threads per block, R bodies per thread (register blocking: each j read
// from shared memory feeds R pairs) and S blocks of a thread-block cluster
// that split one i-block's j range, so that a small N still fills the card.
// Rank s sums j in [s chunk, (s + 1) chunk) in j order, the last rank fewer
// or none, and the cluster's leader adds the S partials through distributed
// shared memory in rank order: one launch, deterministic.
// ops/pairwise.py::pair_plan is its plain twin; the two must agree
// (nbt_gravity_plan, nbt_gravity_vjp_plan, nbt_boids_plan and
// nbt_boids_partials_plan expose this one to the tests).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SPLIT = 8;  // the portable cluster size

struct PairPlan {
  int threads;  // T, threads per block
  int r;        // R, bodies per thread
  int split;    // S, blocks (cluster ranks) sharing one i-block's j range
  int chunk;    // j positions per rank, a multiple of T when split > 1
  int blocks_i;
};

// The first (T, R) of T in 256, 128, 64, 32 and R in 2, 1 that leaves no
// thread idle beyond the ragged tail and, with the split, gives each SM
// min_warps warps; S doubled up to max_split while the grid is smaller than
// that and each rank keeps a whole tile. A block of more than 32 threads
// that n fills to half or less is passed over (a batch of 128-body shards
// takes 128-thread blocks, not 256-thread blocks half idle). Without such a
// (T, R): one-warp blocks of one body a thread, split as far as m allows.
inline PairPlan pair_plan(int batch, int n, int m, int sms, int min_warps, int max_split) {
  const long long target = (long long)min_warps * sms;
  PairPlan plan{32, 1, 1, m, 1};
  bool filled = false;
  for (int t = 256; t >= 32 && !filled; t /= 2) {
    if (t > 32 && 2 * n <= t) continue;
    for (int r = 2; r >= 1 && !filled; --r) {
      if (r > 1 && n < t * r) continue;
      const int bi = (n + t * r - 1) / (t * r);
      int s = 1;
      while (s < max_split && (long long)batch * bi * s * t / 32 < target && m >= 2 * s * t) {
        s *= 2;
      }
      plan = PairPlan{t, r, s, m, bi};
      filled = (long long)batch * bi * s * t / 32 >= target;
    }
  }
  if (plan.split > 1) {
    const int per = (m + plan.split - 1) / plan.split;
    plan.chunk = (per + plan.threads - 1) / plan.threads * plan.threads;
  }
  return plan;
}

inline int multiprocessors() {
  static int sms = 0;  // the first card's; queried once, outside any graph capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// out[0..4] = T, R, S, chunk, i-blocks of `plan`
inline void write_plan(const PairPlan& plan, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = plan.threads;
  o[1] = plan.r;
  o[2] = plan.split;
  o[3] = plan.chunk;
  o[4] = plan.blocks_i;
}

}  // namespace
