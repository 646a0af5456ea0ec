// Flocking (boids) rules on Hopper: the fused rules and, as a second
// instantiation of the same kernel, the raw cross-block rule sums of a ring
// hop.
//
// Replaces nenbody_tpu/ops/boids.py::_boids_kernel (the Pallas TPU kernel;
// nbt_boids_velocity) and ::_boids_partials_kernel (the one the agent-axis
// ring runs on every hop; nbt_boids_partials). For every agent i of env b,
// over the agents j of the j-set (the same set for the fused rules):
//   cohesion:   sum and count of x_j with |x_j - x_i|^2 < cohesion_dist_sq
//   separation: -sum (x_j - x_i)     with |x_j - x_i|^2 < separation_dist^2
//   alignment:  sum and count of v_j with |v_j - v_i|^2 < alignment_dist^2
// The pair i == j is masked by index, never by position: always for the
// fused rules, on ring hop 0 only for the partials (exclude_diagonal, where
// a shard meets its own block). The fused rules then take the guarded means
// and the weighted sum, the REPLACEMENT velocity before the speed clamp
// (nenbody_tpu_torch/physics/dense.py::boids_accels); with skip_alignment
// the alignment partials stay zero and the caller adds the O(N) global
// velocity mean (BoidsConfig.global_alignment). The partials are written
// raw: the eight accumulators (sum1 x/y, cnt1, repel x/y, sum3 x/y, cnt3,
// the counts as floats of exact ints), additive across j-blocks, as
// physics.dense.boids_partials_cross returns them; the ring adds one
// partial per hop and applies boids_finalize once. The ring pads the agent
// axis with far sentinels (1e17): |x_j - x_i|^2 = 1e34 still fits in fp32
// and fails every threshold, so padded agents stay inert.
//
// What bounds it: the fp32 and predicate pipes (about 24 operations per
// pair, no divide), against 16 bytes of position and velocity per j shared
// by the block. One thread per body in 256-thread blocks would leave the
// card idle at the serving shapes (N=4,096 gives 16 blocks for 132 SMs,
// reference-100 one block) and at a ring hop's (16,384 x 16,384 gives 64).
// Design, as gravity.cu's:
// - T threads per block, R bodies per thread, each holding the eight
//   accumulators of pair_math.cuh::BoidsSums in registers (counts as ints,
//   so they are exact); each (x_j, v_j) read from shared memory feeds R
//   bodies.
// - The block stages j-tiles of T positions and velocities in shared memory,
//   the next tile prefetched into registers while the current one is summed
//   (boids_tile.cuh, whose loop the RDMA ring's boids hop runs too).
// - Where the bodies alone would give an SM fewer than MIN_WARPS_PER_SM
//   warps, the j range is split S ways (S <= MAX_CLUSTER = 16, a cluster
//   size beyond the portable 8 that Hopper allows on request) across the
//   blocks of a thread-block cluster; the leader adds the S partials (six
//   sums, two int counts) through distributed shared memory in rank order,
//   so the result is deterministic and the call one launch. A pair has no
//   divide and little latency to hide behind, so the grid needs every warp
//   the split gives: N=4,096 takes 16 ranks of 256 j each.
// pair_plan.cuh's pair_plan picks T, R and S, for the partials from the
// i-block alone (pair_plan(batch, n, n)), the last rank taking every j from
// (S - 1) chunk to m: a j-block padded with far sentinels keeps its ranks'
// boundaries, so its sums keep their bits (a ring hop's blocks are all of
// n). The partials aim for 16 warps an SM where a plan gives them: a hop at
// 16,384 x 16,384 took 0.342 ms with 16 ranks, 0.422 with 8 (H100).
// ops/boids.py::boids_plan and ::boids_partials_plan are its plain versions
// (nbt_boids_plan and nbt_boids_partials_plan expose this one to the
// tests). A batch of envs rides blockIdx.y; ragged tails are masked by
// bounds. Built with -fmad=false: the masks are threshold tests, and a
// contracted d^2 would flip pairs at the boundary against the plain PyTorch
// version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "boids_tile.cuh"
#include "pair_math.cuh"
#include "pair_plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_WARPS_PER_SM = 8;
// the partials aim for twice that where the i-block and a split of up to
// MAX_CLUSTER give it (a ring hop at N=65,536 on 4 shards: 16 ranks, not 8)
constexpr int PARTIALS_MIN_WARPS_PER_SM = 16;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;

struct BoidsArgs {
  float coh_sq, sep_sq, ali_sq;
  float coh_scale, sep_scale, ali_scale;
  int alignment;         // 0 under skip_alignment
  int exclude_diagonal;  // mask the pair i == j by index
};

// Where the kernel writes: the replacement velocity (the fused rules), or
// the eight raw sums (the partials; counts as floats of exact ints).
struct BoidsOut {
  float2* vel;
  float2* sum1;
  float* cnt1;
  float2* repel;
  float2* sum3;
  float* cnt3;
};

// pos_i, vel_i [B, n]; pos_j, vel_j [B, m] (the same arrays for the fused
// rules). RAW writes the partials, else the replacement velocity.
template <int T, int R, bool RAW>
__device__ __forceinline__ void boids_body(const float2* __restrict__ pos_i,
                                           const float2* __restrict__ vel_i,
                                           const float2* __restrict__ pos_j,
                                           const float2* __restrict__ vel_j, const BoidsOut& out,
                                           int n, int m, int split, int chunk,
                                           const BoidsArgs& a) {
  __shared__ float4 tile[T];  // (x_j, v_j)
  __shared__ float part_f[6][R * T];  // the partials the cluster's leader reads
  __shared__ int part_c[2][R * T];
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int i0 = (blockIdx.x / split) * T * R + t;
  const float2* pbi = pos_i + (long long)b * n;
  const float2* vbi = vel_i + (long long)b * n;
  const float2* pbj = pos_j + (long long)b * m;
  const float2* vbj = vel_j + (long long)b * m;
  float2 xi[R], vi[R];
  int skip[R];  // the j masked for body r: its own index, or none
  BoidsSums s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    const bool in = i < n;
    xi[r] = in ? pbi[i] : make_float2(0.f, 0.f);
    vi[r] = in ? vbi[i] : make_float2(0.f, 0.f);
    skip[r] = a.exclude_diagonal ? i : -1;
  }
  const int j_begin = rank * chunk;
  const int j_end = rank == split - 1 ? m : min(m, j_begin + chunk);  // the last rank: the rest
  auto load = [&](int j) {
    const float2 x = pbj[j], v = vbj[j];
    return make_float4(x.x, x.y, v.x, v.y);
  };
  sum_j_range<R, true>(tile, T, load, j_begin, j_end, xi, vi, skip, a, s);

  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = r * T + t;
      part_f[0][o] = s[r].s1x;
      part_f[1][o] = s[r].s1y;
      part_f[2][o] = s[r].rx;
      part_f[3][o] = s[r].ry;
      part_f[4][o] = s[r].s3x;
      part_f[5][o] = s[r].s3y;
      part_c[0][o] = s[r].c1;
      part_c[1][o] = s[r].c3;
    }
    cluster.sync();
    if (rank == 0) {
      for (int q = 1; q < split; ++q) {
        const float(*of)[R * T] = cluster.map_shared_rank(part_f, q);
        const int(*oc)[R * T] = cluster.map_shared_rank(part_c, q);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int o = r * T + t;
          s[r].s1x += of[0][o];
          s[r].s1y += of[1][o];
          s[r].rx += of[2][o];
          s[r].ry += of[3][o];
          s[r].s3x += of[4][o];
          s[r].s3y += of[5][o];
          s[r].c1 += oc[0][o];
          s[r].c3 += oc[1][o];
        }
      }
    }
    cluster.sync();  // every partial stays in shared memory until the leader has read it
    if (rank != 0) return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    if (i >= n) continue;
    const long long o = (long long)b * n + i;
    const BoidsSums& q = s[r];
    if (RAW) {
      out.sum1[o] = make_float2(q.s1x, q.s1y);
      out.cnt1[o] = (float)q.c1;
      out.repel[o] = make_float2(q.rx, q.ry);
      out.sum3[o] = make_float2(q.s3x, q.s3y);
      out.cnt3[o] = (float)q.c3;
      continue;
    }
    // guarded means (the reference divides only when the count is > 0)
    const float cx = q.c1 > 0 ? q.s1x / (float)q.c1 : q.s1x;
    const float cy = q.c1 > 0 ? q.s1y / (float)q.c1 : q.s1y;
    const float ax = q.c3 > 0 ? q.s3x / (float)q.c3 : q.s3x;
    const float ay = q.c3 > 0 ? q.s3y / (float)q.c3 : q.s3y;
    out.vel[o] = make_float2(cx * a.coh_scale + q.rx * a.sep_scale + ax * a.ali_scale,
                             cy * a.coh_scale + q.ry * a.sep_scale + ay * a.ali_scale);
  }
}

// The two instantiations, as kernels of their own names (a profile tells
// them apart).
template <int T, int R>
__global__ void boids_kernel(const float2* __restrict__ pos_i, const float2* __restrict__ vel_i,
                             const float2* __restrict__ pos_j, const float2* __restrict__ vel_j,
                             BoidsOut out, int n, int m, int split, int chunk, BoidsArgs a) {
  boids_body<T, R, false>(pos_i, vel_i, pos_j, vel_j, out, n, m, split, chunk, a);
}

template <int T, int R>
__global__ void boids_partials_kernel(const float2* __restrict__ pos_i,
                                      const float2* __restrict__ vel_i,
                                      const float2* __restrict__ pos_j,
                                      const float2* __restrict__ vel_j, BoidsOut out, int n,
                                      int m, int split, int chunk, BoidsArgs a) {
  boids_body<T, R, true>(pos_i, vel_i, pos_j, vel_j, out, n, m, split, chunk, a);
}

struct BoidsIn {
  const float2* pos_i;
  const float2* vel_i;
  const float2* pos_j;
  const float2* vel_j;
  int batch, n, m;
};

template <int T, int R, bool RAW>
cudaError_t launch(const PairPlan& plan, const BoidsIn& in, const BoidsOut& out,
                   const BoidsArgs& a, cudaStream_t stream) {
  const auto kernel = RAW ? boids_partials_kernel<T, R> : boids_kernel<T, R>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks_i * plan.split, in.batch);
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.split > 1 ? 1 : 0;
  if (plan.split > MAX_SPLIT) {  // a non-portable cluster size: opt in once per card
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      opted_in[dev] = true;
    }
  }
  return cudaLaunchKernelEx(&cfg, kernel, in.pos_i, in.vel_i, in.pos_j, in.vel_j, out, in.n,
                            in.m, plan.split, plan.chunk, a);
}

// The partials' plan: the i-block's own, pair_plan(batch, n, n), aiming at
// PARTIALS_MIN_WARPS_PER_SM warps an SM where some plan gives them, else at
// MIN_WARPS_PER_SM as the fused rules do.
inline PairPlan partials_plan(int batch, int n, int sms) {
  const PairPlan wide = pair_plan(batch, n, n, sms, PARTIALS_MIN_WARPS_PER_SM, MAX_CLUSTER);
  const long long warps = (long long)batch * wide.blocks_i * wide.split * wide.threads / 32;
  if (warps >= (long long)PARTIALS_MIN_WARPS_PER_SM * sms) return wide;
  return pair_plan(batch, n, n, sms, MIN_WARPS_PER_SM, MAX_CLUSTER);
}

// The instantiation the plan names, for the fused rules or (RAW) the
// partials; both plans are the i-block's own.
template <bool RAW>
cudaError_t launch_plan(const BoidsIn& in, const BoidsOut& out, const BoidsArgs& a,
                        cudaStream_t stream) {
  const int sms = multiprocessors();
  const PairPlan plan = RAW ? partials_plan(in.batch, in.n, sms)
                            : pair_plan(in.batch, in.n, in.n, sms, MIN_WARPS_PER_SM, MAX_CLUSTER);
  const bool two = plan.r == 2;
  switch (plan.threads) {
    case 256: return two ? launch<256, 2, RAW>(plan, in, out, a, stream)
                         : launch<256, 1, RAW>(plan, in, out, a, stream);
    case 128: return two ? launch<128, 2, RAW>(plan, in, out, a, stream)
                         : launch<128, 1, RAW>(plan, in, out, a, stream);
    case 64: return two ? launch<64, 2, RAW>(plan, in, out, a, stream)
                        : launch<64, 1, RAW>(plan, in, out, a, stream);
    default: return two ? launch<32, 2, RAW>(plan, in, out, a, stream)
                        : launch<32, 1, RAW>(plan, in, out, a, stream);
  }
}

}  // namespace

// pos, vel, out: [B, N, 2] fp32, contiguous. Thresholds are squared.
// Returns the launch's error, else cudaGetLastError().
extern "C" int nbt_boids_velocity(const void* pos, const void* vel, void* out, int batch, int n,
                                  float coh_sq, float sep_sq, float ali_sq, float coh_scale,
                                  float sep_scale, float ali_scale, int skip_alignment,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const auto* p = static_cast<const float2*>(pos);
    const auto* v = static_cast<const float2*>(vel);
    const BoidsIn in{p, v, p, v, batch, n, n};
    BoidsOut o = {};
    o.vel = static_cast<float2*>(out);
    const BoidsArgs a{coh_sq, sep_sq, ali_sq, coh_scale, sep_scale, ali_scale,
                      skip_alignment ? 0 : 1, 1};
    const cudaError_t err = launch_plan<false>(in, o, a, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan nbt_boids_velocity launches for (batch, n) on a card with `sms`
// SMs: out[0..4] = T, R, S, chunk, i-blocks.
extern "C" int nbt_boids_plan(int batch, int n, int sms, void* out) {
  write_plan(pair_plan(batch, n, n, sms, MIN_WARPS_PER_SM, MAX_CLUSTER), out);
  return 0;
}

// The partials: pos_i, vel_i [B, N, 2]; pos_j, vel_j [B, M, 2]; sum1, repel,
// sum3 [B, N, 2]; cnt1, cnt3 [B, N]; all fp32, contiguous. Thresholds are
// squared. Returns the launch's error, else cudaGetLastError().
extern "C" int nbt_boids_partials(const void* pos_i, const void* vel_i, const void* pos_j,
                                  const void* vel_j, void* sum1, void* cnt1, void* repel,
                                  void* sum3, void* cnt3, int batch, int n, int m, float coh_sq,
                                  float sep_sq, float ali_sq, int exclude_diagonal,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const BoidsIn in{static_cast<const float2*>(pos_i), static_cast<const float2*>(vel_i),
                     static_cast<const float2*>(pos_j), static_cast<const float2*>(vel_j),
                     batch, n, m};
    const BoidsOut o{nullptr,
                     static_cast<float2*>(sum1),
                     static_cast<float*>(cnt1),
                     static_cast<float2*>(repel),
                     static_cast<float2*>(sum3),
                     static_cast<float*>(cnt3)};
    const BoidsArgs a{coh_sq, sep_sq, ali_sq, 0.f, 0.f, 0.f, 1, exclude_diagonal ? 1 : 0};
    const cudaError_t err = launch_plan<true>(in, o, a, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan nbt_boids_partials launches for (batch, n, m) on a card with
// `sms` SMs, the i-block's own (m does not enter it): out[0..4] = T, R, S,
// chunk, i-blocks.
extern "C" int nbt_boids_partials_plan(int batch, int n, int m, int sms, void* out) {
  write_plan(partials_plan(batch, n, sms), out);
  return 0;
}
