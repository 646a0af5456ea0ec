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
// by the block. One thread per body in 256-thread blocks would leave the
// card idle at the serving shapes (N=4,096 gives 16 blocks for 132 SMs,
// reference-100 one block). Design, as gravity.cu's:
// - T threads per block, R bodies per thread, each holding the eight
//   accumulators of pair_math.cuh::BoidsSums in registers (counts as ints,
//   so they are exact); each (x_j, v_j) read from shared memory feeds R
//   bodies.
// - The block stages j-tiles of T positions and velocities in shared memory,
//   the next tile prefetched into registers while the current one is summed.
// - Where the bodies alone would give an SM fewer than MIN_WARPS_PER_SM
//   warps, the j range is split S ways (S <= MAX_CLUSTER = 16, a cluster
//   size beyond the portable 8 that Hopper allows on request) across the
//   blocks of a thread-block cluster; the leader adds the S partials (six
//   sums, two int counts) through distributed shared memory in rank order,
//   so the result is deterministic and the call one launch. A pair has no
//   divide and little latency to hide behind, so the grid needs every warp
//   the split gives: N=4,096 takes 16 ranks of 256 j each.
// pair_plan.cuh's pair_plan picks T, R and S; ops/boids.py::boids_plan is its
// plain version (nbt_boids_plan exposes this one to the tests). A batch of
// envs rides blockIdx.y; ragged tails are masked by bounds. Built with
// -fmad=false: the masks are threshold tests, and a contracted d^2 would flip
// pairs at the boundary against the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_math.cuh"
#include "pair_plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_WARPS_PER_SM = 8;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;

struct BoidsArgs {
  float coh_sq, sep_sq, ali_sq;
  float coh_scale, sep_scale, ali_scale;
  int alignment;  // 0 under skip_alignment
};

template <int R>
__device__ __forceinline__ void pair_all(const float2 (&xi)[R], const float2 (&vi)[R],
                                         const int (&ii)[R], int j, float4 xv,
                                         const BoidsArgs& a, BoidsSums (&s)[R]) {
  const float2 xj = make_float2(xv.x, xv.y);
  const float2 vj = make_float2(xv.z, xv.w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (j != ii[r]) boids_pair(xi[r], vi[r], xj, vj, a.coh_sq, a.sep_sq, a.ali_sq,
                               a.alignment != 0, s[r]);
  }
}

template <int T, int R>
__global__ void boids_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                             float2* __restrict__ out, int n, int split, int chunk,
                             BoidsArgs a) {
  __shared__ float4 tile[T];  // (x_j, v_j)
  __shared__ float part_f[6][R * T];  // the partials the cluster's leader reads
  __shared__ int part_c[2][R * T];
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int i0 = (blockIdx.x / split) * T * R + t;
  const float2* pb = pos + (long long)b * n;
  const float2* vb = vel + (long long)b * n;
  float2 xi[R], vi[R];
  int ii[R];
  BoidsSums s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ii[r] = i0 + r * T;
    const bool in = ii[r] < n;
    xi[r] = in ? pb[ii[r]] : make_float2(0.f, 0.f);
    vi[r] = in ? vb[ii[r]] : make_float2(0.f, 0.f);
  }
  const int j_begin = rank * chunk;
  const int j_end = min(n, j_begin + chunk);
  auto load = [&](int j) {
    const float2 x = pb[j], v = vb[j];
    return make_float4(x.x, x.y, v.x, v.y);
  };
  float4 next = j_begin + t < j_end ? load(j_begin + t) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = j_begin; j0 < j_end; j0 += T) {
    __syncthreads();
    tile[t] = next;
    __syncthreads();
    if (j0 + T + t < j_end) next = load(j0 + T + t);
    if (j0 + T <= j_end) {
#pragma unroll 8
      for (int k = 0; k < T; ++k) pair_all<R>(xi, vi, ii, j0 + k, tile[k], a, s);
    } else {
      for (int k = 0; k < j_end - j0; ++k) pair_all<R>(xi, vi, ii, j0 + k, tile[k], a, s);
    }
  }

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
    if (ii[r] >= n) continue;
    // guarded means (the reference divides only when the count is > 0)
    const BoidsSums& q = s[r];
    const float cx = q.c1 > 0 ? q.s1x / (float)q.c1 : q.s1x;
    const float cy = q.c1 > 0 ? q.s1y / (float)q.c1 : q.s1y;
    const float ax = q.c3 > 0 ? q.s3x / (float)q.c3 : q.s3x;
    const float ay = q.c3 > 0 ? q.s3y / (float)q.c3 : q.s3y;
    out[(long long)b * n + ii[r]] =
        make_float2(cx * a.coh_scale + q.rx * a.sep_scale + ax * a.ali_scale,
                    cy * a.coh_scale + q.ry * a.sep_scale + ay * a.ali_scale);
  }
}

template <int T, int R>
cudaError_t launch(const PairPlan& plan, const float2* pos, const float2* vel, float2* out,
                   int batch, int n, const BoidsArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks_i * plan.split, batch);
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
      const cudaError_t err = cudaFuncSetAttribute(
          boids_kernel<T, R>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      opted_in[dev] = true;
    }
  }
  return cudaLaunchKernelEx(&cfg, boids_kernel<T, R>, pos, vel, out, n, plan.split, plan.chunk,
                            a);
}

template <int T>
cudaError_t launch_plan(const PairPlan& plan, const float2* pos, const float2* vel, float2* out,
                        int batch, int n, const BoidsArgs& a, cudaStream_t stream) {
  return plan.r == 2 ? launch<T, 2>(plan, pos, vel, out, batch, n, a, stream)
                     : launch<T, 1>(plan, pos, vel, out, batch, n, a, stream);
}

}  // namespace

// pos, vel, out: [B, N, 2] fp32, contiguous. Thresholds are squared.
// Returns the launch's error, else cudaGetLastError().
extern "C" int nbt_boids_velocity(const void* pos, const void* vel, void* out, int batch, int n,
                                  float coh_sq, float sep_sq, float ali_sq, float coh_scale,
                                  float sep_scale, float ali_scale, int skip_alignment,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const PairPlan plan =
        pair_plan(batch, n, n, multiprocessors(), MIN_WARPS_PER_SM, MAX_CLUSTER);
    const BoidsArgs a{coh_sq, sep_sq, ali_sq, coh_scale, sep_scale, ali_scale,
                      skip_alignment ? 0 : 1};
    const auto* p = static_cast<const float2*>(pos);
    const auto* v = static_cast<const float2*>(vel);
    auto* o = static_cast<float2*>(out);
    auto* st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (plan.threads) {
      case 256: err = launch_plan<256>(plan, p, v, o, batch, n, a, st); break;
      case 128: err = launch_plan<128>(plan, p, v, o, batch, n, a, st); break;
      case 64: err = launch_plan<64>(plan, p, v, o, batch, n, a, st); break;
      default: err = launch_plan<32>(plan, p, v, o, batch, n, a, st); break;
    }
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
