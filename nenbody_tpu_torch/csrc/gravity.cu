// All-pairs gravity forces on Hopper.
//
// Replaces nenbody_tpu/ops/pairwise.py::_gravity_kernel (the Pallas TPU
// kernel). For every agent i of env b:
//
//     g_i = G * sum_j (x_j - x_i) / (|x_j - x_i|^2 + bias)
//
// the self-pair included (zero numerator, bias keeps the denominator
// finite), exactly as nenbody_tpu_torch/physics/dense.py.
//
// What bounds it: instruction issue on the fp32 pipe. Built with
// -fmad=false (the products round like the plain PyTorch version), a pair
// is 12 fp32 instructions (two differences, two squares, two adds, one
// Newton step, two products, two accumulations) and one MUFU reciprocal:
// at one warp instruction per scheduler and clock, about 1.7 ms at
// N=65,536 on 132 SMs at 1.98 GHz, against the 0.7 ms the FMA-counted peak
// gives. Design:
// - T threads per block, R bodies per thread (register blocking): each x_j
//   read from shared memory feeds R pairs, and the R reciprocals are
//   independent, so their latency overlaps.
// - The block stages j-tiles of T positions in shared memory, one coalesced
//   load per thread, the next tile prefetched into a register while the
//   current one is summed; a full tile runs an unrolled loop of constant
//   trip count, the ragged tail a masked one. That loop is
//   gravity_tile.cuh's, which the RDMA ring's gravity (rdma_ring.cu) runs
//   too.
// - The reciprocal is rcp.approx (MUFU, within 1 ulp) plus one Newton step
//   in explicit fma, which -fmad=false leaves alone: as accurate as the IEEE
//   divide's reciprocal within an ulp, without its per-pair slow-path
//   branch (d2 >= bias > 0 never takes it).
// - When the bodies alone would give an SM fewer than MIN_WARPS_PER_SM
//   warps (N=1,024 gives 32 in all), the j range is split S ways (S <= 8)
//   across the blocks of a thread-block cluster: each sums its chunk in j
//   order, and the leader adds the S partials through distributed shared
//   memory in rank order, so the result is deterministic and the call one
//   launch.
// pair_plan.cuh's pair_plan picks T, R and S (large blocks of two bodies a
// thread for large N, one-warp blocks of one for small N, as measured on an
// H100); ops/pairwise.py::gravity_plan is its plain version and the two
// must agree (nbt_gravity_plan exposes this one to the tests). A batch of envs
// rides blockIdx.y; the ragged tails of i and j are masked by bounds (no
// padding).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gravity_tile.cuh"
#include "pair_plan.cuh"

namespace cg = cooperative_groups;

namespace {

// the grid the plan aims for: enough warps on each SM to hide the MUFU and
// shared-memory latencies
constexpr int MIN_WARPS_PER_SM = 8;

template <int T, int R, bool APPROX>
__global__ void gravity_kernel(const float2* __restrict__ pos_i,
                               const float2* __restrict__ pos_j, float2* __restrict__ out,
                               int n, int m, int split, int chunk, float g, float bias) {
  __shared__ float2 tile[T];
  __shared__ float2 partial[R * T];  // read by the cluster's leader
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int i0 = (blockIdx.x / split) * T * R + t;
  const float2* pj = pos_j + (long long)b * m;
  float2 xi[R];
  float gx[R], gy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    xi[r] = i < n ? pos_i[(long long)b * n + i] : make_float2(0.f, 0.f);
    gx[r] = 0.f;
    gy[r] = 0.f;
  }
  const int j_begin = rank * chunk;
  const int j_end = min(m, j_begin + chunk);
  gravity_j_range<T, R, APPROX, false>(tile, [pj](int j) { return pj[j]; }, j_begin, j_end, xi,
                                       bias, gx, gy);

  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < R; ++r) partial[r * T + t] = make_float2(gx[r], gy[r]);
    cluster.sync();
    if (rank == 0) {
      for (int s = 1; s < split; ++s) {
        const float2* other = cluster.map_shared_rank(partial, s);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 v = other[r * T + t];
          gx[r] += v.x;
          gy[r] += v.y;
        }
      }
    }
    cluster.sync();  // every partial stays in shared memory until the leader has read it
    if (rank != 0) return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    if (i < n) out[(long long)b * n + i] = make_float2(g * gx[r], g * gy[r]);
  }
}

template <int T, int R, bool APPROX>
cudaError_t launch(const PairPlan& plan, const float2* pos_i, const float2* pos_j,
                   float2* out, int batch, int n, int m, float g, float bias,
                   cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, gravity_kernel<T, R, APPROX>, pos_i, pos_j, out, n, m,
                            plan.split, plan.chunk, g, bias);
}

// The instantiation of gravity_kernel that `plan` names.
template <int T>
cudaError_t launch_plan(const PairPlan& plan, bool approx, const float2* pos_i,
                        const float2* pos_j, float2* out, int batch, int n, int m, float g,
                        float bias, cudaStream_t stream) {
  if (plan.r == 2) {
    return approx ? launch<T, 2, true>(plan, pos_i, pos_j, out, batch, n, m, g, bias, stream)
                  : launch<T, 2, false>(plan, pos_i, pos_j, out, batch, n, m, g, bias, stream);
  }
  return approx ? launch<T, 1, true>(plan, pos_i, pos_j, out, batch, n, m, g, bias, stream)
                : launch<T, 1, false>(plan, pos_i, pos_j, out, batch, n, m, g, bias, stream);
}

}  // namespace

// pos_i [B, N, 2], pos_j [B, M, 2] (may alias pos_i), out [B, N, 2]; all
// fp32, contiguous. Returns the launch's error, else cudaGetLastError().
extern "C" int nbt_gravity_forces(const void* pos_i, const void* pos_j, void* out, int batch,
                                  int n, int m, float g, float bias, int approx,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const PairPlan plan = pair_plan(batch, n, m, multiprocessors(), MIN_WARPS_PER_SM, MAX_SPLIT);
    const auto* pi = static_cast<const float2*>(pos_i);
    const auto* pj = static_cast<const float2*>(pos_j);
    auto* o = static_cast<float2*>(out);
    auto* st = static_cast<cudaStream_t>(stream);
    const bool ap = approx != 0;
    cudaError_t err;
    switch (plan.threads) {
      case 256: err = launch_plan<256>(plan, ap, pi, pj, o, batch, n, m, g, bias, st); break;
      case 128: err = launch_plan<128>(plan, ap, pi, pj, o, batch, n, m, g, bias, st); break;
      case 64: err = launch_plan<64>(plan, ap, pi, pj, o, batch, n, m, g, bias, st); break;
      default: err = launch_plan<32>(plan, ap, pi, pj, o, batch, n, m, g, bias, st); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan nbt_gravity_forces launches for (batch, n, m) on a card with
// `sms` SMs: out[0..4] = T, R, S, chunk, i-blocks.
extern "C" int nbt_gravity_plan(int batch, int n, int m, int sms, void* out) {
  write_plan(pair_plan(batch, n, m, sms, MIN_WARPS_PER_SM, MAX_SPLIT), out);
  return 0;
}
