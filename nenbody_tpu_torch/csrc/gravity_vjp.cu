// The pullback of all-pairs gravity on Hopper (the backward of gravity.cu).
//
// Replaces nenbody_tpu/ops/pairwise.py::_gravity_vjp_kernel (the Pallas TPU
// kernel behind the custom VJP gravity_forces_diff). With
// g_i = G * sum_j (x_j - x_i) / d2_ij, d2 = |x_j - x_i|^2 + bias, and a
// cotangent u on g, for every agent k of env b:
//
//     dL/dx_k = G * sum_j [ (u_j - u_k)/d2 - 2 r ((u_j - u_k) . r)/d2^2 ],
//     r = x_k - x_j, d2 = |r|^2 + bias
//
// (A(r) = I/d2 - 2 r r^T/d2^2 is even in r, so the i-sum and the j-sum of
// the chain rule fold into one all-pairs pass). u_j - u_k is taken BEFORE
// any product: forming A u_j and A u_k apart and subtracting cancels in
// fp32 (DESIGN.md section 4b; pairwise.py:187-188). The self-pair gives
// exactly 0 (u_k - u_k = 0 and r = 0, bias keeps d2 finite).
//
// The cross form (nbt_gravity_vjp_cross) is the pullback of the forces BY a
// set pos_j ON a set pos_i, g_i = G * sum_j (y_j - x_i) / d2_ij, which a ring
// hop past the first computes (the first, a shard's own block, takes the
// self form above, whose u_j - u_k ordering keeps the diagonal block exact):
//
//     dL/dx_i = -G * sum_j A(r_ij) u_i,   dL/dy_j = G * sum_i A(r_ij) u_i,
//     A(r) = I/d2 - 2 r r^T/d2^2,  r = y_j - x_i,  d2 = |r|^2 + bias.
//
// Both are the self form's pair loop with another w in place of u_j - u_k,
// launched twice with the roles swapped: for each k of its own set,
// out_k = sign * G * sum_m A(x_k - y_m) w, with w = u_k (the k's own
// cotangent, sign -1: the rows) or w = v_m (the other set's, sign +1: the
// columns); A is even in r, so the direction of r does not matter. 1/d2^2
// is taken as (1/d2)^2, so a far ring sentinel (d2 = 1e34, 1/d2 = 1e-34)
// underflows to 0 instead of overflowing.
//
// The reciprocal is pair_math.cuh's `reciprocal<false>` (rcp.approx and one
// Newton step, within an ulp of the IEEE divide, without its slow-path
// branch), whatever the forward's approx_reciprocal, as the JAX VJP ignores
// it too.
//
// What bounds it: instruction issue on the fp32 pipe. The sources build
// with -fmad=false, which would leave a pair 24 fp32 instructions and one
// MUFU reciprocal (about 3.1 ms of issue at N=65,536 on 132 SMs at
// 1.98 GHz); the pair contracts its squared distance, dot product and
// accumulations by explicit fma instead, 17 instructions (about 2.2 ms),
// which the checks against the plain version and float64 hold as before.
// Design, as gravity.cu's:
// - T threads per block, R bodies per thread (register blocking): each
//   (x_j, u_j) read from shared memory as one float4 feeds R pairs, and the
//   R reciprocals are independent, so their latency overlaps.
// - The block stages j-tiles of T (x_j, u_j) in shared memory, one
//   coalesced load per thread, the next tile prefetched into registers while
//   the current one is summed; a full tile runs an unrolled loop of constant
//   trip count, the ragged tail a masked one.
// - Where the bodies alone would give an SM fewer than MIN_WARPS_PER_SM
//   warps, the j range is split S ways (S <= 8) across the blocks of a
//   thread-block cluster: each sums its chunk in j order, and the leader
//   adds the S partials through distributed shared memory in rank order, so
//   the result is deterministic and the call one launch (two for the cross
//   form, one per role, each with its own plan).
// pair_plan.cuh's pair_plan picks T, R and S; ops/pairwise.py::
// gravity_vjp_plan is its plain version and the two must agree
// (nbt_gravity_vjp_plan exposes this one to the tests). A batch of envs rides
// blockIdx.y; the ragged tails of k and j are masked by bounds (no padding).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_math.cuh"
#include "pair_plan.cuh"

namespace cg = cooperative_groups;

namespace {

// the grid the plan aims for: enough warps on each SM to hide the MUFU and
// shared-memory latencies
constexpr int MIN_WARPS_PER_SM = 8;

// The pair loop's w: u_j - u_k (the self form), u_k (the cross form's rows)
// or v_j (its columns).
enum Form { SELF, ROWS, COLS };

// (ox, oy) += A(x_k - y_j) w for the j staged as (y_j, v_j) in `yv`: the
// plain version's terms (pairwise.py::_gravity_vjp_rows) with the squared
// distance, the dot product and the two accumulations contracted by
// explicit fma (17 fp32 instructions and the MUFU instead of 24), the
// differences r and w still taken before any product
template <Form F>
__device__ __forceinline__ void pair(float2 xk, float2 uk, float4 yv, float bias, float& ox,
                                     float& oy) {
  const float rx = xk.x - yv.x;
  const float ry = xk.y - yv.y;
  const float d2 = __fmaf_rn(rx, rx, __fmaf_rn(ry, ry, bias));
  const float wx = F == SELF ? yv.z - uk.x : F == ROWS ? uk.x : yv.z;
  const float wy = F == SELF ? yv.w - uk.y : F == ROWS ? uk.y : yv.w;
  const float inv = reciprocal<false>(d2);
  const float dot2 = 2.0f * __fmaf_rn(wx, rx, wy * ry) * (inv * inv);
  ox = __fmaf_rn(-rx, dot2, __fmaf_rn(wx, inv, ox));
  oy = __fmaf_rn(-ry, dot2, __fmaf_rn(wy, inv, oy));
}

// xs, us: the k set's positions and cotangents [B, n] (us unread by COLS);
// ys, vs: the j set's [B, m] (vs unread by ROWS); out [B, n].
template <int T, int R, Form F>
__global__ void gravity_vjp_kernel(const float2* __restrict__ xs, const float2* __restrict__ us,
                                   const float2* __restrict__ ys, const float2* __restrict__ vs,
                                   float2* __restrict__ out, int n, int m, int split, int chunk,
                                   float scale, float bias) {
  __shared__ float4 tile[T];  // (y_j, v_j)
  __shared__ float2 partial[R * T];  // read by the cluster's leader
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int k0 = (blockIdx.x / split) * T * R + t;
  const float2* yb = ys + (long long)b * m;
  const float2* vb = F == ROWS ? nullptr : vs + (long long)b * m;
  float2 xk[R], uk[R];
  float ox[R], oy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r * T;
    const bool in = k < n;
    xk[r] = in ? xs[(long long)b * n + k] : make_float2(0.f, 0.f);
    uk[r] = in && F != COLS ? us[(long long)b * n + k] : make_float2(0.f, 0.f);
    ox[r] = 0.f;
    oy[r] = 0.f;
  }
  auto load = [&](int j) {
    const float2 y = yb[j];
    const float2 v = F == ROWS ? make_float2(0.f, 0.f) : vb[j];
    return make_float4(y.x, y.y, v.x, v.y);
  };
  const int j_begin = rank * chunk;
  const int j_end = min(m, j_begin + chunk);
  float4 next = j_begin + t < j_end ? load(j_begin + t) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = j_begin; j0 < j_end; j0 += T) {
    __syncthreads();
    tile[t] = next;
    __syncthreads();
    if (j0 + T + t < j_end) next = load(j0 + T + t);
    if (j0 + T <= j_end) {
#pragma unroll 16
      for (int q = 0; q < T; ++q) {
        const float4 yv = tile[q];
#pragma unroll
        for (int r = 0; r < R; ++r) pair<F>(xk[r], uk[r], yv, bias, ox[r], oy[r]);
      }
    } else {
      for (int q = 0; q < j_end - j0; ++q) {
        const float4 yv = tile[q];
#pragma unroll
        for (int r = 0; r < R; ++r) pair<F>(xk[r], uk[r], yv, bias, ox[r], oy[r]);
      }
    }
  }

  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < R; ++r) partial[r * T + t] = make_float2(ox[r], oy[r]);
    cluster.sync();
    if (rank == 0) {
      for (int s = 1; s < split; ++s) {
        const float2* other = cluster.map_shared_rank(partial, s);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 v = other[r * T + t];
          ox[r] += v.x;
          oy[r] += v.y;
        }
      }
    }
    cluster.sync();  // every partial stays in shared memory until the leader has read it
    if (rank != 0) return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r * T;
    if (k < n) out[(long long)b * n + k] = make_float2(scale * ox[r], scale * oy[r]);
  }
}

struct VjpArgs {
  const float2* xs;
  const float2* us;
  const float2* ys;
  const float2* vs;
  float2* out;
  int batch, n, m;
  float scale, bias;
};

template <int T, int R, Form F>
cudaError_t launch(const PairPlan& plan, const VjpArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks_i * plan.split, a.batch);
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, gravity_vjp_kernel<T, R, F>, a.xs, a.us, a.ys, a.vs, a.out,
                            a.n, a.m, plan.split, plan.chunk, a.scale, a.bias);
}

// The instantiation of gravity_vjp_kernel that `plan` names, for the form F.
template <Form F>
cudaError_t launch_plan(const VjpArgs& a, cudaStream_t stream) {
  const PairPlan plan =
      pair_plan(a.batch, a.n, a.m, multiprocessors(), MIN_WARPS_PER_SM, MAX_SPLIT);
  const bool two = plan.r == 2;
  switch (plan.threads) {
    case 256: return two ? launch<256, 2, F>(plan, a, stream) : launch<256, 1, F>(plan, a, stream);
    case 128: return two ? launch<128, 2, F>(plan, a, stream) : launch<128, 1, F>(plan, a, stream);
    case 64: return two ? launch<64, 2, F>(plan, a, stream) : launch<64, 1, F>(plan, a, stream);
    default: return two ? launch<32, 2, F>(plan, a, stream) : launch<32, 1, F>(plan, a, stream);
  }
}

}  // namespace

// pos, u, out [B, N, 2]; all fp32, contiguous. Returns the launch's error,
// else cudaGetLastError().
extern "C" int nbt_gravity_vjp(const void* pos, const void* u, void* out, int batch, int n,
                               float g, float bias, void* stream) {
  if (batch > 0 && n > 0) {
    const auto* p = static_cast<const float2*>(pos);
    const auto* c = static_cast<const float2*>(u);
    const VjpArgs a{p, c, p, c, static_cast<float2*>(out), batch, n, n, g, bias};
    const cudaError_t err = launch_plan<SELF>(a, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cross form: pos_i, u [B, N, 2]; pos_j [B, M, 2]; g_i [B, N, 2] and g_j
// [B, M, 2] (d pos_i and d pos_j); all fp32, contiguous. Two launches of the
// pair loop, the rows' and the columns', each with its own plan. Returns the
// first launch error, else cudaGetLastError().
extern "C" int nbt_gravity_vjp_cross(const void* pos_i, const void* pos_j, const void* u,
                                     void* g_i, void* g_j, int batch, int n, int m, float g,
                                     float bias, void* stream) {
  const auto* xi = static_cast<const float2*>(pos_i);
  const auto* yj = static_cast<const float2*>(pos_j);
  const auto* c = static_cast<const float2*>(u);
  auto* st = static_cast<cudaStream_t>(stream);
  if (batch > 0 && n > 0) {
    const VjpArgs rows{xi, c, yj, nullptr, static_cast<float2*>(g_i), batch, n, m, -g, bias};
    const cudaError_t err = launch_plan<ROWS>(rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0 && m > 0) {
    const VjpArgs cols{yj, nullptr, xi, c, static_cast<float2*>(g_j), batch, m, n, g, bias};
    const cudaError_t err = launch_plan<COLS>(cols, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan nbt_gravity_vjp launches for (batch, n, n), and each launch of
// nbt_gravity_vjp_cross for (batch, n, m) (the rows) and (batch, m, n) (the
// columns), on a card with `sms` SMs: out[0..4] = T, R, S, chunk, i-blocks.
extern "C" int nbt_gravity_vjp_plan(int batch, int n, int m, int sms, void* out) {
  write_plan(pair_plan(batch, n, m, sms, MIN_WARPS_PER_SM, MAX_SPLIT), out);
  return 0;
}
