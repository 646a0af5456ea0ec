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
// exactly 0 (u_k - u_k = 0, bias keeps d2 finite). The divide is always
// exact, even when the forward ran with approx_reciprocal, as in the JAX
// VJP.
//
// What bounds it: the fp32 pipe, as in the forward: one exact divide and
// about 16 flops per pair against 16 bytes of (x_j, u_j) that every thread
// of a block shares. Design: one thread per k keeps (x_k, u_k)
// and its two accumulators in registers; the block stages j-tiles of TILE
// (x_j, u_j) pairs as float4 in shared memory; a batch of envs rides
// blockIdx.y; ragged tails are masked by bounds. Built with -fmad=false.
//
// The cross form (nbt_gravity_vjp_cross) is the pullback of the forces BY a
// set pos_j ON a set pos_i, g_i = G * sum_j (y_j - x_i) / d2_ij, which a ring
// hop past the first computes (the first, a shard's own block, takes the
// self form above, whose u_j - u_k ordering keeps the diagonal block exact):
//
//     dL/dx_i = -G * sum_j A(r_ij) u_i,   dL/dy_j = G * sum_i A(r_ij) u_i,
//     A(r) = I/d2 - 2 r r^T/d2^2,  r = y_j - x_i,  d2 = |r|^2 + bias.
//
// Both are one pair loop, launched twice with the roles swapped: for each
// k of its own set, out_k = sign * G * sum_m A(x_k - y_m) w, with w = u_k
// (the k's own cotangent, sign -1: the rows) or w = v_m (the other set's,
// sign +1: the columns); A is even in r, so the direction of r does not
// matter. 1/d2^2 is taken as (1/d2)^2, so a far ring sentinel (d2 = 1e34)
// underflows to 0 instead of overflowing. Bound and design as above.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void gravity_vjp_kernel(const float2* __restrict__ pos, const float2* __restrict__ u,
                                   float2* __restrict__ out, int n, float g, float bias) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int k = blockIdx.x * TILE + threadIdx.x;
  const float2* pb = pos + (long long)b * n;
  const float2* ub = u + (long long)b * n;
  float2 xk = make_float2(0.f, 0.f), uk = make_float2(0.f, 0.f);
  if (k < n) {
    xk = pb[k];
    uk = ub[k];
  }
  float ox = 0.f, oy = 0.f;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      const float2 xj = pb[j];
      const float2 uj = ub[j];
      tile[threadIdx.x] = make_float4(xj.x, xj.y, uj.x, uj.y);
    }
    __syncthreads();
    const int cnt = min(TILE, n - j0);
    for (int q = 0; q < cnt; ++q) {
      const float4 t = tile[q];
      const float rx = xk.x - t.x;
      const float ry = xk.y - t.y;
      const float d2 = rx * rx + ry * ry + bias;
      const float sux = t.z - uk.x;
      const float suy = t.w - uk.y;
      const float inv = 1.0f / d2;
      const float dot2 = 2.0f * (sux * rx + suy * ry) * (inv * inv);
      ox += sux * inv - rx * dot2;
      oy += suy * inv - ry * dot2;
    }
    __syncthreads();
  }
  if (k < n) out[(long long)b * n + k] = make_float2(g * ox, g * oy);
}

__global__ void gravity_vjp_cross_kernel(const float2* __restrict__ xs,
                                         const float2* __restrict__ us,
                                         const float2* __restrict__ ys,
                                         const float2* __restrict__ vs, float2* __restrict__ out,
                                         int n, int m, float g, float bias, int own) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int k = blockIdx.x * TILE + threadIdx.x;
  const float2* yb = ys + (long long)b * m;
  const float2* vb = own ? nullptr : vs + (long long)b * m;
  float2 xk = make_float2(0.f, 0.f), uk = make_float2(0.f, 0.f);
  if (k < n) {
    xk = xs[(long long)b * n + k];
    if (own) uk = us[(long long)b * n + k];
  }
  float ox = 0.f, oy = 0.f;
  for (int j0 = 0; j0 < m; j0 += TILE) {
    const int j = j0 + threadIdx.x;
    if (j < m) {
      const float2 yj = yb[j];
      const float2 vj = own ? uk : vb[j];
      tile[threadIdx.x] = make_float4(yj.x, yj.y, vj.x, vj.y);
    }
    __syncthreads();
    const int cnt = min(TILE, m - j0);
    for (int q = 0; q < cnt; ++q) {
      const float4 t = tile[q];
      const float rx = xk.x - t.x;
      const float ry = xk.y - t.y;
      const float d2 = rx * rx + ry * ry + bias;
      const float wx = own ? uk.x : t.z;
      const float wy = own ? uk.y : t.w;
      const float inv = 1.0f / d2;
      const float dot2 = 2.0f * (wx * rx + wy * ry) * (inv * inv);
      ox += wx * inv - rx * dot2;
      oy += wy * inv - ry * dot2;
    }
    __syncthreads();
  }
  if (k < n) {
    const float sg = own ? -g : g;
    out[(long long)b * n + k] = make_float2(sg * ox, sg * oy);
  }
}

}  // namespace

// pos, u, out [B, N, 2]; all fp32, contiguous. Returns cudaGetLastError()
// after the launch.
extern "C" int nbt_gravity_vjp(const void* pos, const void* u, void* out, int batch, int n,
                               float g, float bias, void* stream) {
  if (batch > 0 && n > 0) {
    dim3 grid((n + TILE - 1) / TILE, batch);
    gravity_vjp_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos), static_cast<const float2*>(u),
        static_cast<float2*>(out), n, g, bias);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cross form: pos_i, u [B, N, 2]; pos_j [B, M, 2]; g_i [B, N, 2] and g_j
// [B, M, 2] (d pos_i and d pos_j); all fp32, contiguous. Two launches of the
// pair loop. Returns cudaGetLastError() after them.
extern "C" int nbt_gravity_vjp_cross(const void* pos_i, const void* pos_j, const void* u,
                                     void* g_i, void* g_j, int batch, int n, int m, float g,
                                     float bias, void* stream) {
  if (batch > 0 && n > 0) {
    dim3 grid((n + TILE - 1) / TILE, batch);
    gravity_vjp_cross_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos_i), static_cast<const float2*>(u),
        static_cast<const float2*>(pos_j), nullptr, static_cast<float2*>(g_i), n, m, g, bias, 1);
  }
  if (batch > 0 && m > 0) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    dim3 grid((m + TILE - 1) / TILE, batch);
    gravity_vjp_cross_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos_j), nullptr, static_cast<const float2*>(pos_i),
        static_cast<const float2*>(u), static_cast<float2*>(g_j), m, n, g, bias, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
