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
// What bounds it: the fp32 pipe. Each pair costs 8 flops plus one divide
// (an exact IEEE divide is a reciprocal plus Newton refinement, several
// instructions), against 8 bytes of position that every thread of a block
// shares. Design: one thread per i keeps its accumulators in registers;
// the block stages j-tiles of TILE float2 positions in shared memory, so
// each position is read from device memory once per block, not once per
// thread. A batch of envs rides blockIdx.y; the ragged tails of i and j are
// masked by bounds (no padding). Built with -fmad=false so the products
// round like the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void gravity_kernel(const float2* __restrict__ pos_i,
                               const float2* __restrict__ pos_j, float2* __restrict__ out,
                               int n, int m, float g, float bias, int approx) {
  __shared__ float2 tile[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * TILE + threadIdx.x;
  const float2* pj = pos_j + (long long)b * m;
  float2 xi = make_float2(0.f, 0.f);
  if (i < n) xi = pos_i[(long long)b * n + i];
  float gx = 0.f, gy = 0.f;
  for (int j0 = 0; j0 < m; j0 += TILE) {
    const int j = j0 + threadIdx.x;
    if (j < m) tile[threadIdx.x] = pj[j];
    __syncthreads();
    const int cnt = min(TILE, m - j0);
    for (int k = 0; k < cnt; ++k) {
      const float2 xj = tile[k];
      const float dx = xj.x - xi.x;
      const float dy = xj.y - xi.y;
      const float d2 = dx * dx + dy * dy + bias;
      const float w = approx ? __fdividef(1.0f, d2) : 1.0f / d2;
      gx += dx * w;
      gy += dy * w;
    }
    __syncthreads();
  }
  if (i < n) out[(long long)b * n + i] = make_float2(g * gx, g * gy);
}

}  // namespace

// pos_i [B, N, 2], pos_j [B, M, 2] (may alias pos_i), out [B, N, 2]; all
// fp32, contiguous. Returns cudaGetLastError() after the launch.
extern "C" int nbt_gravity_forces(const void* pos_i, const void* pos_j, void* out, int batch,
                                  int n, int m, float g, float bias, int approx,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    dim3 grid((n + TILE - 1) / TILE, batch);
    gravity_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos_i), static_cast<const float2*>(pos_j),
        static_cast<float2*>(out), n, m, g, bias, approx);
  }
  return static_cast<int>(cudaGetLastError());
}
