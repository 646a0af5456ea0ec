// The skin texture's bilinear sample (clamp-to-edge, the sampler the
// reference binds for skin.png, src/main.rs:358-376), shared by the eyes
// (disc_eye.cu, wireframe_eye.cu) and the wireframe pullback
// (wireframe_eye_bwd.cu).
//
// sample_texture's products and sums are those of
// nenbody_tpu_torch/vision/render.py::sample_texture in the same order, so
// that with -fmad=false the kernels sample as the plain versions do; the
// pullback reads the texels and weights it used from its Tap.
//
// A texture of at most SMEM_TEXELS texels (a 64 x 64 skin) is staged in
// shared memory by each block (stage_texture); a larger one is read through
// the read-only data path.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SMEM_TEXELS = 4096;

// The four texels one sample reads (row-major [Ht, Wt] indices) and its
// primal fractional position within them.
struct Tap {
  int i00, i01, i10, i11;
  float fx, fy;
};

__device__ __forceinline__ float fetch_texel(const float* tex, int i, bool staged) {
  return staged ? tex[i] : __ldg(tex + i);
}

// The texture [ht, wt] sampled at (u, v) (u along the width); `tex` points to
// shared memory when `staged`, else to device memory.
__device__ __forceinline__ float sample_texture(const float* tex, bool staged, int ht, int wt,
                                                float u, float v, Tap& tap) {
  const float x = fminf(fmaxf(u, 0.0f), 1.0f) * (float)(wt - 1);
  const float y = fminf(fmaxf(v, 0.0f), 1.0f) * (float)(ht - 1);
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  const int x1 = min(x0 + 1, wt - 1);
  const int y1 = min(y0 + 1, ht - 1);
  const float fx = x - (float)x0;
  const float fy = y - (float)y0;
  tap = Tap{y0 * wt + x0, y0 * wt + x1, y1 * wt + x0, y1 * wt + x1, fx, fy};
  const float t00 = fetch_texel(tex, tap.i00, staged);
  const float t01 = fetch_texel(tex, tap.i01, staged);
  const float t10 = fetch_texel(tex, tap.i10, staged);
  const float t11 = fetch_texel(tex, tap.i11, staged);
  return t00 * (1.0f - fx) * (1.0f - fy) + t01 * fx * (1.0f - fy) + t10 * (1.0f - fx) * fy +
         t11 * fx * fy;
}

// Copy a small texture into the block's shared memory `s_tex`; returns where
// the block reads the texture from (null without one). Every thread of the
// block calls it; it ends with a barrier when it stages.
__device__ __forceinline__ const float* stage_texture(const float* texture, int texels,
                                                      float* s_tex, bool& staged) {
  staged = texture != nullptr && texels <= SMEM_TEXELS;
  if (!staged) return texture;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < texels; i += blockDim.x * blockDim.y) s_tex[i] = texture[i];
  __syncthreads();
  return s_tex;
}

// Dynamic shared memory a launch gives stage_texture.
inline size_t staged_bytes(const void* texture, int texels) {
  return texture != nullptr && texels <= SMEM_TEXELS ? sizeof(float) * texels : 0;
}

}  // namespace
