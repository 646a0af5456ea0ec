// The disc eye on Hopper: every agent's 1D vision line in one launch.
//
// Replaces BOTH Pallas TPU kernels of the disc eye,
// nenbody_tpu/ops/raycast.py::_raster_kernel (projections precomputed into
// [N_e, N_t] tensors) and ::_raycast_kernel (projections in-kernel). The TPU
// kept two routes for lane packing; a GPU has no such reason, so one kernel
// projects in-kernel and never writes an [N_e, N_t] tensor to device memory.
//
// For eye e (position p_e, unit heading d_e), target j and pixel centre u_p
// (NDC), as nenbody_tpu_torch/vision/render.py computes them:
//   f = rel . d_e, l = rel . (d_e.y, -d_e.x), rel = x_j - p_e
//   visible iff near < f < far and |u_c| <= 1 + du, u_c = l/(f t), du = r/(f t)
//   covered iff visible and |off| < 1 (1 + (1/W)/du with antialias),
//   off = (u_p - u_c)/du
// and the nearest covered target wins the pixel. Targets are scanned in index
// order with a strict < on depth, so a depth tie goes to the lowest index,
// the rule of the plain version's argmin. The epilogue shades the winner with
// the squared-radial vignette and, with antialias, box-filters its edge
// coverage against the background (raycast.py::_decode_winner's outputs).
// Appearance (the Pallas kernels' has_alb and raw forms): with a per-target
// albedo [B, Nt] the epilogue reads the winner's own albedo in place of the
// scalar; with a texture it samples the skin at the winner's splat uv
// (0.5 + 0.5 oc, 0.5), before the vignette and the antialias blend. The TPU
// kernels write the winner's raw streams (signed offset, 1/du, albedo) to
// device memory for an XLA epilogue to decode (raycast.py::_decode_textured),
// because Mosaic does not gather; here the one sample per pixel runs in the
// kernel's own epilogue, from a texture staged in shared memory
// (texture.cuh), so no raw stream is written.
// When the wrapper passes a winner buffer (autograd needs the pixel), the
// kernel also writes each pixel's winning target index (-1 for background):
// the residual of the backward kernel, disc_eye_bwd.cu.
//
// What bounds it: the fp32 divide of off for each (eye, target, pixel) that
// is nearer than the current winner. Design: a block owns EG eyes x PB
// pixels of one env (blockIdx.z). For each tile of PB targets, each thread
// first projects one (eye, target) pair into shared memory (depth, u_c, du,
// coverage threshold; an invisible target gets depth +inf), then every
// thread scans the tile for its (eye, pixel), skipping the divide for targets
// behind its current winner. Any width and any N: pixel, eye and target
// tails are masked by bounds. Built with -fmad=false so that edge pixels
// agree with the plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "pair_math.cuh"
#include "texture.cuh"

namespace {

constexpr int THREADS = 256;

struct EyeParams {
  float tan_half_fov;
  float near_plane;
  float far_plane;
  float radius;
  float inv_width;   // 1/W, the NDC half-width of a pixel
  float half_width;  // W/2
  float background;
  float albedo;
  int antialias;
};

__global__ void disc_eye_kernel(const float2* __restrict__ eye_pos,
                                const float2* __restrict__ eye_dir,
                                const float2* __restrict__ tgt,
                                const float* __restrict__ albedo,
                                const float* __restrict__ texture, float* __restrict__ shade,
                                float* __restrict__ depth, int* __restrict__ winner, int ne,
                                int nt, int w, int ht, int wt, EyeParams q) {
  extern __shared__ float s_tex[];  // the staged texture (texture.cuh)
  __shared__ float s_f[THREADS];
  __shared__ float s_uc[THREADS];
  __shared__ float s_du[THREADS];
  __shared__ float s_thr[THREADS];
  const int pb = blockDim.x;  // pixels per block == targets per tile
  const int b = blockIdx.z;
  const int e = blockIdx.x * blockDim.y + threadIdx.y;
  const int p = blockIdx.y * pb + threadIdx.x;
  const int row = threadIdx.y * pb;

  float2 pe = make_float2(0.f, 0.f), de = make_float2(1.f, 0.f);
  if (e < ne) {
    pe = eye_pos[(long long)b * ne + e];
    de = eye_dir[(long long)b * ne + e];
  }
  const float2* tb = tgt + (long long)b * nt;
  const float u_p = 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
  bool staged;
  const float* tex = stage_texture(texture, ht * wt, s_tex, staged);

  float best_d = INFINITY, best_off = 0.f, best_du = 1.f;
  int best_j = -1;
  for (int j0 = 0; j0 < nt; j0 += pb) {
    const int j = j0 + threadIdx.x;
    float fv = INFINITY, uc = 0.f, du = 1.f, thr = 0.f;
    if (e < ne && j < nt) {
      float f, u, ft;
      const bool in_depth =
          disc_project(pe, de, tb[j], q.near_plane, q.far_plane, q.tan_half_fov, f, u, ft);
      const float d = q.radius / ft;
      if (in_depth && fabsf(u) <= 1.0f + d) {
        fv = f;
        uc = u;
        du = fmaxf(d, 1e-30f);
        thr = q.antialias ? 1.0f + q.inv_width / du : 1.0f;
      }
    }
    s_f[row + threadIdx.x] = fv;
    s_uc[row + threadIdx.x] = uc;
    s_du[row + threadIdx.x] = du;
    s_thr[row + threadIdx.x] = thr;
    __syncthreads();
    const int cnt = min(pb, nt - j0);
    for (int k = 0; k < cnt; ++k) {
      const float fk = s_f[row + k];
      if (fk < best_d) {
        const float duk = s_du[row + k];
        const float off = (u_p - s_uc[row + k]) / duk;
        if (fabsf(off) < s_thr[row + k]) {
          best_d = fk;
          best_off = off;
          best_du = duk;
          best_j = j0 + k;
        }
      }
    }
    __syncthreads();
  }

  if (e < ne && p < w) {
    const long long o = ((long long)b * ne + e) * w + p;
    if (winner) winner[o] = best_j;
    if (best_d < INFINITY) {
      const float oc = fminf(fmaxf(best_off, -1.0f), 1.0f);
      float alb = albedo ? albedo[(long long)b * nt + best_j] : q.albedo;
      if (tex) {
        Tap tap;
        alb = alb * sample_texture(tex, staged, ht, wt, 0.5f + 0.5f * oc, 0.5f, tap);
      }
      float val = alb * (1.0f - 0.25f * oc * oc);
      if (q.antialias) {
        const float s_win = q.half_width * best_du;
        const float covf = fminf(fmaxf((1.0f - fabsf(best_off)) * s_win + 0.5f, 0.0f), 1.0f);
        val = q.background + covf * (val - q.background);
      }
      shade[o] = val;
      depth[o] = best_d;
    } else {
      shade[o] = q.background;
      depth[o] = q.far_plane;
    }
  }
}

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt [B, Nt, 2]; albedo [B, Nt], or null for
// the scalar; texture [ht, wt], or null for none; shade, depth [B, Ne, W];
// all fp32, contiguous; winner [B, Ne, W] int32, or null to skip it. Returns
// cudaGetLastError() after the launch.
extern "C" int nbt_disc_eye(const void* eye_pos, const void* eye_dir, const void* tgt,
                            const void* albedo, const void* texture, void* shade, void* depth,
                            void* winner, int batch, int ne, int nt, int w, int ht, int wt,
                            float tan_half_fov, float near_plane, float far_plane, float radius,
                            float inv_width, float half_width, float background,
                            float albedo_scalar, int antialias, void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    const int pb = w <= 32 ? 32 : (w <= 64 ? 64 : 128);
    const int eg = THREADS / pb;
    dim3 block(pb, eg);
    dim3 grid((ne + eg - 1) / eg, (w + pb - 1) / pb, batch);
    EyeParams q{tan_half_fov, near_plane, far_plane, radius, inv_width,
                half_width,   background, albedo_scalar, antialias};
    disc_eye_kernel<<<grid, block, staged_bytes(texture, ht * wt),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const float*>(albedo),
        static_cast<const float*>(texture), static_cast<float*>(shade),
        static_cast<float*>(depth), static_cast<int*>(winner), ne, nt, w, ht, wt, q);
  }
  return static_cast<int>(cudaGetLastError());
}
