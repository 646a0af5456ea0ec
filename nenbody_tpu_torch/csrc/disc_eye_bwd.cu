// The pullback of the disc eye on Hopper (the backward of disc_eye.cu).
//
// Replaces nenbody_tpu/ops/raycast.py::_raycast_bwd_kernel (the Pallas TPU
// kernel behind the custom VJP render_rows_diff). Given cotangents us, ud on
// (shade, depth) [B, Ne, W], it returns d eye position [B, Ne, 2], d eye
// heading [B, Ne, 2] and d target position [B, Nt, 2].
//
// Design: a winner-index backward. The forward kernel, when autograd needs
// it, writes the index of each pixel's winning target (-1 for background).
// The shade and depth of a pixel depend on its winner alone, so one thread
// per (env, eye, pixel) reads the index, recomputes rel, f, l, u_c, du and
// off for that one target with the forward's expressions (built with
// -fmad=false, so off rounds as in the forward and the plain renderer), and
// evaluates the derivative of raycast.py:705-752:
//   off = (u_p - u_c)/du, with d off/d f = u_p t/R and d off/d l = -1/R;
//   vignette dval = -albedo/2 * off on |off| <= 1;
//   with antialias, shade = bg + covf (val - bg), covf = clamp(c, 0, 1),
//   c = (1 - |off|) s + 1/2, s = (W/2) du, d s/d f = -s/f, so
//   d shade/d off = covf dval - sign(off) s (val - bg) and
//   d shade/d s = (1 - |off|)(val - bg) where 0 <= c <= 1 ("live");
//   the depth cotangent ud adds to d f.
// (Inclusive bounds, as autograd through the plain renderer's clamps.)
// d f and d l then go to the target (f = rel.d, l = rel.(d_y, -d_x)), to
// the eye (minus the target's share) and to the heading.
//
// Why not the TPU's method: the Pallas kernel re-walks every target and
// credits each one whose depth matches the saved depth within 1e-5
// relative (raycast.py:715), which credits every target inside the
// tolerance at a near-tie and costs O(B Ne Nt W). The index credits exactly
// the one winner the forward chose (the plain version's argmin, lowest index
// on an exact tie) and costs O(B Ne W).
//
// What bounds it: memory and atomics. Each pixel reads its index and two
// cotangents (12 bytes) and does about 40 flops; each covered pixel adds its
// target's share with two float atomics (their order varies from run to
// run, so target gradients agree with the plain version to rounding, not
// bit for bit). The eye's share is summed over the pixels of a warp (a block
// is 32 pixels x 8 eyes, one warp per eye row) by shuffles, then added with
// one atomic per warp and component.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PB = 32;  // pixels of one eye row per warp
constexpr int EG = 8;   // eyes (warps) per block

struct EyeParams {
  float tan_half_fov;
  float near_plane;
  float far_plane;
  float radius;
  float inv_width;
  float half_width;  // W/2
  float background;
  float albedo;
  int antialias;
};

__global__ void disc_eye_bwd_kernel(const float2* __restrict__ eye_pos,
                                    const float2* __restrict__ eye_dir,
                                    const float2* __restrict__ tgt,
                                    const int* __restrict__ winner, const float* __restrict__ us,
                                    const float* __restrict__ ud, float* __restrict__ g_eye,
                                    float* __restrict__ g_dir, float* __restrict__ g_tgt, int ne,
                                    int nt, int w, EyeParams q) {
  const int b = blockIdx.z;
  const int e = blockIdx.x * EG + threadIdx.y;
  const int p = blockIdx.y * PB + threadIdx.x;
  float gex = 0.f, gey = 0.f, gdx = 0.f, gdy = 0.f;
  if (e < ne && p < w) {
    const long long o = ((long long)b * ne + e) * w + p;
    const int j = winner[o];
    const float cs = us[o];
    const float cd = ud[o];
    if (j >= 0 && (cs != 0.f || cd != 0.f)) {
      const float2 pe = eye_pos[(long long)b * ne + e];
      const float2 de = eye_dir[(long long)b * ne + e];
      const float2 xj = tgt[(long long)b * nt + j];
      const float rx = xj.x - pe.x;
      const float ry = xj.y - pe.y;
      const float f = rx * de.x + ry * de.y;
      const float l = rx * de.y - ry * de.x;
      const float ft = f * q.tan_half_fov;
      const float uc = l / ft;
      const float du = fmaxf(q.radius / ft, 1e-30f);
      const float u_p = 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
      const float off = (u_p - uc) / du;
      const float aoff = fabsf(off);
      const float oc = fminf(fmaxf(off, -1.0f), 1.0f);
      const float dval = aoff <= 1.0f ? -0.5f * q.albedo * oc : 0.0f;
      float dsh_doff = dval, dsh_ds = 0.f, s = 0.f;
      if (q.antialias) {
        const float vmb = q.albedo * (1.0f - 0.25f * oc * oc) - q.background;
        s = q.half_width * du;
        const float c = (1.0f - aoff) * s + 0.5f;
        const bool live = c >= 0.0f && c <= 1.0f;
        const float covf = fminf(fmaxf(c, 0.0f), 1.0f);
        const float sgn = off > 0.f ? 1.f : (off < 0.f ? -1.f : 0.f);
        dsh_doff = covf * dval + (live ? -sgn * s * vmb : 0.0f);
        dsh_ds = live ? (1.0f - aoff) * vmb : 0.0f;
      }
      const float goff = cs * dsh_doff;
      const float gf = goff * (u_p * q.tan_half_fov / q.radius) + cs * dsh_ds * (-s / f) + cd;
      const float gl = -goff / q.radius;
      const float gx = gf * de.x + gl * de.y;
      const float gy = gf * de.y - gl * de.x;
      float* gt = g_tgt + 2 * ((long long)b * nt + j);
      atomicAdd(gt, gx);
      atomicAdd(gt + 1, gy);
      gex = -gx;
      gey = -gy;
      gdx = gf * rx - gl * ry;
      gdy = gf * ry + gl * rx;
    }
  }
  // one warp is the 32 pixels of one eye: sum its share, one atomic each
  for (int sh = 16; sh > 0; sh >>= 1) {
    gex += __shfl_down_sync(0xffffffffu, gex, sh);
    gey += __shfl_down_sync(0xffffffffu, gey, sh);
    gdx += __shfl_down_sync(0xffffffffu, gdx, sh);
    gdy += __shfl_down_sync(0xffffffffu, gdy, sh);
  }
  if (threadIdx.x == 0 && e < ne) {
    const long long ie = 2 * ((long long)b * ne + e);
    atomicAdd(g_eye + ie, gex);
    atomicAdd(g_eye + ie + 1, gey);
    atomicAdd(g_dir + ie, gdx);
    atomicAdd(g_dir + ie + 1, gdy);
  }
}

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt [B, Nt, 2]; winner [B, Ne, W] int32 (the
// forward's); us, ud [B, Ne, W]; g_eye, g_dir [B, Ne, 2] and g_tgt [B, Nt, 2]
// zeroed by the caller (the kernel adds into them); all fp32 but winner,
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int nbt_disc_eye_bwd(const void* eye_pos, const void* eye_dir, const void* tgt,
                                const void* winner, const void* us, const void* ud, void* g_eye,
                                void* g_dir, void* g_tgt, int batch, int ne, int nt, int w,
                                float tan_half_fov, float near_plane, float far_plane,
                                float radius, float inv_width, float half_width, float background,
                                float albedo, int antialias, void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    dim3 block(PB, EG);
    dim3 grid((ne + EG - 1) / EG, (w + PB - 1) / PB, batch);
    EyeParams q{tan_half_fov, near_plane, far_plane, radius, inv_width,
                half_width,   background, albedo,    antialias};
    disc_eye_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const int*>(winner),
        static_cast<const float*>(us), static_cast<const float*>(ud), static_cast<float*>(g_eye),
        static_cast<float*>(g_dir), static_cast<float*>(g_tgt), ne, nt, w, q);
  }
  return static_cast<int>(cudaGetLastError());
}
