// The exact wireframe eye on Hopper: every agent's 1D vision line against
// the reference's sprite, the LineStrip triangle of src/main.rs:130-139
// turned to each target's heading, with the uv vignette of
// shaders/scene.frag:15-16, in one launch for a batch of envs.
//
// Replaces the four Pallas TPU kernels of nenbody_tpu/ops/wireframe.py:
// _wireframe_raster_kernel (division route over XLA-precomputed [N_e, N_t]
// vert tensors), _wireframe_rasterq_kernel (its inverse-depth twin),
// _wireframe_stream_kernel (projecting target chunks in-kernel, also the
// env-indexed batched grid) and _wireframe_compact_kernel (screen-sorted
// candidates for wide rows). The TPU needed four routes for lane packing and
// VMEM budgets; this kernel projects in-kernel, writes no [N_e, N_t] tensor,
// and takes any N, any width and a batch of envs.
//
// Arithmetic: the plain renderer's division route
// (nenbody_tpu_torch/vision/render.py: sprite_view, edge_fragment,
// fragment_shade, coverage), expression for expression, built with
// -fmad=false, so that it equals the plain version bit for bit where the
// pixel centres agree. For eye e and target j, each sprite vert is rotated
// to the target's heading and projected into the eye's frame (forward f,
// lateral l); the pixel ray at NDC u meets edge (a, b) at
//   tau = (u t f_a - l_a) / (dl - u t df),  depth f_a + tau df.
// Without antialias a fragment hits when tau in [0, 1] and near < depth <
// far. With antialias each edge's tau range is clipped to the [near, far]
// slab, its u-interval read off the clipped endpoints, the fragment taken at
// the pixel centre clamped into it, and the winning sprite's shade
// box-filtered against the background by the share of the pixel its union
// interval covers. The depth test is the plain argmin over the flattened
// (edge, target) axis, edge-major: targets are scanned in index order,
// edges in order within each, and a candidate wins on a smaller depth, or on
// an equal depth from a lower edge. A target coincident with the eye (exact
// float equality) is culled. With a winner buffer the kernel also writes
// each pixel's winning target (-1 for background), the residual of the
// pullback (ops/wireframe.py, winner_pullback).
//
// Appearance (the Pallas kernels' has_alb and raw forms): a per-target albedo
// [B, Nt] replaces the scalar with the winner's own; a texture is sampled at
// the winning edge's interpolated uv, before the vignette 1 - |uv - 0.5|^2
// and before the coverage blend (wireframe.py::_decode_textured_wf's
// semantics). The TPU kernels write the winner's uv (and albedo and coverage)
// as raw streams for an XLA epilogue; this kernel samples in its own
// epilogue, once per pixel, from a texture staged in shared memory
// (texture.cuh).
//
// What bounds it: the (pixel, target, edge) tests, N_e * N_t * W * 3 of
// them, with an fp32 divide each on the TPU routes. Design: a block owns EG
// eyes x PB pixels of one env (blockIdx.z). For each tile of PB targets,
// each thread projects one (eye, target) pair into shared memory once: the
// 3 edges' (f_a, l_a, df, dl) and, with antialias, their slab intervals
// (tau_lo, tau_hi, u_lo, u_hi; an invalid edge gets the off-screen
// sentinels) and the sprite's union interval. Every divide of the slab clip
// happens there, once per (eye, target). Each thread then scans the tile for
// its (eye, pixel). Two skips leave the outputs bit-identical, since each
// passes over only fragments that cannot hit: with antialias a target whose
// union interval misses the pixel (every edge interval lies inside the
// union), which is the culling the JAX compact kernel exists for; without
// antialias an edge whose tau = num/den is outside [0, 1] by its operands'
// signs and sizes before the divide. Any width and any N: pixel, eye and target tails are
// masked by bounds. The sprite projection and the slab clip are templates in
// wireframe_common.cuh, which the pullback (wireframe_eye_bwd.cu) evaluates
// on dual numbers.

#include "texture.cuh"
#include "wireframe_common.cuh"

namespace {

constexpr int THREADS = 256;

// One edge's slab clip packed for shared memory: (tau_lo, tau_hi, lo, hi),
// lo/hi the off-screen sentinels when the edge is invalid.
__device__ __forceinline__ float4 slab_tile(float fa, float la, float df, float dl, bool live,
                                            const WireframeParams& q) {
  const Slab<float> s = slab_interval(fa, la, df, dl, live, q);
  return make_float4(s.tau_lo, s.tau_hi, s.valid ? s.e_lo : OFF_SCREEN,
                     s.valid ? s.e_hi : -OFF_SCREEN);
}

__global__ void __launch_bounds__(THREADS)
wireframe_eye_kernel(const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
                     const float2* __restrict__ tgt, const float2* __restrict__ hdg,
                     const float* __restrict__ albedo, const float* __restrict__ texture,
                     float* __restrict__ shade, float* __restrict__ depth,
                     int* __restrict__ winner, int ne, int nt, int w, int ht, int wt,
                     WireframeParams q) {
  extern __shared__ float s_tex[];       // the staged texture (texture.cuh)
  __shared__ float4 s_geo[3][THREADS];   // per edge (f_a, l_a, df, dl)
  __shared__ float4 s_slab[3][THREADS];  // per edge (tau_lo, tau_hi, lo, hi), antialias
  __shared__ float2 s_span[THREADS];     // the sprite's union u-interval, antialias
  __shared__ int s_live[THREADS];
  const int pb = blockDim.x;  // pixels per block == targets per tile
  const int b = blockIdx.z;
  const int e = blockIdx.x * blockDim.y + threadIdx.y;
  const int p = blockIdx.y * pb + threadIdx.x;
  const int row = threadIdx.y * pb;
  const bool aa = q.antialias != 0;

  float2 pe = make_float2(0.f, 0.f), de = make_float2(1.f, 0.f);
  if (e < ne) {
    pe = eye_pos[(long long)b * ne + e];
    de = eye_dir[(long long)b * ne + e];
  }
  const float2* tb = tgt + (long long)b * nt;
  const float2* hb = hdg + (long long)b * nt;
  const float u_p = 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
  const float ut = u_p * q.tan_half_fov;
  const float u_lo = u_p - q.hp;
  const float u_hi = u_p + q.hp;
  bool staged;
  const float* tex = stage_texture(texture, ht * wt, s_tex, staged);

  float best_d = INFINITY, best_tau = 0.f, best_lo = 0.f, best_hi = 0.f;
  int best_e = 0, best_j = -1;
  for (int j0 = 0; j0 < nt; j0 += pb) {
    const int j = j0 + threadIdx.x;
    const int slot = row + threadIdx.x;
    int live = 0;
    if (e < ne && j < nt) {
      const float2 xj = tb[j];
      const float2 hj = hb[j];
      float f[3], l[3];
      sprite_view(pe.x, pe.y, de.x, de.y, xj.x, xj.y, hj.x, hj.y, q, f, l);
      live = (xj.x != pe.x) || (xj.y != pe.y);
      float sp_lo = 0.f, sp_hi = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int a = k, c = (k + 1) % 3;
        const float df = f[c] - f[a];
        const float dl = l[c] - l[a];
        s_geo[k][slot] = make_float4(f[a], l[a], df, dl);
        if (aa) {
          const float4 sl = slab_tile(f[a], l[a], df, dl, live != 0, q);
          s_slab[k][slot] = sl;
          sp_lo = k == 0 ? sl.z : fminf(sp_lo, sl.z);
          sp_hi = k == 0 ? sl.w : fmaxf(sp_hi, sl.w);
        }
      }
      s_span[slot] = make_float2(sp_lo, sp_hi);
    }
    s_live[slot] = live;
    __syncthreads();
    const int cnt = min(pb, nt - j0);
    for (int t = 0; t < cnt; ++t) {
      if (!s_live[row + t]) continue;
      float2 span = make_float2(0.f, 0.f);
      if (aa) {
        span = s_span[row + t];
        if (!(span.y > u_lo && span.x < u_hi)) continue;  // no edge covers the pixel
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 g = s_geo[k][row + t];
        float tau, fk;
        bool hit;
        if (aa) {
          const float4 sl = s_slab[k][row + t];
          if (!(sl.w > u_lo && sl.z < u_hi)) continue;  // edge interval misses the pixel
          const float utc = fminf(fmaxf(u_p, sl.z), sl.w) * q.tan_half_fov;
          const float num = utc * g.x - g.y;
          const float den = g.w - utc * g.z;
          if (!(fabsf(den) > 1e-12f)) continue;  // edge parallel to the ray
          tau = fminf(fmaxf(num / den, sl.x), sl.y);
          fk = g.x + tau * g.z;
          hit = fk < q.far_plane;
        } else {
          const float num = ut * g.x - g.y;
          const float den = g.w - ut * g.z;
          if (!(fabsf(den) > 1e-12f)) continue;
          // tau = num/den outside [0, 1] without the divide: opposite signs
          // with |num| > |den| 2^-60 give tau <= -2^-60; |num| > fl(|den|
          // (1 + 2^-22)) >= |den| (1 + 2^-23) gives |tau| >= 1 + 2^-23
          const float an = fabsf(num), ad = fabsf(den);
          if (((num < 0.f) != (den < 0.f) && an > ad * 0x1p-60f) || an > ad * (1.0f + 0x1p-22f))
            continue;
          tau = num / den;
          fk = g.x + tau * g.z;
          hit = tau >= 0.f && tau <= 1.f && fk > q.near_plane && fk < q.far_plane;
        }
        if (hit && (fk < best_d || (fk == best_d && k < best_e))) {
          best_d = fk;
          best_e = k;
          best_j = j0 + t;
          best_tau = tau;
          best_lo = span.x;
          best_hi = span.y;
        }
      }
    }
    __syncthreads();
  }

  if (e < ne && p < w) {
    const long long o = ((long long)b * ne + e) * w + p;
    if (winner) winner[o] = best_j;
    if (best_j >= 0) {
      const float uvx = c_uv[best_e][0] + best_tau * c_uv[best_e][2];
      const float uvy = c_uv[best_e][1] + best_tau * c_uv[best_e][3];
      float alb = albedo ? albedo[(long long)b * nt + best_j] : q.albedo;
      if (tex) {
        Tap tap;
        alb = alb * sample_texture(tex, staged, ht, wt, uvx, uvy, tap);
      }
      const float ux = uvx - 0.5f;
      const float uy = uvy - 0.5f;
      float val = alb * (1.0f - (ux * ux + uy * uy));
      if (aa) {
        const float cov =
            fminf(fmaxf((fminf(best_hi, u_hi) - fmaxf(best_lo, u_lo)) / q.two_hp, 0.0f), 1.0f);
        val = q.background + cov * (val - q.background);
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

// eye_pos, eye_dir [B, Ne, 2]; tgt, hdg [B, Nt, 2] (unit headings); albedo
// [B, Nt], or null for the scalar; texture [ht, wt], or null for none; shade,
// depth [B, Ne, W]; all fp32, contiguous; winner [B, Ne, W] int32, or null
// to skip it. Returns cudaGetLastError() after the launch.
extern "C" int nbt_wireframe_eye(const void* eye_pos, const void* eye_dir, const void* tgt,
                                 const void* hdg, const void* albedo, const void* texture,
                                 void* shade, void* depth, void* winner, int batch, int ne,
                                 int nt, int w, int ht, int wt, float tan_half_fov,
                                 float near_plane, float far_plane, float radius, float hp,
                                 float two_hp, float background, float albedo_scalar,
                                 int antialias, void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    const int pb = w <= 32 ? 32 : (w <= 64 ? 64 : 128);
    const int eg = THREADS / pb;
    dim3 block(pb, eg);
    dim3 grid((ne + eg - 1) / eg, (w + pb - 1) / pb, batch);
    WireframeParams q{tan_half_fov, near_plane, far_plane, radius,    hp,
                      two_hp,       background, albedo_scalar, antialias};
    wireframe_eye_kernel<<<grid, block, staged_bytes(texture, ht * wt),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const float2*>(hdg),
        static_cast<const float*>(albedo), static_cast<const float*>(texture),
        static_cast<float*>(shade), static_cast<float*>(depth), static_cast<int*>(winner), ne,
        nt, w, ht, wt, q);
  }
  return static_cast<int>(cudaGetLastError());
}
