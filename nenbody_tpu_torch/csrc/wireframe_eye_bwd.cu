// The pullback of the exact wireframe eye on Hopper (the backward of
// wireframe_eye.cu, one device or one ring hop).
//
// Replaces nenbody_tpu/ops/wireframe.py::_wf_bwd_kernel (the Pallas TPU
// kernel behind render_rows_wireframe_vjp_cross, the ring's per-hop
// pullback) and, with it, ::_compact_bwd_kernel (the same pullback at
// compact-eligible, wide-row hop shapes). Given cotangents us, ud on
// (shade, depth) [B, Ne, W], it returns d eye position and d eye heading
// [B, Ne, 2], and d target position and d target heading [B, Nt, 2].
//
// Why it also covers _compact_bwd_kernel: that kernel's output is field
// cotangents [TE*K, F] of the compact prologue's screen-sorted candidate
// tensors, which exist only to be pulled back through that prologue (XLA's
// vjp of its `build`) into positions and headings. The port has no compact
// prologue (wireframe_eye.cu covers the compact forward without one), so
// this kernel gives directly what those cotangents end in, at any width.
//
// Design: a winner-index backward, as disc_eye_bwd.cu. The forward writes
// each pixel's winning target (-1 for background, and on a ring hop for a
// pixel no target of this hop's block covers). One thread per (env, eye,
// pixel) with a winner >= 0 and a non-zero cotangent re-evaluates only that
// sprite's 3 edges at its pixel, with ops/wireframe.py::_winner_fragments'
// expressions (the plain version, winner_pullback): the edges merge by depth,
// a tie to the lower edge, and with antialias the winner's shade box-filters
// by the union of its edge intervals. The Pallas kernel runs jax.vjp of its
// tile function inside the kernel; CUDA has no such thing, so the
// re-evaluation runs on forward-mode dual numbers: each value carries its
// derivatives along the pair's 8 inputs (eye position and heading, target
// position and heading). The sprite projection and the slab clip are
// wireframe_common.cuh's templates, the forward's own code, and every branch
// (near clip, slab clip, hit, edge tie, coverage) is taken on the values, so
// it follows the forward's path. Where a min, max or clamp ties, the
// derivative is autograd's (half to each side of a min or max; a clamp
// passes at its bounds).
//
// Appearance (the _compact_bwd_kernel's raw and has_alb forms, and the
// albedo and texture cotangents of the JAX _winner_pullback): with the
// forward's per-target albedo the winner's own shades, and its share
// (d shade / d albedo) goes to the winner's slot like the target's; with a
// texture the bilinear sample (texture.cuh's template) joins the dual sweep,
// its texel picks from the value and its weights carrying the derivatives,
// and each pixel's share of the 4 texels it read goes to d texture [Ht, Wt],
// summed over every env. With antialias, most hit pixels of a far sprite
// sit at a clamped end of its interval and sample at a vertex's uv, so a few
// texels would take most of those atomics: the lanes of a warp that read
// the same texels add their shares first (a labeled partition) and one
// atomic each follows. (Measured on the H100: summing each block's share in
// shared memory first was slower than these global atomics.)
//
// What bounds it: operations. Each live pixel evaluates 3 edges, about 150
// fp32 operations, on 9 lanes (the value and 8 derivatives), against 12 bytes
// of winner and cotangents. The eye's share is summed over the 32 pixels of a
// warp by shuffles and added with one atomic per warp and component; the
// target's share is added at its winner's slot with float atomics, whose
// order varies from run to run, so target gradients agree with the plain
// version to rounding, not bit for bit. Built with -fmad=false.

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>

#include "texture.cuh"
#include "wireframe_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int PB = 32;   // pixels of one eye row per warp
constexpr int EG = 8;    // eyes (warps) per block
constexpr int NDIR = 8;  // eye pos x/y, eye heading x/y, target pos x/y, target heading x/y

// A value and its derivatives along the 8 inputs of one (eye, target) pair.
struct Dual {
  float v;
  float d[NDIR];
  Dual() = default;
  __device__ explicit Dual(float c) : v(c) {
#pragma unroll
    for (int k = 0; k < NDIR; ++k) d[k] = 0.0f;
  }
};

__device__ __forceinline__ Dual seed(float v, int k) {
  Dual r(v);
  r.d[k] = 1.0f;
  return r;
}

__device__ __forceinline__ float value(const Dual& a) { return a.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual operator+(float a, const Dual& b) {
  Dual r = b;
  r.v = a + b.v;
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}
__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = -b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(float a, const Dual& b) {
  Dual r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = a * b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = a.d[k] * b;
  return r;
}

// autograd's min and max: on a tie, half the derivative to each side
__device__ __forceinline__ Dual tie(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) r.d[k] = 0.5f * (a.d[k] + b.d[k]);
  return r;
}
__device__ __forceinline__ Dual vmin(const Dual& a, const Dual& b) {
  return a.v < b.v ? a : (b.v < a.v ? b : tie(a, b));
}
__device__ __forceinline__ Dual vmax(const Dual& a, const Dual& b) {
  return a.v > b.v ? a : (b.v > a.v ? b : tie(a, b));
}
// clamp(min=lo): passes the derivative where a >= lo
__device__ __forceinline__ Dual clamp_min(const Dual& a, float lo) {
  return a.v >= lo ? a : Dual(lo);
}
// clamp(0, 1): passes the derivative where 0 <= a <= 1
__device__ __forceinline__ Dual clamp01(const Dual& a) {
  return a.v < 0.0f ? Dual(0.0f) : (a.v > 1.0f ? Dual(1.0f) : a);
}

struct Fragment {
  Dual depth;  // +inf (no derivative) on a miss
  Dual tau;
  Dual lo, hi;  // the edge's u-interval, the off-screen sentinels when invalid (antialias)
};

// One sprite edge (a, b) at the pixel centre u_p: render.edge_fragment.
__device__ __forceinline__ Fragment edge_fragment(const Dual& fa, const Dual& la, const Dual& fb,
                                                  const Dual& lb, bool live, float u_p,
                                                  const WireframeParams& q) {
  const Dual df = fb - fa;
  const Dual dl = lb - la;
  Fragment out;
  bool hit;
  if (q.antialias) {
    const Slab<Dual> s = slab_interval(fa, la, df, dl, live, q);
    out.lo = s.valid ? s.e_lo : Dual(OFF_SCREEN);
    out.hi = s.valid ? s.e_hi : Dual(-OFF_SCREEN);
    const Dual utc = vmin(vmax(Dual(u_p), s.e_lo), s.e_hi) * q.tan_half_fov;
    const Dual num = utc * fa - la;
    const Dual den = dl - utc * df;
    const bool ok = fabsf(den.v) > 1e-12f;
    const Dual tau = vmin(vmax(num / (ok ? den : Dual(1.0f)), s.tau_lo), s.tau_hi);
    const Dual fk = fa + tau * df;
    const bool cover = (s.e_hi.v > u_p - q.hp) && (s.e_lo.v < u_p + q.hp);
    hit = ok && s.valid && cover && (fk.v < q.far_plane);
    out.tau = tau;
    out.depth = hit ? fk : Dual(INFINITY);
  } else {
    const float ut = u_p * q.tan_half_fov;
    const Dual num = ut * fa - la;
    const Dual den = dl - ut * df;
    const bool ok = fabsf(den.v) > 1e-12f;
    const Dual tau = num / (ok ? den : Dual(1.0f));
    const Dual fk = fa + tau * df;
    hit = ok && live && tau.v >= 0.0f && tau.v <= 1.0f && fk.v > q.near_plane &&
          fk.v < q.far_plane;
    out.tau = tau;
    out.depth = hit ? fk : Dual(INFINITY);
  }
  return out;
}

// The texture sampler's template (texture.cuh) on dual numbers: the clamp
// passes the derivative at its bounds, as torch.clamp does.
__device__ __forceinline__ float texel_primal(const Dual& a) { return a.v; }
__device__ __forceinline__ Dual texel_clamp01(const Dual& a) { return clamp01(a); }

// Where a block's threads read the appearance and add its gradients.
struct Skin {
  const float* albedo;  // [B, Nt], or null for the scalar
  const float* tex;     // the texture (staged in shared memory or not), or null
  bool staged;
  int ht, wt;
  float* g_alb;   // [B, Nt] d albedo, or null
  float* g_tex;   // [ht, wt] d texture (summed over envs), or null
};

// d (shade, depth) of one live pixel (env b, eye e, pixel p, winner j) with
// cotangents (cs, cd): its eye share goes to ge[4] (d eye pos, d eye heading),
// the rest to the winner's slots by atomics. kTexture: the forward sampled a
// texture (a template argument, so that the untextured launch does not hold
// the sampler's registers).
template <bool kTexture>
__device__ __forceinline__ void pixel_pullback(
    const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
    const float2* __restrict__ tgt, const float2* __restrict__ hdg, float* __restrict__ g_tgt,
    float* __restrict__ g_hdg, const Skin& skin, long long b, int ne, int nt, int e, int p,
    int j, float cs, float cd, int w, const WireframeParams& q, float ge[4]) {
  const float2 pe = eye_pos[b * ne + e];
  const float2 de = eye_dir[b * ne + e];
  const float2 xj = tgt[b * nt + j];
  const float2 hj = hdg[b * nt + j];
  Dual f[3], l[3];
  sprite_view(seed(pe.x, 0), seed(pe.y, 1), seed(de.x, 2), seed(de.y, 3), seed(xj.x, 4),
              seed(xj.y, 5), seed(hj.x, 6), seed(hj.y, 7), q, f, l);
  const bool live = (xj.x != pe.x) || (xj.y != pe.y);
  const float u_p = 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
  // _winner_fragments: merge the 3 edges by depth, a tie to the lower edge
  Fragment m = edge_fragment(f[0], l[0], f[1], l[1], live, u_p, q);
  int edge = 0;
  Dual sp_lo = m.lo, sp_hi = m.hi;
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const int c = (k + 1) % 3;
    const Fragment fr = edge_fragment(f[k], l[k], f[c], l[c], live, u_p, q);
    if (fr.depth.v < m.depth.v) {
      m.depth = fr.depth;
      m.tau = fr.tau;
      edge = k;
    }
    if (q.antialias) {
      sp_lo = vmin(sp_lo, fr.lo);
      sp_hi = vmax(sp_hi, fr.hi);
    }
  }
  if (!isfinite(m.depth.v)) return;
  // the winning edge's shade (render.fragment_shade): albedo, times the
  // texture at uv, times 1 - |uv - 0.5|^2
  const Dual uvx = c_uv[edge][0] + m.tau * c_uv[edge][2];
  const Dual uvy = c_uv[edge][1] + m.tau * c_uv[edge][3];
  const float alb = skin.albedo ? skin.albedo[b * nt + j] : q.albedo;
  const Dual ux = uvx - 0.5f;
  const Dual uy = uvy - 0.5f;
  const Dual vig = 1.0f - (ux * ux + uy * uy);
  Tap tap;
  Dual sample(1.0f);
  Dual s_m;
  if constexpr (kTexture) {
    sample = sample_texture(skin.tex, skin.staged, skin.ht, skin.wt, uvx, uvy, tap);
    s_m = (alb * sample) * vig;
  } else {
    s_m = alb * vig;
  }
  float blend = 1.0f;  // d shade / d (the unblended shade)
  if (q.antialias) {
    const Dual cov =
        clamp01((vmin(sp_hi, Dual(u_p + q.hp)) - vmax(sp_lo, Dual(u_p - q.hp))) / Dual(q.two_hp));
    s_m = q.background + cov * (s_m - q.background);
    blend = cov.v;
  }
  float gin[NDIR];
#pragma unroll
  for (int k = 0; k < NDIR; ++k) gin[k] = cs * s_m.d[k] + cd * m.depth.d[k];
  const long long it = 2 * (b * nt + j);
  atomicAdd(g_tgt + it, gin[4]);
  atomicAdd(g_tgt + it + 1, gin[5]);
  atomicAdd(g_hdg + it, gin[6]);
  atomicAdd(g_hdg + it + 1, gin[7]);
#pragma unroll
  for (int k = 0; k < 4; ++k) ge[k] = gin[k];
  // the appearance's shares: d shade / d albedo = blend * sample * vig, and
  // d shade / d texel = blend * albedo * vig * (the texel's bilinear weight)
  const float g_shade = cs * blend;
  if (skin.g_alb) atomicAdd(skin.g_alb + b * nt + j, g_shade * sample.v * vig.v);
  if constexpr (kTexture) {
    if (!skin.g_tex) return;
    const float g_s = g_shade * alb * vig.v;
    const float gx0 = 1.0f - tap.fx, gy0 = 1.0f - tap.fy;
    // the lanes of the warp here that read the same 4 texels add their
    // shares first and one of them adds the sums: with antialias most hit
    // pixels of far sprites sample at a vertex's uv, so the same few texels
    // would take most of the atomics
    const cg::coalesced_group peers = cg::labeled_partition(cg::coalesced_threads(), tap.i00);
    const float s00 = cg::reduce(peers, g_s * gx0 * gy0, cg::plus<float>());
    const float s01 = cg::reduce(peers, g_s * tap.fx * gy0, cg::plus<float>());
    const float s10 = cg::reduce(peers, g_s * gx0 * tap.fy, cg::plus<float>());
    const float s11 = cg::reduce(peers, g_s * tap.fx * tap.fy, cg::plus<float>());
    if (peers.thread_rank() == 0) {
      atomicAdd(skin.g_tex + tap.i00, s00);
      atomicAdd(skin.g_tex + tap.i01, s01);
      atomicAdd(skin.g_tex + tap.i10, s10);
      atomicAdd(skin.g_tex + tap.i11, s11);
    }
  }
}

template <bool kTexture>
__global__ void __launch_bounds__(PB * EG)
wireframe_eye_bwd_kernel(const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
                         const float2* __restrict__ tgt, const float2* __restrict__ hdg,
                         const float* __restrict__ albedo, const float* __restrict__ texture,
                         const int* __restrict__ winner, const float* __restrict__ us,
                         const float* __restrict__ ud, float* __restrict__ g_eye,
                         float* __restrict__ g_dir, float* __restrict__ g_tgt,
                         float* __restrict__ g_hdg, float* __restrict__ g_alb,
                         float* __restrict__ g_tex, int ne, int nt, int w, int ht, int wt,
                         WireframeParams q) {
  extern __shared__ float s_tex[];  // the staged texture (texture.cuh)
  Skin skin;
  skin.albedo = albedo;
  skin.ht = ht;
  skin.wt = wt;
  skin.g_alb = g_alb;
  skin.g_tex = g_tex;
  skin.tex = stage_texture(texture, ht * wt, s_tex, skin.staged);
  const long long b = blockIdx.z;
  const int e = blockIdx.x * EG + threadIdx.y;
  const int p = blockIdx.y * PB + threadIdx.x;
  float ge[4] = {0.f, 0.f, 0.f, 0.f};  // d eye pos x/y, d eye heading x/y
  if (e < ne && p < w) {
    const long long o = (b * ne + e) * w + p;
    const int j = winner[o];
    const float cs = us[o];
    const float cd = ud[o];
    if (j >= 0 && (cs != 0.f || cd != 0.f))
      pixel_pullback<kTexture>(eye_pos, eye_dir, tgt, hdg, g_tgt, g_hdg, skin, b, ne, nt, e, p,
                               j, cs, cd, w, q, ge);
  }
  // one warp is the 32 pixels of one eye: sum its share, one atomic each
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int sh = 16; sh > 0; sh >>= 1) ge[k] += __shfl_down_sync(0xffffffffu, ge[k], sh);
  }
  if (threadIdx.x == 0 && e < ne) {
    const long long ie = 2 * (b * ne + e);
    atomicAdd(g_eye + ie, ge[0]);
    atomicAdd(g_eye + ie + 1, ge[1]);
    atomicAdd(g_dir + ie, ge[2]);
    atomicAdd(g_dir + ie + 1, ge[3]);
  }
}

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt, hdg [B, Nt, 2] (unit headings); albedo
// [B, Nt] or null, texture [ht, wt] or null (the forward's appearance);
// winner [B, Ne, W] int32 (the forward's); us, ud [B, Ne, W]; g_eye, g_dir
// [B, Ne, 2], g_tgt, g_hdg [B, Nt, 2], g_alb [B, Nt] (or null) and g_tex
// [ht, wt] (or null, summed over envs) zeroed by the caller (the kernel adds
// into them); all fp32 but winner, contiguous. Returns cudaGetLastError()
// after the launch.
extern "C" int nbt_wireframe_eye_bwd(const void* eye_pos, const void* eye_dir, const void* tgt,
                                     const void* hdg, const void* albedo, const void* texture,
                                     const void* winner, const void* us, const void* ud,
                                     void* g_eye, void* g_dir, void* g_tgt, void* g_hdg,
                                     void* g_alb, void* g_tex, int batch, int ne, int nt, int w,
                                     int ht, int wt, float tan_half_fov, float near_plane,
                                     float far_plane, float radius, float hp, float two_hp,
                                     float background, float albedo_scalar, int antialias,
                                     void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    dim3 block(PB, EG);
    dim3 grid((ne + EG - 1) / EG, (w + PB - 1) / PB, batch);
    WireframeParams q{tan_half_fov, near_plane, far_plane, radius,        hp,
                      two_hp,       background, albedo_scalar, antialias};
    auto kernel = texture ? wireframe_eye_bwd_kernel<true> : wireframe_eye_bwd_kernel<false>;
    kernel<<<grid, block, staged_bytes(texture, ht * wt), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const float2*>(hdg),
        static_cast<const float*>(albedo), static_cast<const float*>(texture),
        static_cast<const int*>(winner), static_cast<const float*>(us),
        static_cast<const float*>(ud), static_cast<float*>(g_eye), static_cast<float*>(g_dir),
        static_cast<float*>(g_tgt), static_cast<float*>(g_hdg), static_cast<float*>(g_alb),
        static_cast<float*>(g_tex), ne, nt, w, ht, wt, q);
  }
  return static_cast<int>(cudaGetLastError());
}
