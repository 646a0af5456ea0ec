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
// pixel no target of this hop's block covers). The Pallas kernel runs
// jax.vjp of its tile function inside the kernel; here the reverse sweep is
// written out, split at the winning sprite's view-space verts (f_v, l_v):
// - Per live pixel (a winner and a non-zero cotangent), the primal in float
//   with the forward's own code (wireframe_common.cuh: sprite_view,
//   edge_slab, edge_depth; -fmad=false), so every branch (near clip, slab
//   clip, hit, edge tie, union span, coverage) is taken on the forward's
//   values. Then the adjoint from (cs, cd) back to the 6 vert coordinates,
//   ops/wireframe.py::wireframe_view_cotangents transcribed line for line:
//   only the winning edge reaches (shade, depth) through its tau and depth
//   (its adjoint runs once per lane, the edge picked at run time), and with
//   antialias each edge's u-interval and slab clip through the winner's
//   clamps and the union span's ends (one pass per edge). A tied min or max
//   sends half to each side, a clamp passes at its bounds, as autograd
//   through the plain version (winner_pullback) does; quotients are the
//   primal's, times a fast reciprocal (no branch depends on them).
// - Per winner group: the sprite's projection is one map per (eye, target)
//   pair, so each run of lanes that hold the same winner (warp_runs.cuh)
//   sums its 6 vert cotangents, and its last lane applies the transpose of
//   sprite_view once: 4 float atomics per (warp step, winner) into the
//   target's position and heading, not 4 per pixel, and the eye's share
//   kept in a register.
// - A warp walks one eye row in 32-pixel steps (a segment of it where the
//   batch has few rows) and queues its live pixels in shared memory (ballot
//   and popc), so each adjoint step runs on up to 32 live lanes and a
//   background pixel costs only its 12 bytes; the eye's 4 components are
//   summed over the warp and added once per row.
//
// Appearance (the _compact_bwd_kernel's raw and has_alb forms, and the
// albedo and texture cotangents of the JAX _winner_pullback): with the
// forward's per-target albedo the winner's own shades, and its share
// (d shade / d albedo) joins the winner run's sum (one atomic per run);
// with a texture the bilinear sample (texture.cuh) joins the primal and its
// weights' derivatives the adjoint, and each pixel's share of the 4 texels
// it read goes to d texture [Ht, Wt], summed over every env. With
// antialias, most hit pixels of a far sprite sit at a clamped end of its
// interval and sample at a vertex's uv, so a few texels take most of those
// shares: each run of lanes that read the same texels sums them, and with a
// texture staged in shared memory each block sums its d texture there and
// adds its non-zero texels once at its end.
//
// What bounds it: operations. A live pixel runs the primal of 3 edges
// (about 150 fp32 operations with antialias, 3 to 9 IEEE divides) and the
// adjoint of 1 to 3 edges (a reciprocal each), against 12 bytes of winner
// and cotangents; the warp adds the run sums (a few shuffles a value) and
// one transpose per step. 80 registers a thread, 3 blocks of 256 an SM.
// Target sums are float atomics, whose order varies from run to run, so
// target gradients agree with the plain version to rounding, not bit for
// bit. Built with -fmad=false.

#include "texture.cuh"
#include "warp_runs.cuh"
#include "wireframe_common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;  // eye rows (one a warp at a time) per block
constexpr int THREADS = WARP * WARPS;
constexpr int MIN_BLOCKS = 3;  // blocks an SM holds: at most 80 registers a thread
constexpr unsigned FULL = 0xffffffffu;

// autograd's share of d min(a, b) that goes to a: all of it where a is the
// smaller, half on a tie (ops/wireframe.py::_min_w); and of d max(a, b)
__device__ __forceinline__ float min_w(float a, float b) {
  return a < b ? 1.0f : (b < a ? 0.0f : 0.5f);
}
__device__ __forceinline__ float max_w(float a, float b) {
  return a > b ? 1.0f : (b > a ? 0.0f : 0.5f);
}

__device__ __forceinline__ float pick(const float x[3], int k) {
  return k == 0 ? x[0] : (k == 1 ? x[1] : x[2]);
}

// One edge's fragment at a pixel: depth (+inf on a miss), tau, and with
// antialias its u-interval (the off-screen sentinels when invalid), whether
// it is valid and which of its ends is the tau_lo end's.
struct Frag {
  float depth, tau, lo, hi;
  bool valid, a_lo;
};

// render.edge_fragment of edge (a, b) at the pixel centre u_p, on the
// forward's code.
__device__ __forceinline__ Frag edge_fragment(float fa, float la, float fb, float lb, float u_p,
                                              const WireframeParams& q) {
  const float4 g = make_float4(fa, la, fb - fa, lb - la);
  float4 sl = make_float4(0.f, 0.f, 0.f, 0.f);
  Frag fr;
  fr.valid = fr.a_lo = true;
  if (q.antialias) {
    const Slab<float> s = edge_slab(g.x, g.y, g.z, g.w, true, q);
    sl = make_float4(s.tau_lo, s.tau_hi, s.valid ? s.e_lo : OFF_SCREEN,
                     s.valid ? s.e_hi : -OFF_SCREEN);
    fr.valid = s.valid;
    fr.a_lo = s.a_lo;
  }
  fr.tau = 0.f;
  fr.depth = edge_depth(g, sl, u_p, q, &fr.tau);
  fr.lo = sl.z;
  fr.hi = sl.w;
  return fr;
}

// The cotangents of one edge's (f_a, l_a, f_b, l_b).
struct EdgeGrad {
  float fa, la, fb, lb;
};

// d (u_end) -> one end of the edge's u-interval: u = (l_a + tau_end dl) /
// (t clamp_min(f_end, 1e-30)), f_end = f_a + tau_end df. The adjoint's
// reciprocals feed no branch: they take the fast divide.
__device__ __forceinline__ void end_adjoint(float g_u, float u, float d, float f_end,
                                            float tau_end, float df, float dl, float t,
                                            float& g_fa, float& g_la, float& g_df, float& g_dl,
                                            float& g_tau_end) {
  const float r = __fdividef(1.0f, d);
  const float g_n = g_u * r;
  const float g_f = f_end >= 1e-30f ? -(g_u * u) * r * t : 0.0f;
  g_fa += g_f;
  g_df += g_f * tau_end;
  g_la += g_n;
  g_dl += g_n * tau_end;
  g_tau_end += g_f * df + g_n * dl;
}

// The edge's slab clip as the primal's slab_interval made it: its tau range
// and whether it was read off the clip parameters (edge_slab's fast case:
// both ends strictly inside the slab put both clip parameters outside
// [0, 1], where tau_lo and tau_hi pass no gradient).
struct SlabClip {
  bool clipped;
  float t_near, t_far, tau_lo, tau_hi;
};

__device__ __forceinline__ SlabClip slab_clip(float fa, float df, const WireframeParams& q) {
  SlabClip c{false, 0.f, 0.f, 0.f, 1.f};
  const float f_end = fa + 1.0f * df;  // edge_slab's test of the far end
  c.clipped = fabsf(df) > 1e-30f && !(fa > q.near_plane && fa < q.far_plane &&
                                     f_end > q.near_plane && f_end < q.far_plane);
  if (c.clipped) {
    c.t_near = (q.near_plane - fa) / df;
    c.t_far = (q.far_plane - fa) / df;
    c.tau_lo = fmaxf(fminf(c.t_near, c.t_far), 0.0f);
    c.tau_hi = fminf(fmaxf(c.t_near, c.t_far), 1.0f);
  }
  return c;
}

// The cotangents that reach an edge through its u-interval and its slab
// clip: of the ends (g_e_lo, g_e_hi) and of the clipped tau range (g_tau_lo,
// g_tau_hi).
struct SpanGrad {
  float e_lo, e_hi, tau_lo, tau_hi;
};

// The reverse sweep of the winning edge's fragment (ops/wireframe.py::
// _winner_adjoint): the cotangents of its clamped tau and of its depth ->
// the edge's vert cotangents through the ray's hit, and with antialias
// `span`, what reaches its u-interval and slab clip. `fr` is the edge's
// primal at the pixel; the rest of the primal it reads is recomputed with
// the forward's expressions.
__device__ __forceinline__ EdgeGrad winner_adjoint(float fa, float la, float fb, float lb,
                                                   float u_p, const Frag& fr, float g_tau,
                                                   float g_fk, const WireframeParams& q,
                                                   SpanGrad& span) {
  const float tau = fr.tau;
  const float t = q.tan_half_fov;
  const float df = fb - fa;
  const float dl = lb - la;
  float g_fa = g_fk;
  float g_df = g_fk * tau;
  g_tau = g_tau + g_fk * df;
  span = SpanGrad{0.f, 0.f, 0.f, 0.f};
  // the pixel ray (with antialias, its centre clamped into the u-interval)
  float utc = u_p * t, tau0 = tau, g_tau0 = g_tau, c1 = 0.f;
  if (q.antialias) {
    const SlabClip sc = slab_clip(fa, df, q);
    c1 = fmaxf(u_p, fr.lo);
    utc = fminf(c1, fr.hi) * t;
    tau0 = (utc * fa - la) / (dl - utc * df);
    const float c3 = fmaxf(tau0, sc.tau_lo);
    float w = min_w(c3, sc.tau_hi);
    const float g_c3 = g_tau * w;
    span.tau_hi = g_tau * (1.0f - w);
    w = max_w(tau0, sc.tau_lo);
    g_tau0 = g_c3 * w;
    span.tau_lo = g_c3 * (1.0f - w);
  }
  const float r = __fdividef(1.0f, dl - utc * df);
  const float g_num = g_tau0 * r;
  const float g_den = -(g_tau0 * tau0) * r;
  if (q.antialias) {
    const float g_c2 = (g_num * fa - g_den * df) * t;
    const float w = min_w(c1, fr.hi);
    span.e_hi = g_c2 * (1.0f - w);
    span.e_lo = g_c2 * w * max_w(fr.lo, u_p);
  }
  g_fa += g_num * utc;
  g_df -= g_den * utc;
  return EdgeGrad{g_fa - g_df, -g_num - g_den, g_df, g_den};
}

// The reverse sweep of an edge's u-interval and slab clip (ops/wireframe.py
// ::_span_adjoint, with antialias): `span` -> the edge's vert cotangents.
__device__ __forceinline__ EdgeGrad span_adjoint(float fa, float la, float fb, float lb,
                                                 const Frag& fr, SpanGrad span,
                                                 const WireframeParams& q) {
  // an invalid edge's interval is the sentinels, its fragment a miss
  if (!fr.valid) return EdgeGrad{0.f, 0.f, 0.f, 0.f};
  const float t = q.tan_half_fov;
  const float df = fb - fa;
  const float dl = lb - la;
  const SlabClip sc = slab_clip(fa, df, q);
  float g_fa = 0.f, g_la = 0.f, g_df = 0.f, g_dl = 0.f;
  if (span.e_lo != 0.f || span.e_hi != 0.f) {
    const float f_lo = fa + sc.tau_lo * df;
    const float f_hi = fa + sc.tau_hi * df;
    // the ends' quotients u_a, u_b as the primal's slab clip left them
    const float u_a = fr.a_lo ? fr.lo : fr.hi;
    const float u_b = fr.a_lo ? fr.hi : fr.lo;
    const float w_lo = min_w(u_a, u_b), w_hi = max_w(u_a, u_b);
    const float g_u_a = span.e_lo * w_lo + span.e_hi * w_hi;
    const float g_u_b = span.e_lo * (1.0f - w_lo) + span.e_hi * (1.0f - w_hi);
    end_adjoint(g_u_a, u_a, t * clamp_min(f_lo, 1e-30f), f_lo, sc.tau_lo, df, dl, t, g_fa, g_la,
                g_df, g_dl, span.tau_lo);
    end_adjoint(g_u_b, u_b, t * clamp_min(f_hi, 1e-30f), f_hi, sc.tau_hi, df, dl, t, g_fa, g_la,
                g_df, g_dl, span.tau_hi);
  }
  if (sc.clipped && (span.tau_lo != 0.f || span.tau_hi != 0.f)) {
    const float g_mn = span.tau_lo * max_w(fminf(sc.t_near, sc.t_far), 0.0f);
    const float g_mx = span.tau_hi * min_w(fmaxf(sc.t_near, sc.t_far), 1.0f);
    const float w_n = min_w(sc.t_near, sc.t_far), w_x = max_w(sc.t_near, sc.t_far);
    const float g_tn = g_mn * w_n + g_mx * w_x;
    const float g_tf = g_mn * (1.0f - w_n) + g_mx * (1.0f - w_x);
    const float rs = __fdividef(1.0f, df);
    g_fa -= (g_tn + g_tf) * rs;
    g_df += -(g_tn * sc.t_near + g_tf * sc.t_far) * rs;
  }
  return EdgeGrad{g_fa - g_df, g_la - g_dl, g_df, g_dl};
}

// Where a block's threads read the appearance and add its gradients.
struct Skin {
  const float* albedo;  // [B, Nt], or null for the scalar
  const float* tex;     // the texture (staged in shared memory or not), or null
  bool staged;
  int ht, wt;
  float* g_alb;  // [B, Nt] d albedo, or null
};

// A pixel's share of d texture: d shade / d sample `g` at the texels and
// weights of its sample (tap.i00 < 0: none).
struct TexShare {
  Tap tap;
  float g;
};

// The per-pixel reverse sweep (ops/wireframe.py::wireframe_view_cotangents):
// cotangents (cs, cd) on the pixel at u_p, won by the sprite whose verts
// sit at (f, l) in the eye's frame with albedo `alb` -> the verts'
// cotangents gf, gl, the albedo's share g_alb and the texture's `tex`
// (left at 0 on a miss). kTexture: the forward sampled a texture (a
// template argument, so that the untextured launch does not hold the
// sampler's registers).
template <bool kTexture>
__device__ __forceinline__ void pixel_adjoint(const float f[3], const float l[3], float u_p,
                                              float cs, float cd, float alb, const Skin& skin,
                                              const WireframeParams& q, float gf[3],
                                              float gl[3], float& g_alb, TexShare& tex) {
  // _view_fragments: merge the 3 edges by depth, a tie to the lower edge
  Frag fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = (k + 1) % 3;
    fr[k] = edge_fragment(f[k], l[k], f[c], l[c], u_p, q);
  }
  int e_m = 0;
  float d_m = fr[0].depth, tau_m = fr[0].tau;
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    if (fr[k].depth < d_m) {
      d_m = fr[k].depth;
      tau_m = fr[k].tau;
      e_m = k;
    }
  }
  if (!isfinite(d_m)) return;
  // the winning edge's shade (render.fragment_shade): albedo, times the
  // texture at uv, times 1 - |uv - 0.5|^2
  const float du_x = c_uv[e_m][2], du_y = c_uv[e_m][3];
  const float uvx = c_uv[e_m][0] + tau_m * du_x;
  const float uvy = c_uv[e_m][1] + tau_m * du_y;
  float sample = 1.0f;
  Tap tap;
  if constexpr (kTexture) sample = sample_texture(skin.tex, skin.staged, skin.ht, skin.wt, uvx,
                                                  uvy, tap);
  const float base = alb * sample;
  const float ux = uvx - 0.5f;
  const float uy = uvy - 0.5f;
  const float vig = 1.0f - (ux * ux + uy * uy);
  float g_s = cs;
  float g_lo[3] = {0.f, 0.f, 0.f}, g_hi[3] = {0.f, 0.f, 0.f};
  if (q.antialias) {
    // render.coverage of the union span, the min/max chain of
    // _view_fragments, each end's cotangent shared among the edges by
    // autograd's tie rule
    const float s_lo = fminf(fr[0].lo, fr[1].lo), s_hi = fmaxf(fr[0].hi, fr[1].hi);
    const float a_lo = min_w(fr[0].lo, fr[1].lo), b_lo = min_w(s_lo, fr[2].lo);
    const float a_hi = max_w(fr[0].hi, fr[1].hi), b_hi = max_w(s_hi, fr[2].hi);
    const float sp_lo = fminf(s_lo, fr[2].lo), sp_hi = fmaxf(s_hi, fr[2].hi);
    const float u_lo = u_p - q.hp, u_hi = u_p + q.hp;
    const float raw = (fminf(sp_hi, u_hi) - fmaxf(sp_lo, u_lo)) / q.two_hp;
    g_s = cs * fminf(fmaxf(raw, 0.0f), 1.0f);
    const float g_raw =
        (raw >= 0.0f && raw <= 1.0f) ? cs * (base * vig - q.background) / q.two_hp : 0.0f;
    const float g_sp_hi = g_raw * min_w(sp_hi, u_hi);
    const float g_sp_lo = -g_raw * max_w(sp_lo, u_lo);
    g_lo[0] = g_sp_lo * b_lo * a_lo;
    g_lo[1] = g_sp_lo * b_lo * (1.0f - a_lo);
    g_lo[2] = g_sp_lo * (1.0f - b_lo);
    g_hi[0] = g_sp_hi * b_hi * a_hi;
    g_hi[1] = g_sp_hi * b_hi * (1.0f - a_hi);
    g_hi[2] = g_sp_hi * (1.0f - b_hi);
  }
  const float g_vig = g_s * base;
  const float g_base = g_s * vig;
  float g_uvx = -(g_vig * ux + g_vig * ux);
  float g_uvy = -(g_vig * uy + g_vig * uy);
  g_alb = g_base * sample;
  if constexpr (kTexture) {
    // d sample / d uv through the weights (the clamp passes at its bounds),
    // and each texel's share, d sample / d texel = its bilinear weight
    const float g_smp = g_base * alb;
    const float t00 = fetch_texel(skin.tex, tap.i00, skin.staged);
    const float t01 = fetch_texel(skin.tex, tap.i01, skin.staged);
    const float t10 = fetch_texel(skin.tex, tap.i10, skin.staged);
    const float t11 = fetch_texel(skin.tex, tap.i11, skin.staged);
    const float gx0 = 1.0f - tap.fx, gy0 = 1.0f - tap.fy;
    const float g_fx = g_smp * ((t01 - t00) * gy0 + (t11 - t10) * tap.fy);
    const float g_fy = g_smp * ((t10 - t00) * gx0 + (t11 - t01) * tap.fx);
    if (uvx >= 0.0f && uvx <= 1.0f) g_uvx += g_fx * (float)(skin.wt - 1);
    if (uvy >= 0.0f && uvy <= 1.0f) g_uvy += g_fy * (float)(skin.ht - 1);
    tex = TexShare{tap, g_smp};
  }
  const float g_tau = g_uvx * du_x + g_uvy * du_y;
  // the winning edge, by its tau and depth: once per lane, its edge picked
  const int c_m = e_m == 2 ? 0 : e_m + 1;
  const Frag frm = e_m == 0 ? fr[0] : (e_m == 1 ? fr[1] : fr[2]);
  SpanGrad span_m;
  const EdgeGrad e = winner_adjoint(pick(f, e_m), pick(l, e_m), pick(f, c_m), pick(l, c_m), u_p,
                                    frm, g_tau, cd, q, span_m);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    gf[v] += (v == e_m ? e.fa : 0.f) + (v == c_m ? e.fb : 0.f);
    gl[v] += (v == e_m ? e.la : 0.f) + (v == c_m ? e.lb : 0.f);
  }
  if (!q.antialias) return;
  // with antialias, each edge's u-interval and slab clip: the winner's
  // through its clamps, those that give the union span's ends through the
  // coverage
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool mine = k == e_m;
    const SpanGrad sg{g_lo[k] + (mine ? span_m.e_lo : 0.f), g_hi[k] + (mine ? span_m.e_hi : 0.f),
                      mine ? span_m.tau_lo : 0.f, mine ? span_m.tau_hi : 0.f};
    if (sg.e_lo == 0.f && sg.e_hi == 0.f && sg.tau_lo == 0.f && sg.tau_hi == 0.f) continue;
    const int c = k == 2 ? 0 : k + 1;
    const EdgeGrad s = span_adjoint(f[k], l[k], f[c], l[c], fr[k], sg, q);
    gf[k] += s.fa;
    gl[k] += s.la;
    gf[c] += s.fb;
    gl[c] += s.lb;
  }
}

// The transpose of sprite_view at one (eye, target) pair
// (ops/wireframe.py::sprite_view_vjp): the verts' cotangents gf, gl -> g =
// (d eye pos x/y, d eye heading x/y, d target pos x/y, d target heading x/y).
__device__ __forceinline__ void sprite_view_vjp(float2 pe, float2 de, float2 xj, float2 hj,
                                                const float gf[3], const float gl[3],
                                                const WireframeParams& q, float g[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float vxr = c_vx[v] * q.radius;
    const float vyr = c_vy[v] * q.radius;
    const float relx = (xj.x + (vxr * hj.x - vyr * hj.y)) - pe.x;
    const float rely = (xj.y + (vxr * hj.y + vyr * hj.x)) - pe.y;
    const float g_rx = gf[v] * de.x + gl[v] * de.y;
    const float g_ry = gf[v] * de.y - gl[v] * de.x;
    g[2] += gf[v] * relx - gl[v] * rely;
    g[3] += gf[v] * rely + gl[v] * relx;
    g[4] += g_rx;
    g[5] += g_ry;
    g[6] += g_rx * vxr + g_ry * vyr;
    g[7] += g_ry * vxr - g_rx * vyr;
  }
  g[0] = -g[4];
  g[1] = -g[5];
}

// The inputs and outputs of a launch, as its warps read them.
struct Pull {
  const float2 *eye_pos, *eye_dir, *tgt, *hdg;
  const int* winner;
  const float *us, *ud;
  float *g_eye, *g_dir, *g_tgt, *g_hdg;
  int ne, nt, w;
};

// One eye row as a warp reads it.
struct Row {
  long long b, row;  // env, flat (env, eye) row
  float2 pe, de;     // the eye
  const int* winner;
  const float *us, *ud;  // the row's cotangents
};

// One step of a warp over up to 32 queued pixels of its row, in pixel order
// (p < 0: none): each lane's per-pixel sweep, then per run of lanes with the
// same winner one sum and one transpose, whose target shares the run's last
// lane adds and whose eye share it keeps in ge[4]. The texture's shares go
// to `g_tex` (shared or device memory) per run of lanes that read the same
// texels. Every lane of the warp calls it.
template <bool kTexture>
__device__ __forceinline__ void pullback_step(const Pull& a, const Row& r, int p,
                                              const Skin& skin, float* g_tex,
                                              const WireframeParams& q, float ge[4]) {
  int j = -1;
  float gf[3] = {0.f, 0.f, 0.f}, gl[3] = {0.f, 0.f, 0.f}, g_alb = 0.f;
  TexShare tex{Tap{-1, -1, -1, -1, 0.f, 0.f}, 0.f};
  float2 xj = make_float2(0.f, 0.f), hj = make_float2(1.f, 0.f);
  if (p >= 0) {
    j = r.winner[p];
    xj = a.tgt[r.b * a.nt + j];
    hj = a.hdg[r.b * a.nt + j];
    if (xj.x != r.pe.x || xj.y != r.pe.y) {  // a coincident target never shows
      float f[3], l[3];
      sprite_view(r.pe.x, r.pe.y, r.de.x, r.de.y, xj.x, xj.y, hj.x, hj.y, q, f, l);
      const float alb = skin.albedo ? skin.albedo[r.b * a.nt + j] : q.albedo;
      pixel_adjoint<kTexture>(f, l, pixel_center(p, a.w), r.us[p], r.ud[p], alb, skin, q, gf,
                              gl, g_alb, tex);
    }
  }
  __syncwarp();
  if constexpr (kTexture) {
    if (g_tex) {
      // the texture's shares: with antialias most hit pixels of a far
      // sprite sample at a vertex's uv, so neighbouring lanes read the same
      // 4 texels; each run of them adds its sums with one atomic a texel
      const Runs texels = lane_runs(tex.tap.i00);
      const float gx0 = 1.0f - tex.tap.fx, gy0 = 1.0f - tex.tap.fy;
      const float s00 = run_sum(tex.g * gx0 * gy0, texels);
      const float s01 = run_sum(tex.g * tex.tap.fx * gy0, texels);
      const float s10 = run_sum(tex.g * gx0 * tex.tap.fy, texels);
      const float s11 = run_sum(tex.g * tex.tap.fx * tex.tap.fy, texels);
      if (tex.tap.i00 >= 0 && texels.last) {
        atomicAdd(g_tex + tex.tap.i00, s00);
        atomicAdd(g_tex + tex.tap.i01, s01);
        atomicAdd(g_tex + tex.tap.i10, s10);
        atomicAdd(g_tex + tex.tap.i11, s11);
      }
    }
  }
  const Runs runs = lane_runs(j);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    gf[v] = run_sum(gf[v], runs);
    gl[v] = run_sum(gl[v], runs);
  }
  if (skin.g_alb) g_alb = run_sum(g_alb, runs);
  if (j < 0 || !runs.last) return;
  float g[8];
  sprite_view_vjp(r.pe, r.de, xj, hj, gf, gl, q, g);
#pragma unroll
  for (int k = 0; k < 4; ++k) ge[k] += g[k];
  const long long it = 2 * (r.b * a.nt + j);
  atomicAdd(a.g_tgt + it, g[4]);
  atomicAdd(a.g_tgt + it + 1, g[5]);
  atomicAdd(a.g_hdg + it, g[6]);
  atomicAdd(a.g_hdg + it + 1, g[7]);
  if (skin.g_alb) atomicAdd(skin.g_alb + r.b * a.nt + j, g_alb);
}

// A warp per (env, eye) row and segment of `seg` pixels (blockIdx.y). With
// a texture staged in shared memory the block sums d texture in shared
// memory too, and adds its non-zero texels to g_tex once at its end.
template <bool kTexture>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wireframe_eye_bwd_kernel(Pull a, const float* __restrict__ albedo,
                         const float* __restrict__ texture, float* __restrict__ g_alb,
                         float* __restrict__ g_tex, long long rows, int seg, int ht, int wt,
                         WireframeParams q) {
  extern __shared__ float s_tex[];  // the staged texture, then its gradient (texture.cuh)
  __shared__ int s_queue[WARPS][2 * WARP];  // each warp's live pixels, not yet pulled back
  Skin skin;
  skin.albedo = albedo;
  skin.ht = ht;
  skin.wt = wt;
  skin.g_alb = g_alb;
  skin.tex = stage_texture(texture, ht * wt, s_tex, skin.staged);
  float* s_gtex = nullptr;  // the block's d texture, where the texture is staged
  if constexpr (kTexture) {
    if (skin.staged && g_tex) {
      s_gtex = s_tex + ht * wt;
      for (int i = threadIdx.x; i < ht * wt; i += THREADS) s_gtex[i] = 0.f;
      __syncthreads();
    }
  }
  float* tex_sum = s_gtex ? s_gtex : g_tex;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  int* queue = s_queue[warp];
  const int p_begin = blockIdx.y * seg;
  const int p_end = min(a.w, p_begin + seg);
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row < rows) {
    Row r;
    r.row = row;
    r.b = row / a.ne;
    r.pe = a.eye_pos[row];
    r.de = a.eye_dir[row];
    r.winner = a.winner + row * a.w;
    r.us = a.us + row * a.w;
    r.ud = a.ud + row * a.w;
    float ge[4] = {0.f, 0.f, 0.f, 0.f};  // d eye pos x/y, d eye heading x/y
    int queued = 0;
    for (int p0 = p_begin; p0 < p_end; p0 += WARP) {
      const int p = p0 + lane;
      const bool live = p < p_end && r.winner[p] >= 0 && (r.us[p] != 0.f || r.ud[p] != 0.f);
      const unsigned m = __ballot_sync(FULL, live);
      if (live) queue[queued + __popc(m & ((1u << lane) - 1u))] = p;
      queued += __popc(m);
      __syncwarp();
      if (queued >= WARP) {
        pullback_step<kTexture>(a, r, queue[lane], skin, tex_sum, q, ge);
        const int rest = queued - WARP;
        const int moved = lane < rest ? queue[WARP + lane] : 0;
        __syncwarp();
        if (lane < rest) queue[lane] = moved;
        __syncwarp();
        queued = rest;
      }
    }
    if (queued > 0)
      pullback_step<kTexture>(a, r, lane < queued ? queue[lane] : -1, skin, tex_sum, q, ge);
    // the eye's share, summed over the warp: one atomic per component
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      for (int sh = 16; sh > 0; sh >>= 1) ge[k] += __shfl_xor_sync(FULL, ge[k], sh);
    }
    if (lane == 0) {
      atomicAdd(a.g_eye + 2 * row, ge[0]);
      atomicAdd(a.g_eye + 2 * row + 1, ge[1]);
      atomicAdd(a.g_dir + 2 * row, ge[2]);
      atomicAdd(a.g_dir + 2 * row + 1, ge[3]);
    }
  }
  if constexpr (kTexture) {
    if (s_gtex) {
      __syncthreads();
      for (int i = threadIdx.x; i < ht * wt; i += THREADS)
        if (s_gtex[i] != 0.f) atomicAdd(g_tex + i, s_gtex[i]);
    }
  }
}

// Pixels a warp walks: the whole row, or where that gives fewer than
// GRID_WARPS warps (warp_runs.cuh), segments of whole 32-pixel steps that
// give about as many.
int segment_pixels(long long rows, int w) {
  const long long steps = (w + WARP - 1) / WARP;
  long long split = (GRID_WARPS + rows - 1) / rows;
  split = split < 1 ? 1 : (split > steps ? steps : split);
  return (int)(WARP * ((steps + split - 1) / split));
}

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt, hdg [B, Nt, 2] (unit headings); albedo
// [B, Nt] or null, texture [ht, wt] or null (the forward's appearance);
// winner [B, Ne, W] int32 (the forward's); us, ud [B, Ne, W]; g_eye, g_dir
// [B, Ne, 2], g_tgt, g_hdg [B, Nt, 2], g_alb [B, Nt] (or null) and g_tex
// [ht, wt] (or null, summed over envs) zeroed by the caller (the kernel
// adds into them); all fp32 but winner, contiguous. Returns
// cudaGetLastError() after the launch.
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
    const long long rows = (long long)batch * ne;
    const int seg = segment_pixels(rows, w);
    size_t smem = staged_bytes(texture, ht * wt);
    if (smem && g_tex) smem *= 2;  // and the block's d texture
    dim3 grid((unsigned)((rows + WARPS - 1) / WARPS), (w + seg - 1) / seg);
    WireframeParams q{tan_half_fov, near_plane, far_plane, radius,        hp,
                      two_hp,       background, albedo_scalar, antialias};
    Pull a{static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
           static_cast<const float2*>(tgt),     static_cast<const float2*>(hdg),
           static_cast<const int*>(winner),     static_cast<const float*>(us),
           static_cast<const float*>(ud),       static_cast<float*>(g_eye),
           static_cast<float*>(g_dir),          static_cast<float*>(g_tgt),
           static_cast<float*>(g_hdg),          ne,
           nt,                                  w};
    auto kernel = texture ? wireframe_eye_bwd_kernel<true> : wireframe_eye_bwd_kernel<false>;
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const float*>(albedo), static_cast<const float*>(texture),
        static_cast<float*>(g_alb), static_cast<float*>(g_tex), rows, seg, ht, wt, q);
  }
  return static_cast<int>(cudaGetLastError());
}
