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
// (edge, target) axis, edge-major: the least depth, then the lower edge,
// then the lower target. A target coincident with the eye (exact float
// equality) is culled. With a winner buffer the kernel also writes each
// pixel's winning target (-1 for background), the residual of the pullback
// (ops/wireframe.py, winner_pullback).
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
// What bounds it: a scan of every (pixel, target, edge) triple, as the plain
// version's argmin makes it, is N_e N_t W 3 tests with an fp32 divide each,
// nearly all of them on pixels a sprite cannot reach: under spread spawns a
// quarter of the targets lie in an eye's 90-degree frustum, and a sprite
// covers one or two pixels of a 64-pixel line. The work the inputs need is
// one projection and slab clip per (eye, target) that may be visible and the
// tests on the pixels its edges reach. Design (that of disc_eye.cu):
// - A block owns EB eyes x SEG pixels of one env (blockIdx.z; a row wider
//   than SEG_MAX is cut into segments, blockIdx.y) and keeps one 64-bit key
//   per pixel in shared memory: the depth's bits above k Nt + j (edge k,
//   target j). Depths are > 0 (without antialias near < depth < far; with
//   it the slab clip keeps the fragment within [near, far)), so their bits
//   order as unsigned integers, and the least key is the plain argmin's
//   winner, tie rule included, whatever order the atomicMin's land in.
// - Each warp takes one eye and reads its targets 32 at a time; those that
//   may be visible (wireframe_maybe_visible: the sprite's bounding circle
//   against the frustum and the [near, far] slab, without a divide) queue up
//   in shared memory, and the warp draws them 32 at a time, a lane per
//   target, so the projections and slab clips run on full warps.
// - A lane projects its target exactly (sprite_view) and turns each edge's
//   slab-clipped u-interval into a pixel range (edge_pixel_range): widened
//   by half a pixel with antialias (the coverage test's reach) and by a
//   slack above every rounding of the exact test and of the pixel centres.
//   A hit of the exact test lies on the clipped segment up to those
//   roundings (near and far are floats, so a depth that rounds inside the
//   slab lies inside it up to the rounding of tau df), and the segment's
//   projection is monotone in tau, so no pixel it covers is left out.
// - On each pixel of the union of its edges' ranges where the target can
//   still win (the pixel's key not less than its least vert depth allows),
//   the plain per-pixel test runs on each edge whose range holds the pixel,
//   with the same expressions, and the least key is atomicMin'd into the
//   pixel's. The warp walks its 32 targets' unions as one list of (target,
//   pixel) items, a lane per item, reading each target's edges from shared
//   memory: a near or clustered sprite costs a few warp steps, not a long
//   serial loop, and ranges of unequal lengths leave no lane idle. Four
//   blocks of 256 threads fit an SM (64 registers a thread).
// - The epilogue reads (j, k) from each pixel's key, reprojects the winner
//   with the same expressions (tau and, with antialias, the union span) and
//   shades it.
// ops/wireframe.py::wireframe_maybe_visible and ::wireframe_pixel_ranges are
// the plain versions of the two culls: they must agree with the kernel,
// expression for expression (the CPU tests prove them conservative against
// the exact test). Any width and any N; pixel, eye and target tails are
// masked by bounds. The sprite projection, the slab clip and the per-pixel
// edge test are in wireframe_common.cuh, whose float code the pullback
// (wireframe_eye_bwd.cu) runs for its primal.

#include "texture.cuh"
#include "wireframe_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int SEG_MAX = 256;      // pixels of one eye a block holds
constexpr int KEY_PIXELS = 2048;  // keys a block holds: EB eyes x SEG pixels
// float4 words of one staged target, 8 used: the 9th staggers the lanes'
// slots across the shared-memory banks
constexpr int WIDE_WORDS = 9;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
// sqrt(2) rounded up: the sprite's verts lie within sqrt(2) r of its centre
constexpr float SPRITE_REACH = 1.4142137f;
// the frustum test's slack, relative to the positions (the verts' rounding)
// and to t (f + m) (the exact test's rounding of u)
constexpr float FRUSTUM_SLACK = 1.0f / 65536.0f;
// the range's slack in u, RANGE_SLACK of (1 + |e_lo| + |e_hi|)(1 + (|df| +
// |dl|) / (t near)): far above the roundings of the slab clip's u-interval
// (cancellation in l_a + tau dl over t f >= t near), of the fragment and of
// the pixel centres (ops/wireframe.py's constants of the same names)
constexpr float RANGE_SLACK = 1.0f / 262144.0f;
// a fragment's depth is at least DEPTH_FLOOR times its sprite's least vert
// depth, whatever its rounding
constexpr float DEPTH_FLOOR = 1.0f - 1.0f / 4096.0f;
constexpr int MAX_DEVICES = 64;

// Constants of the launch derived from its arguments.
struct RangeParams {
  float half_width;  // W/2
  float inv_tnear;   // 1/(t near)
};

// Whether the sprite of the target at xj may be hit from the eye at (pe,
// de), without a divide: its bounding circle (radius r SPRITE_REACH, widened
// by FRUSTUM_SLACK of the positions) meets the [near, far] slab and the
// frustum |l| <= t f, widened by FRUSTUM_SLACK; and it is not coincident
// with the eye. ops/wireframe.py::wireframe_maybe_visible computes the same
// expressions.
__device__ __forceinline__ bool wireframe_maybe_visible(float2 pe, float2 de, float2 xj,
                                                        const WireframeParams& q) {
  const float rx = xj.x - pe.x;
  const float ry = xj.y - pe.y;
  const float f = rx * de.x + ry * de.y;
  const float l = rx * de.y - ry * de.x;
  const float m = q.radius * SPRITE_REACH +
                  FRUSTUM_SLACK * (((fabsf(xj.x) + fabsf(xj.y)) + (fabsf(pe.x) + fabsf(pe.y))) +
                                   q.radius);
  const bool live = (xj.x != pe.x) || (xj.y != pe.y);
  return live && f + m > q.near_plane && f - m < q.far_plane &&
         fabsf(l) <= (f + m) * q.tan_half_fov * (1.0f + FRUSTUM_SLACK) + m;
}

// Pixels [lo, hi] of a w-pixel line that edge (fa, la, df, dl) can hit (lo >
// hi: none), and with antialias its slab clip packed as the per-pixel test
// reads it: (tau_lo, tau_hi, lo, hi), lo/hi the off-screen sentinels when
// the edge is invalid. ops/wireframe.py::wireframe_pixel_ranges computes the
// same expressions.
__device__ __forceinline__ void edge_pixel_range(float fa, float la, float df, float dl,
                                                 bool live, const WireframeParams& q,
                                                 const RangeParams& c, int w, int& lo, int& hi,
                                                 float4& slab) {
  const Slab<float> sl = edge_slab(fa, la, df, dl, live, q);
  slab = make_float4(sl.tau_lo, sl.tau_hi, sl.valid ? sl.e_lo : OFF_SCREEN,
                     sl.valid ? sl.e_hi : -OFF_SCREEN);
  lo = 1;
  hi = 0;
  if (!sl.valid) return;
  const float pad = (q.antialias ? q.hp : 0.0f) +
                    RANGE_SLACK * ((1.0f + fabsf(sl.e_lo)) + fabsf(sl.e_hi)) *
                        (1.0f + (fabsf(df) + fabsf(dl)) * c.inv_tnear);
  const float lo_f = (sl.e_lo - pad + 1.0f) * c.half_width - 0.5f;
  const float hi_f = (sl.e_hi + pad + 1.0f) * c.half_width - 0.5f;
  lo = max(0, (int)ceilf(fminf(fmaxf(lo_f, -1.0f), (float)w)));
  hi = min(w - 1, (int)floorf(fmaxf(fminf(hi_f, (float)w), -1.0f)));
}

__device__ __forceinline__ int range_lo(int r) { return r & 0xffff; }
__device__ __forceinline__ int range_hi(int r) { return r >> 16; }

// Target j's least key at segment pixel p over its edges whose range (lo |
// hi << 16; empty: lo > hi) holds p, atomicMin'd into the pixel's key where
// it is less; skipped where the key is already below lb_bits, the bits of
// the least depth any of its fragments can have. `geo` holds each edge's
// (f_a, l_a, df, dl), `slab` its slab clip (edge_pixel_range), in registers
// or in the warp's staging slot.
__device__ __forceinline__ void test_pixel(unsigned long long* key, const float* s_up, int p,
                                           const float4* geo, const float4* slab,
                                           const int (&range)[3], int j, unsigned lb_bits,
                                           const WireframeParams& q, int nt) {
  const unsigned long long cur = key[p];
  if (cur < ((unsigned long long)lb_bits << 32)) return;
  unsigned long long best = NO_KEY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (p < range_lo(range[k]) || p > range_hi(range[k])) continue;
    const float fk = edge_depth(geo[k], slab[k], s_up[p], q, nullptr);
    if (fk == INFINITY) continue;
    const unsigned long long kk = ((unsigned long long)__float_as_uint(fk) << 32) |
                                  ((unsigned)k * (unsigned)nt + (unsigned)j);
    best = kk < best ? kk : best;
  }
  if (best < cur) atomicMin(key + p, best);
}

// One target per lane (j < 0: none), all 32 lanes together: project it, find
// its edges' pixel ranges in the segment [p0, p0 + pn), and run the test on
// each pixel of their union. The warp walks the 32 unions as one list, a
// lane per (target, pixel) item: each lane with a nonempty union stages its
// target in `wide` (its slot of the warp's), a prefix sum over the unions'
// lengths numbers the items, and a lane finds its item's target by a binary
// search over their starts (`start`), so that the lanes stay busy whatever
// the spread of the ranges (a lane walking its own union first, or alone,
// measured slower on the H100: the warp waits for its longest walk).
__device__ __forceinline__ void draw_targets(int j, int lane, float2 pe, float2 de,
                                             const float2* tb, const float2* hb,
                                             const WireframeParams& q, const RangeParams& rp,
                                             int w, int p0, int pn, int nt,
                                             unsigned long long* key, const float* s_up,
                                             float4 (*wide)[WIDE_WORDS], int* start) {
  float4 geo[3], slab[3];
  int range[3] = {1, 1, 1};  // lo 1 > hi 0: empty
  int lo = 0, hi = -1;       // the union of the edges' segment ranges, none by default
  unsigned lb_bits = 0;
  if (j >= 0) {
    const float2 xj = tb[j];
    const float2 hj = hb[j];
    float f[3], l[3];
    sprite_view(pe.x, pe.y, de.x, de.y, xj.x, xj.y, hj.x, hj.y, q, f, l);
    const bool live = (xj.x != pe.x) || (xj.y != pe.y);
    lo = pn;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = k, b = (k + 1) % 3;
      const float df = f[b] - f[a];
      const float dl = l[b] - l[a];
      geo[k] = make_float4(f[a], l[a], df, dl);
      int klo, khi;
      edge_pixel_range(f[a], l[a], df, dl, live, q, rp, w, klo, khi, slab[k]);
      klo = max(klo, p0) - p0;
      khi = min(khi, p0 + pn - 1) - p0;
      if (klo <= khi) {
        range[k] = klo | (khi << 16);
        lo = min(lo, klo);
        hi = max(hi, khi);
      }
    }
    const float lb = fminf(fminf(f[0], f[1]), f[2]) * DEPTH_FLOOR;
    lb_bits = lb > 0.0f ? __float_as_uint(lb) : 0u;
  }
  const int len = max(hi - lo + 1, 0);
  int end = len;  // inclusive prefix sum of the lengths
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int v = __shfl_up_sync(FULL, end, o);
    if (lane >= o) end += v;
  }
  const int total = __shfl_sync(FULL, end, WARP - 1);
  if (total == 0) return;  // uniform across the warp
  if (len > 0) {
    float4* slot = wide[lane];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      slot[k] = geo[k];
      slot[3 + k] = slab[k];
    }
    slot[6] = make_float4(__int_as_float(range[0]), __int_as_float(range[1]),
                          __int_as_float(range[2]), __int_as_float(j));
    slot[7] = make_float4(__uint_as_float(lb_bits), __int_as_float(lo), 0.0f, 0.0f);
  }
  start[lane] = end - len;
  __syncwarp();
  for (int item = lane; item < total; item += WARP) {
    int owner = 0;  // the last lane whose start is <= item: its union holds the item
#pragma unroll
    for (int step = WARP / 2; step > 0; step >>= 1) {
      if (start[owner + step] <= item) owner += step;
    }
    const float4* os = wide[owner];
    const float4 r = os[6];
    const float4 s = os[7];
    const int orange[3] = {__float_as_int(r.x), __float_as_int(r.y), __float_as_int(r.z)};
    test_pixel(key, s_up, __float_as_int(s.y) + item - start[owner], os, os + 3, orange,
               __float_as_int(r.w), __float_as_uint(s.x), q, nt);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 4)
wireframe_eye_kernel(const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
                     const float2* __restrict__ tgt, const float2* __restrict__ hdg,
                     const float* __restrict__ albedo, const float* __restrict__ texture,
                     float* __restrict__ shade, float* __restrict__ depth,
                     int* __restrict__ winner, int ne, int nt, int w, int seg, int eb, int ht,
                     int wt, WireframeParams q, RangeParams rp) {
  // dynamic: each warp's staging slots, then the staged texture (texture.cuh)
  extern __shared__ float4 s_dyn[];
  __shared__ unsigned long long s_key[KEY_PIXELS];
  __shared__ float s_up[SEG_MAX];  // the segment's pixel centres
  __shared__ int s_queue[WARPS][2 * WARP];  // each warp's targets that may be visible
  __shared__ int s_start[WARPS][WARP];      // each warp's first item of each lane's target
  float4(*s_wide)[WARP][WIDE_WORDS] = reinterpret_cast<float4(*)[WARP][WIDE_WORDS]>(s_dyn);
  float* s_tex = reinterpret_cast<float*>(s_dyn + WARPS * WARP * WIDE_WORDS);
  const int b = blockIdx.z;
  const int e0 = blockIdx.x * eb;
  const int p0 = blockIdx.y * seg;
  const int pn = min(seg, w - p0);
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const bool aa = q.antialias != 0;
  for (int i = threadIdx.x; i < eb * seg; i += THREADS) s_key[i] = NO_KEY;
  for (int i = threadIdx.x; i < pn; i += THREADS) s_up[i] = pixel_center(p0 + i, w);
  bool staged;
  const float* tex = stage_texture(texture, ht * wt, s_tex, staged);
  __syncthreads();

  // warp -> (eye el, every (WARPS / eb)-th chunk of cw targets); the
  // targets that may be visible queue up, and the warp draws them 32 at a
  // time. Chunks are 32 targets, or fewer where the eye's warps would
  // otherwise not all get one (reference-100: 13 each of 8 warps, not 32
  // each of 4), so that a few near sprites spread their pixels over every
  // warp
  const int el = warp % eb;
  const int e = e0 + el;
  const int wpe = WARPS / eb;
  const int cw = min(WARP, (nt + wpe - 1) / wpe);
  const float2* tb = tgt + (long long)b * nt;
  const float2* hb = hdg + (long long)b * nt;
  if (e < ne) {  // uniform across the warp
    const float2 pe = eye_pos[(long long)b * ne + e];
    const float2 de = eye_dir[(long long)b * ne + e];
    unsigned long long* key = s_key + el * seg;
    int* queue = s_queue[warp];
    int queued = 0;
    for (int j0 = (warp / eb) * cw; j0 < nt; j0 += cw * wpe) {
      const int j = j0 + lane;
      const bool maybe = lane < cw && j < nt && wireframe_maybe_visible(pe, de, tb[j], q);
      const unsigned mask = __ballot_sync(FULL, maybe);
      if (maybe) queue[queued + __popc(mask & ((1u << lane) - 1))] = j;
      queued += __popc(mask);
      __syncwarp();
      if (queued >= WARP) {
        draw_targets(queue[lane], lane, pe, de, tb, hb, q, rp, w, p0, pn, nt, key, s_up,
                     s_wide[warp], s_start[warp]);
        queued -= WARP;
        const int moved = lane < queued ? queue[WARP + lane] : 0;
        __syncwarp();
        if (lane < queued) queue[lane] = moved;
        __syncwarp();
      }
    }
    if (queued > 0) {
      draw_targets(lane < queued ? queue[lane] : -1, lane, pe, de, tb, hb, q, rp, w, p0, pn, nt,
                   key, s_up, s_wide[warp], s_start[warp]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < eb * seg; i += THREADS) {
    const int p = i % seg;
    const int ei = e0 + i / seg;
    if (ei >= ne || p >= pn) continue;
    const long long o = ((long long)b * ne + ei) * w + p0 + p;
    const unsigned long long kw = s_key[i];
    if (kw == NO_KEY) {
      if (winner) winner[o] = -1;
      shade[o] = q.background;
      depth[o] = q.far_plane;
      continue;
    }
    const unsigned idx = (unsigned)(kw & 0xffffffffu);
    const int best_e = (int)(idx / (unsigned)nt);
    const int best_j = (int)(idx - (unsigned)best_e * (unsigned)nt);
    if (winner) winner[o] = best_j;
    // the winner's edge and union span, as its lane computed them
    const float2 pe = eye_pos[(long long)b * ne + ei];
    const float2 de = eye_dir[(long long)b * ne + ei];
    const float2 xj = tb[best_j];
    const float2 hj = hb[best_j];
    float f[3], l[3];
    sprite_view(pe.x, pe.y, de.x, de.y, xj.x, xj.y, hj.x, hj.y, q, f, l);
    const float u_p = s_up[p];
    const int a = best_e, c = (best_e + 1) % 3;
    const float4 geo = make_float4(f[a], l[a], f[c] - f[a], l[c] - l[a]);
    float4 slab = make_float4(0.f, 0.f, 0.f, 0.f);
    const float u_lo = u_p - q.hp;
    const float u_hi = u_p + q.hp;
    float sp_lo = u_lo, sp_hi = u_hi;
    if (aa) {
      const Slab<float> s = edge_slab(geo.x, geo.y, geo.z, geo.w, true, q);
      slab = make_float4(s.tau_lo, s.tau_hi, s.valid ? s.e_lo : OFF_SCREEN,
                         s.valid ? s.e_hi : -OFF_SCREEN);
      // the union span, from the other two edges only where the winning
      // edge leaves part of the pixel's footprint uncovered (otherwise the
      // coverage reads u_lo and u_hi alone)
      if (!(slab.z <= u_lo && slab.w >= u_hi)) {
        sp_lo = slab.z;
        sp_hi = slab.w;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k == best_e) continue;
          const int ka = k, kb = (k + 1) % 3;
          const Slab<float> o = edge_slab(f[ka], l[ka], f[kb] - f[ka], l[kb] - l[ka], true, q);
          sp_lo = fminf(sp_lo, o.valid ? o.e_lo : OFF_SCREEN);
          sp_hi = fmaxf(sp_hi, o.valid ? o.e_hi : -OFF_SCREEN);
        }
      }
    }
    float best_tau = 0.f;
    edge_depth(geo, slab, u_p, q, &best_tau);
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
          fminf(fmaxf((fminf(sp_hi, u_hi) - fmaxf(sp_lo, u_lo)) / q.two_hp, 0.0f), 1.0f);
      val = q.background + cov * (val - q.background);
    }
    shade[o] = val;
    depth[o] = __uint_as_float((unsigned)(kw >> 32));
  }
}

// Eyes per block, EB (a power of two, so that each eye gets WARPS / EB
// warps), for SEG-pixel segments: as many as the warps and KEY_PIXELS keys
// hold, halved while the grid would give an SM fewer than two blocks (each
// eye's targets then spread over more warps).
int eyes_per_block(int batch, int ne, int segments, int seg) {
  static int sms = 0;  // the first card's; queried once, outside any graph capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int eb = WARPS;
  while (eb > 1 && eb * seg > KEY_PIXELS) eb /= 2;
  while (eb > 1 && (long long)batch * segments * ((ne + eb - 1) / eb) < 2LL * sms) eb /= 2;
  return eb;
}

constexpr size_t WIDE_BYTES = sizeof(float4) * WARPS * WARP * WIDE_WORDS;

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt, hdg [B, Nt, 2] (unit headings); albedo
// [B, Nt], or null for the scalar; texture [ht, wt], or null for none; shade,
// depth [B, Ne, W]; all fp32, contiguous; winner [B, Ne, W] int32, or null
// to skip it; 3 Nt < 2^32 (the keys' index). Returns the attribute's or the
// launch's error, else cudaGetLastError() after the launch.
extern "C" int nbt_wireframe_eye(const void* eye_pos, const void* eye_dir, const void* tgt,
                                 const void* hdg, const void* albedo, const void* texture,
                                 void* shade, void* depth, void* winner, int batch, int ne,
                                 int nt, int w, int ht, int wt, float tan_half_fov,
                                 float near_plane, float far_plane, float radius, float hp,
                                 float two_hp, float background, float albedo_scalar,
                                 int antialias, void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    // the staging slots and a staged texture take more than the default
    // 48 KB: opt in once per card
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted_in[dev]) {
      const cudaError_t err =
          cudaFuncSetAttribute(wireframe_eye_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(WIDE_BYTES + sizeof(float) * SMEM_TEXELS));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in[dev] = true;
    }
    const int seg = min(w, SEG_MAX);
    const int segments = (w + seg - 1) / seg;
    const int eb = eyes_per_block(batch, ne, segments, seg);
    dim3 grid((ne + eb - 1) / eb, segments, batch);
    WireframeParams q{tan_half_fov, near_plane, far_plane, radius,    hp,
                      two_hp,       background, albedo_scalar, antialias};
    RangeParams rp{0.5f * (float)w, 1.0f / (tan_half_fov * near_plane)};
    wireframe_eye_kernel<<<grid, THREADS, WIDE_BYTES + staged_bytes(texture, ht * wt),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const float2*>(hdg),
        static_cast<const float*>(albedo), static_cast<const float*>(texture),
        static_cast<float*>(shade), static_cast<float*>(depth), static_cast<int*>(winner), ne,
        nt, w, seg, eb, ht, wt, q, rp);
  }
  return static_cast<int>(cudaGetLastError());
}
