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
// and the nearest covered target wins the pixel, a depth tie going to the
// lowest index, the rule of the plain version's argmin. The epilogue shades the winner with
// the squared-radial vignette and, with antialias, box-filters its edge
// coverage against the background (raycast.py::_decode_winner's outputs).
// Appearance (the Pallas kernels' has_alb and raw forms): with a per-target
// albedo [B, Nt] the epilogue reads the winner's own albedo in place of the
// scalar; with a texture it samples the skin at the winner's splat uv
// (0.5 + 0.5 oc, 0.5), before the vignette and the antialias blend. The TPU
// kernels write the winner's raw streams (signed offset, 1/du, albedo) to
// device memory for an XLA epilogue to decode (raycast.py::_decode_textured),
// because Mosaic does not gather; here the one sample per pixel runs in the
// kernel's own epilogue (texture.cuh), through the read-only data path (the
// pair list takes the shared memory a staged texture would), so no raw
// stream is written.
// When the wrapper passes a winner buffer (autograd needs the pixel), the
// kernel also writes each pixel's winning target index (-1 for background):
// the residual of the backward kernel, disc_eye_bwd.cu.
// When the wrapper passes a counter array (five unsigned 64-bit sums; the
// port's recorder counts: inside its recording() alone, so that a profiler
// trace without it times disc_eye_kernel), the launch runs
// disc_eye_kernel_counted, the same block with counters: it also adds, once
// a block, the (eye, target) pairs that pass the frustum pre-cull, the pairs
// that cover at least one pixel, the covered (eye, target, pixel) triples,
// the list flushes (below) and the pixel tests that fell in the band and
// took the divide. Every pixel of a target's range is then tested, where it
// can win or not. A pair is counted in the segment that holds its first
// covered pixel (a footprint covers a run of pixels: the offset grows with
// the pixel), its pre-cull in segment 0. With a null array the launch runs
// disc_eye_kernel, which counts nothing.
//
// What bounds it: the [B, Ne, W] output write by bytes (the shade and depth
// lines, and the winner); the work the inputs need is a frustum test per
// (eye, target) pair, a projection (two or three IEEE divides) per pair that
// may be visible and a test per pixel its footprint can reach. A scan of
// every pixel of every target, as the plain version's argmin makes it,
// spends almost all its work on pixels a target cannot reach: under spread
// spawns a quarter of the targets lie in an eye's 90-degree frustum, and a
// footprint covers one or two pixels of a 64-pixel line. The time goes to
// latency: short chains of dependent loads, divides and shared atomics. So
// every phase gives each thread work that does not wait on a lane with more.
// Design: a block owns EB eyes x SEG pixels of one env (blockIdx.z; a row
// wider than SEG_MAX is cut into segments, blockIdx.y), and keeps one 64-bit
// key per pixel in shared memory: the winner's depth bits above its target
// index. It stages its eyes' positions and headings, and the env's targets
// TILE at a time, in shared memory. Then, for each tile:
// - The cull: each thread tests ROUND pairs a round, independent of each
//   other, of a target of the tile against the block's eyes
//   (may_be_visible: depth and frustum without a divide). The pairs that
//   pass go into one block-wide list of (eye, target) entries, a shared
//   atomicAdd a thread a round. Where the next round might not fit the
//   list, it is drawn and emptied first (a flush), so any N and any EB fit.
// - The draw: every thread takes an entry of the list at a time, whichever
//   eye it belongs to: it projects its target exactly and computes the
//   pixels its footprint can reach (disc_pixel_range: widened by a slack
//   above every rounding involved and an eighth of a pixel, so rounding
//   never leaves out a pixel the exact test covers). The pixels of a warp's
//   ranges are then spread over its lanes as items, a lane an item a step
//   (a range of a few pixels and one of a whole segment cost the warp
//   alike), its entry named by a map from item to lane in shared memory, or
//   past the map by a binary search of the lanes' starts, and its footprint
//   handed over by shuffles. On each item where the target can still win
//   (its centre within the band's outer edge, the pixel's key not less) the
//   lane decides the plain version's per-pixel test and atomicMin's its key
//   into the pixel's. The test needs the divide only within 2^-20 of the
//   footprint's edge (cover_pixel): elsewhere |a| against thr du decides it
//   as the divide would.
// Depths are > near > 0, so their bits order as unsigned integers and the
// least key is the least depth, then the lowest index: the winner of the
// plain version's argmin, tie rule included, whatever order the pairs are
// drawn in and the atomics land in. The epilogue reprojects each pixel's
// winner with the same expressions (its target from the staged tile where
// the env's targets fit one) and shades it, two pixels a lane.
// ops/raycast.py::disc_maybe_visible, ::disc_pixel_ranges and
// ::disc_band_cover are the plain versions of the two culls and of the band
// test: they must agree with the kernel, expression for expression (the CPU
// tests prove the culls conservative, and the band test equal, against the
// exact test). Any width and any N; a tile's last slots hold NaN targets and
// the eye slots past the block's eyes face nowhere, so that no pair of them
// passes the cull. Built with -fmad=false so that edge pixels agree with the
// plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "pair_math.cuh"
#include "texture.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int SEG_MAX = 256;          // pixels of one eye a block holds
constexpr int KEY_PIXELS = 2048;      // keys a block holds: EB eyes x SEG pixels
constexpr int EB_MAX = 32;            // eyes a block holds
constexpr int TILE_BITS = 10;
constexpr int TILE = 1 << TILE_BITS;  // targets staged at a time
constexpr int LIST = 4096;            // entries the pair list holds
constexpr int ROUND = 8;              // pairs a thread tests a round
constexpr int MAP = 224;              // items a warp's owner map holds
// 44 KB of shared memory a block, so that five blocks fit an SM's 228 KB
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;

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

// The counting kernel's sums of one thread: pairs drawn (those that passed
// the pre-cull), pairs covering a pixel whose first covered pixel lies in
// this segment, covered triples, and pixel tests that took the divide.
struct Counts {
  unsigned drawn = 0u, covering = 0u, triples = 0u, band = 0u;
};

// NDC centre of pixel p of a w-pixel line (camera.pixel_centers_for_width).
__device__ __forceinline__ float pixel_center(int p, int w) {
  return 2.0f * ((float)p + 0.5f) / (float)w - 1.0f;
}

// The visible target's footprint (centre uc, half-width du, threshold thr)
// for the eye at pe: false where it is not visible (render.py's project).
__device__ __forceinline__ bool project_target(float2 pe, float2 de, float2 xj,
                                               const EyeParams& q, float& f, float& uc,
                                               float& du, float& thr) {
  float ft;
  const bool in_depth =
      disc_project(pe, de, xj, q.near_plane, q.far_plane, q.tan_half_fov, f, uc, ft);
  const float d = q.radius / ft;
  du = fmaxf(d, 1e-30f);
  thr = q.antialias ? 1.0f + q.inv_width / du : 1.0f;
  return in_depth && fabsf(uc) <= 1.0f + d;
}

// Pixels [lo, hi] of a w-pixel line that a footprint can cover, and the
// distance reach_plus from uc within which a covered centre lies: the
// pixel span (pair_math.cuh) of a reach of thr du. ops/raycast.py::
// disc_pixel_ranges computes the same expressions.
__device__ __forceinline__ void disc_pixel_range(float uc, float du, float thr,
                                                 const EyeParams& q, int w, int& lo, int& hi,
                                                 float& reach_plus) {
  pixel_span(uc, thr * du, q.inv_width, q.half_width, w, lo, hi, reach_plus);
}

// The band [inner, outer) of |a| around reach = thr du (reach times 1 -/+
// 2^-20) outside which cover_pixel decides |a / du| < thr without the
// divide: below it the divide rounds under thr, from its top up it rounds to
// thr or above, whatever the few roundings of thr du and of the band (each
// 2^-24 of it) and of the divide. Its outer bound lies below reach_plus
// (thr du plus 2^-16 of it at least). ops/raycast.py::disc_band_cover
// computes the same expressions.
__device__ __forceinline__ void edge_band(float reach, float& inner, float& outer) {
  inner = reach * (1.0f - 1.0f / 1048576.0f);
  outer = reach * (1.0f + 1.0f / 1048576.0f);
}

// The plain version's per-pixel test of one target (key k, footprint
// centre uc and half-width du, reach thr du) at segment pixel p, where it
// can win: first two cheap exits, a centre at or beyond the band's outer
// edge (the exact test cannot cover it) and a pixel that already holds a
// lesser key; then the band test, thr and the divide only inside the band
// (thr as project_target makes it). COUNT tests the pixel whatever its key
// holds, returns 1 where it covers and adds the tests in the band to `band`.
template <bool COUNT>
__device__ __forceinline__ unsigned cover_pixel(unsigned long long* key, const float* s_up,
                                                int p, float uc, float du, float reach,
                                                unsigned long long k, const EyeParams& q,
                                                unsigned& band) {
  const float a = s_up[p] - uc;
  const float m = fabsf(a);
  float inner, outer;
  edge_band(reach, inner, outer);
  if (COUNT) {
    const bool in_band = m >= inner && m < outer;
    const bool covered =
        m < inner || (in_band && fabsf(a / du) < (q.antialias ? 1.0f + q.inv_width / du : 1.0f));
    band += in_band ? 1u : 0u;
    if (covered && k < key[p]) atomicMin(key + p, k);
    return covered ? 1u : 0u;
  }
  if (m >= outer || k >= key[p]) return 0u;
  if (m < inner || fabsf(a / du) < (q.antialias ? 1.0f + q.inv_width / du : 1.0f)) {
    atomicMin(key + p, k);
  }
  return 0u;
}

// Whether the target at xj may be visible from the eye at (pe, de), without
// a divide (pair_math.cuh::disc_may_be_visible): project_target's |l/(f t)|
// <= 1 + r/(f t) implies it whatever their roundings.
// ops/raycast.py::disc_maybe_visible computes the same expressions.
__device__ __forceinline__ bool may_be_visible(float2 pe, float2 de, float2 xj,
                                               const EyeParams& q) {
  return disc_may_be_visible(pe, de, xj, q.near_plane, q.far_plane, q.tan_half_fov, q.radius);
}

// Draw the list's first n entries (eye slot above TILE_BITS, target of the
// staged tile below; the tile's first target is j0), every thread of the
// block together, an entry a thread at a time, dealt round the warps (so
// that a short list spreads over them): project the target, and run the
// test on the segment pixels [0, pn) of its range where it can still win.
// The pixels of the warp's ranges are its items, numbered by a scan of the
// ranges' lengths: each lane takes an item a step, its entry's lane named
// by `owner` (the warp's map from item to lane, MAP items long; past it a
// binary search of the lanes' starts) and its footprint handed over by
// shuffles, so that a long range does not hold the warp while the short
// ones wait. COUNT: `hit` collects the lanes whose entry covered an item.
template <bool COUNT>
__device__ __forceinline__ void draw_list(const int* list, int n, const float4* eyes,
                                          const float2* tile, int j0, const EyeParams& q, int w,
                                          int p0, int pn, int seg, unsigned long long* s_key,
                                          const float* s_up, int lane, unsigned char* owner,
                                          unsigned* hit, Counts& cnt) {
  for (int base = 0; base < n; base += THREADS) {  // uniform across the block
    const int i = base + lane * WARPS + (int)threadIdx.x / WARP;
    float f = 0.f, uc = 0.f, du = 1.f, thr = 0.f;
    int lo = 1, hi = 0, el = 0, j = 0;  // the segment pixels to test, none by default
    bool first_here = true;             // COUNT: no pixel before the segment is covered
    if (i < n) {
      const int entry = list[i];
      const int jl = entry & (TILE - 1);
      el = entry >> TILE_BITS;
      j = j0 + jl;
      const float4 eye = eyes[el];
      if (project_target(make_float2(eye.x, eye.y), make_float2(eye.z, eye.w), tile[jl], q, f,
                         uc, du, thr)) {
        float rp;
        disc_pixel_range(uc, du, thr, q, w, lo, hi, rp);
        lo = max(lo, p0) - p0;
        hi = min(hi, p0 + pn - 1) - p0;
        if (COUNT && p0 > 0) first_here = !(fabsf((pixel_center(p0 - 1, w) - uc) / du) < thr);
      }
      if (COUNT) ++cnt.drawn;
    }
    const unsigned long long k = ((unsigned long long)__float_as_uint(f) << 32) | (unsigned)j;
    const float reach = thr * du;
    const int items = max(hi - lo + 1, 0);
    int end = items;
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int v = __shfl_up_sync(FULL, end, o);
      if (lane >= o) end += v;
    }
    const int total = __shfl_sync(FULL, end, WARP - 1);
    const int start = end - items;
    for (int x = start; x < min(start + items, MAP); ++x) owner[x] = (unsigned char)lane;
    // this entry's eye and its pixel of item 0 (lo - start > -SEG_MAX WARP)
    const int where = (lo - start + SEG_MAX * WARP) | (el << 16);
    __syncwarp();
    for (int x0 = 0; x0 < total; x0 += WARP) {  // uniform across the warp
      const int x = x0 + lane;
      int o = lane;  // the item's owner: the last lane whose items start at or before it
      if (x0 + WARP <= MAP) {
        if (x < total) o = owner[x];
      } else {  // past the map: a binary search of the lanes' starts
        o = 0;
#pragma unroll
        for (int step = WARP / 2; step > 0; step >>= 1) {
          if (__shfl_sync(FULL, start, o + step) <= x) o += step;
        }
      }
      const float o_uc = __shfl_sync(FULL, uc, o);
      const float o_du = __shfl_sync(FULL, du, o);
      const float o_reach = __shfl_sync(FULL, reach, o);
      const unsigned long long o_k = __shfl_sync(FULL, k, o);
      const int o_where = __shfl_sync(FULL, where, o);
      if (x < total) {
        const int p = (o_where & 0xffff) - SEG_MAX * WARP + x;
        const unsigned c = cover_pixel<COUNT>(s_key + (o_where >> 16) * seg, s_up, p, o_uc, o_du,
                                              o_reach, o_k, q, cnt.band);
        if (COUNT && c) {
          cnt.triples += 1u;
          atomicOr(hit, 1u << o);
        }
      }
    }
    __syncwarp();  // the map read, and `hit` complete
    if (COUNT) {
      cnt.covering += (((*hit >> lane) & 1u) && first_here) ? 1u : 0u;
      __syncwarp();
      if (lane == 0) *hit = 0u;
      __syncwarp();
    }
  }
}

// One block of either kernel: EB eyes x SEG pixels of one env.
template <bool COUNT>
__device__ __forceinline__ void eye_block(const float2* __restrict__ eye_pos,
                                          const float2* __restrict__ eye_dir,
                                          const float2* __restrict__ tgt,
                                          const float* __restrict__ albedo,
                                          const float* __restrict__ texture,
                                          float* __restrict__ shade, float* __restrict__ depth,
                                          int* __restrict__ winner, int ne, int nt, int w,
                                          int seg, int eb, int ht, int wt, const EyeParams& q,
                                          unsigned long long* __restrict__ counters) {
  __shared__ unsigned long long s_key[KEY_PIXELS];
  __shared__ float2 s_tile[TILE];    // the staged targets
  __shared__ int s_list[LIST];       // the pairs that may be visible
  __shared__ float s_up[SEG_MAX];    // the segment's pixel centres
  __shared__ float4 s_eye[EB_MAX];   // the block's eyes: position, heading
  __shared__ int s_filled[2];        // the list's entries, by the round's parity
  __shared__ unsigned char s_owner[WARPS][MAP];  // each warp's item owners
  __shared__ unsigned s_hit[WARPS];  // COUNT: each warp's lanes whose entry covered an item
  __shared__ unsigned s_count[4];    // COUNT: the block's Counts
  const int b = blockIdx.z;
  const int e0 = blockIdx.x * eb;
  const int p0 = blockIdx.y * seg;
  const int pn = min(seg, w - p0);
  const int ebv = min(eb, ne - e0);  // the block's eyes
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  for (int i = threadIdx.x; i < eb * seg; i += THREADS) s_key[i] = NO_KEY;
  for (int i = threadIdx.x; i < pn; i += THREADS) s_up[i] = pixel_center(p0 + i, w);
  if (threadIdx.x < EB_MAX) {  // a slot past the block's eyes faces nowhere: f = 0, no target seen
    float4 eye = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((int)threadIdx.x < ebv) {
      const long long e = (long long)b * ne + e0 + threadIdx.x;
      const float2 pe = eye_pos[e];
      const float2 de = eye_dir[e];
      eye = make_float4(pe.x, pe.y, de.x, de.y);
    }
    s_eye[threadIdx.x] = eye;
  }
  if (threadIdx.x < 2) s_filled[threadIdx.x] = 0;
  if (COUNT && threadIdx.x < 4) s_count[threadIdx.x] = 0u;
  if (COUNT && threadIdx.x < WARPS) s_hit[threadIdx.x] = 0u;

  const float2* tb = tgt + (long long)b * nt;
  Counts cnt;
  unsigned flushes = 0u;  // COUNT: lists drawn before their tile's cull ended
  int parity = 0;
  for (int t0 = 0; t0 < nt; t0 += TILE) {
    const int tn = min(TILE, nt - t0);
    // thread -> (target slot, eye group): tp threads cover the tile's
    // targets, THREADS / tp groups the block's eyes (EB and both powers of
    // two); a thread's pairs are its slots' targets against its group's
    // eyes, ROUND a round, pair u the eye u % per_slot of slot u / per_slot
    const int tp = tn >= THREADS ? THREADS : max(WARP, 1 << (32 - __clz(tn - 1)));
    const int groups = THREADS / tp;
    const int group = threadIdx.x / tp;
    const int per_slot = max(eb / groups, 1);
    const int shift = __ffs(per_slot) - 1;
    const int span = (tn + tp - 1) / tp * tp;  // the slots' targets
    const int pairs = span / tp << shift;
    if (t0 > 0) __syncthreads();  // the last tile drawn
    // the tile, its last slots filled with NaN targets, which no eye sees
    for (int i = threadIdx.x; i < span; i += THREADS) {
      s_tile[i] = i < tn ? tb[t0 + i] : make_float2(NAN, NAN);
    }
    __syncthreads();
    for (int u0 = 0; u0 < pairs; u0 += ROUND) {
      const int j_at = (u0 >> shift) * tp + (threadIdx.x & (tp - 1));
      const int e_at = group + groups * (u0 & (per_slot - 1));
      unsigned bits = 0u;  // bit r: pair u0 + r passes
      if (per_slot >= ROUND) {  // uniform: the round's pairs share their target
        const float2 xj = s_tile[j_at];
#pragma unroll
        for (int r = 0; r < ROUND; ++r) {
          const float4 eye = s_eye[e_at + groups * r];
          if (may_be_visible(make_float2(eye.x, eye.y), make_float2(eye.z, eye.w), xj, q)) {
            bits |= 1u << r;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < ROUND; ++r) {
          if (u0 + r < pairs) {
            const float4 eye = s_eye[e_at + groups * (r & (per_slot - 1))];
            if (may_be_visible(make_float2(eye.x, eye.y), make_float2(eye.z, eye.w),
                               s_tile[j_at + (r >> shift) * tp], q)) {
              bits |= 1u << r;
            }
          }
        }
      }
      if (u0 > 0) __syncthreads();  // the list drawn, where it was (the tile's start did)
      int at = bits ? atomicAdd(s_filled + parity, __popc(bits)) : 0;
      for (; bits; bits &= bits - 1) {
        const int r = __ffs(bits) - 1;
        s_list[at++] = (j_at + (r >> shift) * tp) |
                       ((e_at + groups * (r & (per_slot - 1))) << TILE_BITS);
      }
      __syncthreads();  // the round's entries written
      const int n = s_filled[parity];
      // uniform: draw the list where the tile's cull ended or the next round might not fit
      if (u0 + ROUND >= pairs || n > LIST - THREADS * ROUND) {
        if (threadIdx.x == 0) s_filled[parity ^ 1] = 0;  // last read before the last barrier
        parity ^= 1;
        if (COUNT && u0 + ROUND < pairs) ++flushes;
        draw_list<COUNT>(s_list, n, s_eye, s_tile, t0, q, w, p0, pn, seg, s_key, s_up, lane,
                         s_owner[warp], s_hit + warp, cnt);
      }
    }
  }
  __syncthreads();
  // COUNT: the block's counts into the launch's, the pre-cull's from segment 0 alone
  if (COUNT) {
    const unsigned drawn = __reduce_add_sync(FULL, cnt.drawn);
    const unsigned covering = __reduce_add_sync(FULL, cnt.covering);
    const unsigned triples = __reduce_add_sync(FULL, cnt.triples);
    const unsigned band = __reduce_add_sync(FULL, cnt.band);
    if (lane == 0) {
      atomicAdd(s_count + 0, drawn);
      atomicAdd(s_count + 1, covering);
      atomicAdd(s_count + 2, triples);
      atomicAdd(s_count + 3, band);
    }
    __syncthreads();
    if (threadIdx.x < 3 && (threadIdx.x > 0 || blockIdx.y == 0)) {
      atomicAdd(counters + threadIdx.x, (unsigned long long)s_count[threadIdx.x]);
    }
    if (threadIdx.x == 3) atomicAdd(counters + 3, (unsigned long long)flushes);
    if (threadIdx.x == 4) atomicAdd(counters + 4, (unsigned long long)s_count[3]);
  }

  const int per_row = ebv >= WARPS ? 1 : WARPS / ebv;
  for (int el = warp / per_row; el < ebv; el += WARPS / per_row) {
    const float4 eye = s_eye[el];
    const long long row = ((long long)b * ne + e0 + el) * w + p0;
    for (int p = 2 * (lane + warp % per_row * WARP); p < pn; p += 2 * per_row * WARP) {
      float val[2], dep[2];
      int best[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long kw = p + h < pn ? s_key[el * seg + p + h] : NO_KEY;
        best[h] = kw == NO_KEY ? -1 : (int)(unsigned)(kw & 0xffffffffu);
        val[h] = q.background;
        dep[h] = q.far_plane;
        if (best[h] < 0) continue;
        float f, uc, du, thr;
        project_target(make_float2(eye.x, eye.y), make_float2(eye.z, eye.w),
                       nt <= TILE ? s_tile[best[h]] : tb[best[h]], q, f, uc, du, thr);
        const float best_off = (s_up[p + h] - uc) / du;
        const float oc = fminf(fmaxf(best_off, -1.0f), 1.0f);
        float alb = albedo ? albedo[(long long)b * nt + best[h]] : q.albedo;
        if (texture) {
          Tap tap;
          alb = alb * sample_texture(texture, false, ht, wt, 0.5f + 0.5f * oc, 0.5f, tap);
        }
        val[h] = alb * (1.0f - 0.25f * oc * oc);
        if (q.antialias) {
          const float s_win = q.half_width * du;
          const float covf =
              fminf(fmaxf((1.0f - fabsf(best_off)) * s_win + 0.5f, 0.0f), 1.0f);
          val[h] = q.background + covf * (val[h] - q.background);
        }
        dep[h] = f;
      }
      const long long o = row + p;
      if (p + 1 < pn && (o & 1) == 0) {
        *reinterpret_cast<float2*>(shade + o) = make_float2(val[0], val[1]);
        *reinterpret_cast<float2*>(depth + o) = make_float2(dep[0], dep[1]);
        if (winner) *reinterpret_cast<int2*>(winner + o) = make_int2(best[0], best[1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (p + h >= pn) break;
          shade[o + h] = val[h];
          depth[o + h] = dep[h];
          if (winner) winner[o + h] = best[h];
        }
      }
    }
  }
}

// Both kernels are held to five blocks of 256 threads an SM (48 registers
// of a Hopper card's 64K; the shared memory fits five too): the draw's
// chains of short latencies want the fifth block's warps more than the
// registers, and a traced run keeps the occupancy of an untraced one.
__global__ void __launch_bounds__(THREADS, 5)
    disc_eye_kernel(const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
                    const float2* __restrict__ tgt, const float* __restrict__ albedo,
                    const float* __restrict__ texture, float* __restrict__ shade,
                    float* __restrict__ depth, int* __restrict__ winner, int ne, int nt, int w,
                    int seg, int eb, int ht, int wt, EyeParams q) {
  eye_block<false>(eye_pos, eye_dir, tgt, albedo, texture, shade, depth, winner, ne, nt, w, seg,
                   eb, ht, wt, q, nullptr);
}

__global__ void __launch_bounds__(THREADS, 5)
    disc_eye_kernel_counted(const float2* __restrict__ eye_pos,
                            const float2* __restrict__ eye_dir, const float2* __restrict__ tgt,
                            const float* __restrict__ albedo, const float* __restrict__ texture,
                            float* __restrict__ shade, float* __restrict__ depth,
                            int* __restrict__ winner, int ne, int nt, int w, int seg, int eb,
                            int ht, int wt, EyeParams q, unsigned long long* __restrict__ counters) {
  eye_block<true>(eye_pos, eye_dir, tgt, albedo, texture, shade, depth, winner, ne, nt, w, seg,
                  eb, ht, wt, q, counters);
}

// Eyes per block, EB (a power of two, as the cull's mapping of threads to
// pairs needs), for SEG-pixel segments: as many as EB_MAX and KEY_PIXELS
// keys hold, halved while the grid would give an SM fewer than two blocks.
int eyes_per_block(int batch, int ne, int segments, int seg) {
  static int sms = 0;  // the first card's; queried once, outside any graph capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int eb = EB_MAX;
  while (eb > 1 && eb * seg > KEY_PIXELS) eb /= 2;
  while (eb > 1 && (long long)batch * segments * ((ne + eb - 1) / eb) < 2LL * sms) eb /= 2;
  return eb;
}

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt [B, Nt, 2]; albedo [B, Nt], or null for
// the scalar; texture [ht, wt], or null for none; shade, depth [B, Ne, W];
// all fp32, contiguous; winner [B, Ne, W] int32, or null to skip it;
// counters: five unsigned 64-bit sums the launch adds its pairs passed,
// pairs covering, covered triples, list flushes and band divides to, or
// null to count nothing. Returns cudaGetLastError() after the launch.
extern "C" int nbt_disc_eye(const void* eye_pos, const void* eye_dir, const void* tgt,
                            const void* albedo, const void* texture, void* shade, void* depth,
                            void* winner, int batch, int ne, int nt, int w, int ht, int wt,
                            float tan_half_fov, float near_plane, float far_plane, float radius,
                            float inv_width, float half_width, float background,
                            float albedo_scalar, int antialias, void* counters, void* stream) {
  if (batch > 0 && ne > 0 && w > 0) {
    const int seg = min(w, SEG_MAX);
    const int segments = (w + seg - 1) / seg;
    const int eb = eyes_per_block(batch, ne, segments, seg);
    dim3 grid((ne + eb - 1) / eb, segments, batch);
    EyeParams q{tan_half_fov, near_plane, far_plane, radius, inv_width,
                half_width,   background, albedo_scalar, antialias};
    const auto s = static_cast<cudaStream_t>(stream);
    const auto ep = static_cast<const float2*>(eye_pos);
    const auto ed = static_cast<const float2*>(eye_dir);
    const auto tp = static_cast<const float2*>(tgt);
    const auto al = static_cast<const float*>(albedo);
    const auto tx = static_cast<const float*>(texture);
    const auto sh = static_cast<float*>(shade);
    const auto dp = static_cast<float*>(depth);
    const auto wn = static_cast<int*>(winner);
    if (counters) {
      disc_eye_kernel_counted<<<grid, THREADS, 0, s>>>(
          ep, ed, tp, al, tx, sh, dp, wn, ne, nt, w, seg, eb, ht, wt, q,
          static_cast<unsigned long long*>(counters));
    } else {
      disc_eye_kernel<<<grid, THREADS, 0, s>>>(ep, ed, tp, al, tx, sh, dp, wn, ne, nt, w, seg,
                                                 eb, ht, wt, q);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
