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
// When the wrapper passes a counter array (three unsigned 64-bit sums; the
// port's recorder counts: inside its recording() alone, so that a profiler
// trace without it times disc_eye_kernel), the launch runs
// disc_eye_kernel_counted, the same block with counters: it also adds, once
// a block, the (eye, target) pairs
// that pass the frustum pre-cull, the pairs that cover at least one pixel
// and the covered (eye, target, pixel) triples. Every pixel of a target's
// range is then tested, where it can win or not, by a test without a divide
// that decides all but the pixels within 2^-20 of the footprint's edge
// (cover_pixel), which take the exact test. A pair is counted in the
// segment that holds its first covered pixel (a footprint covers a run of
// pixels: the offset grows with the pixel), its pre-cull in segment 0. With
// a null array the launch runs disc_eye_kernel, which counts nothing.
//
// What bounds it: the projections (16 operations and three IEEE divides per
// (eye, target) pair that may be visible) and the [B, Ne, W] output write.
// A pixel-by-pixel scan of every target, as the plain version's argmin
// makes it, spends almost all its work on pixels a target cannot reach:
// under spread spawns a quarter of the targets lie in an eye's 90-degree
// frustum, and a footprint covers one or two pixels of a 64-pixel line.
// Design: a block owns EB eyes x SEG pixels of one env (blockIdx.z; a row
// wider than SEG_MAX is cut into segments, blockIdx.y), and keeps one 64-bit
// key per pixel in shared memory: the winner's depth bits above its target
// index. Each warp takes one eye and reads its targets 32 at a time; those
// that may be visible (may_be_visible: depth and frustum without a divide)
// queue up in shared memory, and the warp draws them 32 at a time, a lane
// per target, so the divides run on full warps. A lane projects its target
// exactly and computes the pixels its footprint can reach
// (disc_pixel_range: widened by a slack above every rounding involved and
// an eighth of a pixel, so rounding never leaves out a pixel the exact test
// covers, while a range holds few pixels the footprint misses: each costs
// its lane a loop step); on each of them where the
// target can still win (its centre within the unwidened reach, the pixel's
// key not less) it runs exactly the plain version's per-pixel test and
// atomicMin's its key into the pixel's. A lane walks a range of at most
// NARROW pixels alone; the warp walks the wider ones together, a lane per
// pixel, reading their footprints from shared memory, so a near or
// clustered target costs a warp step or two, not a long serial loop. Rows
// wider than SEG_MAX = 256 pixels are cut into segments, each a block, so
// that a near target's range is walked in a few steps by several blocks. Depths
// are > near > 0, so their bits order as unsigned integers and the least key
// is the least depth, then the lowest index: the winner of the plain
// version's argmin, tie rule included, whatever order the atomics land in.
// The epilogue reprojects each pixel's winner with the same expressions and
// shades it. ops/raycast.py::disc_maybe_visible and ::disc_pixel_ranges are
// the plain versions of the two culls: they must agree with the kernel,
// expression for expression (the CPU tests prove them conservative against
// the exact test). Any width and any N; pixel, eye and target tails are
// masked by bounds. Built with -fmad=false so that edge pixels agree with
// the plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "pair_math.cuh"
#include "texture.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int SEG_MAX = 256;      // pixels of one eye a block holds
constexpr int KEY_PIXELS = 2048;  // keys a block holds: EB eyes x SEG pixels
constexpr int NARROW = 16;        // the widest range a lane walks alone
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

// The plain version's per-pixel test of one target (key k) at segment pixel
// p, where it can win: first two cheap exits, a centre farther than
// reach_plus from uc (thr du and the range's relative slack: the exact test
// cannot cover it) and a pixel that already holds a lesser key.
//
// COUNT tests the pixel whatever its key holds and returns 1 where it
// covers, deciding |a / du| < thr without the divide outside the band
// [inner, outer) of |a| (edge_band: thr du times 1 -/+ 2^-20): below it the
// divide rounds under thr, from its top up it rounds to thr or above,
// whatever the few roundings of thr du and of the band (each 2^-24 of it)
// and of the divide; inside it the exact test decides. Its outer bound lies
// below reach_plus (thr du plus 2^-16 of it at least).
template <bool COUNT>
__device__ __forceinline__ unsigned cover_pixel(unsigned long long* key, const float* s_up,
                                                int p, float uc, float du, float thr,
                                                float reach_plus, unsigned long long k,
                                                float inner = 0.f, float outer = 0.f) {
  const float a = s_up[p] - uc;
  if (COUNT) {
    const float m = fabsf(a);
    const bool covered = m < inner || (m < outer && fabsf(a / du) < thr);
    if (covered && k < key[p]) atomicMin(key + p, k);
    return covered ? 1u : 0u;
  }
  if (fabsf(a) >= reach_plus || k >= key[p]) return 0u;
  if (fabsf(a / du) < thr) atomicMin(key + p, k);
  return 0u;
}

// cover_pixel's band for COUNT: [inner, outer) around thr du.
__device__ __forceinline__ void edge_band(float du, float thr, float& inner, float& outer) {
  const float reach = thr * du;
  inner = reach * (1.0f - 1.0f / 1048576.0f);
  outer = reach * (1.0f + 1.0f / 1048576.0f);
}

// Whether the target at xj may be visible from the eye at (pe, de), without
// a divide (pair_math.cuh::disc_may_be_visible): project_target's |l/(f t)|
// <= 1 + r/(f t) implies it whatever their roundings.
// ops/raycast.py::disc_maybe_visible computes the same expressions.
__device__ __forceinline__ bool may_be_visible(float2 pe, float2 de, float2 xj,
                                               const EyeParams& q) {
  return disc_may_be_visible(pe, de, xj, q.near_plane, q.far_plane, q.tan_half_fov, q.radius);
}

// One target per lane (j < 0: none), all 32 lanes together: project it, and
// run the exact test on the segment pixels [0, pn) of its range where it can
// still win. A range of at most NARROW pixels is walked by its own lane;
// the warp walks the wider ones together, a lane per pixel, reading each
// one's footprint from `wide` (the warp's staging slots). COUNT adds to the
// warp's counts `cnt` (the same in every lane) the targets drawn (those that
// passed the pre-cull), those that cover a pixel whose first covered pixel
// lies in this segment, and their covered pixels.
template <bool COUNT>
__device__ __forceinline__ void draw_targets(int j, int lane, float2 pe, float2 de,
                                             const float2* tb, const EyeParams& q, int w,
                                             int p0, int pn, unsigned long long* key,
                                             const float* s_up, float4 (*wide)[2],
                                             uint3& cnt) {
  float f = 0.f, uc = 0.f, du = 1.f, thr = 0.f, rp = 0.f;
  int lo = 1, hi = 0;  // the segment pixels to test, none by default
  bool first_here = true;  // no pixel before the segment is covered
  if (j >= 0 && project_target(pe, de, tb[j], q, f, uc, du, thr)) {
    disc_pixel_range(uc, du, thr, q, w, lo, hi, rp);
    lo = max(lo, p0) - p0;
    hi = min(hi, p0 + pn - 1) - p0;
    if (COUNT && p0 > 0) first_here = !(fabsf((pixel_center(p0 - 1, w) - uc) / du) < thr);
  }
  const unsigned long long k = ((unsigned long long)__float_as_uint(f) << 32) | (unsigned)j;
  unsigned mine = 0u;  // COUNT: this lane's target's covered pixels
  if (hi - lo < NARROW) {
    float inner = 0.f, outer = 0.f;
    if (COUNT) edge_band(du, thr, inner, outer);
    for (int p = lo; p <= hi; ++p) {
      mine += cover_pixel<COUNT>(key, s_up, p, uc, du, thr, rp, k, inner, outer);
    }
  }
  const unsigned wide_lanes = __ballot_sync(FULL, hi - lo >= NARROW);
  if (hi - lo >= NARROW) {
    wide[lane][0] = make_float4(uc, du, thr, rp);
    wide[lane][1] = make_float4(__uint_as_float((unsigned)k),
                                __uint_as_float((unsigned)(k >> 32)), __int_as_float(lo),
                                __int_as_float(hi));
  }
  __syncwarp();
  for (unsigned m = wide_lanes; m; m &= m - 1) {
    const float4 a = wide[__ffs(m) - 1][0];
    const float4 c = wide[__ffs(m) - 1][1];
    const unsigned long long kw =
        ((unsigned long long)__float_as_uint(c.y) << 32) | __float_as_uint(c.x);
    const int hi_w = __float_as_int(c.w);
    float inner = 0.f, outer = 0.f;
    if (COUNT) edge_band(a.y, a.z, inner, outer);
    unsigned got = 0u;
    for (int p = __float_as_int(c.z) + lane; p <= hi_w; p += WARP) {
      got += cover_pixel<COUNT>(key, s_up, p, a.x, a.y, a.z, a.w, kw, inner, outer);
    }
    if (COUNT) {
      const unsigned all = __reduce_add_sync(FULL, got);
      if (lane == __ffs(m) - 1) mine = all;  // the target's own lane
    }
  }
  __syncwarp();
  if (COUNT) {
    const unsigned drawn = __popc(__ballot_sync(FULL, j >= 0));
    const unsigned covering = __popc(__ballot_sync(FULL, mine > 0u && first_here));
    cnt.x += drawn;
    cnt.y += covering;
    cnt.z += __reduce_add_sync(FULL, mine);
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
  extern __shared__ float s_tex[];  // the staged texture (texture.cuh)
  __shared__ unsigned long long s_key[KEY_PIXELS];
  __shared__ float s_up[SEG_MAX];  // the segment's pixel centres
  __shared__ int s_queue[WARPS][2 * WARP];  // each warp's targets that may be visible
  __shared__ float4 s_wide[WARPS][WARP][2];
  __shared__ unsigned s_count[WARPS][3];  // COUNT: each warp's pairs passed, covering, triples
  const int b = blockIdx.z;
  const int e0 = blockIdx.x * eb;
  const int p0 = blockIdx.y * seg;
  const int pn = min(seg, w - p0);
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  for (int i = threadIdx.x; i < eb * seg; i += THREADS) s_key[i] = NO_KEY;
  for (int i = threadIdx.x; i < pn; i += THREADS) s_up[i] = pixel_center(p0 + i, w);
  if (COUNT && threadIdx.x < WARPS * 3) s_count[threadIdx.x / 3][threadIdx.x % 3] = 0u;
  bool staged;
  const float* tex = stage_texture(texture, ht * wt, s_tex, staged);
  __syncthreads();

  // warp -> (eye el, every (WARPS / eb)-th chunk of 32 targets); the targets
  // that may be visible queue up, and the warp draws them 32 at a time
  const int el = warp % eb;
  const int e = e0 + el;
  if (e < ne) {  // uniform across the warp
    const float2 pe = eye_pos[(long long)b * ne + e];
    const float2 de = eye_dir[(long long)b * ne + e];
    const float2* tb = tgt + (long long)b * nt;
    unsigned long long* key = s_key + el * seg;
    int* queue = s_queue[warp];
    int queued = 0;
    uint3 cnt = make_uint3(0u, 0u, 0u);  // COUNT: the warp's pairs drawn, covering, triples
    for (int j0 = (warp / eb) * WARP; j0 < nt; j0 += WARP * (WARPS / eb)) {
      const int j = j0 + lane;
      const bool maybe = j < nt && may_be_visible(pe, de, tb[j], q);
      const unsigned mask = __ballot_sync(FULL, maybe);
      if (maybe) queue[queued + __popc(mask & ((1u << lane) - 1))] = j;
      queued += __popc(mask);
      __syncwarp();
      if (queued >= WARP) {
        draw_targets<COUNT>(queue[lane], lane, pe, de, tb, q, w, p0, pn, key, s_up,
                            s_wide[warp], cnt);
        queued -= WARP;
        const int moved = lane < queued ? queue[WARP + lane] : 0;
        __syncwarp();
        if (lane < queued) queue[lane] = moved;
        __syncwarp();
      }
    }
    if (queued > 0) {
      draw_targets<COUNT>(lane < queued ? queue[lane] : -1, lane, pe, de, tb, q, w, p0, pn, key,
                          s_up, s_wide[warp], cnt);
    }
    if (COUNT && lane == 0) {
      s_count[warp][0] = cnt.x;
      s_count[warp][1] = cnt.y;
      s_count[warp][2] = cnt.z;
    }
  }
  __syncthreads();
  // COUNT: the warps' counts into the launch's, the pre-cull's from segment 0 alone
  if (COUNT && threadIdx.x < 3 && (threadIdx.x > 0 || blockIdx.y == 0)) {
    unsigned long long sum = 0ull;
    for (int i = 0; i < WARPS; ++i) sum += s_count[i][threadIdx.x];
    atomicAdd(counters + threadIdx.x, sum);
  }

  for (int i = threadIdx.x; i < eb * seg; i += THREADS) {
    const int p = i % seg;
    const int ei = e0 + i / seg;
    if (ei >= ne || p >= pn) continue;
    const long long o = ((long long)b * ne + ei) * w + p0 + p;
    const unsigned long long kw = s_key[i];
    const int best_j = kw == NO_KEY ? -1 : (int)(unsigned)(kw & 0xffffffffu);
    if (winner) winner[o] = best_j;
    if (best_j < 0) {
      shade[o] = q.background;
      depth[o] = q.far_plane;
      continue;
    }
    // the winner's footprint and offset, as its lane computed them
    float f, uc, du, thr;
    project_target(eye_pos[(long long)b * ne + ei], eye_dir[(long long)b * ne + ei],
                   tgt[(long long)b * nt + best_j], q, f, uc, du, thr);
    const float best_off = (s_up[p] - uc) / du;
    const float oc = fminf(fmaxf(best_off, -1.0f), 1.0f);
    float alb = albedo ? albedo[(long long)b * nt + best_j] : q.albedo;
    if (tex) {
      Tap tap;
      alb = alb * sample_texture(tex, staged, ht, wt, 0.5f + 0.5f * oc, 0.5f, tap);
    }
    float val = alb * (1.0f - 0.25f * oc * oc);
    if (q.antialias) {
      const float s_win = q.half_width * du;
      const float covf = fminf(fmaxf((1.0f - fabsf(best_off)) * s_win + 0.5f, 0.0f), 1.0f);
      val = q.background + covf * (val - q.background);
    }
    shade[o] = val;
    depth[o] = f;
  }
}

__global__ void disc_eye_kernel(const float2* __restrict__ eye_pos,
                                const float2* __restrict__ eye_dir,
                                const float2* __restrict__ tgt,
                                const float* __restrict__ albedo,
                                const float* __restrict__ texture, float* __restrict__ shade,
                                float* __restrict__ depth, int* __restrict__ winner, int ne,
                                int nt, int w, int seg, int eb, int ht, int wt, EyeParams q) {
  eye_block<false>(eye_pos, eye_dir, tgt, albedo, texture, shade, depth, winner, ne, nt, w, seg,
                   eb, ht, wt, q, nullptr);
}

// The counters cost registers: held to disc_eye_kernel's 48 (five blocks of
// 256 threads an SM on a Hopper card's 64K registers), so that a traced run
// keeps the occupancy of an untraced one.
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

}  // namespace

// eye_pos, eye_dir [B, Ne, 2]; tgt [B, Nt, 2]; albedo [B, Nt], or null for
// the scalar; texture [ht, wt], or null for none; shade, depth [B, Ne, W];
// all fp32, contiguous; winner [B, Ne, W] int32, or null to skip it;
// counters: three unsigned 64-bit sums the launch adds its pairs passed,
// pairs covering and covered triples to, or null to count nothing. Returns
// cudaGetLastError() after the launch.
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
    const size_t smem = staged_bytes(texture, ht * wt);
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
      disc_eye_kernel_counted<<<grid, THREADS, smem, s>>>(
          ep, ed, tp, al, tx, sh, dp, wn, ne, nt, w, seg, eb, ht, wt, q,
          static_cast<unsigned long long*>(counters));
    } else {
      disc_eye_kernel<<<grid, THREADS, smem, s>>>(ep, ed, tp, al, tx, sh, dp, wn, ne, nt, w, seg,
                                                 eb, ht, wt, q);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
