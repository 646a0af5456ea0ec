// The pullback of the disc eye on Hopper (the backward of disc_eye.cu).
//
// Replaces nenbody_tpu/ops/raycast.py::_raycast_bwd_kernel (the Pallas TPU
// kernel behind the custom VJP render_rows_diff). Given cotangents us, ud on
// (shade, depth) [B, Ne, W], it returns d eye position [B, Ne, 2], d eye
// heading [B, Ne, 2] and d target position [B, Nt, 2].
//
// Design: a winner-index backward. The forward kernel, when autograd needs
// it, writes the index of each pixel's winning target (-1 for background).
// The shade and depth of a pixel depend on its winner alone, so a lane
// reads each pixel's index, recomputes rel, f, l, u_c, du and
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
// What bounds it: bytes. Each pixel reads its index and two cotangents (12
// bytes) and a covered one does about 60 flops (4 IEEE divides for the
// forward's quotients, 3 fast ones for the gradient's). A warp takes a run of
// 128-pixel chunks of the flat [B Ne W] pixel array: its lanes read a chunk
// with 16-byte loads (4-byte loads for the array's last partial group of 4
// pixels, or where the arrays are not 16-byte aligned), and shared memory
// turns it so that lane i takes pixel i of each 32-pixel round, all lanes
// busy whatever W. Neighbouring lanes then hold neighbouring pixels, so the
// lanes that hold one winner sit side by side (warp_runs.cuh): each run of
// them sums its target share, and its last lane adds the 2 components with
// one atomic each, not 2 per covered pixel (their order varies from run to
// run, so target gradients agree with the plain version to rounding, not
// bit for bit). Each lane keeps its eye's share in registers until its
// row changes; then each run of lanes of one row adds the 4 components
// with one atomic each, about once per row.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_runs.cuh"

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;  // warps per block
constexpr int MIN_BLOCKS = 6;  // blocks an SM holds: at most 40 registers a thread
constexpr int CHUNK = 4 * WARP;  // pixels a warp reads at once, 4 a lane
constexpr unsigned FULL = 0xffffffffu;

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

// d (shade, depth) of pixel p (cotangents cs, cd) won by the target at xj,
// seen from the eye at pe along de: the target's share (gx, gy), minus the
// eye position's, and the eye heading's (gdx, gdy).
__device__ __forceinline__ void pixel_grad(float2 pe, float2 de, float2 xj, int p, int w,
                                           float cs, float cd, const EyeParams& q, float& gx,
                                           float& gy, float& gdx, float& gdy) {
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
  // quotients that feed no branch (the gradient's own) take the fast divide
  const float goff = cs * dsh_doff;
  const float gf = goff * __fdividef(u_p * q.tan_half_fov, q.radius) +
                   cs * dsh_ds * __fdividef(-s, f) + cd;
  const float gl = __fdividef(-goff, q.radius);
  gx = gf * de.x + gl * de.y;
  gy = gf * de.y - gl * de.x;
  gdx = gf * rx - gl * ry;
  gdy = gf * ry + gl * rx;
}

// Where a lane's pixel lies: flat row (env, eye), env, eye, pixel.
struct Place {
  long long row;
  int b, e, p;
};

// The place `by` pixels further on along the flat pixel array.
__device__ __forceinline__ void advance(Place& at, int by, int ne, int w) {
  at.p += by;
  while (at.p >= w) {
    at.p -= w;
    ++at.row;
    if (++at.e == ne) {
      at.e = 0;
      ++at.b;
    }
  }
}

// Add the lanes' eye shares ge (of row acc_row each; d eye pos x/y, d eye
// heading x/y), one atomic per run of lanes of one row and component, and
// zero them. Every lane of the warp calls it.
__device__ __forceinline__ void flush_eyes(long long acc_row, float ge[4], long long rows,
                                           float* g_eye, float* g_dir) {
  const Runs eyes = lane_runs(acc_row);
#pragma unroll
  for (int k = 0; k < 4; ++k) ge[k] = run_sum(ge[k], eyes);
  if (eyes.last && acc_row < rows) {
    atomicAdd(g_eye + 2 * acc_row, ge[0]);
    atomicAdd(g_eye + 2 * acc_row + 1, ge[1]);
    atomicAdd(g_dir + 2 * acc_row, ge[2]);
    atomicAdd(g_dir + 2 * acc_row + 1, ge[3]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) ge[k] = 0.f;
}

// A warp takes `cpw` chunks of CHUNK pixels of the flat pixel array; lane i
// takes pixel i of each 32-pixel round. `wide`: the arrays are 16-byte
// aligned, so a lane reads its 4 pixels with one load per array.
__global__ void __launch_bounds__(WARP * WARPS, MIN_BLOCKS)
disc_eye_bwd_kernel(const float2* __restrict__ eye_pos, const float2* __restrict__ eye_dir,
                    const float2* __restrict__ tgt, const int* __restrict__ winner,
                    const float* __restrict__ us, const float* __restrict__ ud,
                    float* __restrict__ g_eye, float* __restrict__ g_dir,
                    float* __restrict__ g_tgt, long long rows, int ne, int nt, int w, int cpw,
                    bool wide, EyeParams q) {
  __shared__ int4 s_j[WARPS][WARP];
  __shared__ float4 s_s[WARPS][WARP], s_d[WARPS][WARP];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long total = rows * w;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * cpw * CHUNK;
  if (first >= total) return;
  const long long last = min(total, first + (long long)cpw * CHUNK);
  Place at;  // this lane's pixel of the current round
  {
    const long long q0 = first + lane;
    at.row = q0 / w;
    at.p = (int)(q0 - at.row * w);
    at.b = (int)(at.row / ne);
    at.e = (int)(at.row - (long long)at.b * ne);
  }
  // the lane's eye share, of row acc_row, not yet added
  long long acc_row = at.row;
  float ge[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long base = first; base < last; base += CHUNK) {
    const long long o = base + 4 * lane;  // this lane's 4 pixels of the chunk
    int4 j4 = make_int4(-1, -1, -1, -1);
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f), d4 = s4;
    if (wide && o + 4 <= last) {
      j4 = *reinterpret_cast<const int4*>(winner + o);
      s4 = *reinterpret_cast<const float4*>(us + o);
      d4 = *reinterpret_cast<const float4*>(ud + o);
    } else if (o < last) {
      j4.x = winner[o];
      s4.x = us[o];
      d4.x = ud[o];
      if (o + 1 < last) {
        j4.y = winner[o + 1];
        s4.y = us[o + 1];
        d4.y = ud[o + 1];
      }
      if (o + 2 < last) {
        j4.z = winner[o + 2];
        s4.z = us[o + 2];
        d4.z = ud[o + 2];
      }
      if (o + 3 < last) {
        j4.w = winner[o + 3];
        s4.w = us[o + 3];
        d4.w = ud[o + 3];
      }
    }
    s_j[warp][lane] = j4;
    s_s[warp][lane] = s4;
    s_d[warp][lane] = d4;
    __syncwarp();
    int js[4];
    float css[4], cds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      js[i] = reinterpret_cast<const int*>(s_j[warp])[i * WARP + lane];
      css[i] = reinterpret_cast<const float*>(s_s[warp])[i * WARP + lane];
      cds[i] = reinterpret_cast<const float*>(s_d[warp])[i * WARP + lane];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i > 0 || base > first) advance(at, WARP, ne, w);
      if (__any_sync(FULL, at.row != acc_row)) {  // a row ended in some lane
        flush_eyes(acc_row, ge, rows, g_eye, g_dir);
        acc_row = at.row;
      }
      const bool live = js[i] >= 0 && (css[i] != 0.f || cds[i] != 0.f);
      float gx = 0.f, gy = 0.f;
      long long key = -1;
      if (live) {
        float hx, hy;
        key = (long long)at.b * nt + js[i];
        pixel_grad(eye_pos[at.row], eye_dir[at.row], tgt[key], at.p, w, css[i], cds[i], q, gx,
                   gy, hx, hy);
        ge[0] -= gx;
        ge[1] -= gy;
        ge[2] += hx;
        ge[3] += hy;
      }
      // each run of lanes with one winner adds its share
      const Runs runs = lane_runs(key);
      gx = run_sum(gx, runs);
      gy = run_sum(gy, runs);
      if (key >= 0 && runs.last) {
        atomicAdd(g_tgt + 2 * key, gx);
        atomicAdd(g_tgt + 2 * key + 1, gy);
      }
    }
  }
  flush_eyes(acc_row, ge, rows, g_eye, g_dir);
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
    const long long rows = (long long)batch * ne;
    EyeParams q{tan_half_fov, near_plane, far_plane, radius, inv_width,
                half_width,   background, albedo,    antialias};
    const bool wide = (reinterpret_cast<size_t>(winner) | reinterpret_cast<size_t>(us) |
                       reinterpret_cast<size_t>(ud)) % 16 == 0;
    const long long chunks = (rows * w + CHUNK - 1) / CHUNK;
    const long long per_row = (w + CHUNK - 1) / CHUNK;
    const int cpw = (int)max(1LL, min(per_row, chunks / GRID_WARPS));
    const long long warps = (chunks + cpw - 1) / cpw;
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    disc_eye_bwd_kernel<<<blocks, WARP * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(eye_pos), static_cast<const float2*>(eye_dir),
        static_cast<const float2*>(tgt), static_cast<const int*>(winner),
        static_cast<const float*>(us), static_cast<const float*>(ud),
        static_cast<float*>(g_eye), static_cast<float*>(g_dir), static_cast<float*>(g_tgt),
        rows, ne, nt, w, cpw, wide, q);
  }
  return static_cast<int>(cudaGetLastError());
}
