// The RDMA ring on Hopper: ONE launch per card walks every hop of the
// agent-axis ring for gravity, boids or the disc eye.
//
// Replaces the three Pallas TPU kernels of nenbody_tpu/parallel/rdma.py,
// _rdma_gravity_kernel (rdma_gravity_kernel here), _rdma_boids_kernel
// (rdma_boids_kernel) and _rdma_vision_kernel (rdma_vision_kernel), whose
// grid axis is the hop: each of D shards keeps its block of agents (its
// rows), and the blocks circulate, so that at hop k shard s holds block
// (s - k) mod D (the JAX ppermute s -> s + 1, and parallel/ring.py's order).
// Each hop adds the partial of the shard's rows against the circulating
// block: the unscaled gravity sum (times G after), the eight raw boids rule
// sums (the pair i == j excluded on hop 0, the only hop where a shard meets
// its own block; boids_finalize after), or the disc eye's depth merge into
// (best depth, winner off^2) (the decode after). The wrapper,
// nenbody_tpu_torch/parallel/rdma.py, applies those epilogues.
//
// The schedule (walk_ring), the TPU kernel's double-buffered comm slots and
// capacity handshake with device-side stores and flags in device memory:
//   * each shard owns two comm slots, slot[2][rows x payload floats], and
//     2 x P flags: arrived[q] (share q of the next slot has landed) and
//     consumed[q] (block q of the shard finished reading a hop's block);
//   * a shard's P blocks split its rows between them and its circulating
//     block into P shares; every flag has one writer, which stores the hop
//     count with release semantics at system scope, and its readers load it
//     with acquire semantics at system scope (a neighbour on another card
//     reads and writes through peer access);
//   * hop k of block q of shard s: (1) for k > 0 wait until every
//     arrived[q'] of s reads >= k (the slot k % 2 is whole; hop 0 reads the
//     shard's own block, the inputs); (2) if k < D - 1, wait until every
//     consumed[q'] of the right shard reads >= k for k >= 2 (it finished hop
//     k - 1, the last reader of its slot (k + 1) % 2: the capacity
//     handshake), store share q of the current block into the right shard's
//     slot (k + 1) % 2, fence at system scope and release arrived[q] of the
//     right shard = k + 1; the last hop sends nothing; (3) compute the hop's
//     partial for block q's rows and add it to the outputs; (4) release
//     consumed[q] of s = k + 1.
// A block waits only on flags of blocks that finished an earlier hop, or
// the same hop's puts, which precede every block's compute; so the wait
// graph follows the hops and has no cycle, PROVIDED every block of every
// shard of the card is resident: the grid is launched cooperatively
// (cudaLaunchCooperativeKernel refuses a grid that cannot be resident) and
// sized by the wrapper from the occupancy (nbt_rdma_capacity). A wait that
// outlasts WAIT_LIMIT_NS traps, so a fault fails the launch instead of
// holding the card. Slots are read through L2 (__ldcg), never through the
// non-coherent L1.
//
// The pair arithmetic and loops are the single-device kernels'
// (pair_math.cuh, boids_tile.cuh, gravity_tile.cuh), so a hop's boids pairs
// round as boids.cu's partials round them (summed in another order where
// boids.cu splits j across a cluster) and its gravity pairs as gravity.cu's
// but for the explicit fma (below); the disc eye follows
// the JAX RDMA kernel (rdma.py:535-561): off = (u_p - u_c) * f t / r,
// covered iff in depth and off^2 < 1; within a hop the least depth wins and
// the least off^2 among its targets; across hops a strict <, so an earlier
// hop keeps an exact depth tie. Each thread sums its row's hop in a fixed
// order and the hops in ring order, and the eye's keys are a minimum, so a
// result is the same from run to run.
//
// What bounds it: the pair work, as the single-device kernels (the fp32
// pipe: gravity 8 instructions and a MUFU reciprocal per pair, boids about
// 22, the eye a divide per (eye, target) and about 6 operations per covered
// (eye, target, pixel)), plus the waits: a hop's block count is 1/D of one
// device's, so the blocks of one card are split between its shards. Design:
// - gravity: gravity.cu's pair loop (gravity_tile.cuh): T threads a block,
//   R rows a thread, each x_j read from shared memory feeding R pairs, the
//   next tile prefetched, full tiles unrolled, rcp.approx and a Newton step
//   (within an ulp of the IEEE divide, no slow-path branch), the squared
//   distance and the two sums in explicit fma, as gravity_vjp.cu's pair
//   (8 fp32 instructions a pair, not 12: 1.78 against 2.38 ms at config 4
//   on an H100, PERF.md; gravity.cu keeps the plain version's roundings);
//   (T, R) from rdma_gravity_plan, pair_plan.cuh's rule without a split of
//   j, the card's shards' envs counted together (N=65,536 on 4 shards: 32
//   units of 512 rows a shard, 256 threads x 2 rows);
// - boids: boids.cu's pair loop (boids_tile.cuh): BOIDS_R rows a thread,
//   each (x_j, v_j) read from shared memory feeding both, the next tile
//   prefetched, full tiles unrolled; the index compare only on hop 0; no
//   split of j (N=65,536 on 4 shards: 128 blocks of 256 threads);
// - the disc eye: disc_eye.cu's cull inside each hop. A unit (env, up to
//   64 eyes, a segment of their rows) keeps one 64-bit (depth bits, off^2
//   bits) key per pixel in shared memory and stages its eyes and the
//   circulating block's targets there; each warp takes an eye, queues the
//   targets that may be visible (a frustum test without a divide),
//   projects them a lane each and runs the exact test only on the pixels
//   each footprint's widened span can reach, atomicMin'ing its key. At a
//   later hop each key starts at its row's depth, so a target that an
//   earlier hop's hides stops at the cheap exit, and the hop writes only
//   the pixels it wins (hop 0 writes all). 6 blocks an SM (40 registers):
//   a unit's work is a chain of short latencies, which more blocks hide.
//   parallel/rdma.py::rdma_disc_maybe_visible and ::rdma_disc_pixel_ranges
//   are the culls' plain versions (the CPU tests prove them conservative).
// The rows of env b meet only env b's segment of the block; ragged tails
// are masked by bounds. Built with -fmad=false as the other kernels.

#include <cuda_runtime.h>
#include <math.h>

#include "boids_tile.cuh"
#include "gravity_tile.cuh"
#include "pair_math.cuh"
#include "pair_plan.cuh"

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int MAX_PLANES = 2;  // payload planes: pos (x, y), vel (x, y)
constexpr int MAX_OUTS = 5;
constexpr int MAX_THREADS = 256;
constexpr int TABLE_COLS = MAX_PLANES + 1 + MAX_OUTS + 2;  // one shard's pointers

// One shard's tensors. `in` are its own block's payload planes (read only),
// also the hop-0 block; `out` its accumulators, rows env-major.
struct Shard {
  float* in[MAX_PLANES];
  const float2* eye_dir;  // the disc eye: the unit headings of the shard's eyes
  float* out[MAX_OUTS];
  float* slots;  // [2][planes], each plane rounded up to 4 floats (plane_floats)
  int* flags;    // [2][p]: arrived, consumed
};

struct Ring {
  Shard shard[MAX_SHARDS];
  int local[MAX_SHARDS];  // the shards whose blocks this launch runs
  int d;                  // shards on the ring
  int p;                  // blocks per shard
  int nb, nl;             // envs, and rows of each env in a shard's block
  int planes;
  int width[MAX_PLANES];  // floats per row of each payload plane
};

struct Payload {
  float* plane[MAX_PLANES];
};

__device__ __forceinline__ int thread_rank() { return threadIdx.y * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int block_threads() { return blockDim.x * blockDim.y; }

__device__ __forceinline__ int load_acquire(const int* flag) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* flag, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this traps: the launch fails with an error instead of
// holding the card (a hop at config 4 takes about a millisecond).
constexpr unsigned long long WAIT_LIMIT_NS = 30ull * 1000 * 1000 * 1000;

// Until every flags[0..n) reads >= target; the block's threads split the
// flags, then meet at the barrier, which orders every thread's later loads
// and stores after the acquires.
__device__ void wait_all(const int* flags, int n, int target) {
  for (int q = thread_rank(); q < n; q += block_threads()) {
    if (load_acquire(flags + q) >= target) continue;
    const unsigned long long start = global_ns();
    while (load_acquire(flags + q) < target) {
      __nanosleep(64);
      if (global_ns() - start > WAIT_LIMIT_NS) __trap();
    }
  }
  __syncthreads();
}

// Release `flag` = value once every thread of the block is done with what
// the flag announces (its stores visible at system scope, its loads done).
__device__ void publish(int* flag, int value) {
  __threadfence_system();
  __syncthreads();
  if (thread_rank() == 0) store_release(flag, value);
}

__device__ Payload own_block(const Ring& r, const Shard& sh) {
  Payload pl;
  for (int i = 0; i < MAX_PLANES; ++i) pl.plane[i] = sh.in[i];
  return pl;
}

// Floats of plane i in a slot: rounded up to 4, so that every plane of both
// slots starts on 16 bytes (float2 loads need 8).
__device__ __forceinline__ long long plane_floats(const Ring& r, int i) {
  return ((long long)r.nb * r.nl * r.width[i] + 3) / 4 * 4;
}

__device__ Payload slot(const Ring& r, float* slots, int which) {
  long long total = 0;
  for (int i = 0; i < r.planes; ++i) total += plane_floats(r, i);
  Payload pl;
  float* base = slots + which * total;
  for (int i = 0; i < MAX_PLANES; ++i) {
    pl.plane[i] = base;
    if (i < r.planes) base += plane_floats(r, i);
  }
  return pl;
}

// Store share `share` of P of each plane of `src` into `dst`.
__device__ void put_share(const Ring& r, const Payload& src, const Payload& dst, int share) {
  const long long rows = (long long)r.nb * r.nl;
  for (int i = 0; i < r.planes; ++i) {
    const long long len = rows * r.width[i];
    const long long lo = len * share / r.p, hi = len * (share + 1) / r.p;
    for (long long e = lo + thread_rank(); e < hi; e += block_threads())
      dst.plane[i][e] = __ldcg(src.plane[i] + e);
  }
}

// The hop loop (file header). `hop(s, k, block)` adds hop k's partial of
// this block's rows of shard s against the circulating block.
template <class Hop>
__device__ void walk_ring(const Ring& r, Hop& hop) {
  const int s = r.local[blockIdx.x / r.p];
  const int share = blockIdx.x % r.p;
  const Shard& me = r.shard[s];
  const Shard& right = r.shard[s + 1 == r.d ? 0 : s + 1];
  for (int k = 0; k < r.d; ++k) {
    const Payload cur = k == 0 ? own_block(r, me) : slot(r, me.slots, k & 1);
    if (k > 0) wait_all(me.flags, r.p, k);
    if (k + 1 < r.d) {
      if (k >= 2) wait_all(right.flags + r.p, r.p, k);
      put_share(r, cur, slot(r, right.slots, (k + 1) & 1), share);
      publish(right.flags + share, k + 1);
    }
    hop(s, k, cur);
    publish(me.flags + r.p + share, k + 1);
  }
}

// The hop's partial lands in out[row]: stored at hop 0, added after.
__device__ __forceinline__ void accumulate(float* out, long long row, int k, float v) {
  out[row] = k == 0 ? v : out[row] + v;
}

__device__ __forceinline__ void accumulate(float2* out, long long row, int k, float x, float y) {
  if (k == 0) {
    out[row] = make_float2(x, y);
  } else {
    const float2 o = out[row];
    out[row] = make_float2(o.x + x, o.y + y);
  }
}

// -- gravity (#14) ------------------------------------------------------------

struct GravityParams {
  float bias;
};

// the warps an SM the plan aims for (parallel/rdma.py's
// RDMA_GRAVITY_MIN_WARPS_PER_SM, where the measurement behind it is): 7, not
// gravity.cu's 8, so that config 4 on 4 shards takes R = 2 on 128 of the
// H100's 132 SMs
constexpr int GRAVITY_MIN_WARPS_PER_SM = 7;

// The gravity kernel's launch plan for nb envs of nl rows a shard and
// `shards` shards on a card of `sms` SMs: pair_plan's (T, R) without a
// split of j (S = 1), the envs of the card's shards counted together;
// blocks_i is the units of one env. parallel/rdma.py::rdma_gravity_plan is
// its plain twin, which the wrapper launches from; the two must agree
// (nbt_rdma_gravity_plan exposes this one to the tests).
inline PairPlan rdma_gravity_plan(int nb, int nl, int shards, int sms) {
  return pair_plan(nb * shards, nl, nl, sms, GRAVITY_MIN_WARPS_PER_SM, 1);
}

// A unit is (env, T x R rows of the shard); its thread t holds rows t + r T
// and sums the circulating block's env segment through gravity_tile.cuh's
// loop, from zero in j order; the hop's partial is then added to the rows'
// total in hop order (accumulate). A block takes the same units at every
// hop, so the total's rows need no atomics.
template <int T, int R>
struct GravityHop {
  const Ring& r;
  GravityParams q;
  float2* tile;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const Shard& sh = r.shard[s];
    const int units_per_env = (r.nl + T * R - 1) / (T * R);
    const float2* own = reinterpret_cast<const float2*>(sh.in[0]);
    float2* out = reinterpret_cast<float2*>(sh.out[0]);
    for (int u = blockIdx.x % r.p; u < r.nb * units_per_env; u += r.p) {
      const int b = u / units_per_env;
      const int i0 = (u - b * units_per_env) * T * R + threadIdx.x;
      const long long seg = (long long)b * r.nl;
      const float2* blk = reinterpret_cast<const float2*>(cur.plane[0]) + seg;
      float2 xi[R];
      float gx[R], gy[R];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = i0 + m * T;
        xi[m] = i < r.nl ? own[seg + i] : make_float2(0.f, 0.f);
        gx[m] = 0.f;
        gy[m] = 0.f;
      }
      gravity_j_range<T, R, false, true>(tile, [blk](int j) { return __ldcg(blk + j); }, 0, r.nl,
                                         xi, q.bias, gx, gy);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = i0 + m * T;
        if (i < r.nl) accumulate(out, seg + i, k, gx[m], gy[m]);
      }
    }
  }
};

template <int T, int R>
__global__ void rdma_gravity_kernel(const __grid_constant__ Ring r, const GravityParams q) {
  __shared__ float2 tile[T];
  GravityHop<T, R> hop{r, q, tile};
  walk_ring(r, hop);
}

// -- boids (#15) --------------------------------------------------------------

struct BoidsParams {
  float coh_sq, sep_sq, ali_sq;
  static constexpr int alignment = 1;  // the RDMA ring has no global-alignment form
};

constexpr int BOIDS_R = 2;  // bodies per thread

// A unit is R x blockDim.x rows of one env; its thread t holds rows
// t + r T (register blocking: each (x_j, v_j) read from shared memory feeds
// R bodies) and sums the circulating block's env segment through
// boids_tile.cuh's loop. The pair i == j exists only on hop 0, where the
// circulating block is the shard's own, so only that hop compares indices
// (local ones: the global index differs by the block's offset on both
// sides), as the plain version's exclude_diagonal=(s - k) % d == s.
struct BoidsHop {
  const Ring& r;
  BoidsParams q;
  float4* tile;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const Shard& sh = r.shard[s];
    const int T = blockDim.x, t = threadIdx.x;
    const int units_per_env = (r.nl + T * BOIDS_R - 1) / (T * BOIDS_R);
    const float2* own_p = reinterpret_cast<const float2*>(sh.in[0]);
    const float2* own_v = reinterpret_cast<const float2*>(sh.in[1]);
    for (int u = blockIdx.x % r.p; u < r.nb * units_per_env; u += r.p) {
      const int b = u / units_per_env;
      const int i0 = (u - b * units_per_env) * T * BOIDS_R + t;
      const long long seg = (long long)b * r.nl;
      const float2* blk_p = reinterpret_cast<const float2*>(cur.plane[0]) + seg;
      const float2* blk_v = reinterpret_cast<const float2*>(cur.plane[1]) + seg;
      float2 xi[BOIDS_R], vi[BOIDS_R];
      int skip[BOIDS_R];
#pragma unroll
      for (int m = 0; m < BOIDS_R; ++m) {
        const int i = i0 + m * T;
        const bool in = i < r.nl;
        xi[m] = in ? own_p[seg + i] : make_float2(0.f, 0.f);
        vi[m] = in ? own_v[seg + i] : make_float2(0.f, 0.f);
        skip[m] = i;
      }
      auto load = [&](int j) {
        const float2 x = __ldcg(blk_p + j), v = __ldcg(blk_v + j);
        return make_float4(x.x, x.y, v.x, v.y);
      };
      BoidsSums acc[BOIDS_R];
      if (k == 0) {
        sum_j_range<BOIDS_R, true>(tile, T, load, 0, r.nl, xi, vi, skip, q, acc);
      } else {
        sum_j_range<BOIDS_R, false>(tile, T, load, 0, r.nl, xi, vi, skip, q, acc);
      }
#pragma unroll
      for (int m = 0; m < BOIDS_R; ++m) {
        const int i = i0 + m * T;
        if (i >= r.nl) continue;
        const long long row = seg + i;
        const BoidsSums& a = acc[m];
        accumulate(reinterpret_cast<float2*>(sh.out[0]), row, k, a.s1x, a.s1y);
        accumulate(sh.out[1], row, k, (float)a.c1);
        accumulate(reinterpret_cast<float2*>(sh.out[2]), row, k, a.rx, a.ry);
        accumulate(reinterpret_cast<float2*>(sh.out[3]), row, k, a.s3x, a.s3y);
        accumulate(sh.out[4], row, k, (float)a.c3);
      }
    }
  }
};

__global__ void rdma_boids_kernel(const __grid_constant__ Ring r, const BoidsParams q) {
  __shared__ float4 tile[MAX_THREADS];
  BoidsHop hop{r, q, tile};
  walk_ring(r, hop);
}

// -- the disc eye (#16) -------------------------------------------------------

constexpr int EYE_THREADS = 256;
constexpr int WARP = 32;
constexpr int EYE_WARPS = EYE_THREADS / WARP;
constexpr int SEG_MAX = 256;      // pixels of one eye a unit holds
constexpr int KEY_PIXELS = 2048;  // keys a block holds: EB eyes x SEG pixels
constexpr int KEYS_PER_THREAD = KEY_PIXELS / EYE_THREADS;
constexpr int EYE_MAX = 64;       // eyes of a unit
constexpr int STAGE = 512;        // targets staged in shared memory at once
constexpr int NARROW = 16;        // the widest span a lane walks alone
constexpr unsigned FULL = 0xffffffffu;

struct VisionParams {
  int w, seg, eb;  // row width, pixels and eyes of a unit
  float tan_half_fov, tan_over_radius, near_plane, far_plane, radius;
  float inv_width, half_width;  // 1/W, W/2
};

// A pixel's key for the hop: the depth's bits above off^2's. Both are
// non-negative floats, so the least key is the least depth, then the least
// off^2 at that depth: the hop rule, whatever order the atomics land in.
__device__ __forceinline__ unsigned long long eye_key(float depth, float o2) {
  return ((unsigned long long)__float_as_uint(depth) << 32) | __float_as_uint(o2);
}

// The exact test of one target at segment pixel p (the JAX RDMA kernel's:
// off = (u_p - u_c) * f t / r, covered iff off^2 < 1), where it can win:
// first two cheap exits, a centre as far as reach_plus from uc (the exact
// test cannot cover it) and a pixel whose key already has a lesser depth.
__device__ __forceinline__ void cover_pixel(unsigned long long* key, const float* s_up, int p,
                                            float uc, float inv, float reach_plus,
                                            unsigned depth_bits) {
  const float a = s_up[p] - uc;
  const unsigned long long kd = (unsigned long long)depth_bits << 32;
  if (fabsf(a) >= reach_plus || kd > key[p]) return;
  const float off = a * inv;
  const float o2 = off * off;
  if (o2 < 1.0f) atomicMin(key + p, kd | __float_as_uint(o2));
}

// One target per lane (`has`: a queued target at xj), all 32 lanes
// together: project it, and run the exact test on the segment pixels
// [0, pn) of its span. A footprint of half-width r/(f t) = 1/inv reaches a
// centre only if |fl(u_p - u_c)| < 1/inv, since off^2 < 1 needs |off| < 1
// and a rounded product is monotone: the span of that reach (pixel_span,
// widened by DISC_RANGE_SLACK and an eighth of a pixel) holds every covered
// pixel. A span of at most NARROW pixels is walked by its own lane; the
// warp walks the wider ones together, a lane per pixel, reading each one's
// footprint from `wide` (the warp's staging slots).
__device__ __forceinline__ void draw_targets(bool has, float2 xj, int lane, float2 pe, float2 de,
                                             const VisionParams& q, int p0, int pn,
                                             unsigned long long* key, const float* s_up,
                                             float4 (*wide)[2]) {
  float f = 0.f, uc = 0.f, inv = 0.f, rp = 0.f;
  int lo = 1, hi = 0;  // the segment pixels to test, none by default
  if (has) {
    float ft;
    if (disc_project(pe, de, xj, q.near_plane, q.far_plane, q.tan_half_fov, f, uc, ft)) {
      inv = f * q.tan_over_radius;
      pixel_span(uc, 1.0f / inv, q.inv_width, q.half_width, q.w, lo, hi, rp);
      lo = max(lo, p0) - p0;
      hi = min(hi, p0 + pn - 1) - p0;
    }
  }
  const unsigned fb = __float_as_uint(f);
  if (hi - lo < NARROW) {
    for (int p = lo; p <= hi; ++p) cover_pixel(key, s_up, p, uc, inv, rp, fb);
  }
  const unsigned wide_lanes = __ballot_sync(FULL, hi - lo >= NARROW);
  if (hi - lo >= NARROW) {
    wide[lane][0] = make_float4(uc, inv, rp, __uint_as_float(fb));
    wide[lane][1] = make_float4(__int_as_float(lo), __int_as_float(hi), 0.f, 0.f);
  }
  __syncwarp();
  for (unsigned m = wide_lanes; m; m &= m - 1) {
    const float4 a = wide[__ffs(m) - 1][0];
    const float4 c = wide[__ffs(m) - 1][1];
    const int hi_w = __float_as_int(c.y);
    for (int p = __float_as_int(c.x) + lane; p <= hi_w; p += WARP) {
      cover_pixel(key, s_up, p, a.x, a.y, a.z, __float_as_uint(a.w));
    }
  }
  __syncwarp();
}

// The shared memory of the eye's block.
struct EyeShared {
  unsigned long long key[KEY_PIXELS];  // the unit's (eye, pixel) keys
  float2 tgt[STAGE];                   // a stage of the circulating env-b targets
  float4 eye[EYE_MAX];                 // the unit's eyes: position, heading
  float up[SEG_MAX];                   // the unit's pixel centres
  float2 queue[EYE_WARPS][2 * WARP];   // each warp's targets that may be visible
  float4 wide[EYE_WARPS][WARP][2];
};

// A unit is (env b, EB eyes, a segment of SEG pixels of their rows); the
// block keeps one key per (eye, pixel) of the unit in shared memory for the
// hop, and stages the unit's eyes and the circulating block's env-b
// targets (STAGE at a time) there: each is read from device memory once a
// unit. With EB >= 8 warp w takes eyes w, w + 8, ...; with fewer, each eye
// gets 8 / EB warps, which split its targets in chunks of 32. The targets
// that may be visible (the divide-free frustum test) queue up, and the warp
// draws them 32 at a time. The merge into the shard's rows keeps the strict
// < across hops: hop 0 writes every pixel of the unit ((far, 1) where
// nothing covers it); at a later hop a pixel's key starts at (its row's
// depth, 0), so only a strictly nearer target changes it (and a target an
// earlier hop's hides skips it early), and the merge writes only the
// changed pixels. A unit's pixels belong to the same block and thread at
// every hop (units go to blocks by share), so the rows need no atomics.
struct VisionHop {
  const Ring& r;
  VisionParams q;
  EyeShared& sm;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const Shard& sh = r.shard[s];
    const int segments = (q.w + q.seg - 1) / q.seg;
    const int per_env = (r.nl + q.eb - 1) / q.eb * segments;
    const float2* own = reinterpret_cast<const float2*>(sh.in[0]);
    const float2* blk = reinterpret_cast<const float2*>(cur.plane[0]);
    const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
    // warp -> its eyes of the unit (eye0, eye0 + eye_step, ...) and its
    // chunks of each eye's targets (chunk0, chunk0 + chunk_step, ...)
    const int eye0 = warp % q.eb, eye_step = q.eb < EYE_WARPS ? q.eb : EYE_WARPS;
    const int chunk0 = q.eb < EYE_WARPS ? (warp / q.eb) * WARP : 0;
    const int chunk_step = q.eb < EYE_WARPS ? WARP * (EYE_WARPS / q.eb) : WARP;
    for (int u = blockIdx.x % r.p; u < r.nb * per_env; u += r.p) {
      const int b = u / per_env;
      const int g = (u - b * per_env) / segments;
      const int p0 = (u - b * per_env - g * segments) * q.seg;
      const int pn = min(q.seg, q.w - p0);
      const long long row0 = (long long)b * r.nl + g * q.eb;  // the unit's first eye's row
      unsigned seed[KEYS_PER_THREAD];  // the depth bits each key starts from
      __syncthreads();  // the last unit's keys are merged
#pragma unroll
      for (int n = 0; n < KEYS_PER_THREAD; ++n) {
        const int i = tid + n * EYE_THREADS;
        if (i >= q.eb * q.seg) break;
        const int p = i % q.seg;
        const int ei = g * q.eb + i / q.seg;
        seed[n] = __float_as_uint(q.far_plane);
        if (k > 0 && ei < r.nl && p < pn) {
          seed[n] = __float_as_uint(sh.out[0][(row0 + i / q.seg) * q.w + p0 + p]);
        }
        sm.key[i] = k > 0 ? (unsigned long long)seed[n] << 32 : eye_key(q.far_plane, 1.0f);
      }
      for (int i = tid; i < pn; i += EYE_THREADS) {
        sm.up[i] = 2.0f * ((float)(p0 + i) + 0.5f) / (float)q.w - 1.0f;
      }
      for (int i = tid; i < q.eb && g * q.eb + i < r.nl; i += EYE_THREADS) {
        const float2 pe = own[row0 + i], de = sh.eye_dir[row0 + i];
        sm.eye[i] = make_float4(pe.x, pe.y, de.x, de.y);
      }
      const float2* tb = blk + (long long)b * r.nl;
      for (int t0 = 0; t0 < r.nl; t0 += STAGE) {
        const int tn = min(STAGE, r.nl - t0);
        if (t0 > 0) __syncthreads();  // the last stage is drawn
        for (int i = tid; i < tn; i += EYE_THREADS) sm.tgt[i] = __ldcg(tb + t0 + i);
        __syncthreads();
        for (int el = eye0; el < q.eb; el += eye_step) {
          if (g * q.eb + el >= r.nl) break;  // uniform across the warp
          const float4 ev = sm.eye[el];
          const float2 pe = make_float2(ev.x, ev.y), de = make_float2(ev.z, ev.w);
          unsigned long long* ekey = sm.key + el * q.seg;
          float2* qu = sm.queue[warp];
          int queued = 0;
          for (int j0 = chunk0; j0 < tn; j0 += chunk_step) {
            const int j = j0 + lane;
            const float2 xj = j < tn ? sm.tgt[j] : make_float2(0.f, 0.f);
            const bool maybe = j < tn && disc_may_be_visible(pe, de, xj, q.near_plane,
                                                              q.far_plane, q.tan_half_fov,
                                                              q.radius);
            const unsigned mask = __ballot_sync(FULL, maybe);
            if (maybe) qu[queued + __popc(mask & ((1u << lane) - 1))] = xj;
            queued += __popc(mask);
            __syncwarp();
            if (queued >= WARP) {
              draw_targets(true, qu[lane], lane, pe, de, q, p0, pn, ekey, sm.up, sm.wide[warp]);
              queued -= WARP;
              const float2 moved = lane < queued ? qu[WARP + lane] : make_float2(0.f, 0.f);
              __syncwarp();
              if (lane < queued) qu[lane] = moved;
              __syncwarp();
            }
          }
          if (queued > 0) {
            draw_targets(lane < queued, qu[lane], lane, pe, de, q, p0, pn, ekey, sm.up,
                         sm.wide[warp]);
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int n = 0; n < KEYS_PER_THREAD; ++n) {
        const int i = tid + n * EYE_THREADS;
        if (i >= q.eb * q.seg) break;
        const int p = i % q.seg;
        const int ei = g * q.eb + i / q.seg;
        if (ei >= r.nl || p >= pn) continue;
        const unsigned long long kv = sm.key[i];
        const unsigned hd = (unsigned)(kv >> 32);
        if (k > 0 && hd == seed[n]) continue;  // no strictly nearer target: the row stays
        const long long o = (row0 + i / q.seg) * q.w + p0 + p;
        sh.out[0][o] = __uint_as_float(hd);
        sh.out[1][o] = __uint_as_float((unsigned)kv);
      }
    }
  }
};

// resident blocks an SM the registers must allow: 6 (40 registers, a few
// bytes of spills) ran faster on the H100 than 5 or 3 (PERF.md)
constexpr int EYE_MIN_BLOCKS = 6;

__global__ void __launch_bounds__(EYE_THREADS, EYE_MIN_BLOCKS)
    rdma_vision_kernel(const __grid_constant__ Ring r, const VisionParams q) {
  __shared__ EyeShared sm;
  VisionHop hop{r, q, sm};
  walk_ring(r, hop);
}

// -- launch -------------------------------------------------------------------

template <int T>
const void* gravity_fn(int rows) {
  return rows == 2   ? reinterpret_cast<const void*>(rdma_gravity_kernel<T, 2>)
         : rows == 1 ? reinterpret_cast<const void*>(rdma_gravity_kernel<T, 1>)
                     : nullptr;
}

// The kernel of `kind` (0 gravity, 1 boids, 2 the disc eye) for blocks of
// `threads` threads; gravity's instantiation is (threads, rows), the others
// have one. nbt_rdma_capacity sizes the grid for the function this returns
// and the launch sends that same function, so the grid always fits the
// kernel that runs. Null where no kernel has that shape.
const void* kernel_fn(int kind, int threads, int rows) {
  switch (kind) {
    case 0:
      switch (threads) {
        case 256: return gravity_fn<256>(rows);
        case 128: return gravity_fn<128>(rows);
        case 64: return gravity_fn<64>(rows);
        case 32: return gravity_fn<32>(rows);
        default: return nullptr;
      }
    case 1: return reinterpret_cast<const void*>(rdma_boids_kernel);
    case 2: return reinterpret_cast<const void*>(rdma_vision_kernel);
    default: return nullptr;
  }
}

// The Ring from the wrapper's host table: `table` holds TABLE_COLS pointers
// per shard (in[2], eye_dir, out[5], slots, flags), `local` the n_local
// shards this launch runs.
int make_ring(const void* table, const int* local, int n_local, int d, int p, int nb, int nl,
              int planes, const int* width, Ring& r) {
  if (d < 1 || d > MAX_SHARDS || n_local < 1 || n_local > d || p < 1 || nb < 1 || nl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long* t = static_cast<const unsigned long long*>(table);
  for (int s = 0; s < d; ++s) {
    const unsigned long long* c = t + (long long)s * TABLE_COLS;
    Shard& sh = r.shard[s];
    for (int i = 0; i < MAX_PLANES; ++i) sh.in[i] = reinterpret_cast<float*>(c[i]);
    sh.eye_dir = reinterpret_cast<const float2*>(c[MAX_PLANES]);
    for (int i = 0; i < MAX_OUTS; ++i) sh.out[i] = reinterpret_cast<float*>(c[MAX_PLANES + 1 + i]);
    sh.slots = reinterpret_cast<float*>(c[MAX_PLANES + 1 + MAX_OUTS]);
    sh.flags = reinterpret_cast<int*>(c[MAX_PLANES + 2 + MAX_OUTS]);
  }
  for (int i = 0; i < n_local; ++i) {
    if (local[i] < 0 || local[i] >= d) return static_cast<int>(cudaErrorInvalidValue);
    r.local[i] = local[i];
  }
  r.d = d;
  r.p = p;
  r.nb = nb;
  r.nl = nl;
  r.planes = planes;
  for (int i = 0; i < MAX_PLANES; ++i) r.width[i] = i < planes ? width[i] : 0;
  return 0;
}

// A cooperative launch: all n_local * p blocks resident at once, or an
// error (cudaErrorCooperativeLaunchTooLarge) and no launch.
template <class Params>
int launch(const void* fn, Ring& r, Params& q, int n_local, dim3 block, void* stream) {
  void* args[] = {&r, &q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(n_local * r.p), block, args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of `threads` threads of kernel `kind` (0 gravity, 1 boids, 2 the
// disc eye; `rows` the gravity kernel's R, 1 for the others: kernel_fn)
// that fit on the current device at once, all its SMs together, into
// *blocks (0 where the device has no cooperative launch).
extern "C" int nbt_rdma_capacity(int kind, int threads, int rows, int device, int* blocks) {
  *blocks = 0;
  const void* fn = kernel_fn(kind, threads, rows);
  if (fn == nullptr || threads < 1 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0, coop = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

// Let the current device's kernels read and write `peer`'s memory.
extern "C" int nbt_enable_peer(int peer) {
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  cudaGetLastError();
  return err == cudaErrorPeerAccessAlreadyEnabled ? 0 : static_cast<int>(err);
}

// Gravity (#14): planes pos [nb, nl, 2]; out[0] the unscaled force sums
// [nb, nl, 2]. `threads` (T: 256, 128, 64 or 32) per block, each thread
// `rows` (R: 1 or 2) rows of a unit: rdma_gravity_plan's.
extern "C" int nbt_rdma_gravity(const void* table, const int* local, int n_local, int d, int p,
                                int nb, int nl, int threads, int rows, float bias,
                                void* stream) {
  Ring r;
  const int width[1] = {2};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 1, width, r);
  if (err) return err;
  const void* fn = kernel_fn(0, threads, rows);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GravityParams q{bias};
  return launch(fn, r, q, n_local, dim3(threads), stream);
}

// The plan nbt_rdma_gravity is launched with for nb envs of nl rows a
// shard, `shards` shards on a card of `sms` SMs: out[0..2] = T, R, units of
// one shard.
extern "C" int nbt_rdma_gravity_plan(int nb, int nl, int shards, int sms, void* out) {
  const PairPlan plan = rdma_gravity_plan(nb, nl, shards, sms);
  int* o = static_cast<int*>(out);
  o[0] = plan.threads;
  o[1] = plan.r;
  o[2] = nb * plan.blocks_i;
  return 0;
}

// Boids (#15): planes pos, vel [nb, nl, 2]; out sum1, cnt1, repel, sum3,
// cnt3 (physics.dense.boids_partials_cross's order). `threads` (<= 256, a
// multiple of 32) per block, each thread BOIDS_R rows. Thresholds squared.
extern "C" int nbt_rdma_boids(const void* table, const int* local, int n_local, int d, int p,
                              int nb, int nl, int threads, float coh_sq, float sep_sq,
                              float ali_sq, void* stream) {
  Ring r;
  const int width[2] = {2, 2};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 2, width, r);
  if (err) return err;
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  BoidsParams q{coh_sq, sep_sq, ali_sq};
  return launch(kernel_fn(1, threads, 1), r, q, n_local, dim3(threads), stream);
}

// The disc eye (#16): planes pos [nb, nl, 2], eye_dir the unit headings;
// out[0] best depth, out[1] the winner's off^2, [nb, nl, w]. `eyes` (a
// power of two, at most EYE_MAX) eyes of a unit, each row cut into segments
// of min(w, SEG_MAX) pixels; EYE_THREADS threads per block.
extern "C" int nbt_rdma_vision(const void* table, const int* local, int n_local, int d, int p,
                               int nb, int nl, int eyes, int w, float tan_half_fov,
                               float tan_over_radius, float near_plane, float far_plane,
                               float radius, void* stream) {
  Ring r;
  const int width[1] = {2};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 1, width, r);
  if (err) return err;
  const int seg = min(w, SEG_MAX);
  if (w < 1 || eyes < 1 || eyes > EYE_MAX || (eyes & (eyes - 1)) || eyes * seg > KEY_PIXELS)
    return static_cast<int>(cudaErrorInvalidValue);
  VisionParams q{w, seg, eyes, tan_half_fov, tan_over_radius, near_plane, far_plane, radius,
                 1.0f / (float)w, 0.5f * (float)w};
  return launch(kernel_fn(2, EYE_THREADS, 1), r, q, n_local, dim3(EYE_THREADS), stream);
}
