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
// sums (self excluded by the GLOBAL agent index, which circulates with the
// block; boids_finalize after), or the disc eye's depth merge into (best
// depth, winner off^2) (the decode after). The wrapper,
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
// The pair arithmetic is the single-device kernels' (pair_math.cuh), so a
// hop rounds as gravity.cu and boids_partials.cu do; the disc eye follows
// the JAX RDMA kernel (rdma.py:535-561): off = (u_p - u_c) * f t / r,
// covered iff in depth and off^2 < 1; within a hop the least depth wins and
// the least off^2 among its targets; across hops a strict <, so an earlier
// hop keeps an exact depth tie. Each thread sums its row's hop in a fixed
// order and the hops in ring order, so a result is the same from run to run.
//
// What bounds it: the pair work, as the single-device kernels (the fp32
// pipe: gravity 11 operations and an exact divide per pair, boids about 22,
// the eye a divide per (eye, target) and about 6 operations per (eye,
// target, pixel)), plus the waits: a hop's block count is 1/D of one
// device's, so the blocks of one card are split between its shards. Design:
// one thread per row (gravity, boids) or per (eye, pixel) (the eye), the
// circulating block staged through shared memory in tiles of the block
// width; the rows of env b meet only env b's segment of the block; ragged
// tails are masked by bounds. Built with -fmad=false as the other kernels.

#include <cuda_runtime.h>
#include <math.h>

#include "pair_math.cuh"

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int MAX_PLANES = 3;  // payload planes: pos (x, y), vel (x, y), global index
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

struct GravityHop {
  const Ring& r;
  GravityParams q;
  float2* tile;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const int t = blockDim.x, tiles = (r.nl + t - 1) / t;
    const float2* own = reinterpret_cast<const float2*>(r.shard[s].in[0]);
    const float2* blk = reinterpret_cast<const float2*>(cur.plane[0]);
    float2* out = reinterpret_cast<float2*>(r.shard[s].out[0]);
    for (int u = blockIdx.x % r.p; u < r.nb * tiles; u += r.p) {
      const int b = u / tiles;
      const int i = (u - b * tiles) * t + threadIdx.x;
      const long long row = (long long)b * r.nl + i;
      const float2* xj = blk + (long long)b * r.nl;
      const float2 xi = i < r.nl ? own[row] : make_float2(0.f, 0.f);
      float gx = 0.f, gy = 0.f;
      for (int j0 = 0; j0 < r.nl; j0 += t) {
        if (j0 + threadIdx.x < r.nl) tile[threadIdx.x] = __ldcg(xj + j0 + threadIdx.x);
        __syncthreads();
        const int cnt = min(t, r.nl - j0);
        for (int j = 0; j < cnt; ++j) gravity_pair(xi, tile[j], q.bias, 0, gx, gy);
        __syncthreads();
      }
      if (i < r.nl) accumulate(out, row, k, gx, gy);
    }
  }
};

__global__ void rdma_gravity_kernel(const __grid_constant__ Ring r, const GravityParams q) {
  __shared__ float2 tile[MAX_THREADS];
  GravityHop hop{r, q, tile};
  walk_ring(r, hop);
}

// -- boids (#15) --------------------------------------------------------------

struct BoidsParams {
  float coh_sq, sep_sq, ali_sq;
};

struct BoidsHop {
  const Ring& r;
  BoidsParams q;
  float2* tp;
  float2* tv;
  float* ti;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const Shard& sh = r.shard[s];
    const int t = blockDim.x, tiles = (r.nl + t - 1) / t;
    const float2* own_p = reinterpret_cast<const float2*>(sh.in[0]);
    const float2* own_v = reinterpret_cast<const float2*>(sh.in[1]);
    const float2* blk_p = reinterpret_cast<const float2*>(cur.plane[0]);
    const float2* blk_v = reinterpret_cast<const float2*>(cur.plane[1]);
    for (int u = blockIdx.x % r.p; u < r.nb * tiles; u += r.p) {
      const int b = u / tiles;
      const int i = (u - b * tiles) * t + threadIdx.x;
      const long long row = (long long)b * r.nl + i, seg = (long long)b * r.nl;
      float2 xi = make_float2(0.f, 0.f), vi = make_float2(0.f, 0.f);
      float ii = -1.f;  // no agent's index
      if (i < r.nl) {
        xi = own_p[row];
        vi = own_v[row];
        ii = sh.in[2][row];
      }
      BoidsSums acc;
      for (int j0 = 0; j0 < r.nl; j0 += t) {
        const int j = j0 + threadIdx.x;
        if (j < r.nl) {
          tp[threadIdx.x] = __ldcg(blk_p + seg + j);
          tv[threadIdx.x] = __ldcg(blk_v + seg + j);
          ti[threadIdx.x] = __ldcg(cur.plane[2] + seg + j);
        }
        __syncthreads();
        const int cnt = min(t, r.nl - j0);
        for (int jj = 0; jj < cnt; ++jj) {
          if (ti[jj] == ii) continue;  // the agent itself, by global index
          boids_pair(xi, vi, tp[jj], tv[jj], q.coh_sq, q.sep_sq, q.ali_sq, true, acc);
        }
        __syncthreads();
      }
      if (i < r.nl) {
        accumulate(reinterpret_cast<float2*>(sh.out[0]), row, k, acc.s1x, acc.s1y);
        accumulate(sh.out[1], row, k, (float)acc.c1);
        accumulate(reinterpret_cast<float2*>(sh.out[2]), row, k, acc.rx, acc.ry);
        accumulate(reinterpret_cast<float2*>(sh.out[3]), row, k, acc.s3x, acc.s3y);
        accumulate(sh.out[4], row, k, (float)acc.c3);
      }
    }
  }
};

__global__ void rdma_boids_kernel(const __grid_constant__ Ring r, const BoidsParams q) {
  __shared__ float2 tp[MAX_THREADS];
  __shared__ float2 tv[MAX_THREADS];
  __shared__ float ti[MAX_THREADS];
  BoidsHop hop{r, q, tp, tv, ti};
  walk_ring(r, hop);
}

// -- the disc eye (#16) -------------------------------------------------------

struct VisionParams {
  int w;
  float tan_half_fov, tan_over_radius, near_plane, far_plane;
};

// A block owns blockDim.y eyes x blockDim.x pixels of one env; a tile of
// blockDim.x targets is projected once per (eye, target) into shared memory
// (depth, or +inf where out of depth; u_c; f t / r), then every thread scans
// it for its (eye, pixel).
struct VisionHop {
  const Ring& r;
  VisionParams q;
  float* s_f;
  float* s_uc;
  float* s_inv;

  __device__ void operator()(int s, int k, const Payload& cur) {
    const Shard& sh = r.shard[s];
    const int pb = blockDim.x, eg = blockDim.y;
    const int eye_groups = (r.nl + eg - 1) / eg, pix_blocks = (q.w + pb - 1) / pb;
    const int per_env = eye_groups * pix_blocks;
    const float2* own = reinterpret_cast<const float2*>(sh.in[0]);
    const float2* blk = reinterpret_cast<const float2*>(cur.plane[0]);
    const int lane = threadIdx.y * pb;
    for (int u = blockIdx.x % r.p; u < r.nb * per_env; u += r.p) {
      const int b = u / per_env;
      const int g = (u - b * per_env) / pix_blocks;
      const int e = g * eg + threadIdx.y;
      const int px = (u - b * per_env - g * pix_blocks) * pb + threadIdx.x;
      const long long row = (long long)b * r.nl + e;
      float2 pe = make_float2(0.f, 0.f), de = make_float2(1.f, 0.f);
      if (e < r.nl) {
        pe = own[row];
        de = sh.eye_dir[row];
      }
      const float2* tb = blk + (long long)b * r.nl;
      const float u_p = 2.0f * ((float)px + 0.5f) / (float)q.w - 1.0f;
      float hd = q.far_plane, ho2 = 1.0f;  // this hop's (depth, off^2) at the pixel
      for (int j0 = 0; j0 < r.nl; j0 += pb) {
        const int j = j0 + threadIdx.x;
        float fv = INFINITY, uc = 0.f, inv = 0.f;
        if (e < r.nl && j < r.nl) {
          float f, ft;
          if (disc_project(pe, de, __ldcg(tb + j), q.near_plane, q.far_plane, q.tan_half_fov, f,
                           uc, ft)) {
            fv = f;
            inv = f * q.tan_over_radius;
          } else {
            inv = q.tan_over_radius;  // f taken as 1 out of depth (never covers)
          }
        }
        s_f[lane + threadIdx.x] = fv;
        s_uc[lane + threadIdx.x] = uc;
        s_inv[lane + threadIdx.x] = inv;
        __syncthreads();
        const int cnt = min(pb, r.nl - j0);
        for (int jj = 0; jj < cnt; ++jj) {
          const float f = s_f[lane + jj];
          if (f <= hd) {
            const float off = (u_p - s_uc[lane + jj]) * s_inv[lane + jj];
            const float o2 = off * off;
            if (o2 < 1.0f) {
              if (f < hd) {
                hd = f;
                ho2 = o2;
              } else {
                ho2 = fminf(ho2, o2);
              }
            }
          }
        }
        __syncthreads();
      }
      if (e < r.nl && px < q.w) {
        const long long o = row * q.w + px;
        float best_d = q.far_plane, best_o2 = 1.0f;
        if (k > 0) {
          best_d = sh.out[0][o];
          best_o2 = sh.out[1][o];
        }
        if (hd < best_d) {  // strict: an earlier hop keeps a tie
          best_d = hd;
          best_o2 = ho2;
        }
        sh.out[0][o] = best_d;
        sh.out[1][o] = best_o2;
      }
    }
  }
};

__global__ void rdma_vision_kernel(const __grid_constant__ Ring r, const VisionParams q) {
  __shared__ float s_f[MAX_THREADS];
  __shared__ float s_uc[MAX_THREADS];
  __shared__ float s_inv[MAX_THREADS];
  VisionHop hop{r, q, s_f, s_uc, s_inv};
  walk_ring(r, hop);
}

// -- launch -------------------------------------------------------------------

const void* const KERNEL_FNS[3] = {reinterpret_cast<const void*>(rdma_gravity_kernel),
                                   reinterpret_cast<const void*>(rdma_boids_kernel),
                                   reinterpret_cast<const void*>(rdma_vision_kernel)};

// The Ring from the wrapper's host table: `table` holds TABLE_COLS pointers
// per shard (in[3], eye_dir, out[5], slots, flags), `local` the n_local
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
int launch(int kind, Ring& r, Params& q, int n_local, dim3 block, void* stream) {
  void* args[] = {&r, &q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      KERNEL_FNS[kind], dim3(n_local * r.p), block, args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of `threads` threads of kernel `kind` (0 gravity, 1 boids, 2 the
// disc eye) that fit on the current device at once, all its SMs together,
// into *blocks (0 where the device has no cooperative launch).
extern "C" int nbt_rdma_capacity(int kind, int threads, int device, int* blocks) {
  *blocks = 0;
  if (kind < 0 || kind > 2 || threads < 1 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0, coop = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL_FNS[kind],
                                                                  threads, 0);
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
// [nb, nl, 2]. `threads` (<= 256) rows per block.
extern "C" int nbt_rdma_gravity(const void* table, const int* local, int n_local, int d, int p,
                                int nb, int nl, int threads, float bias, void* stream) {
  Ring r;
  const int width[1] = {2};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 1, width, r);
  if (err) return err;
  if (threads < 1 || threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  GravityParams q{bias};
  return launch(0, r, q, n_local, dim3(threads), stream);
}

// Boids (#15): planes pos, vel [nb, nl, 2] and the global agent index
// [nb, nl]; out sum1, cnt1, repel, sum3, cnt3 (physics.dense.boids_partials_
// cross's order). Thresholds squared.
extern "C" int nbt_rdma_boids(const void* table, const int* local, int n_local, int d, int p,
                              int nb, int nl, int threads, float coh_sq, float sep_sq,
                              float ali_sq, void* stream) {
  Ring r;
  const int width[3] = {2, 2, 1};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 3, width, r);
  if (err) return err;
  if (threads < 1 || threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  BoidsParams q{coh_sq, sep_sq, ali_sq};
  return launch(1, r, q, n_local, dim3(threads), stream);
}

// The disc eye (#16): planes pos [nb, nl, 2], eye_dir the unit headings;
// out[0] best depth, out[1] the winner's off^2, [nb, nl, w].
extern "C" int nbt_rdma_vision(const void* table, const int* local, int n_local, int d, int p,
                               int nb, int nl, int pixels, int eyes, int w, float tan_half_fov,
                               float tan_over_radius, float near_plane, float far_plane,
                               void* stream) {
  Ring r;
  const int width[1] = {2};
  int err = make_ring(table, local, n_local, d, p, nb, nl, 1, width, r);
  if (err) return err;
  if (pixels < 1 || eyes < 1 || pixels * eyes > MAX_THREADS || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  VisionParams q{w, tan_half_fov, tan_over_radius, near_plane, far_plane};
  return launch(2, r, q, n_local, dim3(pixels, eyes), stream);
}
