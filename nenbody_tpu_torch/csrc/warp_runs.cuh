// Per-winner sums across a warp, shared by the eye backward kernels
// (disc_eye_bwd.cu, wireframe_eye_bwd.cu).
//
// A warp walks its pixels in order, lane i on the pixel after lane i - 1's,
// so the lanes that hold the same winner sit side by side: a sprite wins a
// run of neighbouring pixels, broken only where a nearer one occludes it.
// A group is such a run of lanes with equal keys (the same winner, and for
// a warp that spans rows the same row). lane_runs finds each lane's run
// from the neighbour's key and one ballot; run_sum is a segmented inclusive
// scan by shuffles that leaves each run's total at its last lane, which
// then makes the group's atomics. Lanes with the same key that are not side
// by side make two groups and two sets of atomics: correct, and rare. (A
// labeled partition, __match_any_sync and cooperative_groups::reduce over
// arbitrary lane masks, costs a software find-nth-set per shuffle; it made
// the disc backward 3x slower than per-pixel atomics on the H100.)

#pragma once

#include <cuda_runtime.h>

namespace {

// Warps a backward kernel's grid should keep before a warp takes more than
// one step of pixels (the disc: several 128-pixel chunks of a row; the
// wireframe: a whole row rather than a segment of it): one wave of resident
// warps on an H100, 132 SMs x 64 warps = 8,448, rounded to a power of two.
// At the trainers' shapes (W = 64) it binds in neither kernel.
constexpr long long GRID_WARPS = 8192;

// A lane's run: its first lane, whether this lane is its last, and the
// longest run of the warp (how far the scan has to reach).
struct Runs {
  int first;
  bool last;
  int longest;
};

template <typename Key>
__device__ __forceinline__ Runs lane_runs(Key key) {
  const int lane = threadIdx.x & 31;
  const Key prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  Runs r;
  r.first = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
  r.last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  r.longest = __reduce_max_sync(0xffffffffu, (unsigned)(lane - r.first + 1));
  return r;
}

// The sum of v over the lanes of this lane's run up to it: the run's total
// at its last lane. Every lane of the warp calls it.
__device__ __forceinline__ float run_sum(float v, const Runs& r) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < r.longest; d <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane - d >= r.first) v += t;
  }
  return v;
}

}  // namespace
