// The analyzer lanes of the stage kernels (punch_stage.cu,
// texture_stage.cu), on three warps of their own per 32 clips: V the
// envelopes, L the transient's sum and the onsets, E the band energies and
// the six stateless sums (lane.cuh's lane_step split in three). Each warp
// runs its part of the pre lane over the block's input, then, from the pre
// lane's end state, of the post lane over the output as its chunks land.
// V hands L each chunk's transients through a ring of kSlots chunks in
// shared memory, behind once-barriers (pipe.cuh): "ready" per chunk of the
// two passes, and "done" when L has read it, after which V may reuse the
// slot. V and E read their streams a chunk ahead with pipe.cuh's
// ChunkReader, and each sample's input one sample ahead. V's coefficients
// are worked out once a pass into registers (lane.cuh EnvConsts).
#pragma once

#include "lane.cuh"
#include "pipe.cuh"

namespace juicy {
namespace stage_lane {

using pipe::kChunk;

enum : int { kEnvelopes, kOnsets, kEnergy };
constexpr int kSlots = 3;  // chunks of transients in flight from V to L
constexpr int kStageRows = 2 * 2 * kChunk;  // V's and E's reader

// The hand-off from V to L: the ring (kSlots * kChunk rows, at this lane)
// and 2 * nc "ready" then 2 * nc "done" once-barriers (one arrival per lane).
struct Link {
  float* ring;
  uint64_t* bars;
};
__host__ __device__ constexpr int link_bars(int nc) { return 4 * nc; }
constexpr int kRingRows = kSlots * kChunk;

// One pass (p = 0 pre, 1 post) of part PART over `in`'s chunks.
template <int PART, typename Reader>
__device__ __forceinline__ void part_pass(Lane& s, Reader& in,
                                          const Link& link, int p,
                                          const LaneConsts& k) {
  uint64_t* ready = link.bars;
  uint64_t* done = link.bars + 2 * in.nc;
  const EnvConsts e = env_consts(k);
  for (int j = 0; j < in.nc; ++j) {
    const int g = p * in.nc + j, n = in.len(j);
    float* t = link.ring + (g % kSlots) * kChunk * 32;
    if constexpr (PART == kOnsets) {
      pipe::mbar_wait(ready + g);
      float tr = t[0];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float tn = t[(i + 1 < n ? i + 1 : i) * 32];
        lane_step_onsets(s, tr, k);
        tr = tn;
      }
      pipe::mbar_arrive(done + g);
    } else {
      const float* v = in.begin(j);
      if (PART == kEnvelopes && g >= kSlots) pipe::mbar_wait(done + g - kSlots);
      float l = v[0], r = v[32];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int nx = i + 1 < n ? i + 1 : i;
        const float ln = v[(2 * nx) * 32], rn = v[(2 * nx + 1) * 32];
        if constexpr (PART == kEnvelopes)
          t[i * 32] = lane_step_envelopes(s, l, r, e);
        else
          lane_step_energy(s, l, r, k);
        l = ln;
        r = rn;
      }
      if constexpr (PART == kEnvelopes) pipe::mbar_arrive(ready + g);
    }
  }
}

template <int PART>
__device__ __forceinline__ void part_store(const Lane& s, float* fin,
                                           float* acc, int b, int B,
                                           bool live) {
  if (!live) return;
  if constexpr (PART == kEnvelopes)
    lane_store_envelopes(s, fin, b, B);
  else if constexpr (PART == kOnsets)
    lane_store_onsets(s, fin, acc, b, B);
  else
    lane_store_energy(s, fin, acc, b, B);
}

// Part PART of both lanes of clip b (bl: b clamped into the batch, whose
// lane state it reads): `pre` reads the input, `post` the output (L reads
// neither, only their chunk counts).
template <int PART, typename Reader>
__device__ __forceinline__ void run(Reader pre, Reader post, const Link& link,
                                    const float* lane_in, float* pre_fin,
                                    float* pre_acc, float* post_fin,
                                    float* post_acc, int b, int bl, bool live,
                                    int B, const LaneConsts& k) {
  Lane s = lane_load(lane_in, bl, B);
  part_pass<PART>(s, pre, link, 0, k);
  part_store<PART>(s, pre_fin, pre_acc, b, B, live);
  lane_reset(s);
  part_pass<PART>(s, post, link, 1, k);
  part_store<PART>(s, post_fin, post_acc, b, B, live);
}

}  // namespace stage_lane
}  // namespace juicy
