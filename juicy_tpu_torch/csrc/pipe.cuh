// Hand-off machinery of the stage kernels (punch_stage.cu, texture_stage.cu):
// mbarriers in shared memory, 4-byte cp.async, and a reader that brings a
// stream [N, C, B] into shared memory chunk by chunk, a chunk ahead.
//
// The same PTX as chain.cu's copies (chain.cu keeps its own, so that the
// chain kernel compiles as it did). Every barrier is a once-barrier: one
// per chunk of the block and hand-off, completed once per launch (phase
// 0), so a warp that takes every K-th chunk can wait on any chunk without
// tracking phases. The data of a hand-off that stays in shared memory
// lives in a ring of chunk slots; a producer reuses slot j % R only after
// the barrier that says chunk j - R's consumers are done.
#pragma once

#include <stdint.h>

namespace juicy {
namespace pipe {

constexpr int kChunk = 8;  // samples per hand-off chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(smem_u32(bar))
      : "memory");
}
// Has phase 0 completed? (non-blocking; acquire when it has)
__device__ __forceinline__ bool mbar_test(const uint64_t* bar) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar))
      : "memory");
  return ok != 0;
}
// A wait that outlasts any launch (2^26 polls, seconds) is a fault in the
// hand-offs: trap, so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar) {
  uint32_t ok;
  unsigned polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!ok);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// A warp's reader of NCH channels of a stream [N, C, B], chunk by chunk: it
// waits on the chunk's once-barrier (none for a stream that is ready),
// copies the chunk into one half of its double buffer with cp.async, and
// starts on the next chunk at once if every lane sees it ready. Each lane
// copies and reads its own clip's column only.
template <int NCH>
struct ChunkReader {
  const float* src[NCH];  // each channel at this lane's clip
  size_t row;             // floats from one sample to the next (C * B)
  const uint64_t* full;   // once-barriers by chunk, or null
  float* stage;           // 2 * kChunk * NCH floats at this lane, stride 32
  int n, nc, issued;

  __device__ int len(int j) const { return min(kChunk, n - j * kChunk); }
  __device__ bool ready(int j) const {
    return full == nullptr || mbar_test(full + j);
  }
  __device__ void issue(int j) {
    float* dst = stage + (j & 1) * (kChunk * NCH * 32);
    const int t0 = j * kChunk, m = len(j);
    for (int i = 0; i < m; ++i)
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        cp_async4(dst + (i * NCH + k) * 32,
                  src[k] + static_cast<size_t>(t0 + i) * row);
    cp_commit();
    issued = j;
  }
  // Chunk j in shared memory (channel k at sample i: [(i * NCH + k) * 32]);
  // chunk j + 1 on its way if it is ready. Copy groups that the caller
  // committed before this call are complete too.
  __device__ const float* begin(int j) {
    if (issued < j) {
      if (full != nullptr) mbar_wait(full + j);
      issue(j);
    }
    if (j + 1 < nc && __all_sync(0xffffffffu, ready(j + 1))) issue(j + 1);
    if (issued > j)
      cp_wait<1>();
    else
      cp_wait<0>();
    return stage + (j & 1) * (kChunk * NCH * 32);
  }
};

// Channels ch0 .. ch0 + NCH - 1 of `stream` [N, C, B] at clip bl; a channel
// past C - 1 reads channel C - 1 (mono: r = l).
template <int NCH>
__device__ __forceinline__ ChunkReader<NCH> chunk_reader(
    const float* stream, int C, size_t sB, int bl, int ch0, int n,
    const uint64_t* full, float* stage) {
  ChunkReader<NCH> r;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    r.src[k] = stream + min(ch0 + k, C - 1) * sB + bl;
  r.row = static_cast<size_t>(C) * sB;
  r.full = full;
  r.stage = stage;
  r.n = n;
  r.nc = (n + kChunk - 1) / kChunk;
  r.issued = -1;
  return r;
}

// How far ring position q lies after w0 (a chunk's first write index).
__device__ __forceinline__ int ring_rel(int q, int w0, int L) {
  const int d = q - w0;
  return d < 0 ? d + L : d;
}

}  // namespace pipe
}  // namespace juicy
