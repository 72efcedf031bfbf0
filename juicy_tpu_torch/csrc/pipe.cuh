// Hand-off machinery of the stage kernels (punch_stage.cu, texture_stage.cu)
// and the analyzer kernel (analyzer.cu): mbarriers in shared memory,
// cp.async, a reader that brings a stream [N, C, B] into shared memory chunk
// by chunk, a chunk ahead, and a ring that brings a block [B, C, N] in its
// own layout (RowRing).
//
// The same PTX as chain.cu's copies (chain.cu keeps its own, so that the
// chain kernel compiles as it did). The stage kernels' barriers are
// once-barriers: one per chunk of the block and hand-off, completed once
// per launch (phase 0), so a warp that takes every K-th chunk can wait on
// any chunk without tracking phases. RowRing's have phases, one per use of
// a slot. The data of a hand-off that stays in shared memory lives in a
// ring of chunk slots; a producer reuses slot j % R only after the barrier
// that says chunk j - R's consumers are done.
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

// ---- Barriers with phases, 16-byte copies (RowRing)

// Waits until barrier `bar` has completed its use-th phase (0, 1, ...): a
// ring slot's barrier completes once per use of the slot, and a waiter is
// never more than one phase behind, so the parity tells the phases apart.
// Traps after 2^26 polls, as mbar_wait does.
__device__ __forceinline__ void mbar_wait_phase(const uint64_t* bar, int use) {
  uint32_t landed;
  unsigned tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(landed)
        : "r"(smem_u32(bar)), "r"(static_cast<uint32_t>(use) & 1u)
        : "memory");
  } while (!landed);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
// One arrival on `bar` once every cp.async this thread issued so far has
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A block [B, C, N] read in its own layout: the 32 clips of a CTA are 32 * C
// consecutive rows of N floats (row r = clip * C + channel). A ring of S
// slots in shared memory holds chunks of K samples of every row: one
// producer warp fills slot j % S with chunk j, and the consumers, one clip
// per lane, read it; each sector of the block is fetched once.
//
// A slot row is K floats whose 16-byte groups of four samples are swizzled
// by the clip (group g of clip c at g ^ (c % 8)). A plain stride of K
// floats would put the 32 clips of a warp's read on one bank; swizzled, a
// warp reading one group of 32 clips (16 bytes a lane) takes the four
// wavefronts that 512 bytes need, a warp reading one sample of 32 clips
// one wavefront, and a copy keeps 16-byte alignment. The copies are 16-byte
// cp.async where the rows are 16-byte aligned (N % 4 == 0), else 4-byte,
// with consecutive lanes on consecutive addresses of a row.
//
// Barriers, one of each per slot, completing once per use of the slot:
// full when the producer's 32 lanes' copies have landed (cp_arrive),
// empty when the R consumer warps' lanes have read it (32 * R arrivals).
template <int C, int K, int S>
struct RowRing {
  static_assert(K % 32 == 0, "the swizzle needs K / 4 a multiple of 8");
  static constexpr int kSlotFloats = 32 * C * K;
  float* slots;     // S * kSlotFloats
  uint64_t* full;   // [S]
  uint64_t* empty;  // [S]
  int n, nc;

  __device__ int len(int j) const { return min(K, n - j * K); }
  __device__ float* slot(int j) const { return slots + (j % S) * kSlotFloats; }
  // sample i of clip c's row, from the row's start
  static __device__ int swz(int c, int i) {
    return (((i >> 2) ^ (c & 7)) << 2) | (i & 3);
  }
  // sample i of row r in a slot
  static __device__ int at(int r, int i) { return r * K + swz(r / C, i); }

  // Producer: copy chunk j of clips b0 .. b0 + 31 of `x` (a clip past B - 1
  // reads clip B - 1) into its slot, once the slot's previous chunk is read.
  // `vec`: x's rows are 16-byte aligned.
  __device__ void fill(const float* x, int b0, int B, int j, bool vec,
                       int lane) const {
    if (j >= S) mbar_wait_phase(empty + j % S, j / S - 1);
    float* dst = slot(j);
    const int t0 = j * K, m = len(j);
    auto row = [&](int r) {
      const int c = r / C;
      return x + (static_cast<size_t>(min(b0 + c, B - 1)) * C + (r - c * C)) *
                     n + t0;
    };
    if (vec) {
      // lane: group g of rows r0, r0 + R, ...; a whole CTA's rows are
      // consecutive, one stride apart
      constexpr int G = K / 4, R = 32 / G;
      const int i = 4 * (lane % G), r0 = lane / G;
      if (i < m && b0 + 32 <= B) {
        const float* src = row(r0) + i;
        const size_t stride = static_cast<size_t>(R) * n;
#pragma unroll
        for (int q = 0; q < 32 * C / R; ++q)
          cp_async16(dst + at(r0 + q * R, i), src + q * stride);
      } else if (i < m) {
        for (int r = r0; r < 32 * C; r += R)
          cp_async16(dst + at(r, i), row(r) + i);
      }
    } else {
      for (int q = lane; q < 32 * C * K; q += 32) {
        const int r = q / K, i = q % K;
        if (i < m) cp_async4(dst + at(r, i), row(r) + i);
      }
    }
    cp_arrive(full + j % S);
  }

  // Consumer: f(i, l, r) for the samples i of chunk j of clip c (mono:
  // r = l) in order, once the chunk has landed; then this lane's arrival on
  // the slot's empty barrier. A chunk is read a group of four samples at a
  // time, two groups a loop iteration, each group's loads issued before the
  // previous group's f (which may store to shared memory, past which the
  // compiler would not hoist them). Unrolling the whole chunk measured
  // slower: with a warp on each scheduler, the larger loop bodies cost more
  // than the index arithmetic they save.
  template <typename F>
  __device__ __forceinline__ void read(int j, int c, F&& f) const {
    mbar_wait_phase(full + j % S, j / S);
    const float* lr = slot(j) + c * C * K;
    const float* rr = lr + (C - 1) * K;
    const int m = len(j);
    if (m == K) {
      auto group = [&](int g, float4& l4, float4& r4) {
        const int o = (g ^ (c & 7)) << 2;
        l4 = *reinterpret_cast<const float4*>(lr + o);
        r4 = *reinterpret_cast<const float4*>(rr + o);
      };
      float4 l4, r4;
      group(0, l4, r4);
#pragma unroll 2
      for (int g = 0; g < K / 4; ++g) {
        float4 ln = l4, rn = r4;
        if (g + 1 < K / 4) group(g + 1, ln, rn);
        f(4 * g, l4.x, r4.x);
        f(4 * g + 1, l4.y, r4.y);
        f(4 * g + 2, l4.z, r4.z);
        f(4 * g + 3, l4.w, r4.w);
        l4 = ln;
        r4 = rn;
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const int o = swz(c, i);
        f(i, lr[o], rr[o]);
      }
    }
    mbar_arrive(empty + j % S);
  }
};

}  // namespace pipe
}  // namespace juicy
