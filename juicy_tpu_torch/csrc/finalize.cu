// The finalize's repetition/fatigue EMA pair for Hopper (sm_90a): the
// serial walk over a stream's 2 * nb analyzer lanes, for every analyzer and
// clip, in one launch.
//
// Replaces no TPU kernel: JAX's stream finalize reassociates this EMA with
// an associative scan under XLA. The port walks it in the serial order, so
// that the stream's metrics stay bit-equal to finalize_block applied block
// by block; as PyTorch operations that walk was ~18 small launches a step,
// 3,384 for a 94-block corpus, issued one at a time by the host. Plain
// version beside the wrapper: juicy_tpu_torch/kernels/chain_kernel.py::
// ema_scan_plain (analyzer.py::_ema_update per step).
//
// What bounds it: bytes. Each step reads three floats and writes two per
// analyzer and clip (18 f32 operations), so a batch of 8192 clips x 94
// blocks moves ~215 MB: 0.064 ms at 3.35 TB/s. The walk itself is serial
// per thread, but its loads do not depend on it, so each thread loads a
// group of kAhead blocks (both halves) into registers before it steps
// through them: the walk waits on memory once a group, not once a step.
//
// One thread per (analyzer i, clip b), i major, so neighbouring threads read
// neighbouring clips. For each block, half 0 (the pre lane, 2i) then half 1
// (the post lane, 2i + 1), each step _ema_update's operations in its order,
// with the division an IEEE one (div_const) and the clamps NaN-keeping
// (precise.cuh clamp_to, as torch.clamp). Built with -fmad=false, as every
// kernel of the library, so each a*b + c rounds twice as PyTorch's does.
#include <cuda_runtime.h>
#include <stddef.h>

#include "precise.cuh"

namespace juicy {
namespace finalize {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // blocks whose inputs are loaded before the walk

// the f32 roundings of 0.08, 12, 0.35, 0.30 and 0.06 (analyzer.py's f32())
constexpr float kRepRate = 0x1.47ae14p-4f;
constexpr float kRepScale = 0x1.8p+3f;
constexpr float kCrestW = 0x1.666666p-2f;
constexpr float kDensityW = 0x1.333334p-2f;
constexpr float kFatRate = 0x1.eb851ep-5f;

struct Args {
  const float* onset;   // [nb, 2A, B] onset_rate
  const float* crest;   // [nb, 2A, B] crest_penalty
  const float* harsh;   // [nb, 2A, B] harsh_penalty
  const float* rep0;    // [A, B] repetition_ema before the first block
  const float* fat0;    // [A, B] fatigue_ema before the first block
  float* density;       // [nb, 2A, B] repetition_density
  float* risk;          // [nb, 2A, B] fatigue_risk
  float* rep;           // [A, B] repetition_ema after the last block
  float* fat;           // [A, B] fatigue_ema after the last block
  int nb, A, B;
};

// analyzer.py::_ema_update, one step
__device__ __forceinline__ void ema_step(float& rep, float& fat, float onset,
                                         float crest, float harsh,
                                         float& density, float& risk) {
  rep = rep + (onset - rep) * kRepRate;
  density = clamp_to(rep / kRepScale, 0.0f, 1.0f);
  const float inst = clamp_to(
      kCrestW * crest + kCrestW * harsh + kDensityW * density, 0.0f, 1.0f);
  fat = fat + (inst - fat) * kFatRate;
  risk = clamp_to(fat, 0.0f, 1.0f);
}

__global__ void __launch_bounds__(kThreads) ema_scan_kernel(Args a) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t B = static_cast<size_t>(a.B);
  if (t >= static_cast<size_t>(a.A) * B) return;
  const size_t i = t / B, b = t - i * B;
  const size_t blk_stride = 2 * static_cast<size_t>(a.A) * B;
  const float* __restrict__ onset = a.onset;
  const float* __restrict__ crest = a.crest;
  const float* __restrict__ harsh = a.harsh;
  float rep = a.rep0[t], fat = a.fat0[t];
  size_t base = 2 * i * B + b;  // block 0's pre lane of (i, b)
  for (int blk0 = 0; blk0 < a.nb; blk0 += kAhead, base += kAhead * blk_stride) {
    float on[kAhead][2], cr[kAhead][2], ha[kAhead][2];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (blk0 + k < a.nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t o = base + k * blk_stride + h * B;
          on[k][h] = __ldg(onset + o);
          cr[k][h] = __ldg(crest + o);
          ha[k][h] = __ldg(harsh + o);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (blk0 + k < a.nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t o = base + k * blk_stride + h * B;
          float density, risk;
          ema_step(rep, fat, on[k][h], cr[k][h], ha[k][h], density, risk);
          a.density[o] = density;
          a.risk[o] = risk;
        }
      }
    }
  }
  a.rep[t] = rep;
  a.fat[t] = fat;
}

}  // namespace finalize
}  // namespace juicy

extern "C" {

// Launches the EMA walk on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers to contiguous
// float32 arrays of the shapes in juicy::finalize::Args; nb, A, B >= 1.
int juicy_ema_scan(const float* onset, const float* crest, const float* harsh,
                   const float* rep0, const float* fat0, float* density,
                   float* risk, float* rep, float* fat, int nb, int A, int B,
                   void* stream) {
  namespace fz = juicy::finalize;
  if (nb <= 0 || A <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = static_cast<size_t>(A) * B;
  const size_t blocks = (threads + fz::kThreads - 1) / fz::kThreads;
  const fz::Args a{onset, crest, harsh, rep0, fat0, density, risk,
                   rep, fat, nb, A, B};
  fz::ema_scan_kernel<<<static_cast<unsigned>(blocks), fz::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
