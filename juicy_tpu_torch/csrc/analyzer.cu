// Analyzer kernel for Hopper (sm_90a): the JuicinessAnalyzer alone over one
// block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/analyzer_kernel.py::_run_kernel
// (the _kernel pallas_call under analyze_fused). Plain version beside the
// wrapper: juicy_tpu_torch/kernels/analyzer_kernel.py::_analyzer_lanes_plain
// (the stage kernels' _lane_step loop).
//
// What bounds it: the envelopes, the onset cooldown and the band one-poles
// are serial per-sample recurrences, so one thread carries one clip through
// the block in order, as in the stage kernels; at B = 4096 that is 128 warps
// for 132 SMs, and latency sets the pace. The input is time-major and
// clip-contiguous ([N, C, B]) so that a warp's loads coalesce. The TPU kernel
// runs its lane on the mono mix and leaves the side, corr, L^2 and R^2 sums
// to XLA; here lane.cuh's lane_step accumulates them in the same loop, in
// sample order, so the whole analyzer is one pass over the block.
//
// Numerics: built with -fmad=false, as every kernel of the library.
#include <cuda_runtime.h>

#include "lane.cuh"

namespace juicy {

constexpr int kAnalyzerThreads = 128;

// x: [N, C, B]; lane_in, fin: [5, B]; acc: [10, B]. Mono (C = 1) analyzes
// r = l, as the analyzer does.
template <int C>
__global__ void __launch_bounds__(kAnalyzerThreads)
analyzer_kernel(const float* __restrict__ x, const float* __restrict__ lane_in,
                float* __restrict__ fin, float* __restrict__ acc, int B, int N,
                LaneConsts k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged edge of the batch
  const size_t sB = static_cast<size_t>(B);
  Lane lane = lane_load(lane_in, b, B);
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    lane_step(lane, x[row], x[row + (C - 1) * sB], k);
  }
  lane_store(lane, fin, acc, b, B);
}

}  // namespace juicy

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). Device pointers as the kernel documents; the lane
// constants are f32 values the host computed.
int juicy_analyzer_block(const float* x, const float* lane_in, float* fin,
                         float* acc, int B, int C, int N, float atk_s,
                         float rel_s, float atk_l, float rel_l, float low_c,
                         float high_c, float cd_samples, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const juicy::LaneConsts k{atk_s, rel_s, atk_l, rel_l, low_c, high_c,
                            cd_samples};
  const int threads = juicy::kAnalyzerThreads;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    juicy::analyzer_kernel<1><<<blocks, threads, 0, s>>>(x, lane_in, fin, acc,
                                                         B, N, k);
  } else if (C == 2) {
    juicy::analyzer_kernel<2><<<blocks, threads, 0, s>>>(x, lane_in, fin, acc,
                                                         B, N, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
