// Viterbi add-compare-select trellis of the order-15 convolutional code,
// with the traceback, for sm_90a.
//
// Replaces audiowmark_tpu/ops/viterbi_pallas.py::_acs_kernel_batch (the
// pallas_call of viterbi_acs_pallas_batch) and, with B = 1, ::_acs_kernel
// (viterbi_acs_pallas).  Per row and step t, over the 32768 states s:
//
//     new[s] = min(old[s >> 1], old[(s >> 1) + 16384]) + bm[t, s]
//
// where the high predecessor wins only if it is strictly smaller (the
// reference's tie rule; a NaN compare is false, so NaN picks the low one).
// The metric starts at 0 for state 0 and 1e9 elsewhere.
//
// Design: one CTA per trellis row (grid = B), 1024 threads, the 128 KB
// metric resident in dynamic shared memory for all steps (the loop over
// steps replaces the Pallas sequential grid).  Thread i owns predecessor
// pairs p = i + 1024 k, k < 16: it reads old[p] and old[p + 16384] into
// registers, the block synchronises, then it writes new[2p], new[2p + 1]
// and the two int8 decisions of the step, and the block synchronises again.
// bm is read and decisions written as float2 / char2, so a warp touches 256
// and 64 contiguous bytes.  After the last step the final metrics are
// stored and thread 0 walks the decisions back from state 0 (their global
// writes are visible to it after the block barrier).
//
// What bounds it on an H100: the steps are serial, two block barriers each,
// and every step streams 128 KB of branch metrics in and 32 KB of decisions
// out per row.  With B in the tens only B of the 132 SMs work, so a row's
// step is latency-bound, not bandwidth-bound; bit-packed decisions, bm
// computed in the kernel and several rows per SM are the ways to go faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 1 << 15;
constexpr int kHalf = kStates / 2;
constexpr int kThreads = 1024;
constexpr int kPairsPerThread = kHalf / kThreads;   // 16
constexpr int kOrder = 15;

__global__ void __launch_bounds__(kThreads)
viterbi_acs_kernel(const float* __restrict__ bm, int8_t* __restrict__ dec,
                   float* __restrict__ metrics, int32_t* __restrict__ bits,
                   int steps) {
  extern __shared__ float metric[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* bm_row = bm + static_cast<size_t>(row) * steps * kStates;
  int8_t* dec_row = dec + static_cast<size_t>(row) * steps * kStates;

  for (int s = tid; s < kStates; s += kThreads) {
    metric[s] = (s == 0) ? 0.0f : 1e9f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float best[kPairsPerThread];
    uint32_t hi_wins = 0;
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int p = tid + k * kThreads;
      const float lo = metric[p];
      const float hi = metric[p + kHalf];
      const bool d = hi < lo;
      best[k] = d ? hi : lo;
      hi_wins |= static_cast<uint32_t>(d) << k;
    }
    __syncthreads();
    const float2* bm_t =
        reinterpret_cast<const float2*>(bm_row + static_cast<size_t>(t) * kStates);
    char2* dec_t =
        reinterpret_cast<char2*>(dec_row + static_cast<size_t>(t) * kStates);
    float2* metric2 = reinterpret_cast<float2*>(metric);
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int p = tid + k * kThreads;
      const float2 b = bm_t[p];
      metric2[p] = make_float2(best[k] + b.x, best[k] + b.y);
      const signed char d = static_cast<signed char>((hi_wins >> k) & 1u);
      dec_t[p] = make_char2(d, d);
    }
    __syncthreads();
  }

  float* metrics_row = metrics + static_cast<size_t>(row) * kStates;
  for (int s = tid; s < kStates; s += kThreads) {
    metrics_row[s] = metric[s];
  }

  if (tid == 0) {
    int32_t* bits_row = bits + static_cast<size_t>(row) * steps;
    int state = 0;
    for (int t = steps - 1; t >= 0; --t) {
      bits_row[t] = state & 1;
      const int d = dec_row[static_cast<size_t>(t) * kStates + state];
      state = (state >> 1) | (d << (kOrder - 1));
    }
  }
}

}  // namespace

// bm (B, steps, 32768) f32 -> dec (B, steps, 32768) int8, metrics
// (B, 32768) f32, bits (B, steps) int32; all contiguous on the device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int viterbi_acs_launch(const float* bm, int8_t* dec, float* metrics,
                                  int32_t* bits, int batch, int steps,
                                  void* stream) {
  const int smem = kStates * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_acs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  viterbi_acs_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      bm, dec, metrics, bits, steps);
  return static_cast<int>(cudaGetLastError());
}
