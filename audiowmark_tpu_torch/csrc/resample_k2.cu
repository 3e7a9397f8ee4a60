// Windowed-sinc resampling of one write, positions and coefficients
// included, for sm_90a: kernel K2.
//
// Replaces no Pallas kernel: the JAX package leaves its resampler
// (audiowmark_tpu/ops/resample.py) to XLA.  K2 was added because the
// port's plain loop (ops/resample._gather_dot: one index_select, one
// multiply and one add per tap, launched from Python, 48 taps at 48 ->
// 44.1 kHz and 32 at 44.1 -> 48 kHz, for every 64 K rows, and ~15
// elementwise launches of coefficients beside them) and its host-side
// positions (numpy arrays of every output row, uploaded from pageable
// memory, which waits for the card's queue) set the pace of the 48 kHz
// add.  One launch per resampler write now does all of it.
//
// For output row j = j0 + r of a write (one thread per row, every channel
// of the row in that thread), exactly as ops/resample._resample_rows_plain:
//
//     p = j / ratio   (float64, rounded once), ip = floor(p),
//     frac = p - ip   (rounded to T),
//     base = clamp(ip + offset, 0, rows(xpad) - n_taps),
//     t_m = frac - (m - (half_taps - 1)),  m = 0 .. n_taps - 1,
//     coeff_m = float(fr * sinc(fr * t_m) * blackman(t_m / half_width)),
//     y[r, c] = sum over m in order of xpad[base + m, c] * coeff_m,
//
// with the coefficients in T (float64 for the streaming resampler, float32
// for the whole-buffer one) by `_coeffs`' formula in its operation order.
// Every operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing into a fused multiply-add that the torch ops do not
// have; sin and cos are the CUDA math library's, as in torch's kernels.
// Each tap is one rounded multiply and one rounded add from 0.0f, as the
// plain loop takes them, so row j depends on j and the history alone,
// never on how the input was split into writes.
//
// Bound on an H100: per output row the kernel reads n_taps x C floats,
// which neighbouring rows share (so from L1/L2; the unique bytes are the
// write's input once and its output once, ~1.5 MB per second of 48 kHz
// stereo through the pair), and computes n_taps coefficients, each a sin,
// two cos and two divisions in T.  In float64 that is ~87 FP64 instructions
// a coefficient (cuobjdump -sass of the sm_90a build), so at ~92 K output
// rows per audio-second (44.1 K at 48 taps, 48 K at 32) the card's FP64
// rate (64 instructions per SM and clock), not memory, bounds it: ~0.02 ms
// per audio-second, against ~0.0004 ms for the bytes.  Launch and host
// costs are what remains of the layer.
//
// Design: one form for every tap count (a multiple of 16: 48 at 48 ->
// 44.1 kHz, 32 at 44.1 -> 48 kHz and 32 -> 44.1 kHz, others at other rates
// and the speed scan's centres).  It computes the coefficients 16 taps at
// a time and carries each channel's partial sum in y between the passes:
// a float stored and read back is the same float, so the sum is the same.
// Forms with all 32 or 48 coefficients in registers gave the same bits and
// were slower on the H100 (2.01 against 1.64 ms and 1.53 against 1.33 ms
// for the two writes of a 4096-frame tile of the 48 kHz add), so there
// are none.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;               // taps per pass
constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 2 * kPi;       // Python's 2 * math.pi, exactly

template <typename T> struct Rn;

template <> struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sine(double a) { return sin(a); }
  static __device__ double cosine(double a) { return cos(a); }
  static __device__ double narrow(double a) { return a; }
  static __device__ float to_float(double a) { return __double2float_rn(a); }
};

template <> struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sine(float a) { return sinf(a); }
  static __device__ float cosine(float a) { return cosf(a); }
  static __device__ float narrow(double a) { return __double2float_rn(a); }
  static __device__ float to_float(float a) { return a; }
};

// Coefficient of tap offset k = m - (half_taps - 1) at fractional position
// frac: ops/resample._coeffs, one operation after another.
template <typename T>
__device__ __forceinline__ float coeff(T frac, int k, T fr, T half_width) {
  using R = Rn<T>;
  const T t = R::sub(frac, static_cast<T>(k));
  const T x = R::mul(t, fr);
  T sinc = T(1);                         // torch.sinc: 1 at 0
  if (x != T(0)) {
    const T px = R::mul(static_cast<T>(kPi), x);
    sinc = R::div(R::sine(px), px);
  }
  const T w = R::div(t, half_width);
  T win = T(0);
  if (!(fabs(w) >= T(1))) {
    win = R::add(
        R::add(R::mul(static_cast<T>(0.5),
                      R::cosine(R::mul(static_cast<T>(kPi), w))),
               static_cast<T>(0.42)),
        R::mul(static_cast<T>(0.08),
               R::cosine(R::mul(static_cast<T>(kTwoPi), w))));
  }
  return R::to_float(R::mul(R::mul(fr, sinc), win));
}

// n_taps = 2 * half_taps (a multiple of kChunk) in passes of kChunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_k2(const float* __restrict__ xpad, int64_t max_base,
            float* __restrict__ y, int64_t j0, int64_t rows, int channels,
            double ratio, T fr, T half_width, int half_taps, int64_t offset) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const double p = __ddiv_rn(static_cast<double>(j0 + r), ratio);
  const double ip = floor(p);
  const T frac = Rn<T>::narrow(__dsub_rn(p, ip));
  int64_t base = static_cast<int64_t>(ip) + offset;
  base = base < 0 ? 0 : (base > max_base ? max_base : base);
  const float* src = xpad + base * channels;
  float* dst = y + r * channels;
  const int k0 = -(half_taps - 1);
  const int n_taps = 2 * half_taps;
  for (int m0 = 0; m0 < n_taps; m0 += kChunk) {
    float c[kChunk];
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
      c[m] = coeff<T>(frac, k0 + m0 + m, fr, half_width);
    }
    for (int ch = 0; ch < channels; ++ch) {
      float acc = m0 == 0 ? 0.0f : dst[ch];
#pragma unroll
      for (int m = 0; m < kChunk; ++m) {
        acc = __fadd_rn(acc, __fmul_rn(
            src[static_cast<int64_t>(m0 + m) * channels + ch], c[m]));
      }
      dst[ch] = acc;
    }
  }
}

template <typename T>
int launch(const float* xpad, int64_t xpad_rows, float* y, int64_t j0,
           int64_t rows, int channels, double ratio, double fr,
           double half_width, int half_taps, int64_t offset,
           cudaStream_t stream) {
  const int64_t max_base = xpad_rows - 2 * half_taps;
  // the host's rounding of the float64 filter parameters to T, as
  // torch.tensor(fr, dtype=T) gives them
  const T fr_t = static_cast<T>(fr);
  const T hw_t = static_cast<T>(half_width);
  const dim3 grid(static_cast<unsigned>((rows + kThreads - 1) / kThreads));
  resample_k2<T><<<grid, kThreads, 0, stream>>>(
      xpad, max_base, y, j0, rows, channels, ratio, fr_t, hw_t, half_taps,
      offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xpad (xpad_rows, channels) f32 and y (rows, channels) f32, contiguous on
// the device; output rows j0 .. j0 + rows - 1 (see the top of the file),
// coefficients in float64 if coeff_f64 else float32.  Launches on
// `stream`; returns 0, a cudaError_t, -1 if half_taps is not a positive
// multiple of 8, -2 if xpad holds fewer than 2 * half_taps rows, -3 if
// channels < 1, -4 if rows is not in 1 .. 2^31 x 128 - 1 or j0 < 0.
extern "C" int resample_k2_launch(const float* xpad, long long xpad_rows,
                                  float* y, long long j0, long long rows,
                                  int channels, double ratio, double fr,
                                  double half_width, int half_taps,
                                  long long offset, int coeff_f64,
                                  void* stream) {
  if (half_taps <= 0 || half_taps % 8 != 0) return -1;
  if (xpad_rows < 2LL * half_taps) return -2;
  if (channels < 1) return -3;
  if (rows < 1 || j0 < 0 ||
      (rows + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return -4;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_f64
      ? launch<double>(xpad, xpad_rows, y, j0, rows, channels, ratio, fr,
                       half_width, half_taps, offset, s)
      : launch<float>(xpad, xpad_rows, y, j0, rows, channels, ratio, fr,
                      half_width, half_taps, offset, s);
}
