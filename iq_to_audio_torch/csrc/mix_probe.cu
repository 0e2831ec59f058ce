// Warm-up mixer-sign probe for Hopper (sm_90a), plain C ABI.
//
// Replaces no TPU kernel: the JAX package runs this probe on the host, in
// float64 NumPy (ref/chain.py::choose_mix_sign), and so did the port until
// this kernel.  It decides the sign of the run's mixer before the device
// step is built, once per job.  For each sign s of +1, -1 it computes
//
//     y_s[k] = sum_{t=0}^{min(kD, T-1)} h[t] * x[kD - t] * osc_s[kD - t],
//     osc_s[n] = exp(j * (c_s * n) * inv_fs),  c_s = -s * 2 * pi * f,
//
// over the outputs k = first .. first + n_out - 1 that the power reads,
// from zero history, and the power P_s = sum_k |y_s[k]|^2 / n_out, in
// float64 throughout: the host twin's quantity (ref/chain.py::
// mix_sign_powers), in the direct decimated form.  The twin filters every
// input sample with overlap-save FFTs and keeps one output in D.
//
// Bound: at D = 26 about 3,800 outputs a sign, each T real taps times a
// complex sample, 2 * 3,782 * 1,601 * 4 = 48 MFLOP at 1,601 taps and 216
// MFLOP at 7,143, of float64 FMAs (H100 SXM: 34 TFLOP/s outside the tensor
// cores, so 1.4 / 6.4 us); the reads are the 1 MB snippet and the taps.  A
// call is bound by its launches and the copies around it.
//
// Design.  grid = (tiles, 2): CTA (b, s) owns outputs b*M .. b*M + M - 1 of
// sign s, so one launch serves both signs.  A pass over taps t0 .. t1 - 1
// mixes the (M - 1) D + (t1 - t0) input samples its outputs read into
// shared memory once, so a sample's sincos is computed once per CTA and
// not once per tap; the wrapper sizes M to fill the SMs in one wave and
// takes every tap in one pass where the span fits 227 KB (1,601 and 7,143
// taps at D = 26 do).  Each warp takes outputs in turn; its lanes stride
// the taps (read through the read-only path), accumulate with float64
// FMAs, and a butterfly of shuffles sums the lanes.  Each CTA then sums
// its outputs' |y|^2 in order into one partial, and a second kernel sums
// each sign's partials in order: no floating-point atomics, so a run's
// powers are the same bit for bit on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

struct Probe {
  const float2* x;  // the complex64 snippet, n samples
  long long n;
  const double* h;  // T real taps
  int T;
  int D;
  long long first;  // first output the power reads
  long long n_out;  // outputs the power reads, per sign
  int M;            // outputs per CTA
  int Tc;           // taps per pass
  double inv_fs;
  double c[2];  // phase coefficient of sign +1 and of sign -1
  double* partial;  // (2, tiles)
};

__global__ void __launch_bounds__(kThreads) mix_probe_kernel(Probe p) {
  extern __shared__ double2 smem[];
  double2* acc = smem;        // M outputs' sums
  double2* span = smem + p.M;  // the mixed input of one pass
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  const long long k_lo = p.first + (long long)tile * p.M;
  const int cnt = (int)min((long long)p.M, p.first + p.n_out - k_lo);
  const double c = p.c[s];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < cnt; i += kThreads) acc[i] = make_double2(0.0, 0.0);

  for (int t0 = 0; t0 < p.T; t0 += p.Tc) {
    const int t1 = min(p.T, t0 + p.Tc);
    // span[j] is input sample base + j; the tile's outputs read
    // (cnt - 1) D + (t1 - t0) samples from k_lo D - (t1 - 1) on
    const long long base = k_lo * p.D - (t1 - 1);
    const int len = (cnt - 1) * p.D + (t1 - t0);
    __syncthreads();  // the previous pass has read its span
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const long long n = base + j;
      double2 v = make_double2(0.0, 0.0);
      if (n >= 0 && n < p.n) {  // zero history before the snippet
        const float2 xv = p.x[n];
        // the twin's rounding: (c * n) * inv_fs, and its complex product
        // without fused multiply-adds
        const double th = __dmul_rn(__dmul_rn(c, (double)n), p.inv_fs);
        double sn, cs;
        sincos(th, &sn, &cs);
        const double xr = xv.x, xi = xv.y;
        v.x = __dsub_rn(__dmul_rn(xr, cs), __dmul_rn(xi, sn));
        v.y = __dadd_rn(__dmul_rn(xr, sn), __dmul_rn(xi, cs));
      }
      span[j] = v;
    }
    __syncthreads();
    for (int i = warp; i < cnt; i += kWarps) {
      // y[k_lo + i] += sum_t h[t] span[i D + t1 - 1 - t]
      const double2* row = span + (long long)i * p.D + (t1 - 1);
      double re = 0.0, im = 0.0;
      for (int t = t0 + lane; t < t1; t += 32) {
        const double ht = __ldg(p.h + t);
        const double2 sv = row[-t];
        re = fma(ht, sv.x, re);
        im = fma(ht, sv.y, im);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        re += __shfl_xor_sync(0xffffffffu, re, w);
        im += __shfl_xor_sync(0xffffffffu, im, w);
      }
      if (lane == 0) {
        acc[i].x += re;
        acc[i].y += im;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int i = 0; i < cnt; ++i) sum += acc[i].x * acc[i].x + acc[i].y * acc[i].y;
    p.partial[(long long)s * gridDim.x + tile] = sum;
  }
}

// power[s] = (sum of sign s's partials, in tile order) / n_out
__global__ void mix_probe_reduce_kernel(const double* partial, int tiles, long long n_out,
                                        double* power) {
  const int s = threadIdx.x;
  if (s >= 2) return;
  double sum = 0.0;
  for (int b = 0; b < tiles; ++b) sum += partial[(long long)s * tiles + b];
  power[s] = sum / (double)n_out;
}

}  // namespace

// x: n complex64 samples; h: T float64 taps; outputs first .. first + n_out
// - 1 of each sign, m per CTA, tc taps per pass; partial: 2 * ceil(n_out /
// m) doubles of scratch; power: the two float64 powers (sign +1, sign -1).
extern "C" int iq2a_mix_probe(const void* x, long long n, const void* h, int T, int D,
                              long long first, long long n_out, int m, int tc, double inv_fs,
                              double c_plus, double c_minus, void* partial, void* power,
                              void* stream) {
  if (n <= 0 || T <= 0 || D <= 0 || first < 0 || n_out <= 0 || m <= 0 || tc <= 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 8 || reinterpret_cast<uintptr_t>(h) % 8)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n_out + m - 1) / m;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double2) * ((size_t)m + (size_t)(m - 1) * D + (size_t)tc);
  // More than 48 KB has to be asked for; the function keeps the grant, so
  // ask only for more than any earlier launch on this device had.
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(mix_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here: leave no stale error for the next launch check
      return (int)err;
    }
    granted[dev] = smem;
  }
  Probe p;
  p.x = static_cast<const float2*>(x);
  p.n = n;
  p.h = static_cast<const double*>(h);
  p.T = T;
  p.D = D;
  p.first = first;
  p.n_out = n_out;
  p.M = m;
  p.Tc = tc;
  p.inv_fs = inv_fs;
  p.c[0] = c_plus;
  p.c[1] = c_minus;
  p.partial = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mix_probe_kernel<<<dim3((unsigned)tiles, 2), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mix_probe_reduce_kernel<<<1, 32, 0, s>>>(static_cast<const double*>(partial), (int)tiles,
                                           n_out, static_cast<double*>(power));
  return (int)cudaGetLastError();
}
