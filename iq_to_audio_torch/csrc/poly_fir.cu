// Decimating polyphase FIR channelizer for Hopper (sm_90a), plain C ABI.
//
// Replaces the three TPU kernels of iq_to_audio_tpu/ops/pallas_ddc.py:
// _ddc_matmul_kernel (whole tap tensor resident) and
// _ddc_matmul_kernel_tiled (tap axis tiled over a sequential grid axis),
// both reached through pallas_poly_fir_il, and pallas_poly_fir, which runs
// _ddc_matmul_kernel over the pair input.  All compute
//
//     out[o, r] = sum_{k<K} sum_{f<F} X[r + k, f] * W[k, f, o]
//
// with W the (K, F, O) polyphase tensor (O = 2C outputs per row), written
// channel-major (O, m).  Two input layouts give X (F = 2D):
//
//   interleaved (iq2a_poly_fir_il): X[t, f] = x[F*t + f], the contiguous
//     (T, F) view of the scaled interleaved stream;
//   pair (iq2a_poly_fir_pair):      X[t, i*D + p] = x_pair[i, D*t + p], the
//     (2, T, D) -> (T, 2D) relay of pallas_ddc.py:308-309.  The relay is
//     read in place by the staging loop: a tile's span is two contiguous
//     runs, one per row of x_pair, each staged with coalesced loads into
//     its half of the shared-memory rows.  No relayed copy of the stream is
//     written to device memory.
//
// Design.  One CTA owns TILE_M = 128 consecutive output rows, one thread per
// row.  The rows [m0, m0 + TILE_M + kb - 1) that the tile needs are one
// contiguous span of x (two, for the pair layout), so each tap block stages
// that span into shared memory (the ragged end past the stream is masked to
// zero; its weights are zero anyway) next to the tap block W[k0 : k0+kb].
// The loop over tap blocks inside the CTA replaces the sequential grid_k axis
// of the tiled TPU kernel, and the O partial sums stay in f32 registers
// across all blocks.  Arithmetic is plain FFMA in full f32: TF32 tensor-core
// products lose about 3 decimal digits and miss the -60 dB audio contract.
//
// What bounds it.  At the flagship geometry (K = 62, F = 52, O = 2,
// m = 161,250 rows per chunk) one chunk is 2*m*K*F*O ~ 2.08 GFLOP against
// ~33.5 MB of input, ~62 FLOP per byte: FFMA-bound on paper.  This simple
// form issues one shared-memory load of x per O FFMAs (W is a broadcast
// read), so the shared-memory pipe, not the FMA pipe, limits it; register
// blocking over several rows per thread, or 3xTF32 on wgmma, is later work.
// Rows are stored at an odd stride (F | 1 floats) so the 32 threads of a
// warp, which read 32 consecutive rows at the same column, hit 32 banks.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;

__host__ __device__ inline int row_stride(int F) { return F | 1; }

// Stage rows [t0, t0 + rows) of X into xs (row stride fs).  `total` is the
// length of the stream (interleaved) or of each row of x_pair (pair).
template <bool kPair>
__device__ inline void stage_rows(float* xs, const float* __restrict__ x, long long total,
                                  long long t0, int rows, int F, int fs) {
  if constexpr (!kPair) {
    const int span = rows * F;
    const long long base = t0 * F;
    for (int q = threadIdx.x; q < span; q += kTileM) {
      const long long g = base + q;
      const int r = q / F;
      xs[r * fs + (q - r * F)] = g < total ? x[g] : 0.f;
    }
  } else {
    const int D = F >> 1;
    const int span = rows * D;
    const long long base = t0 * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* xi = x + i * total;
      float* xsi = xs + i * D;
      for (int q = threadIdx.x; q < span; q += kTileM) {
        const long long g = base + q;
        const int r = q / D;
        xsi[r * fs + (q - r * D)] = g < total ? xi[g] : 0.f;
      }
    }
  }
}

template <int O, bool kPair>
__global__ void __launch_bounds__(kTileM)
poly_fir_kernel(const float* __restrict__ x, long long total,
                const float* __restrict__ w, float* __restrict__ out,
                int m, int K, int F, int kb) {
  extern __shared__ float smem[];
  const int fs = row_stride(F);
  float* xs = smem;                            // (kTileM + kb - 1) rows x fs
  float* ws = smem + (kTileM + kb - 1) * fs;   // kb x F x O
  const int m0 = blockIdx.x * kTileM;
  const int row = m0 + threadIdx.x;

  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kb) {
    const int kn = min(kb, K - k0);
    __syncthreads();  // the previous block's reads are done
    stage_rows<kPair>(xs, x, total, (long long)(m0 + k0), kTileM + kn - 1, F, fs);
    const float* wsrc = w + (long long)k0 * F * O;
    for (int q = threadIdx.x; q < kn * F * O; q += kTileM) ws[q] = wsrc[q];
    __syncthreads();
    if (row < m) {
      for (int k = 0; k < kn; ++k) {
        const float* xr = xs + (threadIdx.x + k) * fs;
        const float* wk = ws + k * F * O;
        for (int f = 0; f < F; ++f) {
          const float xv = xr[f];
#pragma unroll
          for (int o = 0; o < O; ++o) acc[o] = fmaf(xv, wk[f * O + o], acc[o]);
        }
      }
    }
  }
  if (row < m) {
#pragma unroll
    for (int o = 0; o < O; ++o) out[(long long)o * m + row] = acc[o];
  }
}

template <int O, bool kPair>
int launch(const float* x, long long total, const float* w, float* out, int m, int K,
           int F, int kb, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kTileM + kb - 1) * row_stride(F) + (size_t)kb * F * O);
  cudaError_t err = cudaFuncSetAttribute(
      poly_fir_kernel<O, kPair>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (m + kTileM - 1) / kTileM;
  poly_fir_kernel<O, kPair><<<grid, kTileM, smem, stream>>>(x, total, w, out, m, K, F, kb);
  return (int)cudaGetLastError();
}

template <bool kPair>
int dispatch(const void* x, long long total, const void* w, void* out, int m, int K, int F,
             int O, int kb, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || K <= 0 || F <= 0 || kb <= 0) return (int)cudaErrorInvalidValue;
  if (kPair && (F & 1)) return (int)cudaErrorInvalidValue;
  switch (O) {
    case 2: return launch<2, kPair>(xf, total, wf, of, m, K, F, kb, s);
    case 4: return launch<4, kPair>(xf, total, wf, of, m, K, F, kb, s);
    case 6: return launch<6, kPair>(xf, total, wf, of, m, K, F, kb, s);
    case 8: return launch<8, kPair>(xf, total, wf, of, m, K, F, kb, s);
    case 10: return launch<10, kPair>(xf, total, wf, of, m, K, F, kb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: the interleaved stream of `total` floats.
extern "C" int iq2a_poly_fir_il(const void* x, int total, const void* w, void* out,
                                int m, int K, int F, int O, int kb, void* stream) {
  return dispatch<false>(x, total, w, out, m, K, F, O, kb, stream);
}

// x_pair: (2, row_len) floats, row-major; F = 2D.
extern "C" int iq2a_poly_fir_pair(const void* x_pair, int row_len, const void* w, void* out,
                                  int m, int K, int F, int O, int kb, void* stream) {
  return dispatch<true>(x_pair, row_len, w, out, m, K, F, O, kb, stream);
}
