// Decimating polyphase FIR channelizer for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels of iq_to_audio_tpu/ops/pallas_ddc.py:
// _ddc_matmul_kernel (whole tap tensor resident) and
// _ddc_matmul_kernel_tiled (tap axis tiled over a sequential grid axis),
// both reached through pallas_poly_fir_il.  It computes
//
//     out[o, r] = sum_{k<K} sum_{f<F} X[r + k, f] * W[k, f, o]
//
// where X[t, f] = x[F*t + f] is the contiguous (T, F) view of the scaled
// interleaved stream (F = 2D) and W = build_poly_kernel(kernel_il, 2D) is
// (K, F, O) with O = 2C outputs per row, written channel-major (O, m).
//
// Design.  One CTA owns TILE_M = 128 consecutive output rows, one thread per
// row.  The rows [m0, m0 + TILE_M + kb - 1) that the tile needs are ONE
// contiguous span of x, so each tap block stages x[F*(m0+k0) : ...] into
// shared memory with coalesced loads (the ragged end past the stream is
// masked to zero; its weights are zero anyway) next to the tap block
// W[k0 : k0+kb].  The loop over tap blocks inside the CTA replaces the
// sequential grid_k axis of the tiled TPU kernel, and the O partial sums stay
// in f32 registers across all blocks.  Arithmetic is plain FFMA in full f32:
// TF32 tensor-core products lose about 3 decimal digits and miss the -60 dB
// audio contract.
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

template <int O>
__global__ void __launch_bounds__(kTileM)
poly_fir_il_kernel(const float* __restrict__ x, long long total,
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
    const int span = (kTileM + kn - 1) * F;
    const long long base = (long long)(m0 + k0) * F;
    __syncthreads();  // the previous block's reads are done
    for (int q = threadIdx.x; q < span; q += kTileM) {
      const long long g = base + q;
      const int r = q / F;
      xs[r * fs + (q - r * F)] = g < total ? x[g] : 0.f;
    }
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

template <int O>
int launch(const float* x, int total, const float* w, float* out, int m, int K,
           int F, int kb, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kTileM + kb - 1) * row_stride(F) + (size_t)kb * F * O);
  cudaError_t err = cudaFuncSetAttribute(
      poly_fir_il_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (m + kTileM - 1) / kTileM;
  poly_fir_il_kernel<O><<<grid, kTileM, smem, stream>>>(x, total, w, out, m, K, F, kb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int iq2a_poly_fir_il(const void* x, int total, const void* w, void* out,
                                int m, int K, int F, int O, int kb, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || K <= 0 || F <= 0 || kb <= 0) return (int)cudaErrorInvalidValue;
  switch (O) {
    case 2: return launch<2>(xf, total, wf, of, m, K, F, kb, s);
    case 4: return launch<4>(xf, total, wf, of, m, K, F, kb, s);
    case 6: return launch<6>(xf, total, wf, of, m, K, F, kb, s);
    case 8: return launch<8>(xf, total, wf, of, m, K, F, kb, s);
    case 10: return launch<10>(xf, total, wf, of, m, K, F, kb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
