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
//     (2, T, D) -> (T, 2D) relay of pallas_ddc.py:308-309, read in place by
//     the staging loop (two runs per row; no relayed copy reaches device
//     memory).
//
// The form.  Because X[t, f] = x[F*t + f], the K taps of a row are one
// contiguous run of the flat stream, and the work is one dense GEMM whose
// reduction axis is the merged (tap, feature) axis.  O = 2..10 is far
// narrower than any tensor-core tile, so, as the JAX package's
// shift_matmul_kernel does for the MXU, four consecutive output rows ride
// the column axis: with the super-row rho = r / 4 and t = 4s + q,
//
//     out[4 rho + i, o] = sum_s sum_{q<4} sum_f X[4 (rho + s) + q, f]
//                                               * W[4 s + q - i, f, o]
//
// for i = 0..3, W read as zero outside [0, K): an (m/4) x (K+3)F times
// (K+3)F x 4O product whose N = 4O is a multiple of 8.  The shifted B is
// never materialised: column n = i*O + o of reduction row (4s + q, f) is
// tap 4s + q - i of the unshifted tensor, which is stored with three zero
// taps before it and after it in place of a predicate.
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8.  One TF32 product keeps about
// three decimal digits and misses the -60 dB audio contract, so every
// operand is split into hi = tf32(v), rounded to nearest as
// cvt.rna.tf32.f32 does, and lo = the TF32 truncation of v - hi, and each
// term is lo*hi + hi*lo + hi*hi accumulated in float32, small terms first.
// hi + lo is exact for an s16 or u8 sample scaled by a power of two (16
// significant bits); a general float32 keeps 2^-21.  W is split by
// pack_taps_kernel, which also lays it out as the tiles below (the wrapper
// keeps the result while the tap tensor lives); x is split in registers
// where it is used.  The tensor cores truncate the sum into the accumulator,
// a bias that grows with the length of an MMA chain (-92 dB at 62 taps when
// one chain runs over the whole reduction), so a chain covers one super-tap
// from a zero accumulator and is added to the running sums by FADD.
//
// Tiling.  The feature axis is walked in blocks of 8 (one MMA depth), the
// super-tap axis s in blocks of SB, so no geometry is too wide: a stage of
// the two-stage ring holds, for one (feature block, s block),
//   xs: tile rows + SB - 1 super-rows of 4 rows x 8 features, at a stride of
//       36 floats (the eight row pairs of an A-fragment load hit distinct
//       banks), filled by cp.async of 16, 8 or 4 bytes according to the
//       alignment of the runs, zero-filled past the stream's end;
//   ws: 4 SB + 3 taps x O outputs x 4 float4 (hi f, hi f+1, lo f, lo f+1),
//       one contiguous run of the packed tensor, so that a B fragment with
//       both halves is one conflict-free 16-byte load.
// Block b + 1 is in flight while the MMAs run on block b.  A CTA of four
// warps owns 64 super-rows (256 output rows; each warp one m16 tile) and
// keeps its 4O partial sums per super-row in registers across all blocks.
// MMA rows g and g + 8 are the super-rows 2g and 2g + 1, so the row a step
// reads for g + 8 is the row the next step reads for g: it stays in
// registers, already split, and a step loads one new row.  The k index t of
// a fragment maps to feature 2t and t + 4 to feature 2t + 1, in A and B
// alike, so a lane's two A values of a row are one 8-byte load.  When
// F = 8n + 4 the last block has 4 features, and its steps take them from two
// rows of the super-row at once instead of multiplying zeros.  No atomics
// and no reduction across CTAs: the same call gives the same bits every
// time.
//
// What bounds it.  At the flagship geometry (K = 62, F = 52, O = 2,
// m = 161,250 rows per chunk) one chunk is 2 m K F O ~ 2.08 GFLOP against
// ~33.5 MB of input: operations-bound on paper, three TF32 products per
// term.  Per depth-8 step a warp executes one 8-byte and O/2 16-byte
// shared-memory loads, 8 integer and float ops of the split, 3 O/2 MMAs and
// their FADDs.  Measured on an H100 SXM at 700 W, three TF32 products per
// term counted, the kernel reaches a fifth of the TF32 peak at O = 2, where
// the instruction slots and the mma.sync rate hold it, and a third at
// O = 10, where the B loads of the five column tiles do.  wgmma, with B read
// from shared memory by the tensor cores, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // super-rows per CTA: one m16 tile per warp
constexpr int kStages = 2;      // shared-memory ring: block b + 1 loads while b runs
constexpr int kFeatBlock = 8;   // features per block: one MMA depth
constexpr int kXsStride = 36;   // floats per staged super-row (4 x 8 + 4 pad)

// hi = tf32(v) rounded to nearest (ties away, as cvt.rna.tf32.f32), lo the
// TF32 truncation of v - hi, with integer ops: the conversion instruction
// is several times slower than an add and a mask.
__device__ inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// d = a * b + c on the tensor cores (m16n8k8, TF32 operands, float32 sums).
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Copy kBytes to shared memory, reading only src_bytes of them (the rest is
// zero-filled).
template <int kBytes>
__device__ inline void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(s), "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int kPending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Stage features [f0, f0 + 8) of rows [t0, t0 + 4*srows) of X into xs, as
// super-rows of 4 rows x 8 features at stride kXsStride, in vectors of V
// floats.  `total` is the length of the stream (interleaved) or of each row
// of x_pair (pair).  Features >= F and samples past the end read as zero.
// A thread keeps its (row of the super-row, feature) and walks super-rows.
template <bool kPair, int V>
__device__ inline void stage_x(float* xs, const float* __restrict__ x, long long total,
                               long long t0, int srows, int F, int f0) {
  constexpr int kPerRow = kFeatBlock / V;
  constexpr int kSrStep = kThreads / (4 * kPerRow);
  const int e = (threadIdx.x % kPerRow) * V;
  const int q = (threadIdx.x / kPerRow) & 3;
  int sr = threadIdx.x / (4 * kPerRow);
  const int f = f0 + e;
  float* dst = xs + sr * kXsStride + q * kFeatBlock + e;
  if (f >= F) {
    for (; sr < srows; sr += kSrStep, dst += kSrStep * kXsStride) cp_async<4 * V>(dst, x, 0);
    return;
  }
  // a run of the source holds `run` floats per row of X
  const int run = kPair ? F >> 1 : F;
  const int half = kPair && f >= run;
  long long in_run = (t0 + 4 * sr + q) * run + (f - half * run);
  const float* src = x + half * total + in_run;
  const long long step = (long long)kSrStep * 4 * run;
  for (; sr < srows; sr += kSrStep) {
    const long long left = total - in_run;
    const int nv = left >= V ? V : (left > 0 ? (int)left : 0);
    cp_async<4 * V>(dst, nv > 0 ? src : x, 4 * nv);
    dst += kSrStep * kXsStride;
    src += step;
    in_run += step;
  }
}

// Split W (K, F, O) into TF32 hi and lo parts and lay it out as the tiles
// the main kernel stages: wp[fb][kk][o][fh] = (hi f, hi f+1, lo f, lo f+1)
// with f = 8 fb + 2 fh and tap k = kk - 3, zero outside the tensor.
__global__ void pack_taps_kernel(const float* __restrict__ w, float4* __restrict__ wp, int K,
                                 int F, int O, int KP, int n_fb) {
  const long long n = (long long)n_fb * KP * O * 4;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int fh = idx & 3;
    long long rest = idx >> 2;
    const int o = rest % O;
    rest /= O;
    const int k = (int)(rest % KP) - 3;
    const int f = ((int)(rest / KP)) * kFeatBlock + 2 * fh;
    float v0 = 0.f, v1 = 0.f;
    if (k >= 0 && k < K) {
      const float* src = w + ((long long)k * F + f) * O + o;
      if (f < F) v0 = src[0];
      if (f + 1 < F) v1 = src[O];
    }
    uint32_t h0, l0, h1, l1;
    split_tf32(v0, h0, l0);
    split_tf32(v1, h1, l1);
    wp[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
  }
}

// The MMAs of one staged block for one warp: `ax` and `bx` point at the
// lane's A and B fragments of the warp's first step at s = 0, `b_base` holds
// the B offsets of the n-tiles.  kHalf: a block of 4 features, whose
// depth-8 steps take two rows of the super-row at once (q = 0 and 2 only).
template <int O, bool kHalf>
__device__ __forceinline__ void block_mma(float (&acc)[O / 2][4], const float* ax,
                                          const float4* bx, const int (&b_base)[O / 2],
                                          int sbn) {
  constexpr int NT = O / 2;                       // n8 tiles: 4*O columns
  constexpr int NI = kHalf ? 2 : 4;                // steps per super-tap
  constexpr int QSTEP = kHalf ? 2 : 1;             // rows of the super-row per step
  // MMA chains per tile: enough independent MMAs in flight when tiles are few
  constexpr int QS = NT >= 4 ? 1 : (NT >= 2 || NI == 2 ? 2 : 4);
#ifndef IQ2A_ONE_CHAIN
  const float kZero[4] = {0.f, 0.f, 0.f, 0.f};
#endif
  // The row that step s reads for MMA row g + 8 is the row step s + 1 reads
  // for row g: it stays in registers, split, and a step loads one new row.
  uint32_t chi[NI][2], clo[NI][2];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float2 r = *reinterpret_cast<const float2*>(ax + i * QSTEP * kFeatBlock);
    split_tf32(r.x, chi[i][0], clo[i][0]);
    split_tf32(r.y, chi[i][1], clo[i][1]);
  }
#pragma unroll 1  // unrolling spills within the launch bounds
  for (int sl = 0; sl < sbn; ++sl) {
    // The tensor cores truncate each sum into the accumulator; chained over
    // the whole reduction that bias grows with its length (-92 dB at 62
    // taps).  So a chain covers one super-tap only (3 NI / QS MMAs from a
    // zero accumulator) and is added to the running sums by FADD, which
    // rounds to nearest.
    float part[QS][NT][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      uint32_t ahi[4], alo[4];
      const float2 r = *reinterpret_cast<const float2*>(ax + (sl + 1) * kXsStride +
                                                        i * QSTEP * kFeatBlock);
      ahi[0] = chi[i][0], alo[0] = clo[i][0];
      ahi[2] = chi[i][1], alo[2] = clo[i][1];
      split_tf32(r.x, ahi[1], alo[1]);
      split_tf32(r.y, ahi[3], alo[3]);
      chi[i][0] = ahi[1], clo[i][0] = alo[1];
      chi[i][1] = ahi[3], clo[i][1] = alo[3];
      const float4* bq = bx + (4 * sl + i * QSTEP) * O * 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 bv = bq[b_base[nt]];
        const uint32_t bh0 = __float_as_uint(bv.x), bh1 = __float_as_uint(bv.y);
        const uint32_t bl0 = __float_as_uint(bv.z), bl1 = __float_as_uint(bv.w);
#ifdef IQ2A_ONE_CHAIN  // probe builds only: one chain over the whole reduction
        float (&p)[4] = acc[nt];
        mma_tf32(p, alo, bh0, bh1, p);
#else
        float (&p)[4] = part[i % QS][nt];
        if (i < QS) mma_tf32(p, alo, bh0, bh1, kZero);  // small terms first
        else mma_tf32(p, alo, bh0, bh1, p);
#endif
        mma_tf32(p, ahi, bl0, bl1, p);
        mma_tf32(p, ahi, bh0, bh1, p);
      }
    }
#ifndef IQ2A_ONE_CHAIN
#pragma unroll
    for (int qs = 0; qs < QS; ++qs)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][c] += part[qs][nt][c];
#endif
  }
}

// CTAs per SM that the register budget must allow, by the count of n8
// accumulator tiles of a warp (ops/poly_fir.py::_ctas_by_regs mirrors it).
__host__ __device__ constexpr int min_ctas(int tiles) { return tiles <= 1 ? 5 : tiles <= 2 ? 4 : tiles <= 5 ? 3 : 2; }

template <int O, bool kPair>
__global__ void __launch_bounds__(kThreads, min_ctas(O / 2))
poly_fir_kernel(const float* __restrict__ x, long long total, const float4* __restrict__ wp,
                float* __restrict__ out, int m, int F, int S, int SB, int vec) {
  constexpr int NT = O / 2;  // n8 tiles: 4*O columns
  extern __shared__ __align__(16) float smem[];
  const int xs_floats = (kTileRows + SB - 1) * kXsStride;
  const int ws_f4 = (4 * SB + 3) * O * 4;
  const int stage_floats = xs_floats + 4 * ws_f4;
  const int KP = 4 * S + 3;
  const int n_sb = (S + SB - 1) / SB;
  const int n_fb = (F + kFeatBlock - 1) / kFeatBlock;
  const int n_blocks = n_fb * n_sb;
  // F = 8n + 4: the last feature block holds 4 features, and a depth-8 step
  // there takes them from two rows of the super-row (q and q + 1) at once.
  const bool half_tail = (F & 7) == 4;
  const long long rho0 = (long long)blockIdx.x * kTileRows;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  // float4 index of this lane's B fragment in a tile, per n-tile, at s = q = 0
  // and without the lane's feature pair: column n = 8 nt + g is
  // (i, o) = (n / O, n % O) and reads tap 4s + q - i.
  int b_base[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 8 * nt + g;
    b_base[nt] = ((3 - n / O) * O + n % O) * 4;
  }
  // MMA rows g and g + 8 hold the super-rows 2g and 2g + 1 of the warp's 16.
  const int row0 = warp * 16;
  const int a_base = (row0 + 2 * g) * kXsStride;

  auto stage_block = [&](int b) {
    if (b < n_blocks) {
      const int fb = b / n_sb;
      const int s0 = (b - fb * n_sb) * SB;
      const int sbn = min(SB, S - s0);
      float* xs = smem + (b % kStages) * stage_floats;
      float4* ws = reinterpret_cast<float4*>(xs + xs_floats);
      const float4* src = wp + ((long long)fb * KP + 4 * s0) * O * 4;
      const int n16 = (4 * sbn + 3) * O * 4;
      for (int i = threadIdx.x; i < n16; i += kThreads) cp_async<16>(ws + i, src + i, 16);
      const long long t0 = 4 * (rho0 + s0);
      const int srows = kTileRows + sbn - 1;
      const int f0 = fb * kFeatBlock;
      if (vec == 4) stage_x<kPair, 4>(xs, x, total, t0, srows, F, f0);
      else if (vec == 2) stage_x<kPair, 2>(xs, x, total, t0, srows, F, f0);
      else stage_x<kPair, 1>(xs, x, total, t0, srows, F, f0);
    }
    cp_async_commit();  // one group per block, empty past the last
  };

  for (int p = 0; p < kStages - 1; ++p) stage_block(p);

  for (int b = 0; b < n_blocks; ++b) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // block b landed for all; block b - 1 is read by none
    stage_block(b + kStages - 1);

    const int fb = b / n_sb;
    const int sbn = min(SB, S - (b - fb * n_sb) * SB);
    const float* xs = smem + (b % kStages) * stage_floats;
    const float4* ws = reinterpret_cast<const float4*>(xs + xs_floats);
    // The k index t of a fragment is feature 2t of the block and t + 4 is
    // feature 2t + 1, so a lane reads one float2 of A and one float4 of B.
    // In a half block lanes t = 2, 3 take features 0..3 of the next row.
    const bool half = half_tail && fb == n_fb - 1;
    const float* ax = xs + a_base + (half ? (t >> 1) * kFeatBlock + 2 * (t & 1) : 2 * t);
    const float4* bx = ws + (half ? (t >> 1) * O * 4 + (t & 1) : t);
    if (!half) block_mma<O, false>(acc, ax, bx, b_base, sbn);
    else block_mma<O, true>(acc, ax, bx, b_base, sbn);
  }

  // C fragment: c0, c1 = (row g, columns 2t, 2t + 1), c2, c3 = row g + 8;
  // rows g and g + 8 are the super-rows 2g and 2g + 1.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 8 * nt + 2 * t + (c & 1);
      const long long rho = rho0 + row0 + 2 * g + (c >> 1);
      const long long r = 4 * rho + n / O;
      if (r < m) out[(long long)(n % O) * m + r] = acc[nt][c];
    }
}

constexpr int kMaxDevices = 64;

// `w` is split into `wp` first when `pack` is set.  Nothing is launched
// unless the kernel may have its shared memory.
template <int O, bool kPair>
int launch(const float* x, long long total, const float* w, float4* wp, float* out, int m, int K,
           int F, int S, int SB, int vec, bool pack, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * 4 *
                      ((size_t)(kTileRows + SB - 1) * kXsStride + (size_t)(4 * SB + 3) * O * 16);
  // More than 48 KB has to be asked for; the function keeps the grant, so
  // ask only for more than any earlier launch on this device had.
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(poly_fir_kernel<O, kPair>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here: leave no stale error for the next launch check
      return (int)err;
    }
    granted[dev] = smem;
  }
  if (pack) {
    const int KP = 4 * S + 3;
    const int n_fb = (F + kFeatBlock - 1) / kFeatBlock;
    const long long n_pack = (long long)n_fb * KP * O * 4;
    const int pack_grid = (int)((n_pack + 255) / 256 < 1024 ? (n_pack + 255) / 256 : 1024);
    pack_taps_kernel<<<pack_grid, 256, 0, stream>>>(w, wp, K, F, O, KP, n_fb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long super_rows = ((long long)m + 3) / 4;
  const int grid = (int)((super_rows + kTileRows - 1) / kTileRows);
  poly_fir_kernel<O, kPair><<<grid, kThreads, smem, stream>>>(x, total, wp, out, m, F, S, SB, vec);
  return (int)cudaGetLastError();
}

// `scratch` holds ceil(F/8) * (4S + 3) * O * 16 floats, S = ceil((K + 3) / 4).
template <bool kPair>
int dispatch(const void* x, long long total, const void* w, void* scratch, void* out, int m,
             int K, int F, int O, int SB, int pack, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float4* wp = static_cast<float4*>(scratch);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || K <= 0 || F <= 0 || (F & 1) || SB <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return (int)cudaErrorInvalidValue;
  const int S = (K + 3 + 3) / 4;
  if (SB > S) SB = S;

  // widest copy every run of the input is aligned for
  const int D = F >> 1;
  int vec = 4;
  while (vec > 1 && (reinterpret_cast<uintptr_t>(x) % (4 * vec) ||
                     (kPair ? (D % vec || total % vec) : (F % vec))))
    vec >>= 1;

  const bool p = pack != 0;
  switch (O) {
    case 2: return launch<2, kPair>(xf, total, wf, wp, of, m, K, F, S, SB, vec, p, s);
    case 4: return launch<4, kPair>(xf, total, wf, wp, of, m, K, F, S, SB, vec, p, s);
    case 6: return launch<6, kPair>(xf, total, wf, wp, of, m, K, F, S, SB, vec, p, s);
    case 8: return launch<8, kPair>(xf, total, wf, wp, of, m, K, F, S, SB, vec, p, s);
    case 10: return launch<10, kPair>(xf, total, wf, wp, of, m, K, F, S, SB, vec, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: the interleaved stream of `total` floats.  sb: super-taps (4 taps) per
// block; pack: 0 when `scratch` already holds the split taps of `w` from an
// earlier call.
extern "C" int iq2a_poly_fir_il(const void* x, long long total, const void* w, void* scratch,
                                void* out, int m, int K, int F, int O, int sb, int pack,
                                void* stream) {
  return dispatch<false>(x, total, w, scratch, out, m, K, F, O, sb, pack, stream);
}

// x_pair: (2, row_len) floats, row-major; F = 2D.
extern "C" int iq2a_poly_fir_pair(const void* x_pair, long long row_len, const void* w,
                                  void* scratch, void* out, int m, int K, int F, int O, int sb,
                                  int pack, void* stream) {
  return dispatch<true>(x_pair, row_len, w, scratch, out, m, K, F, O, sb, pack, stream);
}
