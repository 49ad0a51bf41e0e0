// Fused log-mel front-end for Hopper (sm_90a): reflect-padded framing, the
// DFT as two products with the window folded into the bases, amplitude, the
// mel product and log10, in one kernel (K6).
//
// Replaces the TPU kernel a3t_tpu/ops/fused_logmel.py::fused_logmel (:93;
// _kernel :70, the pl.pallas_call at :120).  For audio (B, S) fp32 it
// computes, for F = 1 + S / hop frames, frame t = padded[t*hop : t*hop+n_fft]
// of the signal reflect-padded by n_fft/2:
//
//     re  = frame . W_cos,  im = frame . W_sin     (window folded in)
//     amp = sqrt(max(re^2 + im^2, 1e-10))
//     mel = amp . melmat
//     out = ln(max(mel, 1e-10)) / ln 10,   0 at frames t >= flens[b]
//
// Design.  The TPU kernel holds a (64, n_fft) tile of frames in VMEM; as
// frames that tile is 512 KB at n_fft = 2048, past a CTA's shared memory.
// Here a CTA owns (b, 64 frames) and loads the tile's *audio span* once,
// (64 - 1) * hop + win samples (80 KB at 24 kHz), with the reflection applied
// at both ends while loading; frame t's window row n is span[t*hop + n].
// Only the window's non-zero rows of the bases are read (the wrapper passes
// those rows, zero-padded to a multiple of 32 rows and to a multiple of 64
// bins).  The CTA walks the frequencies in blocks of 64 bins: for each block
// it streams 32-row tiles of W_cos and W_sin through shared memory, each of
// the 256 threads accumulating a 4 x 4 (frame, bin) tile of re and im in
// registers; then the block's amplitudes go to shared memory and each
// thread adds their mel products into its own mel sums (32 registers: 64
// frames x up to 128 mel bins), which never leave the chip until the log
// epilogue.  Padded bins have amp = 1e-5 and meet zero rows of the padded
// mel matrix, so they add nothing.
//
// Bound.  Work: 2 B F win n_freq 2 FLOP for the two DFT products over the
// window's rows, plus 2 B F n_freq n_mels for the mel product; bytes: the
// audio read once and the features written once.  At the JAX bench's batch
// (88 x 129,300 samples, F = 432, n_fft 2048, win 1200, 80 mels) that is
// 1.93e11 FLOP over 67 TFLOP/s (fp32 on the CUDA cores) = 2.9 ms, against
// 57.7 MB of bytes = 0.017 ms: bound by operations.  This first version runs
// fp32 products on the CUDA cores, as the plain version does, with fp32
// accumulation; it still computes the bins above fmax, whose mel weights are
// zero (37% of the DFT at 24 kHz).  Moving the DFT to TF32 or bf16 wgmma with
// TMA-fed basis tiles, and skipping the zero-weight bins, is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TF = 64;     // frames per CTA
constexpr int KB = 64;     // frequency bins per block
constexpr int NK = 32;     // window rows per basis tile
constexpr int NT = 256;    // threads per CTA
constexpr int MAXM = 128;  // most mel bins
constexpr int MPT = TF * MAXM / NT;  // mel sums per thread
constexpr int AS = KB + 1;           // row stride of the amplitude tile

// Sample i of the signal reflect-padded at both ends (torch's "reflect"
// rule, one reflection); positions no real frame reads give 0.
__device__ __forceinline__ float reflected(const float* __restrict__ x,
                                           long long i, int S) {
  if (i < 0) i = -i;
  if (i >= S) i = 2LL * (S - 1) - i;
  return (i >= 0 && i < S) ? x[i] : 0.f;
}

__global__ void __launch_bounds__(NT) fused_logmel_kernel(
    const float* __restrict__ audio, const float* __restrict__ wcos,
    const float* __restrict__ wsin, const float* __restrict__ melmat,
    const int32_t* __restrict__ flens, float* __restrict__ out, int S, int F,
    int hop, int win_pad, int k_pad, int n_mels, int start_off,
    int span_len) {
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);  // span_len (multiple of 4)
  float* wc_s = span + span_len;                   // NK x KB
  float* ws_s = wc_s + NK * KB;                    // NK x KB
  float* amp_s = ws_s + NK * KB;                   // TF x AS
  float* mel_s = amp_s + TF * AS;                  // KB x n_mels

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int tid = threadIdx.x;
  const float* x = audio + (size_t)b * S;

  // the tile's audio span: frame t0 + t, window row n is span[t*hop + n]
  const long long base = (long long)t0 * hop + start_off;
  for (int p = tid; p < span_len; p += NT) span[p] = reflected(x, base + p, S);

  // DFT roles: bins k0 + 4*tx + j, frames ty + 16*i
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // mel roles: frame tm, mel bins mq + 4*j
  const int tm = tid >> 2;
  const int mq = tid & 3;
  float macc[MPT];
#pragma unroll
  for (int j = 0; j < MPT; ++j) macc[j] = 0.f;

  for (int k0 = 0; k0 < k_pad; k0 += KB) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int n0 = 0; n0 < win_pad; n0 += NK) {
      __syncthreads();  // the previous tile is read (and the span loaded)
#pragma unroll
      for (int r = 0; r < NK * KB / 4 / NT; ++r) {
        const int idx = tid + r * NT;
        const int nn = idx / (KB / 4);
        const int kk = (idx % (KB / 4)) * 4;
        const size_t g = (size_t)(n0 + nn) * k_pad + k0 + kk;
        *reinterpret_cast<float4*>(wc_s + nn * KB + kk) =
            *reinterpret_cast<const float4*>(wcos + g);
        *reinterpret_cast<float4*>(ws_s + nn * KB + kk) =
            *reinterpret_cast<const float4*>(wsin + g);
      }
      __syncthreads();
#pragma unroll 4
      for (int nn = 0; nn < NK; ++nn) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = span[(ty + 16 * i) * hop + n0 + nn];
        const float4 c = *reinterpret_cast<const float4*>(wc_s + nn * KB + 4 * tx);
        const float4 s = *reinterpret_cast<const float4*>(ws_s + nn * KB + 4 * tx);
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
            im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
          }
      }
    }

    // amplitudes of this block, and its rows of the mel matrix
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        amp_s[(ty + 16 * i) * AS + 4 * tx + j] =
            sqrtf(fmaxf(re[i][j] * re[i][j] + im[i][j] * im[i][j], 1e-10f));
    for (int p = tid; p < KB * n_mels; p += NT)
      mel_s[p] = melmat[(size_t)k0 * n_mels + p];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      const float a = amp_s[tm * AS + kk];
      const float* mrow = mel_s + kk * n_mels;
#pragma unroll
      for (int j = 0; j < MPT; ++j)
        if (mq + 4 * j < n_mels) macc[j] = fmaf(a, mrow[mq + 4 * j], macc[j]);
    }
  }

  // epilogue: log10 of the clamped mel sums; frames past the length are 0
  const int t = t0 + tm;
  if (t < F) {
    const bool valid = flens == nullptr || t < flens[b];
    float* o = out + ((size_t)b * F + t) * n_mels;
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int m = mq + 4 * j;
      if (m < n_mels)
        o[m] = valid ? logf(fmaxf(macc[j], 1e-10f)) / 2.302585093f : 0.f;
    }
  }
}

}  // namespace

// audio: (B, S) fp32; wcos, wsin: (win_pad, k_pad) fp32, the window's rows
// of the bases (win_pad a multiple of 32, k_pad of 64, both zero-padded);
// melmat: (k_pad, n_mels) fp32 with zero rows past n_freq; flens: (B,) int32
// or null (every frame valid); out: (B, F, n_mels) fp32.  start_off is the
// window's first row minus the reflect padding, (n_fft - win)/2 - n_fft/2.
// Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_logmel(const float* audio, const float* wcos,
                                const float* wsin, const float* melmat,
                                const int32_t* flens, float* out, int B,
                                int S, int F, int hop, int win_pad, int k_pad,
                                int n_mels, int start_off, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || F <= 0 || hop <= 0 || win_pad <= 0 ||
      win_pad % NK != 0 || k_pad <= 0 || k_pad % KB != 0 || n_mels <= 0 ||
      n_mels > MAXM)
    return (int)cudaErrorInvalidValue;
  const int span_len = (((TF - 1) * hop + win_pad) + 3) / 4 * 4;
  const size_t smem = (size_t)(span_len + 2 * NK * KB + TF * AS +
                               KB * n_mels) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + TF - 1) / TF, B);
  fused_logmel_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, wcos, wsin, melmat, flens, out, S, F, hop, win_pad, k_pad, n_mels,
      start_off, span_len);
  return (int)cudaGetLastError();
}
