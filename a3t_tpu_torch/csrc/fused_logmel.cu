// Fused log-mel front-end for Hopper (sm_90a): reflect-padded framing, the
// window, a real FFT, amplitude, the mel sums and log10, in one kernel (K6).
//
// Replaces the TPU kernel a3t_tpu/ops/fused_logmel.py::fused_logmel (:93;
// _kernel :70, the pl.pallas_call at :120).  For audio (B, S) fp32 it
// computes, for F = 1 + S / hop frames, frame t = padded[t*hop : t*hop+n_fft]
// of the signal reflect-padded by n_fft/2, times the centred window of
// win_length:
//
//     X   = rfft(frame)                (n_fft / 2 + 1 bins)
//     amp = sqrt(max(re^2 + im^2, 1e-10))
//     mel = amp . melmat
//     out = ln(max(mel, 1e-10)) / ln 10,   0 at frames t >= flens[b]
//
// Bound.  The function's least work is a real FFT per frame (5 (n_fft / 2)
// log2 n_fft FLOP), the window, the amplitudes up to the last bin with a
// non-zero mel weight and the filterbank's non-zero entries; its bytes are
// the audio read once and the features written once.  At the JAX bench's
// batch (88 x 129,300 samples, F = 432, n_fft 2048, win 1200, 80 mels) that
// is 2.4e9 FLOP over 67 TFLOP/s = 0.036 ms against 57.7 MB over 3.35 TB/s =
// 0.017 ms: bound by operations.
//
// Design, power-of-two n_fft (fused_logmel_fft_kernel; every config of the
// repo: 2048, 1024, 256):
//   * stay in fp32: a bf16 operand (2^-9) or TF32 (2^-11) would miss the
//     1e-4 on log10 features that the kernel is held to, so the FFT runs on
//     the CUDA cores, where it needs about 40x fewer operations than the
//     direct DFT of the TPU kernel's two products;
//   * a CTA owns (b, TF frames), TF = 16 at n_fft <= 2048 when shared memory
//     allows; it loads the frames' audio span once (cp.async, 4 bytes a
//     sample; the reflection at both ends applied while loading) and the
//     config's tables (16-byte cp.async): the FFT's twiddles and the real
//     split's, the window, the mel ranges and weights;
//   * one warp per frame.  The windowed samples go into the frame's buffer
//     of M = n_fft / 2 complex values, z[n] = x[2n] + i x[2n+1], and an
//     M-point complex FFT runs in place: Stockham stages of radix 16 (the
//     first), 4 and 2, each thread loading its butterflies' inputs into
//     registers, the warp syncing, the butterflies' outputs written back.
//     The buffer is swizzled (complex value x sits at x ^ ((x >> 4) & 15)),
//     so that every stage's loads and stores, the strided stores of the
//     first stage included, hit 16 different 8-byte bank pairs in each half
//     of the warp: no bank conflicts;
//   * the real-to-complex split takes Z[k] and Z[M-k] in one thread, which
//     writes the amplitudes of bins k and M-k over them (bin M beside bin
//     0), so no second buffer is needed;
//   * the mel sums are sparse: mel bin m sums only its filter's range of
//     bins, from the first to the last non-zero weight of melmat, in bin
//     order (the wrapper derives the ranges from melmat itself), so the
//     bins above fmax are never touched; then log10, and zeros for the
//     frames past the length, whose FFT is skipped.
// Design, other n_fft (fused_logmel_dft_kernel, the direct DFT): a CTA owns
//   (b, 64 frames), loads their audio span once, streams 32-row tiles of the
//   window's rows of the DFT bases per 64-bin block, each thread
//   accumulating a 4 x 4 (frame, bin) tile of re and im in registers, adds
//   the block's amplitudes into its own mel sums (64 frames x up to 128 mel
//   bins over 256 threads) and takes the log in the epilogue.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float INV_LN10 = 1.f / 2.302585093f;

// Sample i of the signal reflect-padded at both ends (torch's "reflect"
// rule, one reflection); positions no real frame reads give 0.
__device__ __forceinline__ float reflected(const float* __restrict__ x,
                                           long long i, int S) {
  if (i < 0) i = -i;
  if (i >= S) i = 2LL * (S - 1) - i;
  return (i >= 0 && i < S) ? x[i] : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- FFT

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i m / 16) for the m = n2 k1 <= 9 of the 16-point DFT
__device__ __forceinline__ float2 w16(int m) {
  constexpr float C1 = 0.923879532511286756f, S1 = 0.382683432365089772f;
  constexpr float R2 = 0.707106781186547524f;
  switch (m) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(C1, -S1);
    case 2: return make_float2(R2, -R2);
    case 3: return make_float2(S1, -C1);
    case 4: return make_float2(0.f, -1.f);
    case 6: return make_float2(-R2, -R2);
    default: return make_float2(-C1, S1);  // m = 9
  }
}

// forward 4-point DFT in place, natural order
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = csub(a1, a3);
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
  a3 = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
}

// forward R-point DFT of u in place; output l sits at u[pos(l)]
template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  if constexpr (R == 2) {
    const float2 t = u[0];
    u[0] = cadd(t, u[1]);
    u[1] = csub(t, u[1]);
  } else if constexpr (R == 4) {
    dft4(u[0], u[1], u[2], u[3]);
  } else {  // 16 = 4 x 4: n = 4 n1 + n2, k = k1 + 4 k2
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) dft4(u[n2], u[4 + n2], u[8 + n2], u[12 + n2]);
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
#pragma unroll
      for (int n2 = 1; n2 < 4; ++n2) u[4 * k1 + n2] = cmul(u[4 * k1 + n2], w16(n2 * k1));
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) dft4(u[4 * k1], u[4 * k1 + 1], u[4 * k1 + 2], u[4 * k1 + 3]);
  }
}
template <int R>
__device__ __forceinline__ constexpr int pos(int l) {
  return R == 16 ? 4 * (l & 3) + (l >> 2) : l;
}

// the swizzled slot of complex value x in a frame's buffer
__device__ __forceinline__ int swz(int x) { return x ^ ((x >> 4) & 15); }

// One Stockham stage of radix R = 2^LOGR after stages whose radices
// multiply to P = 2^LOGP, over the frame's M = 2^LOGM values in buf, in
// place: butterfly i < M / R reads x[i + j M / R] (j < R), times the
// twiddle exp(-2 pi i j k / (P R)) (tw[j P + k], k = i mod P), and writes
// its R outputs to (i - k) R + k + l P.
template <int LOGM, int LOGP, int LOGR>
__device__ __forceinline__ void fft_stage(float2* buf, const float2* tw, int lane) {
  constexpr int M = 1 << LOGM, R = 1 << LOGR, P = 1 << LOGP, NB = M / R;
  constexpr int QN = (NB + 31) / 32;  // butterflies per thread
  float2 u[QN][R];
#pragma unroll
  for (int qq = 0; qq < QN; ++qq) {
    const int i = lane + 32 * qq;
    if (NB % 32 == 0 || i < NB) {
      const int k = i & (P - 1);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float2 x = buf[swz(i + j * NB)];
        u[qq][j] = (LOGP == 0 || j == 0) ? x : cmul(x, tw[j * P + k]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int qq = 0; qq < QN; ++qq) {
    const int i = lane + 32 * qq;
    if (NB % 32 == 0 || i < NB) {
      dft<R>(u[qq]);
      const int k = i & (P - 1);
      const int o = (i >> LOGP) * (P * R) + k;
#pragma unroll
      for (int l = 0; l < R; ++l) buf[swz(o + l * P)] = u[qq][pos<R>(l)];
    }
  }
  __syncwarp();
}

// the stages from P = 2^LOGP on: radix 16 first, then 4, then a last 2;
// stage s's twiddles follow the earlier stages' R P entries each
template <int LOGM, int LOGP>
__device__ __forceinline__ void fft_stages(float2* buf, const float2* tw, int lane) {
  if constexpr (LOGP < LOGM) {
    constexpr int LOGR = LOGP == 0 ? (LOGM < 4 ? LOGM : 4) : (LOGM - LOGP >= 2 ? 2 : 1);
    fft_stage<LOGM, LOGP, LOGR>(buf, tw, lane);
    fft_stages<LOGM, LOGP + LOGR>(buf, tw + (1 << (LOGP + LOGR)), lane);
  }
}

struct FftArgs {
  const float* audio;
  const float* tab;      // twiddles, split twiddles, window, mel weights
  const int32_t* mels;   // first bin, bin count, weight offset per mel bin
  const int32_t* flens;  // (B,) or null
  float* out;
  int S, F, hop, win, n_mels, start_off;
  int tf;                               // frames per CTA
  int o_split, o_win, o_wts, n_tab;     // table offsets (floats), its length
  int span_len;                         // floats of audio per CTA
};

// frames per CTA at most, and threads: one warp a frame
template <int LOGM>
struct FftCfg {
  static constexpr int TFMAX = LOGM <= 10 ? 16 : 8;
  static constexpr int NT = 32 * TFMAX;
};

template <int LOGM>
__global__ void __launch_bounds__(FftCfg<LOGM>::NT) fused_logmel_fft_kernel(FftArgs a) {
  constexpr int M = 1 << LOGM;
  extern __shared__ float4 smem4[];
  float2* bufs = reinterpret_cast<float2*>(smem4);            // tf x M
  float* tab = reinterpret_cast<float*>(bufs + a.tf * M);     // n_tab
  int* mels = reinterpret_cast<int*>(tab + a.n_tab);          // 3 n_mels, padded to 4
  float* span = reinterpret_cast<float*>(mels + (3 * a.n_mels + 3) / 4 * 4);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tf;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* x = a.audio + (size_t)b * a.S;

  // the frames' audio span (span[p] = audio[t0 hop + start_off + p],
  // reflected at both ends) and the tables
  const long long base = (long long)t0 * a.hop + a.start_off;
  for (int p = tid; p < a.span_len; p += nt) {
    const long long i = base + p;
    if (i >= 0 && i < a.S)
      cp_async4(span + p, x + i);
    else
      span[p] = reflected(x, i, a.S);
  }
  for (int e = 4 * tid; e < a.n_tab; e += 4 * nt) cp_async16(tab + e, a.tab + e);
  for (int e = tid; e < 3 * a.n_mels; e += nt) mels[e] = a.mels[e];
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  cp_async_wait_all();
  __syncthreads();

  const int wid = tid >> 5, lane = tid & 31;
  const int t = t0 + wid;
  if (wid >= a.tf || t >= a.F) return;
  float* o = a.out + ((size_t)b * a.F + t) * a.n_mels;
  if (a.flens != nullptr && t >= a.flens[b]) {
    for (int m = lane; m < a.n_mels; m += 32) o[m] = 0.f;
    return;
  }

  float2* buf = bufs + wid * M;
  const float2* tw = reinterpret_cast<const float2*>(tab);
  const float2* tws = reinterpret_cast<const float2*>(tab + a.o_split);
  const float* wnd = tab + a.o_win;
  const float* wts = tab + a.o_wts;
  // z[n] = x[2n] + i x[2n+1] of the windowed frame: window row r of frame
  // sample n = left + r is span[wid hop + r]
  const int left = a.start_off + M;  // (n_fft - win) / 2
  const float* fs = span + wid * a.hop;
  for (int n = lane; n < M; n += 32) {
    const int r0 = 2 * n - left, r1 = r0 + 1;
    const float v0 = (r0 >= 0 && r0 < a.win) ? fs[r0] * wnd[r0] : 0.f;
    const float v1 = (r1 >= 0 && r1 < a.win) ? fs[r1] * wnd[r1] : 0.f;
    buf[swz(n)] = make_float2(v0, v1);
  }
  __syncwarp();
  fft_stages<LOGM, 0>(buf, tw, lane);

  // the real split: X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k (Z[k] - Z*[M-k]) / 2
  // with W = exp(-2 pi i / n_fft), and X[M-k] from the same pair; the
  // amplitudes of bins k and M-k replace Z[k] and Z[M-k] (bin M sits in the
  // imaginary half of slot 0)
  for (int kk = lane; kk <= M / 2; kk += 32) {
    const int sk = swz(kk), sm = swz((M - kk) & (M - 1));
    const float2 zk = buf[sk], zm = buf[sm];
    const float2 w = tws[kk];
    const float2 sa = make_float2(zk.x + zm.x, zk.y - zm.y);  // Z[k] + Z*[M-k]
    const float2 sb = make_float2(zk.x - zm.x, zk.y + zm.y);  // Z[k] - Z*[M-k]
    const float2 wb = cmul(w, sb);
    // X[k] = sa / 2 - i wb / 2;  X[M-k] = conj(sa) / 2 - i conj(wb) / 2
    const float xr = 0.5f * (sa.x + wb.y), xi = 0.5f * (sa.y - wb.x);
    const float yr = 0.5f * (sa.x - wb.y), yi = 0.5f * (-sa.y - wb.x);
    const float ak = sqrtf(fmaxf(xr * xr + xi * xi, 1e-10f));
    const float am = sqrtf(fmaxf(yr * yr + yi * yi, 1e-10f));
    if (kk == 0) {
      buf[sk] = make_float2(ak, am);
    } else {
      buf[sk].x = ak;
      buf[sm].x = am;
    }
  }
  __syncwarp();

  // the sparse mel sums, each over its filter's bins in order, and log10
  const float* amp = reinterpret_cast<const float*>(buf);
  for (int m = lane; m < a.n_mels; m += 32) {
    const int lo = mels[m], n = mels[a.n_mels + m];
    const float* wm = wts + mels[2 * a.n_mels + m];
    float acc = 0.f;
    for (int e = 0; e < n; ++e) {
      const int kb = lo + e;
      const float av = kb == M ? amp[1] : amp[2 * swz(kb)];
      acc = fmaf(wm[e], av, acc);
    }
    o[m] = logf(fmaxf(acc, 1e-10f)) * INV_LN10;
  }
}

template <int LOGM>
int run_fft(const FftArgs& a, int B, size_t smem, cudaStream_t stream) {
  if (a.tf <= 0 || a.tf > FftCfg<LOGM>::TFMAX) return (int)cudaErrorInvalidValue;
  auto kern = fused_logmel_fft_kernel<LOGM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.F + a.tf - 1) / a.tf, B);
  kern<<<grid, 32 * a.tf, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- direct DFT

constexpr int TF = 64;     // frames per CTA
constexpr int KB = 64;     // frequency bins per block
constexpr int NK = 32;     // window rows per basis tile
constexpr int NT = 256;    // threads per CTA
constexpr int MAXM = 128;  // most mel bins
constexpr int MPT = TF * MAXM / NT;  // mel sums per thread
constexpr int AS = KB + 1;           // row stride of the amplitude tile

__global__ void __launch_bounds__(NT) fused_logmel_dft_kernel(
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

// The FFT route.  audio: (B, S) fp32; tab: the config's fp32 tables, n_tab
// floats (a multiple of 4, 16-byte aligned): the FFT's stage twiddles from
// 0, the split's n_fft / 4 + 1 twiddles exp(-2 pi i k / n_fft) from o_split,
// the window's win values from o_win, the mel weights from o_wts (each
// offset a multiple of 4); mels: (3, n_mels) int32, each mel bin's first
// bin, bin count and weight offset; flens: (B,) int32 or null (every frame
// valid); out: (B, F, n_mels) fp32.  n_fft = 2^logn, 6 <= logn <= 12; tf
// frames per CTA; start_off = (n_fft - win) / 2 - n_fft / 2; smem the
// dynamic shared memory in bytes: 8 tf n_fft / 2 + 4 n_tab + 4 * (3 n_mels
// rounded up to 4) + 4 span_len, span_len = (tf - 1) hop + win rounded up to
// 4.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_logmel_fft(const float* audio, const float* tab, const int32_t* mels,
                                    const int32_t* flens, float* out, int B, int S, int F,
                                    int hop, int win, int logn, int n_mels, int start_off,
                                    int tf, int o_split, int o_win, int o_wts, int n_tab,
                                    int span_len, int smem, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || F <= 0 || hop <= 0 || win <= 0 || win > (1 << logn) ||
      n_mels <= 0 || n_tab % 4 != 0 || o_split % 4 != 0 || o_win % 4 != 0 || o_wts % 4 != 0 ||
      smem <= 0 || (reinterpret_cast<uintptr_t>(tab) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const FftArgs a{audio, tab, mels, flens, out, S, F, hop, win, n_mels, start_off,
                  tf, o_split, o_win, o_wts, n_tab, span_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (logn - 1) {
    case 5: return run_fft<5>(a, B, smem, s);
    case 6: return run_fft<6>(a, B, smem, s);
    case 7: return run_fft<7>(a, B, smem, s);
    case 8: return run_fft<8>(a, B, smem, s);
    case 9: return run_fft<9>(a, B, smem, s);
    case 10: return run_fft<10>(a, B, smem, s);
    case 11: return run_fft<11>(a, B, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The direct-DFT route.  audio: (B, S) fp32; wcos, wsin: (win_pad, k_pad)
// fp32, the window's rows of the bases (win_pad a multiple of 32, k_pad of
// 64, both zero-padded); melmat: (k_pad, n_mels) fp32 with zero rows past
// n_freq; flens: (B,) int32 or null (every frame valid); out: (B, F, n_mels)
// fp32.  start_off is the window's first row minus the reflect padding,
// (n_fft - win)/2 - n_fft/2.  Returns the CUDA error code (0 = ok).
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
      fused_logmel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + TF - 1) / TF, B);
  fused_logmel_dft_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, wcos, wsin, melmat, flens, out, S, F, hop, win_pad, k_pad, n_mels,
      start_off, span_len);
  return (int)cudaGetLastError();
}
