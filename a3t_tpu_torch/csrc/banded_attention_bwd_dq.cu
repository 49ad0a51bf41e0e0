// Banded self-attention backward, query-chunk pass, for Hopper (sm_90a):
// recompute each query row's probabilities over its 3c band keys and tt text
// keys from the forward's logsumexp, regenerate the dropout mask, and form dq;
// also the global text keys' gradients dk_text and dv_text, summed over every
// query row of a (b, h).
//
// Replaces the TPU kernel a3t_tpu/ops/banded_attention.py::_bwd_dq_call (the
// pl.pallas_call at :249, grid (b, h, chunk), a whole (c, 3c) block in VMEM,
// dk_text/dv_text accumulated across the sequential chunk axis of the grid).
// Computes, per (b, h, chunk i) and query row r, with delta = sum(g * out)
// per row (from the wrapper):
//
//     s     = masked band / text scores, exactly as the forward (-1e30 where
//             masked, phantom neighbours read from the clipped chunk)
//     p     = exp(s - lse)          (1 on a row whose every key is masked)
//     dp    = (g . v^T) * keep / (1 - rate),   p_d = p * keep / (1 - rate)
//     ds    = p * (dp - delta) / sqrt(d)
//     dq    = ds_band . k_band + ds_text . k_text
//     dk_text += ds_text^T . q,     dv_text += p_d_text^T . g
//
// Design.  A CTA owns (b, h, chunk, 32 query rows) and streams the band keys,
// then the text keys, in tiles of 32 (k and v of a tile in shared memory); dq
// of its rows stays in registers over all tiles and is written once.  The
// text-key gradients reduce over all query rows of a (b, h), which are spread
// over CTAs: each CTA writes its 32 rows' share for every text key to a
// partial buffer of its own, and a second launch of this library sums the
// partials in a fixed order.  So the result is bit-reproducible from run to
// run, unlike an fp32 atomicAdd (whose order changes).  The caller may skip
// the text gradients (the fully masked text block that stands in for missing
// text has none that are used).  256 threads, eight per query row; products
// on the CUDA cores in fp32 from shared memory, as in the forward kernel.
//
// Dropout regenerates the forward's masks bit for bit: lane (b * H + h) * nc +
// i, counter row * 3c + col (band) and row * tt + col + 2^20 (text).
//
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256, tt=64):
//   operations: T (18 c d + 10 tt d) per (b, h) = 6.60e10 FLOP (s, dp and dq
//          over 3c band keys, those and dk_text, dv_text over the text keys),
//          over 67 TFLOP/s in fp32 = 0.99 ms;
//   bytes: q, k, v, g, dq (5 x 25 MB in bf16), lse, delta, text keys, values
//          and gradients: 0.13 GB over 3.35 TB/s = 0.04 ms (plus the partial
//          buffers, which no bound counts).
// Bound by operations; shared-memory loads set its pace, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BM = 32;       // query rows per CTA
constexpr int BN = 32;       // keys per tile
constexpr int NT = 256;      // threads per CTA: eight per query row
constexpr int PS = BN + 4;   // row stride of the ds / p tiles
constexpr uint32_t TEXT_DRAW = 1u << 20;

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kt, const T* __restrict__ vt,
    const int32_t* __restrict__ txm, const int32_t* __restrict__ spm,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ parts, int H, int L, int d, int c, int tt,
    int text_grads, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout) {
  constexpr int NG = DMAX / 32;  // float4 groups of d per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  const int dp4 = dp / 4;
  const int d4 = (d + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);  // BM x dp
  float* gs = qs + BM * dp;                     // BM x dp
  float* ks = gs + BM * dp;                     // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* dss = vs + BN * dp;                    // BM x PS: ds (scaled)
  float* pds = dss + BM * PS;                   // BM x PS: dropped p
  float* rl = pds + BM * PS;                    // BM: lse
  float* rd = rl + BM;                          // BM: delta
  int* krow = reinterpret_cast<int*>(rd + BM);  // BN: source row, -1 = none
  int* kval = krow + BN;                        // BN: key valid
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  const int nc = gridDim.y;
  const int ci = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int hi = tid >> 3;  // a query row (scores, dq) or a text key (partials)
  const int lo = tid & 7;   // its eighth of the keys or of d
  const int rloc = r0 + hi;
  const bool row_ok = rloc < c;
  const size_t mat = (size_t)bh * L * d;
  const size_t tmat = (size_t)bh * tt * d;
  const uint32_t lane = (uint32_t)(bh * nc + ci);
  const int nband = 3 * c;
  const int nbt = (nband + BN - 1) / BN;
  const int ntiles = nbt + (tt + BN - 1) / BN;
  const int n_parts = nc * gridDim.x;
  const int part = ci * gridDim.x + blockIdx.x;

  for (int e = tid; e < BM * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, lr = r0 + rr;
    const bool in = lr < c && cc < d;
    const size_t off = mat + (size_t)(ci * c + lr) * d + cc;
    qs[e] = in ? to_f(q[off]) : 0.f;
    gs[e] = in ? to_f(g[off]) : 0.f;
  }
  if (tid < BM) {
    const int lr = r0 + tid;
    rl[tid] = lr < c ? lse[(size_t)bh * L + ci * c + lr] : 0.f;
    rd[tid] = lr < c ? delta[(size_t)bh * L + ci * c + lr] : 0.f;
  }

  float4 dq_acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) dq_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = 0; tile < ntiles; ++tile) {
    const bool text = tile >= nbt;
    const int c0 = (text ? tile - nbt : tile) * BN;
    const int ncols = text ? tt : nband;
    __syncthreads();  // the previous tile is done with ks, vs, dss, pds, krow
    if (tid < BN) {
      const int col = c0 + tid;
      int src = -1, valid = 0;
      if (col < ncols) {
        if (text) {
          src = col;
          valid = txm[(size_t)b * tt + col] > 0;
        } else {
          const int nb = ci + col / c - 1;  // neighbour chunk, maybe phantom
          const int within = col % c;
          src = min(max(nb, 0), nc - 1) * c + within;
          valid = nb >= 0 && nb < nc && spm[(size_t)b * L + nb * c + within] > 0;
        }
      }
      krow[tid] = src;
      kval[tid] = valid;
    }
    __syncthreads();
    const T* kb = text ? kt + tmat : k + mat;
    const T* vb = text ? vt + tmat : v + mat;
    for (int e = tid; e < BN * dp; e += NT) {
      const int rr = e / dp, cc = e - rr * dp, src = krow[rr];
      const bool in = src >= 0 && cc < d;
      const size_t off = (size_t)src * d + cc;
      ks[e] = in ? to_f(kb[off]) : 0.f;
      vs[e] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores and dp for row hi, keys lo + 8 i
    float s[4], dpv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = dpv[i] = 0.f;
    const float4* q4 = qs4 + hi * dp4;
    const float4* g4 = gs4 + hi * dp4;
    for (int t = 0; t < d4; ++t) {
      const float4 a = q4[t];
      const float4 gg = g4[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = lo + 8 * i;
        s[i] += dot4(a, ks4[cc * dp4 + t]);
        dpv[i] += dot4(gg, vs4[cc * dp4 + t]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = lo + 8 * i;
      float pd = 0.f, ds = 0.f;
      if (row_ok && krow[cc] >= 0) {
        const float x = kval[cc] ? s[i] * scale : NEG;
        const float p = expf(x - rl[hi]);
        float dpk = dpv[i];
        pd = p;
        if (dropout) {
          const uint32_t col = (uint32_t)(c0 + cc);
          const uint32_t ctr = text ? (uint32_t)rloc * (uint32_t)tt + col + TEXT_DRAW
                                    : (uint32_t)rloc * (uint32_t)nband + col;
          const bool keep = hash_bits(ctr, seed, lane) >= threshold;
          pd = keep ? p * keep_scale : 0.f;
          dpk = keep ? dpk * keep_scale : 0.f;
        }
        ds = p * (dpk - rd[hi]) * scale;
      }
      dss[hi * PS + cc] = ds;
      pds[hi * PS + cc] = pd;
    }
    __syncthreads();

    // this tile's share of dq for row hi, float4 groups lo + 8 j
    const int n = min(BN, ncols - c0);
    for (int cc = 0; cc < n; ++cc) {
      const float w = dss[hi * PS + cc];
      const float4* kc4 = ks4 + cc * dp4;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int gi = lo + 8 * j;
        if (gi < d4) fma4(dq_acc[j], w, kc4[gi]);
      }
    }

    // this CTA's share of dk_text and dv_text for text key c0 + hi
    if (text && text_grads && hi < n) {
      float4 ak[NG], av[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        ak[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        av[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = 0; r < BM; ++r) {
        const float w = dss[r * PS + hi];
        const float a = pds[r * PS + hi];
        const float4* qr4 = qs4 + r * dp4;
        const float4* gr4 = gs4 + r * dp4;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int gi = lo + 8 * j;
          if (gi < d4) {
            fma4(ak[j], w, qr4[gi]);
            fma4(av[j], a, gr4[gi]);
          }
        }
      }
      const size_t slab = ((size_t)bh * n_parts + part) * tt * d + (size_t)(c0 + hi) * d;
      float* pk = parts + slab;
      float* pv = parts + (size_t)gridDim.z * n_parts * tt * d + slab;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int col = 4 * (lo + 8 * j);
        const float kv[4] = {ak[j].x, ak[j].y, ak[j].z, ak[j].w};
        const float vv[4] = {av[j].x, av[j].y, av[j].z, av[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < d) {
            pk[col + e] = kv[e];
            pv[col + e] = vv[e];
          }
        }
      }
    }
  }

  if (row_ok) {
    T* dqr = dq + mat + (size_t)(ci * c + rloc) * d;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * (lo + 8 * j);
      const float vals[4] = {dq_acc[j].x, dq_acc[j].y, dq_acc[j].z, dq_acc[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) store(dqr + col + e, vals[e]);
    }
  }
}

// dk_text / dv_text = the sum of the CTAs' partials, in the order of the
// partials: out[w][bh][i] = sum_p parts[w][bh][p][i] for i < tt * d.
__global__ void __launch_bounds__(NT) banded_text_grad_sum_kernel(
    const float* __restrict__ parts, float* __restrict__ dkt,
    float* __restrict__ dvt, int n_parts, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int bh = blockIdx.y;
  const int w = blockIdx.z;
  const float* src = parts + ((size_t)w * gridDim.y + bh) * n_parts * n + i;
  float acc = 0.f;
  for (int p = 0; p < n_parts; ++p) acc += src[(size_t)p * n];
  (w == 0 ? dkt : dvt)[(size_t)bh * n + i] = acc;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* kt,
           const void* vt, const int32_t* txm, const int32_t* spm,
           const void* g, const float* lse, const float* delta, void* dq,
           float* dkt, float* dvt, float* parts, int B, int H, int L, int d,
           int c, int tt, int text_grads, float scale, uint32_t seed,
           uint32_t threshold, float keep_scale, int dropout,
           cudaStream_t stream) {
  const int dp = padded_dim(d);
  const size_t smem = (size_t)(2 * BM * dp + 2 * BN * dp + 2 * BM * PS + 2 * BM) * sizeof(float)
                      + 2 * BN * sizeof(int);
  auto kern = banded_attention_bwd_dq_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (c + BM - 1) / BM;
  const dim3 grid(row_tiles, L / c, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(kt),
      static_cast<const T*>(vt), txm, spm, static_cast<const T*>(g), lse,
      delta, static_cast<T*>(dq), parts, H, L, d, c, tt, text_grads, scale,
      seed, threshold, keep_scale, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess || !text_grads) return (int)err;
  const int n = tt * d;
  const dim3 sum_grid((n + NT - 1) / NT, B * H, 2);
  banded_text_grad_sum_kernel<<<sum_grid, NT, 0, stream>>>(
      parts, dkt, dvt, row_tiles * (L / c), n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kt,
             const void* vt, const int32_t* txm, const int32_t* spm,
             const void* g, const float* lse, const float* delta, void* dq,
             float* dkt, float* dvt, float* parts, int B, int H, int L, int d,
             int c, int tt, int text_grads, float scale, uint32_t seed,
             uint32_t threshold, float keep_scale, int dropout,
             cudaStream_t s) {
#define A3T_DQ_LAUNCH(DMAX)                                                   \
  return launch<T, DMAX>(q, k, v, kt, vt, txm, spm, g, lse, delta, dq, dkt,  \
                         dvt, parts, B, H, L, d, c, tt, text_grads, scale,    \
                         seed, threshold, keep_scale, dropout, s)
  if (d <= 64) A3T_DQ_LAUNCH(64);
  if (d <= 128) A3T_DQ_LAUNCH(128);
  if (d <= 192) A3T_DQ_LAUNCH(192);
  A3T_DQ_LAUNCH(256);
#undef A3T_DQ_LAUNCH
}

}  // namespace

// q, k, v, g: (B, H, L, d) contiguous, L a multiple of c; kt, vt: (B, H, tt,
// d); txm: (B, tt) int32; spm: (B, L) int32; lse, delta: (B, H, L) fp32.
// dq: (B, H, L, d) in the input type.  With text_grads: dkt, dvt (B, H, tt, d)
// fp32 and the scratch parts (2, B, H, (L / c) * ceil(c / 32), tt, d) fp32;
// without, all three may be null.  dtype 0 = float32, 1 = bfloat16.  Returns
// the CUDA error code (0 = ok).
extern "C" int a3t_banded_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* kt,
    const void* vt, const int32_t* txm, const int32_t* spm, const void* g,
    const float* lse, const float* delta, void* dq, float* dkt, float* dvt,
    float* parts, int B, int H, int L, int d, int c, int tt, int dtype,
    int text_grads, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || c <= 0 || tt <= 0 ||
      L % c != 0 || L / c > 65535 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (text_grads && (!dkt || !dvt || !parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, kt, vt, txm, spm, g, lse, delta, dq, dkt,
                           dvt, parts, B, H, L, d, c, tt, text_grads, scale,
                           seed, threshold, keep_scale, dropout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kt, vt, txm, spm, g, lse, delta,
                                   dq, dkt, dvt, parts, B, H, L, d, c, tt,
                                   text_grads, scale, seed, threshold,
                                   keep_scale, dropout, s);
  return (int)cudaErrorInvalidValue;
}
