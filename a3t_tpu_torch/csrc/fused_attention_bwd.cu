// Fused full-attention backward for Hopper (sm_90a): recompute the
// probabilities from the forward's logsumexp, regenerate the dropout mask,
// and form dq, dk, dv and dbias without an (L, L) probability tensor.
//
// Replaces the TPU kernel a3t_tpu/ops/fused_attention.py::_bwd_call (the
// pl.pallas_call at :178, grid (b, h), one whole (L, L) block in VMEM).
// Computes, per (b, h), with delta = sum(g * out) per row (from the wrapper):
//
//     s   = (q_u . k^T + bias) / sqrt(d),  s = -1e30 where the key is masked
//     p   = exp(s - lse), masked columns re-zeroed
//     keep from the counter hash (the forward kernel's rule)
//     dv  = (p * keep / (1 - rate))^T . g
//     dp  = (g . v^T) * keep / (1 - rate)
//     ds  = p * (dp - delta) / sqrt(d)
//     dq  = ds . k,   dk = ds^T . q_u,   dbias = ds
//
// Design.  A CTA owns (b, h, 32 keys): it keeps the k and v tiles in shared
// memory and walks the queries in tiles of 32 rows.  For each query tile it
// streams q_u, g, the bias tile, lse and delta through shared memory,
// recomputes s and p, writes the dbias tile (each (i, j) tile is written
// exactly once, by the one CTA that owns key tile j), and accumulates dk and
// dv for its 32 keys in registers over all query tiles.  dq reduces over
// keys, which are spread over CTAs: each CTA adds its 32-key share of a
// query tile's dq into a float32 buffer with atomicAdd.  That was chosen
// over a second pass owning query tiles, which would recompute s and dp
// (two more of the five products); the price is a run-dependent summation
// order in dq, about 1e-6 relative in float32.  256 threads; products run on
// the CUDA cores in fp32 from shared memory (bf16 inputs are converted when
// a tile is loaded), as in the forward kernel.
//
// Dropout is the forward kernel's rule: keep iff hash(row * L + col, seed,
// b * 4096 + h) >= uint32(rate * 0xFFFFFFFF), so the mask regenerates bit
// for bit; dp is scaled by keep / (1 - rate) while ds uses the undropped p.
//
// Bound at the training shape (B=88, H=2, L=496, d=192, float32):
//   operations: five products of 2 L^2 d per (b, h) = 10 B H L^2 d
//          = 8.31e10 over 67 TFLOP/s (fp32 outside the tensor cores)
//          = 1.24 ms;
//   bytes: q, k, v, g, out, dq, dk, dv (8 x 67 MB), bias read and dbias
//          write (2 x 173 MB), lse and delta: 0.88 GB over 3.35 TB/s
//          = 0.26 ms.
// So K2 is bound by operations.  This design is far from that bound: every
// product reads its operands from shared memory (about one 16-byte load per
// four fused multiply-adds), so shared-memory bandwidth, not the FMA units,
// sets its pace, and the dq atomics add L2 traffic.  A later design moves
// the products to wgmma (bf16, or TF32 where float32 is asked for) with
// TMA-fed tiles and keeps dq in a second pass or in a cluster's shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BM = 32;       // query rows per step of the query loop
constexpr int BN = 32;       // keys per CTA
constexpr int NT = 256;      // threads per CTA
constexpr int PS = BN + 4;   // row stride of the p / ds tiles

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int L, int d, int dp) {
  for (int e = threadIdx.x; e < rows * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, gr = row0 + rr;
    dst[e] = (gr < L && cc < d) ? to_f(src[(size_t)gr * d + cc]) : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) fused_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int32_t* __restrict__ mask,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dbias, int H,
    int L, int d, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout) {
  constexpr int NG = DMAX / 32;  // float4 groups of d per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  const int dp4 = dp / 4;
  const int d4 = (d + 3) / 4;
  float* ks = reinterpret_cast<float*>(smem4);  // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* qs = vs + BN * dp;                     // BM x dp
  float* gs = qs + BM * dp;                     // BM x dp
  float* ps = gs + BM * dp;                     // BM x PS: bias, then dropped p
  float* dss = ps + BM * PS;                    // BM x PS: ds
  float* rl = dss + BM * PS;                    // BM: lse
  float* rd = rl + BM;                          // BM: delta
  int* kvalid = reinterpret_cast<int*>(rd + BM);  // BN
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int hi = tid >> 3;  // a query row (scores, dq) or a key (dk, dv)
  const int lo = tid & 7;   // its eighth of the columns or of d
  const size_t mat = (size_t)bh * L * d;
  const size_t sq = (size_t)bh * L * L;
  const uint32_t lane = (uint32_t)(b * 4096 + h);
  const int nc = min(BN, L - col0);

  load_tile(ks, k + mat, col0, BN, L, d, dp);
  load_tile(vs, v + mat, col0, BN, L, d, dp);
  if (tid < BN) {
    const int gc = col0 + tid;
    kvalid[tid] = gc < L && mask[(size_t)b * L + gc] > 0;
  }

  float4 dk_acc[NG], dv_acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    dk_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int row0 = 0; row0 < L; row0 += BM) {
    __syncthreads();  // the previous query tile is done with qs, gs, ps, dss
    load_tile(qs, q + mat, row0, BM, L, d, dp);
    load_tile(gs, g + mat, row0, BM, L, d, dp);
    for (int e = tid; e < BM * BN; e += NT) {
      const int rr = e / BN, cc = e - rr * BN;
      const int gr = row0 + rr, gc = col0 + cc;
      ps[rr * PS + cc] = (gr < L && gc < L) ? to_f(bias[sq + (size_t)gr * L + gc]) : 0.f;
    }
    if (tid < BM) {
      const int gr = row0 + tid;
      rl[tid] = gr < L ? lse[(size_t)bh * L + gr] : 0.f;
      rd[tid] = gr < L ? delta[(size_t)bh * L + gr] : 0.f;
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
        const int c = lo + 8 * i;
        s[i] += dot4(a, ks4[c * dp4 + t]);
        dpv[i] += dot4(gg, vs4[c * dp4 + t]);
      }
    }
    const int gr = row0 + hi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lo + 8 * i;
      float pd = 0.f, ds = 0.f;
      if (gr < L && kvalid[c]) {  // keys masked or past L: p = 0
        const float p = expf((s[i] + ps[hi * PS + c]) * scale - rl[hi]);
        float dpk = dpv[i];
        pd = p;
        if (dropout) {
          const bool keep = hash_bits((uint32_t)gr * (uint32_t)L + (uint32_t)(col0 + c),
                                      seed, lane) >= threshold;
          pd = keep ? p * keep_scale : 0.f;
          dpk = keep ? dpk * keep_scale : 0.f;
        }
        ds = p * (dpk - rd[hi]) * scale;
      }
      ps[hi * PS + c] = pd;  // this thread alone read this bias entry
      dss[hi * PS + c] = ds;
    }
    __syncthreads();

    // dbias tile, row by row
    for (int e = tid; e < BM * BN; e += NT) {
      const int rr = e / BN, cc = e - rr * BN;
      const int r = row0 + rr, c = col0 + cc;
      if (r < L && c < L) store(dbias + sq + (size_t)r * L + c, dss[rr * PS + cc]);
    }

    // dv and dk of key hi, float4 groups lo + 8 j
    const int nr = min(BM, L - row0);
    for (int r = 0; r < nr; ++r) {
      const float a = ps[r * PS + hi];
      const float w = dss[r * PS + hi];
      const float4* gr4 = gs4 + r * dp4;
      const float4* qr4 = qs4 + r * dp4;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int gi = lo + 8 * j;
        if (gi < d4) {
          fma4(dv_acc[j], a, gr4[gi]);
          fma4(dk_acc[j], w, qr4[gi]);
        }
      }
    }

    // this key tile's share of dq for row hi
    if (gr < L) {
      float4 acc[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < nc; ++c) {
        const float w = dss[hi * PS + c];
        const float4* kc4 = ks4 + c * dp4;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int gi = lo + 8 * j;
          if (gi < d4) fma4(acc[j], w, kc4[gi]);
        }
      }
      float* dqr = dq + mat + (size_t)gr * d;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int col = 4 * (lo + 8 * j);
        if (col < d) {
          const float vals[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d) atomicAdd(dqr + col + e, vals[e]);
        }
      }
    }
  }

  if (hi < nc) {
    const size_t off = mat + (size_t)(col0 + hi) * d;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * (lo + 8 * j);
      if (col < d) {
        const float kv[4] = {dk_acc[j].x, dk_acc[j].y, dk_acc[j].z, dk_acc[j].w};
        const float vv[4] = {dv_acc[j].x, dv_acc[j].y, dv_acc[j].z, dv_acc[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < d) {
            store(dk + off + col + e, kv[e]);
            store(dv + off + col + e, vv[e]);
          }
        }
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const int32_t* mask, const void* g, const float* lse,
           const float* delta, float* dq, void* dk, void* dv, void* dbias,
           int B, int H, int L, int d, float scale, uint32_t seed,
           uint32_t threshold, float keep_scale, int dropout,
           cudaStream_t stream) {
  const int dp = padded_dim(d);
  const size_t smem = (size_t)(2 * BN * dp + 2 * BM * dp + 2 * BM * PS + 2 * BM) * sizeof(float)
                      + BN * sizeof(int);
  auto kern = fused_attention_bwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BN - 1) / BN, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias), mask,
      static_cast<const T*>(g), lse, delta, dq, static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(dbias), H, L, d, scale, seed,
      threshold, keep_scale, dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias,
             const int32_t* mask, const void* g, const float* lse,
             const float* delta, float* dq, void* dk, void* dv, void* dbias,
             int B, int H, int L, int d, float scale, uint32_t seed,
             uint32_t threshold, float keep_scale, int dropout,
             cudaStream_t s) {
#define A3T_BWD_LAUNCH(DMAX)                                                  \
  return launch<T, DMAX>(q, k, v, bias, mask, g, lse, delta, dq, dk, dv,     \
                         dbias, B, H, L, d, scale, seed, threshold,          \
                         keep_scale, dropout, s)
  if (d <= 64) A3T_BWD_LAUNCH(64);
  if (d <= 128) A3T_BWD_LAUNCH(128);
  if (d <= 192) A3T_BWD_LAUNCH(192);
  A3T_BWD_LAUNCH(256);
#undef A3T_BWD_LAUNCH
}

}  // namespace

// q, k, v, g: (B, H, L, d) contiguous; bias: (B, H, L, L); mask: (B, L)
// int32; lse, delta: (B, H, L) fp32.  dq: (B, H, L, d) fp32, zeroed by the
// caller (the kernel adds into it); dk, dv, dbias in the input type.
// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const int32_t* mask, const void* g, const float* lse, const float* delta,
    float* dq, void* dk, void* dv, void* dbias, int B, int H, int L, int d,
    int dtype, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, bias, mask, g, lse, delta, dq, dk, dv,
                           dbias, B, H, L, d, scale, seed, threshold,
                           keep_scale, dropout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, bias, mask, g, lse, delta, dq, dk,
                                   dv, dbias, B, H, L, d, scale, seed,
                                   threshold, keep_scale, dropout, s);
  return (int)cudaErrorInvalidValue;
}
