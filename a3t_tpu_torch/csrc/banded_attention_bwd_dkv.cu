// Banded self-attention backward, key-chunk pass, for Hopper (sm_90a): dk and
// dv of each speech key chunk from the three query chunks whose bands hold
// it, with the probabilities recomputed from the forward's logsumexp and the
// dropout mask regenerated.
//
// Replaces the TPU kernel a3t_tpu/ops/banded_attention.py::_bwd_dkv_call (the
// pl.pallas_call at :357, grid (b, h, key chunk), whole (c, c) blocks in
// VMEM).  Computes, per (b, h, key chunk j), for each query chunk i = j + off
// (off = -1, 0, 1) that exists, with delta = sum(g * out) per row:
//
//     s   = q_i . k_j^T / sqrt(d),  s = -1e30 where key j is padding (the
//           key chunk's own validity only)
//     p   = exp(s - lse_i)
//     keep: query chunk i's band draw (lane (b * H + h) * nc + i, counter
//           row * 3c + col), columns (1 - off) c .. (2 - off) c, which is
//           where key chunk j sits in chunk i's band
//     dp  = (g_i . v_j^T) * keep / (1 - rate),   p_d = p * keep / (1 - rate)
//     ds  = p * (dp - delta_i) / sqrt(d)
//     dv_j += p_d^T . g_i,   dk_j += ds^T . q_i
//
// A missing neighbour (i < 0 or i >= nc) adds nothing, as the TPU kernel
// weighs it by 0: the phantom copy of an edge chunk that the forward read for
// chunk 0's and chunk nc-1's bands gets no credit.
//
// Design.  A CTA owns (b, h, key chunk j, 32 keys) with their k and v in
// shared memory, and walks the query rows of the three neighbouring chunks in
// tiles of 32 (q, g, lse, delta of a tile in shared memory).  dk and dv of its
// keys stay in registers and are written once, so no two CTAs write the same
// value and the result is bit-reproducible.  256 threads: eight per query row
// for the scores, eight per key for dk and dv; products on the CUDA cores in
// fp32 from shared memory.
//
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256):
//   operations: 3 neighbours x 4 products (s, dp, dv, dk) of 2 c^2 d per key
//          chunk = 24 c d T per (b, h) = 7.73e10 FLOP, over 67 TFLOP/s in
//          fp32 = 1.15 ms;
//   bytes: q, k, v, g, dk, dv (6 x 25 MB in bf16), lse and delta: 0.15 GB over
//          3.35 TB/s = 0.05 ms.
// Bound by operations; shared-memory loads set its pace.  A later design
// moves the four products to wgmma and keeps s and dp for the three
// neighbours in one pass over q.

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ spm, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int L, int d, int c,
    float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout) {
  constexpr int NG = DMAX / 32;  // float4 groups of d per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  const int dp4 = dp / 4;
  const int d4 = (d + 3) / 4;
  float* ks = reinterpret_cast<float*>(smem4);  // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* qs = vs + BN * dp;                     // BM x dp
  float* gs = qs + BM * dp;                     // BM x dp
  float* pds = gs + BM * dp;                    // BM x PS: dropped p
  float* dss = pds + BM * PS;                   // BM x PS: ds (scaled)
  float* rl = dss + BM * PS;                    // BM: lse
  float* rd = rl + BM;                          // BM: delta
  int* kval = reinterpret_cast<int*>(rd + BM);  // BN: key valid
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);

  const int nc = gridDim.y;
  const int j = blockIdx.y;  // the key chunk
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int k0 = blockIdx.x * BN;  // first key of the CTA, within the chunk
  const int tid = threadIdx.x;
  const int hi = tid >> 3;  // a query row (scores) or a key (dk, dv)
  const int lo = tid & 7;   // its eighth of the keys or of d
  const size_t mat = (size_t)bh * L * d;
  const int nk = min(BN, c - k0);

  for (int e = tid; e < BN * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp;
    const bool in = rr < nk && cc < d;
    const size_t off = mat + (size_t)(j * c + k0 + rr) * d + cc;
    ks[e] = in ? to_f(k[off]) : 0.f;
    vs[e] = in ? to_f(v[off]) : 0.f;
  }
  if (tid < BN)
    kval[tid] = tid < nk && spm[(size_t)b * L + j * c + k0 + tid] > 0;

  float4 dk_acc[NG], dv_acc[NG];
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) {
    dk_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int off = -1; off <= 1; ++off) {
    const int iq = j + off;
    if (iq < 0 || iq >= nc) continue;  // the same for the whole CTA
    const uint32_t lane = (uint32_t)(bh * nc + iq);
    const uint32_t col0 = (uint32_t)((1 - off) * c + k0);
    for (int r0 = 0; r0 < c; r0 += BM) {
      __syncthreads();  // the previous query tile is done with qs, gs, pds, dss
      for (int e = tid; e < BM * dp; e += NT) {
        const int rr = e / dp, cc = e - rr * dp, lr = r0 + rr;
        const bool in = lr < c && cc < d;
        const size_t o = mat + (size_t)(iq * c + lr) * d + cc;
        qs[e] = in ? to_f(q[o]) : 0.f;
        gs[e] = in ? to_f(g[o]) : 0.f;
      }
      if (tid < BM) {
        const int lr = r0 + tid;
        rl[tid] = lr < c ? lse[(size_t)bh * L + iq * c + lr] : 0.f;
        rd[tid] = lr < c ? delta[(size_t)bh * L + iq * c + lr] : 0.f;
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
          const int kk = lo + 8 * i;
          s[i] += dot4(a, ks4[kk * dp4 + t]);
          dpv[i] += dot4(gg, vs4[kk * dp4 + t]);
        }
      }
      const int rloc = r0 + hi;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = lo + 8 * i;
        float pd = 0.f, ds = 0.f;
        if (rloc < c && kk < nk) {
          const float x = kval[kk] ? s[i] * scale : NEG;
          const float p = expf(x - rl[hi]);
          float dpk = dpv[i];
          pd = p;
          if (dropout) {
            const uint32_t ctr = (uint32_t)rloc * (uint32_t)(3 * c) + col0 + (uint32_t)kk;
            const bool keep = hash_bits(ctr, seed, lane) >= threshold;
            pd = keep ? p * keep_scale : 0.f;
            dpk = keep ? dpk * keep_scale : 0.f;
          }
          ds = p * (dpk - rd[hi]) * scale;
        }
        pds[hi * PS + kk] = pd;
        dss[hi * PS + kk] = ds;
      }
      __syncthreads();

      // dv and dk of key hi, float4 groups lo + 8 jj
      const int nr = min(BM, c - r0);
      for (int r = 0; r < nr; ++r) {
        const float a = pds[r * PS + hi];
        const float w = dss[r * PS + hi];
        const float4* gr4 = gs4 + r * dp4;
        const float4* qr4 = qs4 + r * dp4;
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const int gi = lo + 8 * jj;
          if (gi < d4) {
            fma4(dv_acc[jj], a, gr4[gi]);
            fma4(dk_acc[jj], w, qr4[gi]);
          }
        }
      }
    }
  }

  if (hi < nk) {
    const size_t o = mat + (size_t)(j * c + k0 + hi) * d;
#pragma unroll
    for (int jj = 0; jj < NG; ++jj) {
      const int col = 4 * (lo + 8 * jj);
      const float kv[4] = {dk_acc[jj].x, dk_acc[jj].y, dk_acc[jj].z, dk_acc[jj].w};
      const float vv[4] = {dv_acc[jj].x, dv_acc[jj].y, dv_acc[jj].z, dv_acc[jj].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < d) {
          store(dk + o + col + e, kv[e]);
          store(dv + o + col + e, vv[e]);
        }
      }
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const int32_t* spm,
           const void* g, const float* lse, const float* delta, void* dk,
           void* dv, int B, int H, int L, int d, int c, float scale,
           uint32_t seed, uint32_t threshold, float keep_scale, int dropout,
           cudaStream_t stream) {
  const int dp = padded_dim(d);
  const size_t smem = (size_t)(2 * BN * dp + 2 * BM * dp + 2 * BM * PS + 2 * BM) * sizeof(float)
                      + BN * sizeof(int);
  auto kern = banded_attention_bwd_dkv_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + BN - 1) / BN, L / c, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), spm, static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, d, c, scale, seed,
      threshold, keep_scale, dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int32_t* spm,
             const void* g, const float* lse, const float* delta, void* dk,
             void* dv, int B, int H, int L, int d, int c, float scale,
             uint32_t seed, uint32_t threshold, float keep_scale, int dropout,
             cudaStream_t s) {
#define A3T_DKV_LAUNCH(DMAX)                                                  \
  return launch<T, DMAX>(q, k, v, spm, g, lse, delta, dk, dv, B, H, L, d, c, \
                         scale, seed, threshold, keep_scale, dropout, s)
  if (d <= 64) A3T_DKV_LAUNCH(64);
  if (d <= 128) A3T_DKV_LAUNCH(128);
  if (d <= 192) A3T_DKV_LAUNCH(192);
  A3T_DKV_LAUNCH(256);
#undef A3T_DKV_LAUNCH
}

}  // namespace

// q, k, v, g: (B, H, L, d) contiguous, L a multiple of c; spm: (B, L) int32;
// lse, delta: (B, H, L) fp32.  dk, dv: (B, H, L, d) in the input type.
// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_banded_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const int32_t* spm,
    const void* g, const float* lse, const float* delta, void* dk, void* dv,
    int B, int H, int L, int d, int c, int dtype, float scale, uint32_t seed,
    uint32_t threshold, float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || c <= 0 ||
      L % c != 0 || L / c > 65535 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, spm, g, lse, delta, dk, dv, B, H, L, d, c,
                           scale, seed, threshold, keep_scale, dropout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, spm, g, lse, delta, dk, dv, B, H,
                                   L, d, c, scale, seed, threshold,
                                   keep_scale, dropout, s);
  return (int)cudaErrorInvalidValue;
}
