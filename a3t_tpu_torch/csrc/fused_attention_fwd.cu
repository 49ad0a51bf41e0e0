// Fused full-attention forward for Hopper (sm_90a): scores + key mask +
// fp32 softmax + optional in-kernel dropout + P.V, with one logsumexp per row.
//
// Replaces the TPU kernel a3t_tpu/ops/fused_attention.py::_fwd_call (the
// pl.pallas_call at :121, grid (b, h), one whole (L, L) score block in VMEM).
// Computes, per (b, h):
//
//     s   = (q_u . k^T + bias) / sqrt(d)          bias = rel-shifted pos scores
//     s   = -1e30 where the key is masked
//     p   = softmax(s) (fp32); masked columns re-zeroed
//     p  *= keep / (1 - rate)                     keep from the counter hash
//     out = p . v,  lse = max + log(sum)
//
// Design.  A CTA owns (b, h, 64 query rows) and walks the keys in tiles of 32
// with an online softmax (running max, sum and fp32 accumulator), so no
// (L, L) block ever exists: the bias tile is streamed through shared memory
// once, which is the only L^2 traffic.  256 threads, four per query row; each
// thread holds 8 scores of its row and a quarter of the row's accumulator in
// registers (float4 groups, d <= 256).  Products run on the CUDA cores in
// fp32 (inputs converted to fp32 in shared memory), matching the TPU kernel's
// fp32-accumulated dot products; bf16 inputs are read as bf16.
//
// Dropout is the TPU kernel's interpret-mode rule (fused_attention.py:69-80):
// an xxhash-style mix of counter row*L + col, seed and lane b*4096 + h; keep
// iff bits >= uint32(rate * 0xFFFFFFFF).  The counter depends on position
// only, so the tiling does not change it and the masks equal the Pallas
// interpret-mode masks bit for bit.  The denominator stays undropped.
//
// Bound at the slice's shape (B=1, H=2, L=552, d=192):
//   bytes: q, k, v, out 4 x 2 x 552 x 192 x 4 B = 3.39 MB, bias
//          2 x 552^2 x 4 B = 2.44 MB, mask + lse 6.6 kB: 5.84 MB over
//          3.35 TB/s = 1.74 us;
//   operations: 2 products x 2 x 552^2 x 192 x 2 heads = 0.468 GFLOP over
//          67 TFLOP/s (fp32 outside the tensor cores) = 6.99 us.
// So in fp32 this kernel is bound by operations on the CUDA cores, not by the
// bias bytes; in bf16 (0.47 us of operations at 989 TFLOP/s against 0.87 us
// of bytes) it would be bound by bytes.  It is far from either bound: the
// grid has only B*H*ceil(L/64) = 18 CTAs for 132 SMs, and each score costs
// shared-memory loads.  A later design splits the key loop across CTAs (or
// uses 16-row tiles) to fill the card, moves the products to wgmma with
// TMA-fed double-buffered K/V/bias tiles, and in bf16 keeps the bias as the
// one L^2 read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 32;       // keys per tile
constexpr int NT = 256;      // threads per CTA: four per query row
constexpr int PS = BN + 4;   // row stride of the bias / probability tile

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) fused_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int32_t* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, int H, int L, int d,
    float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout) {
  constexpr int NG = DMAX / 16;  // float4 accumulator groups per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  float* qs = reinterpret_cast<float*>(smem4);  // BM x dp
  float* ks = qs + BM * dp;                     // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* ps = vs + BN * dp;                     // BM x PS

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // this thread's query row in the tile
  const int j = tid & 3;   // its quarter of the row
  const int grow = row0 + r;
  const size_t mat = (size_t)bh * L * d;
  const T* qb = q + mat;
  const T* kb = k + mat;
  const T* vb = v + mat;
  const T* bb = bias + (size_t)bh * L * L;
  const int32_t* mb = mask + (size_t)b * L;
  const uint32_t lane = (uint32_t)(b * 4096 + h);
  const int d4 = (d + 3) / 4;

  for (int e = tid; e < BM * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, gr = row0 + rr;
    qs[e] = (gr < L && cc < d) ? to_f(qb[(size_t)gr * d + cc]) : 0.f;
  }

  float4 acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int c0 = 0; c0 < L; c0 += BN) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    for (int e = tid; e < BN * dp; e += NT) {
      const int rr = e / dp, cc = e - rr * dp, gc = c0 + rr;
      const bool in = gc < L && cc < d;
      const size_t off = (size_t)gc * d + cc;
      ks[e] = in ? to_f(kb[off]) : 0.f;
      vs[e] = in ? to_f(vb[off]) : 0.f;
    }
    for (int e = tid; e < BM * BN; e += NT) {
      const int rr = e / BN, cc = e - rr * BN;
      const int gr = row0 + rr, gc = c0 + cc;
      ps[rr * PS + cc] = (gr < L && gc < L) ? to_f(bb[(size_t)gr * L + gc]) : 0.f;
    }
    __syncthreads();

    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(qs + r * dp);
    for (int t = 0; t < d4; ++t) {
      const float4 a = q4[t];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 kk = reinterpret_cast<const float4*>(ks + (j + 4 * i) * dp)[t];
        s[i] += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
    }

    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gc = c0 + j + 4 * i;
      float x = -INFINITY;  // past the end: no part of the softmax
      if (gc < L) {
        x = (s[i] + ps[r * PS + j + 4 * i]) * scale;
        if (mb[gc] <= 0) x = NEG;
      }
      s[i] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gc = c0 + j + 4 * i;
      const float p = expf(s[i] - m_new);
      rs += p;
      bool keep = gc < L && mb[gc] > 0;
      float w = p;
      if (dropout) {
        keep = keep && hash_bits((uint32_t)grow * (uint32_t)L + (uint32_t)gc, seed, lane) >= threshold;
        w = p * keep_scale;
      }
      s[i] = keep ? w : 0.f;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g].x *= alpha;
      acc[g].y *= alpha;
      acc[g].z *= alpha;
      acc[g].w *= alpha;
    }

    __syncthreads();  // every thread has read its bias
#pragma unroll
    for (int i = 0; i < 8; ++i) ps[r * PS + j + 4 * i] = s[i];
    __syncthreads();

    const int nc = min(BN, L - c0);
    for (int c = 0; c < nc; ++c) {
      const float p = ps[r * PS + c];
      const float4* v4 = reinterpret_cast<const float4*>(vs + c * dp);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int gi = j + 4 * g;
        if (gi < d4) {
          const float4 vv = v4[gi];
          acc[g].x += p * vv.x;
          acc[g].y += p * vv.y;
          acc[g].z += p * vv.z;
          acc[g].w += p * vv.w;
        }
      }
    }
  }

  if (grow < L) {
    const float inv = 1.f / l_i;
    T* ob = out + mat + (size_t)grow * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 4 * (j + 4 * g);
      if (col < d) {
        const float vals[4] = {acc[g].x, acc[g].y, acc[g].z, acc[g].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) store(ob + col + e, vals[e] * inv);
      }
    }
    if (j == 0) lse[(size_t)bh * L + grow] = m_i + logf(l_i);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const int32_t* mask, void* out, float* lse, int B, int H, int L,
           int d, float scale, uint32_t seed, uint32_t threshold,
           float keep_scale, int dropout, cudaStream_t stream) {
  const int dp = padded_dim(d);
  const size_t smem = (size_t)(BM * dp + 2 * BN * dp + BM * PS) * sizeof(float);
  auto kern = fused_attention_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias), mask,
      static_cast<T*>(out), lse, H, L, d, scale, seed, threshold, keep_scale,
      dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias,
             const int32_t* mask, void* out, float* lse, int B, int H, int L,
             int d, float scale, uint32_t seed, uint32_t threshold,
             float keep_scale, int dropout, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, bias, mask, out, lse, B, H, L, d, scale,
                         seed, threshold, keep_scale, dropout, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, bias, mask, out, lse, B, H, L, d, scale,
                          seed, threshold, keep_scale, dropout, stream);
  return launch<T, 256>(q, k, v, bias, mask, out, lse, B, H, L, d, scale,
                        seed, threshold, keep_scale, dropout, stream);
}

}  // namespace

// q_u, k, v: (B, H, L, d) contiguous; bias: (B, H, L, L); mask: (B, L) int32;
// out: (B, H, L, d) in the input type; lse: (B, H, L) fp32.
// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    const int32_t* mask, void* out, float* lse, int B, int H, int L, int d,
    int dtype, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, bias, mask, out, lse, B, H, L, d, scale,
                           seed, threshold, keep_scale, dropout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, bias, mask, out, lse, B, H, L, d,
                                   scale, seed, threshold, keep_scale, dropout, s);
  return (int)cudaErrorInvalidValue;
}
