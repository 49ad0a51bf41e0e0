// Banded self-attention forward with global text keys for Hopper (sm_90a):
// per query chunk of c = window / 2 speech frames, scores against the 3c band
// keys of chunks i-1, i, i+1 and the tt text keys, one joint fp32 softmax,
// optional in-kernel dropout, P.V, and one logsumexp per row.
//
// Replaces the TPU kernel a3t_tpu/ops/banded_attention.py::_fwd_call (the
// pl.pallas_call at :139, grid (b, h, chunk), a whole (c, 3c) block in VMEM).
// Computes, per (b, h, chunk i) and query row r of the chunk:
//
//     band = q_r . k_band^T / sqrt(d)   k_band = [k_{i-1}; k_i; k_{i+1}], the
//                                       missing edge neighbours clipped to
//                                       chunk 0 / nc-1 (the TPU index maps)
//     text = q_r . k_text^T / sqrt(d)
//     s = -1e30 where the band key is a phantom neighbour or padding, or the
//         text token is padding (no re-zeroing: a row whose every key is
//         masked averages all 3c + tt values, as the TPU kernel does)
//     p = exp(s - max) (fp32), denom = sum p (undropped)
//     p *= keep / (1 - rate)     keep from the counter hash
//     out = p . [v_band; v_text] / denom,   lse = max + log(denom)
//
// Design.  c = 256 and d = 192 put 295 KB of bf16 band keys in one chunk, more
// than a CTA's shared memory, so a CTA owns (b, h, chunk, 64 query rows) and
// streams the band keys and then the text keys in tiles of 32 with an online
// softmax (running max, sum and fp32 accumulator); no (c, 3c) block exists
// anywhere.  Each key column of a tile is mapped to its source row (clipped
// chunk, or text token) once, in shared memory.  256 threads, four per query
// row: each holds 8 scores of its row and a quarter of its accumulator in
// registers (float4 groups, d <= 256).  Products run on the CUDA cores in
// fp32 from shared memory (bf16 inputs are converted when a tile is loaded),
// as the TPU kernel accumulates its products in fp32.
//
// Dropout is the TPU kernel's interpret-mode rule (fused_attention.py:64-80):
// lane (b * H + h) * nc + i; counter row * 3c + col for the band draw and
// row * tt + col + 2^20 for the text draw (row, col local to the chunk); keep
// iff the bits are >= uint32(rate * 0xFFFFFFFF).  The counter depends on the
// position only, so the masks equal the Pallas interpret-mode masks bit for
// bit.
//
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256, tt=64):
//   operations: T (12 c d + 4 tt d) per (b, h) = 4.19e10 FLOP, over 67
//          TFLOP/s in fp32 outside the tensor cores = 0.63 ms (0.042 ms at
//          the bf16 tensor-core rate);
//   bytes: q, k, v, out (4 x 25 MB in bf16), text keys and values, masks and
//          lse: 0.10 GB in bf16 over 3.35 TB/s = 0.03 ms.
// So this kernel is bound by operations; its pace is set by shared-memory
// loads (about one 16-byte load per four multiply-adds).  A later design
// moves both products to wgmma on bf16 tiles fed by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 32;       // keys per tile
constexpr int NT = 256;      // threads per CTA: four per query row
constexpr int PS = BN + 4;   // row stride of the probability tile
constexpr uint32_t TEXT_DRAW = 1u << 20;

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kt, const T* __restrict__ vt,
    const int32_t* __restrict__ txm, const int32_t* __restrict__ spm,
    T* __restrict__ out, float* __restrict__ lse, int H, int L, int d, int c,
    int tt, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout) {
  constexpr int NG = DMAX / 16;  // float4 accumulator groups per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  float* qs = reinterpret_cast<float*>(smem4);  // BM x dp
  float* ks = qs + BM * dp;                     // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* ps = vs + BN * dp;                     // BM x PS
  int* krow = reinterpret_cast<int*>(ps + BM * PS);  // BN: source row, -1 = none
  int* kval = krow + BN;                             // BN: key valid

  const int nc = gridDim.y;
  const int ci = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int r0 = blockIdx.x * BM;  // first row of the tile, within the chunk
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // this thread's query row in the tile
  const int j = tid & 3;   // its quarter of the row
  const int rloc = r0 + r;
  const size_t mat = (size_t)bh * L * d;
  const size_t tmat = (size_t)bh * tt * d;
  const uint32_t lane = (uint32_t)(bh * nc + ci);
  const int d4 = (d + 3) / 4;
  const int nband = 3 * c;
  const int nbt = (nband + BN - 1) / BN;
  const int ntiles = nbt + (tt + BN - 1) / BN;

  for (int e = tid; e < BM * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, lr = r0 + rr;
    qs[e] = (lr < c && cc < d) ? to_f(q[mat + (size_t)(ci * c + lr) * d + cc]) : 0.f;
  }

  float4 acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const bool text = tile >= nbt;
    const int c0 = (text ? tile - nbt : tile) * BN;
    const int ncols = text ? tt : nband;
    __syncthreads();  // the previous tile's P.V is done with ks, vs, ps, krow
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
      const int cc = j + 4 * i;
      float x = -INFINITY;  // past the segment's end: no part of the softmax
      if (krow[cc] >= 0) x = kval[cc] ? s[i] * scale : NEG;
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
      const float p = expf(s[i] - m_new);
      rs += p;
      float w = p;
      if (dropout) {
        const uint32_t col = (uint32_t)(c0 + j + 4 * i);
        const uint32_t ctr = text ? (uint32_t)rloc * (uint32_t)tt + col + TEXT_DRAW
                                  : (uint32_t)rloc * (uint32_t)nband + col;
        w = hash_bits(ctr, seed, lane) >= threshold ? p * keep_scale : 0.f;
      }
      s[i] = w;
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
#pragma unroll
    for (int i = 0; i < 8; ++i) ps[r * PS + j + 4 * i] = s[i];
    __syncthreads();

    const int n = min(BN, ncols - c0);
    for (int cc = 0; cc < n; ++cc) {
      const float p = ps[r * PS + cc];
      const float4* v4 = reinterpret_cast<const float4*>(vs + cc * dp);
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

  if (rloc < c) {
    const int grow = ci * c + rloc;
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
int launch(const void* q, const void* k, const void* v, const void* kt,
           const void* vt, const int32_t* txm, const int32_t* spm, void* out,
           float* lse, int B, int H, int L, int d, int c, int tt, float scale,
           uint32_t seed, uint32_t threshold, float keep_scale, int dropout,
           cudaStream_t stream) {
  const int dp = padded_dim(d);
  const size_t smem = (size_t)(BM * dp + 2 * BN * dp + BM * PS) * sizeof(float)
                      + 2 * BN * sizeof(int);
  auto kern = banded_attention_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + BM - 1) / BM, L / c, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(kt),
      static_cast<const T*>(vt), txm, spm, static_cast<T*>(out), lse, H, L, d,
      c, tt, scale, seed, threshold, keep_scale, dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kt,
             const void* vt, const int32_t* txm, const int32_t* spm, void* out,
             float* lse, int B, int H, int L, int d, int c, int tt,
             float scale, uint32_t seed, uint32_t threshold, float keep_scale,
             int dropout, cudaStream_t s) {
#define A3T_FWD_LAUNCH(DMAX)                                                  \
  return launch<T, DMAX>(q, k, v, kt, vt, txm, spm, out, lse, B, H, L, d, c, \
                         tt, scale, seed, threshold, keep_scale, dropout, s)
  if (d <= 64) A3T_FWD_LAUNCH(64);
  if (d <= 128) A3T_FWD_LAUNCH(128);
  if (d <= 192) A3T_FWD_LAUNCH(192);
  A3T_FWD_LAUNCH(256);
#undef A3T_FWD_LAUNCH
}

}  // namespace

// q, k, v: (B, H, L, d) contiguous, L a multiple of c; kt, vt: (B, H, tt, d);
// txm: (B, tt) int32; spm: (B, L) int32.  out: (B, H, L, d) in the input
// type; lse: (B, H, L) fp32.  dtype 0 = float32, 1 = bfloat16.  Returns the
// CUDA error code (0 = ok).
extern "C" int a3t_banded_attention_fwd(
    const void* q, const void* k, const void* v, const void* kt,
    const void* vt, const int32_t* txm, const int32_t* spm, void* out,
    float* lse, int B, int H, int L, int d, int c, int tt, int dtype,
    float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || c <= 0 || tt <= 0 ||
      L % c != 0 || L / c > 65535 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, kt, vt, txm, spm, out, lse, B, H, L, d, c,
                           tt, scale, seed, threshold, keep_scale, dropout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kt, vt, txm, spm, out, lse, B, H,
                                   L, d, c, tt, scale, seed, threshold,
                                   keep_scale, dropout, s);
  return (int)cudaErrorInvalidValue;
}
