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
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256):
//   operations: 3 neighbours x 4 products (s, dp, dv, dk) of 2 c^2 d per key
//          chunk = 24 c d T per (b, h) (7.65e10 FLOP for the 3 nc - 2 pairs
//          that exist): 0.077 ms at 989 TFLOP/s in bf16, 1.14 ms at 67
//          TFLOP/s in fp32;
//   bytes: q, k, v, g, dk, dv (6 x 25 MB in bf16), lse and delta: 0.15 GB over
//          3.35 TB/s = 0.05 ms.
// Bound by operations in both types.
//
// Design, bf16 (the longformer's type): K2's dk/dv pass (FlashAttention-2's
//   key-major loop) with the band as the query range, on the steps that
//   hopper.cuh shares with K2.  A CTA owns (b, h, key chunk j, 64 keys) with
//   K and V in swizzled shared memory, and walks the 64-row query tiles of
//   the chunks j-1, j, j+1 that exist (12 tiles at c = 256, 8 at the edges),
//   Q, G, lse and delta double-buffered through cp.async; rows past a
//   chunk's end are zero-filled and get p = 0.  Two warpgroups in two roles,
//   so no product is computed twice: warpgroup 0 forms S^T = K.Q^T
//   (m64n64k16), p and the keep-mask, hands p to warpgroup 1 through shared
//   memory (negated where dropped; a named barrier orders it) and adds
//   P_d^T.G into dv; warpgroup 1 forms dP^T = V.G^T and ds and adds dS^T.Q
//   into dk.  P_d^T and dS^T are rounded to bf16 in registers as the A
//   operand (G and Q MN-major); dk and dv, 64 x d fp32 per warpgroup, stay in
//   registers and are written once, so no two CTAs write the same value and
//   the result is the same bit for bit in every run.
// Design, fp32 (full fp32 on the CUDA cores, no TF32): a CTA owns 32 keys
//   and walks the neighbours' query rows in tiles of 32 through shared
//   memory, eight threads per query row for the scores, eight per key for
//   dk and dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

struct Args {
  const void *q, *k, *v;
  const int32_t* spm;
  const void* g;
  const float *lse, *delta;
  void *dk, *dv;
  int B, H, L, d, c, vec;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- bf16

constexpr int KB = 64;  // keys per CTA, query rows per tile

template <int DPAD>
struct DkvBf16 {
  static constexpr int TILE = KB * DPAD * 2;
  static constexpr int STAGE = (2 * TILE + 2 * KB * 4 + 1023) / 1024 * 1024;  // Q, G, lse, delta
  static constexpr int SMEM = 1024 + 2 * TILE + 2 * STAGE + 32 * 128 * 4;
};

template <int DPAD>
__global__ void __launch_bounds__(256, 1) banded_attention_bwd_dkv_bf16_kernel(Args a) {
  using S = DkvBf16<DPAD>;
  constexpr int TILE = S::TILE, STAGE = S::STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TILE;
  uint8_t* stages = vs + TILE;
  // p of the tile, passed from warpgroup 0 to warpgroup 1 in accumulator
  // order, negated where the dropout mask drops it
  float* xbuf = reinterpret_cast<float*>(stages + 2 * STAGE);

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* g = static_cast<const bf16*>(a.g);
  const int L = a.L, d = a.d, c = a.c;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w = t >> 5, lane = tid & 31;
  const int g8 = lane >> 2, qd = lane & 3;
  const int nc = gridDim.y, j = blockIdx.y, bh = blockIdx.z, b = bh / a.H;
  const int k0 = blockIdx.x * KB;  // the CTA's first key within the chunk
  const size_t mat = (size_t)bh * L * d;
  const int nbt = (c + KB - 1) / KB;  // query tiles per neighbour chunk
  const int first = j > 0 ? -1 : 0;   // the neighbours that exist: first .. last
  const int last = j < nc - 1 ? 1 : 0;
  const int ntiles = (last - first + 1) * nbt;
  const bool vc = a.vec != 0;
  auto sw = [](int r, int col) { return sw64(r, col, KB); };

  // this thread's two keys: element i of a score tile is key kr[(i / 2) %
  // 2], query row 8 (i / 4) + 2 qd + i % 2 of the tile
  int kr[2];
  bool kex[2], kvalid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = 16 * w + g8 + 8 * hr;
    kex[hr] = k0 + kr[hr] < c;
    kvalid[hr] = kex[hr] && a.spm[(size_t)b * L + j * c + k0 + kr[hr]] > 0;
  }

  auto load_stage = [&](int st, int it) {
    const int row0 = (j + first + it / nbt) * c, w0 = (it % nbt) * KB;
    uint8_t* qs = stages + st * STAGE;
    uint8_t* gs = qs + TILE;
    float* rl = reinterpret_cast<float*>(gs + TILE);
    load_tile<bf16, 256, KB, DPAD>(qs, q + mat, d, row0 + w0, row0 + c, 0, d, vc, tid, sw);
    load_tile<bf16, 256, KB, DPAD>(gs, g + mat, d, row0 + w0, row0 + c, 0, d, vc, tid, sw);
    if (tid < KB) {
      const bool in = w0 + tid < c;
      const size_t o = (size_t)bh * L + row0 + w0 + tid;
      rl[tid] = in ? a.lse[o] : 0.f;
      rl[KB + tid] = in ? a.delta[o] : 0.f;
    }
  };

  load_tile<bf16, 256, KB, DPAD>(ks, static_cast<const bf16*>(a.k) + mat, d, j * c + k0,
                                 j * c + c, 0, d, vc, tid, sw);
  load_tile<bf16, 256, KB, DPAD>(vs, static_cast<const bf16*>(a.v) + mat, d, j * c + k0,
                                 j * c + c, 0, d, vc, tid, sw);
  load_stage(0, 0);
  cp_async_commit();

  // warpgroup 0: S^T = K.Q^T, p, the keep-mask, dv += P_d^T.G;
  // warpgroup 1: dP^T = V.G^T, ds (with warpgroup 0's p), dk += dS^T.Q
  float acc[DPAD / 2], sc[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_stage(st ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint8_t* qs = stages + st * STAGE;
    const uint8_t* gs = qs + TILE;
    const float* rl = reinterpret_cast<const float*>(gs + TILE);
    const float* rd = rl + KB;
    const int off = first + it / nbt, w0 = (it % nbt) * KB;

    fence_regs(sc);
    wgmma_fence();
    wgmma_abt64<DPAD>(sc, wg == 0 ? ks : vs, wg == 0 ? qs : gs);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    if (wg == 0) {
      // query chunk j + off's band draw, at key chunk j's block 1 - off
      const uint32_t lane_id = (uint32_t)(bh * nc + j + off);
      const uint32_t col0 = (uint32_t)((1 - off) * c + k0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * jj + 2 * qd + e;
          const int row = w0 + qc;  // within query chunk j + off
          const float lse_c = rl[qc];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * jj + 2 * hr + e;
            float p = 0.f;
            bool keep = true;
            if (kex[hr] && row < c) {
              const float x = kvalid[hr] ? sc[i] * a.scale : NEG;
              p = __expf(x - lse_c);
              if (a.dropout)
                keep = hash_bits((uint32_t)row * (uint32_t)(3 * c) + col0 + (uint32_t)kr[hr],
                                 a.seed, lane_id) >= a.threshold;
            }
            xbuf[i * 128 + t] = keep ? p : -p;
            sc[i] = keep ? (a.dropout ? p * a.keep_scale : p) : 0.f;  // p_d
          }
        }
      named_bar_arrive(1, 256);
    } else {
      named_bar_sync(1, 256);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float delta_c = rd[8 * jj + 2 * qd + e];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * jj + 2 * hr + e;
            const float x = xbuf[i * 128 + t];
            float dpk = sc[i];
            if (a.dropout) dpk = x > 0.f ? dpk * a.keep_scale : 0.f;
            sc[i] = fabsf(x) * (dpk - delta_c) * a.scale;  // ds, 0 where p is
          }
        }
    }

    wgmma_acc_pb<DPAD>(acc, sc, wg == 0 ? gs : qs);
    __syncthreads();  // this stage and xbuf are free
  }

  store_acc_bf16<DPAD>(static_cast<bf16*>(wg == 0 ? a.dv : a.dk) + mat + (size_t)(j * c + k0) * d,
                       d, c - k0, acc, t);
}

// ---------------------------------------------------------------- fp32

constexpr int BM = 32;       // query rows per step of the query loop
constexpr int BN = 32;       // keys per CTA
constexpr int NT = 256;      // threads per CTA
constexpr int PS = BN + 4;   // row stride of the p / ds tiles

template <int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ spm, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int L, int d, int c,
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
    ks[e] = in ? k[off] : 0.f;
    vs[e] = in ? v[off] : 0.f;
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
        qs[e] = in ? q[o] : 0.f;
        gs[e] = in ? g[o] : 0.f;
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
          dk[o + col + e] = kv[e];
          dv[o + col + e] = vv[e];
        }
      }
    }
  }
}

template <int DPAD>
int run_bf16(const Args& a) {
  constexpr int smem = DkvBf16<DPAD>::SMEM;
  auto kern = banded_attention_bwd_dkv_bf16_kernel<DPAD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c + KB - 1) / KB, a.L / a.c, a.B * a.H);
  kern<<<grid, 256, smem, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DMAX>
int run_f32(const Args& a) {
  const int dp = padded_dim(a.d);
  const size_t smem = (size_t)(2 * BN * dp + 2 * BM * dp + 2 * BM * PS + 2 * BM) * sizeof(float)
                      + BN * sizeof(int);
  auto kern = banded_attention_bwd_dkv_f32_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c + BN - 1) / BN, a.L / a.c, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.spm, static_cast<const float*>(a.g), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.L, a.d, a.c, a.scale,
      a.seed, a.threshold, a.keep_scale, a.dropout);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g);
  const Args a{q, k, v, spm, g, lse, delta, dk, dv, B, H, L, d, c, vec, scale, seed, threshold,
               keep_scale, dropout, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (d <= 64) return run_f32<64>(a);
    if (d <= 128) return run_f32<128>(a);
    if (d <= 192) return run_f32<192>(a);
    return run_f32<256>(a);
  }
  if (dtype == 1) {
    if (d <= 64) return run_bf16<64>(a);
    if (d <= 128) return run_bf16<128>(a);
    if (d <= 192) return run_bf16<192>(a);
    return run_bf16<256>(a);
  }
  return (int)cudaErrorInvalidValue;
}
