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
// Design: two passes, no atomics, so every gradient is the same bit for bit
// from run to run.
//   1. dk/dv pass (FlashAttention-2's key-major loop).  A CTA owns (b, h, 64
//      keys), keeps K and V in shared memory and walks the query tiles of 64;
//      for each it recomputes S^T = K.Q^T and dP^T = V.G^T, p from lse, the
//      keep-mask and ds, writes the dbias tile (each (query, key) tile is
//      written once, by the CTA that owns its keys), and adds P_d^T.G into dv
//      and dS^T.Q into dk, held in registers over all query tiles.
//   2. dq pass.  dbias already holds ds in full, so a CTA owning (b, h, 64
//      query rows) computes dq = ds . k from it, walking the key tiles, with
//      no recompute: one more read of the L^2 ds, in place of summing dq
//      across key tiles with fp32 atomics in an order that changes from run
//      to run.
// Two instantiations of each pass:
//   * bf16 on the tensor cores (wgmma, hopper.cuh).  Pass 1 runs two
//     warpgroups with two roles, so no product is computed twice:
//     warpgroup 0 forms S^T = K.Q^T (m64n64k16 from swizzled shared tiles),
//     p and the keep-mask, hands p to warpgroup 1 through shared memory
//     (negated where dropped; a named barrier orders it) and adds
//     P_d^T.G into dv; warpgroup 1 forms dP^T = V.G^T, ds from that p,
//     writes dbias and adds dS^T.Q into dk.  Each keeps its 64 x d fp32
//     accumulator in registers (96 a thread at d = 192); P_d^T and dS^T are
//     rounded to bf16 in registers as the A operand of m64n(d)k16 with G or
//     Q MN-major.  Q, G and the bias tile are double buffered with cp.async
//     (single above d = 192).  Pass 2 is one warpgroup, m64n(d)k16 with the
//     dS tile K-major and the K tile MN-major, double buffered.  It reads ds
//     as the bf16 dbias: the same rounding that dk already takes through its
//     bf16 dS^T operand (2^-9 relative per element), where an fp32 scratch
//     would cost 4 L^2 B H bytes more (173 MB at the training shape).  P_d
//     and ds in bf16 are roundings the TPU kernel does not have.
//   * fp32 on the CUDA cores in full fp32 (no TF32), register-blocked as in
//     the forward kernel: in pass 1 a thread holds a 4-key x 4-query block
//     of S^T and dP^T and 4 keys x 12 columns of dk and of dv; P_d and ds go
//     through one shared tile, so K, V, Q and G (64 x 192 each) fit.  Pass 2
//     holds 4 rows x 12 columns of dq, key tiles of 32 double buffered.
//
// Dropout is the forward kernel's rule: keep iff hash(row * L + col, seed,
// b * 4096 + h) >= uint32(rate * 0xFFFFFFFF), so the mask regenerates bit
// for bit; dp is scaled by keep / (1 - rate) while ds uses the undropped p.
//
// Bound at the training shape (B=88, H=2, L=496, d=192):
//   fp32: five products of 2 L^2 d per (b, h) = 8.31e10 FLOP over 67
//         TFLOP/s = 1.24 ms, above the bytes (q, k, v, g, out, dq, dk, dv,
//         bias and dbias, lse and delta: 0.88 GB, 0.26 ms);
//   bf16: bytes, 0.44 GB over 3.35 TB/s = 0.132 ms, above the products at
//         989 TFLOP/s (0.084 ms).
// This design does the five products once each and reads ds once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BT = 64;   // keys per CTA in pass 1, query rows per CTA in pass 2
constexpr int BSB = 72;  // row stride (elements) of the bf16 bias tile

struct Args {
  const void *q, *k, *v, *bias;
  const int32_t* mask;
  const void* g;
  const float *lse, *delta;
  void *dq, *dk, *dv, *dbias;
  int B, H, L, d, vec;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- bf16

template <int DPAD, int NST>
__global__ void __launch_bounds__(256, 1) fused_attention_dkdv_bf16_kernel(Args a) {
  constexpr int TILE = BT * DPAD * 2;
  constexpr int STAGE = ((2 * TILE + BT * BSB * 2 + 2 * BT * 4) + 1023) / 1024 * 1024;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TILE;
  uint8_t* stages = vs + TILE;
  // p of the tile, passed from warpgroup 0 to warpgroup 1 in accumulator
  // order, negated where the dropout mask drops it
  float* xbuf = reinterpret_cast<float*>(stages + NST * STAGE);

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* g = static_cast<const bf16*>(a.g);
  const int L = a.L, d = a.d;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w = t >> 5, lane = tid & 31;
  const int g8 = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int col0 = blockIdx.x * BT;
  const size_t mat = (size_t)bh * L * d;
  const size_t sq = (size_t)bh * L * L;
  const uint32_t lane_id = (uint32_t)(b * 4096 + h);
  const bool vc = a.vec != 0;
  auto sw = [](int r, int c) { return sw64(r, c, BT); };
  auto brow = [](int r, int c) { return (uint32_t)((r * BSB + c) * 2); };

  int kr[2], gkey[2];
  bool kvalid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = 16 * w + g8 + 8 * hr;
    gkey[hr] = col0 + kr[hr];
    kvalid[hr] = gkey[hr] < L && a.mask[(size_t)b * L + gkey[hr]] > 0;
  }

  auto load_stage = [&](int st, int r0) {
    uint8_t* qs = stages + st * STAGE;
    uint8_t* gs = qs + TILE;
    uint8_t* bs = gs + TILE;
    float* rl = reinterpret_cast<float*>(bs + BT * BSB * 2);
    load_tile<bf16, 256, BT, DPAD>(qs, q + mat, d, r0, L, 0, d, vc, tid, sw);
    load_tile<bf16, 256, BT, DPAD>(gs, g + mat, d, r0, L, 0, d, vc, tid, sw);
    load_tile<bf16, 256, BT, 64>(bs, static_cast<const bf16*>(a.bias) + sq, L, r0, L, col0, L,
                                 vc, tid, brow);
    if (tid < BT) {
      const int gr = r0 + tid;
      rl[tid] = gr < L ? a.lse[(size_t)bh * L + gr] : 0.f;
      rl[BT + tid] = gr < L ? a.delta[(size_t)bh * L + gr] : 0.f;
    }
  };

  load_tile<bf16, 256, BT, DPAD>(ks, static_cast<const bf16*>(a.k) + mat, d, col0, L, 0, d, vc,
                                 tid, sw);
  load_tile<bf16, 256, BT, DPAD>(vs, static_cast<const bf16*>(a.v) + mat, d, col0, L, 0, d, vc,
                                 tid, sw);
  load_stage(0, 0);
  cp_async_commit();

  // warpgroup 0: S^T = K.Q^T, p, the keep-mask, dv += P_d^T.G;
  // warpgroup 1: dP^T = V.G^T, ds (with warpgroup 0's p), dbias, dk += dS^T.Q
  float acc[DPAD / 2], sc[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  bf16* dbias = static_cast<bf16*>(a.dbias) + sq;

  const int nq = (L + BT - 1) / BT;
  for (int it = 0; it < nq; ++it) {
    const int st = NST == 2 ? (it & 1) : 0, r0 = it * BT;
    if (NST == 2 && it + 1 < nq) {
      load_stage(st ^ 1, r0 + BT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint8_t* qs = stages + st * STAGE;
    const uint8_t* gs = qs + TILE;
    const bf16* bs = reinterpret_cast<const bf16*>(gs + TILE);
    const float* rl = reinterpret_cast<const float*>(bs + BT * BSB);
    const float* rd = rl + BT;

    fence_regs(sc);
    wgmma_fence();
    wgmma_abt64<DPAD>(sc, wg == 0 ? ks : vs, wg == 0 ? qs : gs);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // element i: key kr[(i / 2) % 2], query 8 (i / 4) + 2 qd + i % 2
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e;
          const int gq = r0 + c;
          const float lse_c = rl[c];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr + e;
            float p = 0.f;
            bool keep = true;
            if (kvalid[hr] && gq < L) {
              const float x = (sc[i] + __bfloat162float(bs[c * BSB + kr[hr]])) * a.scale;
              p = __expf(x - lse_c);
              if (a.dropout)
                keep = hash_bits((uint32_t)gq * (uint32_t)L + (uint32_t)gkey[hr], a.seed,
                                 lane_id) >= a.threshold;
            }
            xbuf[i * 128 + t] = keep ? p : -p;
            sc[i] = keep ? (a.dropout ? p * a.keep_scale : p) : 0.f;  // p_d
          }
        }
      named_bar_arrive(1, 256);
    } else {
      named_bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e;
          const int gq = r0 + c;
          const float delta_c = rd[c];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr + e;
            const float x = xbuf[i * 128 + t];
            const float p = fabsf(x);
            float dpk = sc[i];
            if (a.dropout) dpk = x > 0.f ? dpk * a.keep_scale : 0.f;
            const float ds = p * (dpk - delta_c) * a.scale;  // 0 where p is
            sc[i] = ds;
            if (gq < L && gkey[hr] < L) dbias[(size_t)gq * L + gkey[hr]] = __float2bfloat16(ds);
          }
        }
    }

    wgmma_acc_pb<DPAD>(acc, sc, wg == 0 ? gs : qs);
    __syncthreads();  // this stage and xbuf are free
    if (NST == 1 && it + 1 < nq) {
      load_stage(0, r0 + BT);
      cp_async_commit();
    }
  }

  store_acc_bf16<DPAD>(static_cast<bf16*>(wg == 0 ? a.dv : a.dk) + mat + (size_t)col0 * d, d,
                       L - col0, acc, t);
}

template <int DPAD>
__global__ void __launch_bounds__(128) fused_attention_dq_bf16_kernel(Args a) {
  constexpr int TILE = BT * DPAD * 2;
  constexpr int STAGE = TILE + BT * 64 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const int L = a.L, d = a.d;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, row0 = blockIdx.x * BT;
  const size_t mat = (size_t)bh * L * d;
  const bf16* kb = static_cast<const bf16*>(a.k) + mat;
  const bf16* ds = static_cast<const bf16*>(a.dbias) + (size_t)bh * L * L;
  const bool vc = a.vec != 0;
  auto sw = [](int r, int c) { return sw64(r, c, BT); };
  auto load_stage = [&](int st, int c0) {
    uint8_t* kt = base + st * STAGE;
    load_tile<bf16, 128, BT, DPAD>(kt, kb, d, c0, L, 0, d, vc, tid, sw);
    load_tile<bf16, 128, BT, 64>(kt + TILE, ds, L, row0, L, c0, L, vc, tid, sw);
  };

  float acc[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;
  load_stage(0, 0);
  cp_async_commit();
  const int nk = (L + BT - 1) / BT;
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {
      load_stage(st ^ 1, (it + 1) * BT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint8_t* kt = base + st * STAGE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<DPAD, 1>::run(acc, desc_k(kt + TILE, kk, BT), desc_mn(kt, kk, BT), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncthreads();
  }

  store_acc_bf16<DPAD>(static_cast<bf16*>(a.dq) + mat + (size_t)row0 * d, d, L - row0, acc,
                       tid);
}

// ---------------------------------------------------------------- fp32

// acc[i][gg] += w.i * x[gg] for the 4 weights of `wv` and the thread's column
// groups cg + 16 gg of one row of a shared tile
template <int NG>
__device__ __forceinline__ void rank1(float4 (&acc)[4][NG], const float4& wv,
                                      const float4* row, int cg) {
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) {
    const float4 x = row[cg + 16 * gg];
#pragma unroll
    for (int i = 0; i < 4; ++i) fma4(acc[i][gg], lane_of(wv, i), x);
  }
}

template <int DMAX, int BQ>
__global__ void __launch_bounds__(256, 1) fused_attention_dkdv_f32_kernel(Args a) {
  constexpr int NG = DMAX / 64;  // float4 column groups of dk, dv per thread
  constexpr int QI = BQ / 16;    // queries of S^T per thread
  constexpr int DP = DMAX + 4;   // row stride of k, v, q, g (odd in float4s)
  constexpr int DP4 = DP / 4;
  constexpr int PS = BT + 4;     // row stride of the ds / p_d tile
  extern __shared__ float4 smem4[];
  const int L = a.L, d = a.d;
  float* ks = reinterpret_cast<float*>(smem4);  // BT x DP
  float* vs = ks + BT * DP;                     // BT x DP
  float* qs = vs + BT * DP;                     // BQ x DP
  float* gs = qs + BQ * DP;                     // BQ x DP
  float* ps = gs + BQ * DP;                     // BQ x PS: ds, then p_d
  float* rl = ps + BQ * PS;                     // BQ lse, BQ delta
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  float4* ps4 = reinterpret_cast<float4*>(ps);

  const int tid = threadIdx.x, lane = tid & 31;
  const int kg = 2 * (tid >> 5) + (lane >> 4);  // keys 4 kg .. 4 kg + 3
  const int cg = lane & 15;                     // queries cg + 16 i; columns
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int col0 = blockIdx.x * BT;
  const size_t mat = (size_t)bh * L * d;
  const size_t sq = (size_t)bh * L * L;
  const uint32_t lane_id = (uint32_t)(b * 4096 + h);
  const bool vc = a.vec != 0;
  const float* qb = static_cast<const float*>(a.q) + mat;
  const float* gb = static_cast<const float*>(a.g) + mat;
  const float* bias = static_cast<const float*>(a.bias) + sq;
  float* dbias = static_cast<float*>(a.dbias) + sq;
  auto rowd = [](int r, int c) { return (uint32_t)((r * DP + c) * 4); };
  auto as_u8 = [](float* p) { return reinterpret_cast<uint8_t*>(p); };

  bool kvalid[4];
  const int k0 = col0 + 4 * kg;
#pragma unroll
  for (int x = 0; x < 4; ++x) kvalid[x] = k0 + x < L && a.mask[(size_t)b * L + k0 + x] > 0;

  // G (with lse and delta) of query tile r0; Q has its own group so that
  // S^T can start before G lands
  auto load_g = [&](int r0) {
    load_tile<float, 256, BQ, DMAX>(as_u8(gs), gb, d, r0, L, 0, d, vc, tid, rowd);
    if (tid < BQ) {
      const int gr = r0 + tid;
      rl[tid] = gr < L ? a.lse[(size_t)bh * L + gr] : 0.f;
      rl[BQ + tid] = gr < L ? a.delta[(size_t)bh * L + gr] : 0.f;
    }
  };
  load_tile<float, 256, BT, DMAX>(as_u8(ks), static_cast<const float*>(a.k) + mat, d, col0, L,
                                  0, d, vc, tid, rowd);
  load_tile<float, 256, BT, DMAX>(as_u8(vs), static_cast<const float*>(a.v) + mat, d, col0, L,
                                  0, d, vc, tid, rowd);
  load_tile<float, 256, BQ, DMAX>(as_u8(qs), qb, d, 0, L, 0, d, vc, tid, rowd);
  cp_async_commit();
  load_g(0);
  cp_async_commit();

  float4 dka[4][NG], dva[4][NG];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) dka[x][gg] = dva[x][gg] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int r0 = 0; r0 < L; r0 += BQ) {
    const bool next = r0 + BQ < L;
    cp_async_wait<1>();  // Q
    __syncthreads();
    float st[4][QI], dpt[4][QI];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int i = 0; i < QI; ++i) st[x][i] = dpt[x][i] = 0.f;
#pragma unroll 4
    for (int t = 0; t < DMAX / 4; ++t) {
      float4 ka[4], qv[QI];
#pragma unroll
      for (int x = 0; x < 4; ++x) ka[x] = ks4[(4 * kg + x) * DP4 + t];
#pragma unroll
      for (int i = 0; i < QI; ++i) qv[i] = qs4[(cg + 16 * i) * DP4 + t];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int i = 0; i < QI; ++i) st[x][i] = fdot4(ka[x], qv[i], st[x][i]);
    }
    cp_async_wait<0>();  // G, lse, delta
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < DMAX / 4; ++t) {
      float4 va[4], gv[QI];
#pragma unroll
      for (int x = 0; x < 4; ++x) va[x] = vs4[(4 * kg + x) * DP4 + t];
#pragma unroll
      for (int i = 0; i < QI; ++i) gv[i] = gs4[(cg + 16 * i) * DP4 + t];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int i = 0; i < QI; ++i) dpt[x][i] = fdot4(va[x], gv[i], dpt[x][i]);
    }

    // element (key k0 + x, query r0 + cg + 16 i): st -> p_d, dpt -> ds
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      const int qr = cg + 16 * i, gq = r0 + qr;
      const float lse_q = rl[qr], delta_q = rl[BQ + qr];
      float bv[4] = {0.f, 0.f, 0.f, 0.f};
      if (gq < L) {
        const float* brow = bias + (size_t)gq * L + k0;
        if (vc && k0 < L) {
          const float4 b4 = *reinterpret_cast<const float4*>(brow);
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) bv[x] = k0 + x < L ? brow[x] : 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float pd = 0.f, ds = 0.f;
        if (kvalid[x] && gq < L) {
          const float p = __expf((st[x][i] + bv[x]) * a.scale - lse_q);
          float dpk = dpt[x][i];
          pd = p;
          if (a.dropout) {
            const bool keep = hash_bits((uint32_t)gq * (uint32_t)L + (uint32_t)(k0 + x), a.seed,
                                        lane_id) >= a.threshold;
            pd = keep ? p * a.keep_scale : 0.f;
            dpk = keep ? dpk * a.keep_scale : 0.f;
          }
          ds = p * (dpk - delta_q) * a.scale;
        }
        st[x][i] = pd;
        dpt[x][i] = ds;
      }
      const float4 ds4 = make_float4(dpt[0][i], dpt[1][i], dpt[2][i], dpt[3][i]);
      ps4[(qr * PS) / 4 + kg] = ds4;
      if (gq < L) {
        float* drow = dbias + (size_t)gq * L + k0;
        if (vc && k0 < L) {
          *reinterpret_cast<float4*>(drow) = ds4;
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (k0 + x < L) drow[x] = lane_of(ds4, x);
        }
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) rank1(dka, ps4[(r * PS) / 4 + kg], qs4 + r * DP4, cg);
    __syncthreads();  // every thread is done with qs and ds
    if (next) {
      load_tile<float, 256, BQ, DMAX>(as_u8(qs), qb, d, r0 + BQ, L, 0, d, vc, tid, rowd);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < QI; ++i)
      ps4[((cg + 16 * i) * PS) / 4 + kg] = make_float4(st[0][i], st[1][i], st[2][i], st[3][i]);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) rank1(dva, ps4[(r * PS) / 4 + kg], gs4 + r * DP4, cg);
    __syncthreads();  // every thread is done with gs, p_d, lse and delta
    if (next) {
      load_g(r0 + BQ);
      cp_async_commit();
    }
  }

  float* dk = static_cast<float*>(a.dk) + mat;
  float* dv = static_cast<float*>(a.dv) + mat;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (k0 + x >= L) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      const int col = 4 * (cg + 16 * gg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) {
          dk[(size_t)(k0 + x) * d + col + e] = lane_of(dka[x][gg], e);
          dv[(size_t)(k0 + x) * d + col + e] = lane_of(dva[x][gg], e);
        }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(256) fused_attention_dq_f32_kernel(Args a) {
  constexpr int NG = DMAX / 64;
  constexpr int BK = 32;        // keys per stage
  constexpr int DP = DMAX + 4;  // row stride of the K tile
  constexpr int DP4 = DP / 4;
  constexpr int PS = BK + 4;    // row stride of the ds tile
  constexpr int STAGE = BK * DP + BT * PS;  // floats: K tile, then ds tile
  extern __shared__ float4 smem4[];
  const int L = a.L, d = a.d;
  float* base = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, row0 = blockIdx.x * BT;
  const size_t mat = (size_t)bh * L * d;
  const float* kb = static_cast<const float*>(a.k) + mat;
  const float* ds = static_cast<const float*>(a.dbias) + (size_t)bh * L * L;
  const bool vc = a.vec != 0;
  auto rowd = [](int r, int c) { return (uint32_t)((r * DP + c) * 4); };
  auto rowp = [](int r, int c) { return (uint32_t)((r * PS + c) * 4); };
  auto load_stage = [&](int st, int c0) {
    float* kt = base + st * STAGE;
    load_tile<float, 256, BK, DMAX>(reinterpret_cast<uint8_t*>(kt), kb, d, c0, L, 0, d, vc,
                                    tid, rowd);
    load_tile<float, 256, BT, BK>(reinterpret_cast<uint8_t*>(kt + BK * DP), ds, L, row0, L, c0,
                                  L, vc, tid, rowp);
  };

  float4 acc[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) acc[i][gg] = make_float4(0.f, 0.f, 0.f, 0.f);
  load_stage(0, 0);
  cp_async_commit();
  const int nk = (L + BK - 1) / BK;
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {
      load_stage(st ^ 1, (it + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* kt4 = reinterpret_cast<const float4*>(base + st * STAGE);
    const float4* dt4 = kt4 + BK * DP4;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = dt4[((4 * rg + i) * PS + c) / 4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 wx = make_float4(lane_of(w[0], x), lane_of(w[1], x), lane_of(w[2], x),
                                      lane_of(w[3], x));
        rank1(acc, wx, kt4 + (c + x) * DP4, cg);
      }
    }
    __syncthreads();
  }

  float* dq = static_cast<float*>(a.dq) + mat;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 4 * rg + i;
    if (gr >= L) continue;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      const int col = 4 * (cg + 16 * gg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) dq[(size_t)gr * d + col + e] = lane_of(acc[i][gg], e);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename KernelT>
int launch(KernelT kern, size_t smem, int threads, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.L + BT - 1) / BT, a.B * a.H);
  kern<<<grid, threads, smem, a.stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DPAD>
int run_bf16(const Args& a) {
  // Q, G and the bias double buffered up to d = 192 (181 KB), single above
  constexpr int NST = DPAD <= 192 ? 2 : 1;
  constexpr size_t tile = (size_t)BT * DPAD * 2;
  constexpr size_t stage = ((2 * tile + BT * BSB * 2 + 2 * BT * 4) + 1023) / 1024 * 1024;
  int err = launch(fused_attention_dkdv_bf16_kernel<DPAD, NST>,
                   1024 + 2 * tile + NST * stage + 32 * 128 * 4, 256, a);
  if (err != 0) return err;
  return launch(fused_attention_dq_bf16_kernel<DPAD>, 1024 + 2 * (tile + BT * 64 * 2), 128, a);
}

template <int DMAX, int BQ>
int run_f32(const Args& a) {
  constexpr size_t dp = DMAX + 4;
  int err = launch(fused_attention_dkdv_f32_kernel<DMAX, BQ>,
                   ((2 * BT + 2 * BQ) * dp + BQ * (BT + 4) + 2 * BQ) * sizeof(float), 256, a);
  if (err != 0) return err;
  return launch(fused_attention_dq_f32_kernel<DMAX>, 2 * (32 * dp + BT * 36) * sizeof(float), 256, a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k, v, g: (B, H, L, d) contiguous; bias: (B, H, L, L); mask: (B, L)
// int32; lse, delta: (B, H, L) fp32.  dq, dk, dv, dbias in the input type.
// dtype 0 = float32, 1 = bfloat16.  Two launches on `stream` (dk/dv/dbias,
// then dq).  Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const int32_t* mask, const void* g, const float* lse, const float* delta,
    void* dq, void* dk, void* dv, void* dbias, int B, int H, int L, int d,
    int dtype, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunk = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  const int vec = d % chunk == 0 && L % chunk == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(g) && aligned16(bias) && aligned16(dbias);
  const Args a{q, k, v, bias, mask, g, lse, delta, dq, dk, dv, dbias, B, H, L, d, vec,
               scale, seed, threshold, keep_scale, dropout,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (d <= 64) return run_f32<64, 64>(a);
    if (d <= 128) return run_f32<128, 64>(a);
    if (d <= 192) return run_f32<192, 64>(a);
    return run_f32<256, 32>(a);
  }
  if (dtype == 1) {
    if (d <= 64) return run_bf16<64>(a);
    if (d <= 128) return run_bf16<128>(a);
    if (d <= 192) return run_bf16<192>(a);
    return run_bf16<256>(a);
  }
  return (int)cudaErrorInvalidValue;
}
