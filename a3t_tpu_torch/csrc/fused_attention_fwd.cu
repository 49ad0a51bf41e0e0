// Fused full-attention forward for Hopper (sm_90a): scores + key mask +
// fp32 softmax + optional in-kernel dropout + P.V, with one logsumexp per row.
//
// Replaces the TPU kernel a3t_tpu/ops/fused_attention.py::_fwd_call (the
// pl.pallas_call at :121, grid (b, h), one whole (L, L) score block in VMEM).
// Computes, per (b, h):
//
//     s   = (q_u . k^T + bias) / sqrt(d)          bias = rel-shifted pos scores,
//                                                 (Lq, Lk) per (b, h)
//     s   = -1e30 where the key is masked
//     p   = softmax(s) (fp32); masked columns re-zeroed
//     p  *= keep / (1 - rate)                     keep from the counter hash
//     out = p . v,  lse = max + log(sum)
//
// Design.  A CTA owns (b, h, a tile of query rows, one range of keys) and
// walks the keys in tiles with an online softmax, so no (L, L) block exists:
// the bias is read once, the only L^2 traffic.  Two instantiations:
//   * bf16: two warpgroups (256 threads), 64 query rows each, sharing the
//     K and V tiles of 64 keys, which stream through a ring of three stages
//     (two at d > 192) in 64-byte-swizzled shared memory (hopper.cuh),
//     loaded with cp.async two tiles ahead.  S = Q.K^T is wgmma m64n64k16
//     over d / 16 k-steps, fp32 accumulators; each thread loads its own
//     bias fragment from device memory one tile ahead, while the products
//     run; the scale, mask, online softmax and dropout hash run on the
//     accumulator registers; P is rounded to bf16 in registers and is the A
//     operand of O += P.V, wgmma m64n(d)k16 with V MN-major.  P in bf16 is a
//     rounding the TPU kernel does not have (it multiplies p in fp32): 2^-9
//     relative per element, averaged in the sum.  196 KB of shared memory
//     and 204 registers a thread at d = 192: one CTA per SM.
//   * fp32: 256 threads on the CUDA cores in full fp32 (no TF32), 64 query
//     rows, key tiles of 32 above d = 128 (64 up to it).  Thread (rg, cg)
//     holds a 4 x (tile / 16) block of S (rows 4 rg.., keys cg + 16 j) and a
//     4 x 12 block of O (columns in float4 groups cg + 16 g); Q stays in
//     shared memory, K has its own buffer and V shares a group with the bias
//     tile, loaded with cp.async one step ahead; P overwrites the bias in
//     place.  110 KB of shared memory and <= 128 registers at d = 192, so two
//     CTAs share an SM.  A shared-memory load serves one float per lane per
//     cycle whatever the broadcast, against four FMAs per lane per cycle on
//     the SM's four schedulers: S takes 4 x 2 FMAs per 6 floats it reads and
//     P.V 48 per 16, so shared memory, not the FMA units, sets the pace.
// Query blocks.  The call's Lq query rows may be a block of the Lk keys'
// rows (a rank of the mesh's seq axis: its frame block, then the text): local
// row i is global row i + qoff below qsplit and i + Lk - Lq from there on.
// The scores take the rank's rows of q and of the bias, every key, and the
// dropout counter of the global row, so a block draws exactly the bits of
// those rows of the square call.  Square calls have Lq = Lk = qsplit, qoff 0.
// Ragged edges: tiles past Lq or Lk load zeros, keys past L or past the CTA's range
// take no part in the softmax, masked keys take -1e30; a fully masked row
// ends with out 0 and lse -1e30 + log L, as in the plain version.
//
// Grid.  (ceil(Lq / rows), B * H, splits), rows = 64 (fp32) or 128 (bf16).
// At the serving shapes (B * H = 2, L = 296-872) the row tiles alone give
// 10-28 CTAs for 132 SMs, so the wrapper's plan
// (ops/fused_attention.py::_fwd_plan) splits the keys into ranges (multiples
// of 16 keys) until the grid holds >= 132 CTAs where L allows it; each CTA
// then writes its unnormalised fp32 (acc, max, sum) and a second launch
// combines the ranges of a row in a fixed order, so the output does not
// depend on scheduling.  The training shape (1408 fp32 row tiles, 704 bf16)
// is not split.
//
// Dropout is the TPU kernel's interpret-mode rule (fused_attention.py:69-80):
// an xxhash-style mix of counter global_row*Lk + col, seed and lane b*4096 + head0 + h
// (head0: the global index of the call's first head, non-zero where the
// heads are a model-axis rank's slice of a layer's); keep
// iff bits >= uint32(rate * 0xFFFFFFFF).  The counter depends on position
// only, so neither tiling nor splitting changes the mask.  The denominator
// stays undropped.
//
// Bound at (B, H, L, d) = (88, 2, 496, 192), the training shape:
//   fp32: 2 products x 2 L^2 d x B H = 3.33e10 FLOP over 67 TFLOP/s =
//         0.496 ms, above the bytes (q, k, v, out, bias: 0.441 GB, 0.132 ms);
//   bf16: bytes, 0.221 GB over 3.35 TB/s = 0.066 ms, above the products at
//         989 TFLOP/s (0.034 ms).
// At the serving shape (1, 2, 552, 192) fp32: 7.0 us of operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // query rows per CTA, fp32
constexpr int BM_BF16 = 128;  // query rows per CTA, bf16: 64 per warpgroup

// key flag: 1 valid, 0 masked (-1e30), -1 past L or past the CTA's range
__device__ __forceinline__ int key_flag(const int32_t* mb, int c, int kend) {
  return c < kend ? (mb[c] > 0 ? 1 : 0) : -1;
}

__device__ __forceinline__ float masked_score(float x, int flag) {
  return flag > 0 ? x : (flag == 0 ? NEG : -INFINITY);
}

// where the CTA writes: out/lse directly, or its split's partials
struct Partials {
  float* acc;  // (splits, B*H, Lq, d) unnormalised
  float* m;    // (splits, B*H, Lq)
  float* l;    // (splits, B*H, Lq)
};

// the global row of local query row i (the dropout counter's row)
__device__ __forceinline__ uint32_t global_row(int i, int qsplit, int qoff, int Lq, int Lk) {
  return (uint32_t)(i + (i < qsplit ? qoff : Lk - Lq));
}

__device__ __forceinline__ Partials partials(float* part, int split, int BH, int bh, int L, int d) {
  const int S = gridDim.z;
  Partials p;
  p.acc = part + ((size_t)split * BH + bh) * L * d;
  p.m = part + (size_t)S * BH * L * d + ((size_t)split * BH + bh) * L;
  p.l = p.m + (size_t)S * BH * L;
  return p;
}

// ---------------------------------------------------------------- bf16

// bias pairs (rows r, r + 8; columns c0 + 8 j + 2 qd, + 1) of one key tile,
// in the accumulator's order, as packed bf16x2
__device__ __forceinline__ void load_bias(uint32_t (&bv)[16], const bf16* bb, int Lq,
                                          int Lk, int r, int col, bool vec) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gr = r + 8 * hr, gc = col + 8 * j;
      const bf16* src = bb + (size_t)gr * Lk + gc;
      uint32_t x = 0;
      if (gr < Lq) {
        if (vec) {
          if (gc < Lk) x = *reinterpret_cast<const uint32_t*>(src);
        } else {
          const unsigned short lo = gc < Lk ? __bfloat16_as_ushort(src[0]) : 0;
          const unsigned short hi = gc + 1 < Lk ? __bfloat16_as_ushort(src[1]) : 0;
          x = (uint32_t)lo | ((uint32_t)hi << 16);
        }
      }
      bv[2 * j + hr] = x;
    }
}

template <int DPAD, int STAGES>
__global__ void __launch_bounds__(256, 1) fused_attention_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ bias,
    const int32_t* __restrict__ mask, bf16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, int H, int Lq, int Lk, int d,
    int kps, int vec, int head0, int qsplit, int qoff, float scale, uint32_t seed,
    uint32_t threshold, float keep_scale, int dropout) {
  constexpr int TILE = 64 * DPAD * 2;  // bytes of one 64-row tile
  constexpr int STAGE = 2 * TILE + 1024;  // K, V and the key flags
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);  // two 64-row tiles, one per warpgroup
  uint8_t* stages = qs + 2 * TILE;

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int row0 = blockIdx.x * BM_BF16;
  const int kbeg = blockIdx.z * kps, kend = min(Lk, kbeg + kps);
  const int ntiles = (kend - kbeg + 63) / 64;
  const size_t qmat = (size_t)bh * Lq * d, kmat = (size_t)bh * Lk * d;
  const bf16* kb = k + kmat;
  const bf16* vb = v + kmat;
  const bf16* bb = bias + (size_t)bh * Lq * Lk;
  const int32_t* mb = mask + (size_t)b * Lk;
  const uint32_t lane_id = (uint32_t)(b * 4096 + head0 + h);
  const bool vc = vec != 0;
  auto sw = [](int r, int c) { return sw64(r, c, 64); };

  // tile t of the key range into its stage of the ring (nothing past the end)
  auto load_kv = [&](int t) {
    if (t >= ntiles) return;
    uint8_t* st = stages + (t % STAGES) * STAGE;
    const int c0 = kbeg + 64 * t;
    load_tile<bf16, 256, 64, DPAD>(st, kb, d, c0, Lk, 0, d, vc, tid, sw);
    load_tile<bf16, 256, 64, DPAD>(st + TILE, vb, d, c0, Lk, 0, d, vc, tid, sw);
    if (tid < 64) reinterpret_cast<int*>(st + 2 * TILE)[tid] = key_flag(mb, c0 + tid, kend);
  };

  load_tile<bf16, 256, BM_BF16, DPAD>(qs, q + qmat, d, row0, Lq, 0, d, vc, tid,
                                      [](int r, int c) {
                                        return (uint32_t)((r >> 6) * TILE) + sw64(r & 63, c, 64);
                                      });
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    load_kv(t);
    cp_async_commit();
  }

  const uint8_t* qw = qs + wg * TILE;
  const int rl0 = 16 * w + g;  // this thread's rows rl0 and rl0 + 8 of its warpgroup's 64
  const int rbase = row0 + 64 * wg + rl0;
  // the rows' global indices, for the dropout counter
  const uint32_t grow[2] = {global_row(rbase, qsplit, qoff, Lq, Lk),
                            global_row(rbase + 8, qsplit, qoff, Lq, Lk)};
  float o[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  uint32_t bias_next[16];
  load_bias(bias_next, bb, Lq, Lk, rbase, kbeg + 2 * qd, vc);

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = kbeg + 64 * t;
    cp_async_wait<STAGES - 2>();  // tile t (later tiles may be in flight)
    fence_async_shared();
    __syncthreads();  // ... for every thread; every warp is done with tile t - 1
    load_kv(t + STAGES - 1);
    cp_async_commit();
    const uint8_t* ks = stages + (t % STAGES) * STAGE;
    const uint8_t* vs = ks + TILE;
    const int* kf = reinterpret_cast<const int*>(ks + 2 * TILE);

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DPAD / 16; ++kk)
      WgmmaSS<64, 0>::run(s, desc_k(qw, kk, 64), desc_k(ks, kk, 64), kk > 0);
    wgmma_commit();
    // the next tile's bias lands while this tile's products run
    uint32_t bias_cur[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) bias_cur[i] = bias_next[i];
    if (t + 1 < ntiles) load_bias(bias_next, bb, Lq, Lk, rbase, c0 + 64 + 2 * qd, vc);
    wgmma_wait();
    fence_regs(s);

    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int flag = kf[8 * j + 2 * qd + e];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const uint32_t bp = bias_cur[2 * j + hr];
          const float bv = __uint_as_float(e == 0 ? bp << 16 : bp & 0xFFFF0000u);
          s[i] = masked_score((s[i] + bv) * scale, flag);
          mt[hr] = fmaxf(mt[hr], s[i]);
        }
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      const float m_new = fmaxf(m_r[hr], mt[hr]);
      alpha[hr] = __expf(m_r[hr] - m_new);
      m_r[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * qd + e;
        const int flag = kf[c];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float p = __expf(s[i] - m_r[hr]);
          rs[hr] += p;
          bool keep = flag > 0;
          float wt = p;
          if (dropout) {
            keep = keep && hash_bits(grow[hr] * (uint32_t)Lk + (uint32_t)(c0 + c), seed,
                                     lane_id) >= threshold;
            wt = p * keep_scale;
          }
          s[i] = keep ? wt : 0.f;
        }
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_r[hr] = l_r[hr] * alpha[hr] + rs[hr];
    }
#pragma unroll
    for (int i = 0; i < DPAD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4][4];
    acc_to_a(s, pa);

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DPAD, 1>::run(o, pa[kk], desc_mn(vs, kk, 64), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }

  const int BH = gridDim.y;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = rbase + 8 * hr;  // the local row
    if (gr >= Lq) continue;
    if (part == nullptr) {
      const float inv = 1.f / l_r[hr];
      bf16* orow = out + qmat + (size_t)gr * d;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e;
          if (c < d) orow[c] = __float2bfloat16(o[4 * j + 2 * hr + e] * inv);
        }
      if (qd == 0) lse[(size_t)bh * Lq + gr] = m_r[hr] + logf(l_r[hr]);
    } else {
      const Partials pt = partials(part, blockIdx.z, BH, bh, Lq, d);
      float* arow = pt.acc + (size_t)gr * d;
#pragma unroll
      for (int j = 0; j < DPAD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * qd + e;
          if (c < d) arow[c] = o[4 * j + 2 * hr + e];
        }
      if (qd == 0) {
        pt.m[gr] = m_r[hr];
        pt.l[gr] = l_r[hr];
      }
    }
  }
}

// ---------------------------------------------------------------- fp32

template <int DMAX, int BN, int MINB>
__global__ void __launch_bounds__(256, MINB) fused_attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const int32_t* __restrict__ mask, float* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, int H, int Lq, int Lk, int d,
    int kps, int vec, int head0, int qsplit, int qoff, float scale, uint32_t seed,
    uint32_t threshold, float keep_scale, int dropout) {
  constexpr int NG = DMAX / 64;  // float4 column groups of O per thread
  constexpr int NJ = BN / 16;    // keys of S per thread
  constexpr int DP = DMAX + 4;   // row stride of q, k, v (odd in float4s)
  constexpr int DP4 = DP / 4;
  constexpr int PS = BN + 4;     // row stride of the bias / P tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BM x DP
  float* ks = qs + BM * DP;                     // BN x DP
  float* vs = ks + BN * DP;                     // BN x DP
  float* ps = vs + BN * DP;                     // BM x PS: bias, then P
  int* kf = reinterpret_cast<int*>(ps + BM * PS);  // BN key flags
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  const float4* ps4 = reinterpret_cast<const float4*>(ps);

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int kbeg = blockIdx.z * kps, kend = min(Lk, kbeg + kps);
  const size_t qmat = (size_t)bh * Lq * d, kmat = (size_t)bh * Lk * d;
  const float* kb = k + kmat;
  const float* vb = v + kmat;
  const float* bb = bias + (size_t)bh * Lq * Lk;
  const int32_t* mb = mask + (size_t)b * Lk;
  const uint32_t lane_id = (uint32_t)(b * 4096 + head0 + h);
  const bool vc = vec != 0;
  auto rowd = [](int r, int c) { return (uint32_t)((r * DP + c) * 4); };
  auto rowp = [](int r, int c) { return (uint32_t)((r * PS + c) * 4); };
  auto as_u8 = [](float* p) { return reinterpret_cast<uint8_t*>(p); };

  // columns d..DMAX of every tile load as zeros, so the products run over
  // DMAX with no bounds checks.  K goes alone; V goes with the bias tile and
  // the key flags, which the scores read after the product Q.K^T.
  auto load_k = [&](int c0) {
    load_tile<float, 256, BN, DMAX>(as_u8(ks), kb, d, c0, Lk, 0, d, vc, tid, rowd);
  };
  auto load_v = [&](int c0) {
    load_tile<float, 256, BN, DMAX>(as_u8(vs), vb, d, c0, Lk, 0, d, vc, tid, rowd);
    load_tile<float, 256, BM, BN>(as_u8(ps), bb, Lk, row0, Lq, c0, Lk, vc, tid, rowp);
    if (tid < BN) kf[tid] = key_flag(mb, c0 + tid, kend);
  };

  load_tile<float, 256, BM, DMAX>(as_u8(qs), q + qmat, d, row0, Lq, 0, d, vc, tid, rowd);
  load_k(kbeg);
  cp_async_commit();
  load_v(kbeg);
  cp_async_commit();

  float4 o[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) o[i][gg] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }

  for (int c0 = kbeg; c0 < kend; c0 += BN) {
    const bool next = c0 + BN < kend;
    cp_async_wait<1>();  // Q and this K (V and the bias may be in flight)
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[i][jj] = 0.f;
#pragma unroll (MINB == 2 ? 2 : 4)
    for (int t = 0; t < DMAX / 4; ++t) {
      float4 a[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs4[(4 * rg + i) * DP4 + t];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kk[jj] = ks4[(cg + 16 * jj) * DP4 + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) s[i][jj] = fdot4(a[i], kk[jj], s[i][jj]);
    }

    cp_async_wait<0>();  // V, the bias tile and the key flags
    __syncthreads();     // ... and every thread is done with ks
    if (next) {
      load_k(c0 + BN);
      cp_async_commit();
    }

    // each thread reads the bias at the places where it then writes P
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = cg + 16 * jj;
        const float x = (s[i][jj] + ps[(4 * rg + i) * PS + c]) * scale;
        s[i][jj] = masked_score(x, kf[c]);
        mt = fmaxf(mt, s[i][jj]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_r[i], mt);
      const float alpha = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      float rs = 0.f;
      const uint32_t gr = global_row(row0 + 4 * rg + i, qsplit, qoff, Lq, Lk);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = cg + 16 * jj;
        const float p = __expf(s[i][jj] - m_new);
        rs += p;
        bool keep = kf[c] > 0;
        float wt = p;
        if (dropout) {
          keep = keep && hash_bits(gr * (uint32_t)Lk + (uint32_t)(c0 + c), seed, lane_id) >= threshold;
          wt = p * keep_scale;
        }
        ps[(4 * rg + i) * PS + c] = keep ? wt : 0.f;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[i] = l_r[i] * alpha + rs;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        o[i][gg].x *= alpha;
        o[i][gg].y *= alpha;
        o[i][gg].z *= alpha;
        o[i][gg].w *= alpha;
      }
    }
    __syncthreads();  // P written

#pragma unroll 2
    for (int c = 0; c < BN; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps4[((4 * rg + i) * PS + c) / 4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float4 vv = vs4[(c + x) * DP4 + cg + 16 * gg];
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(o[i][gg], lane_of(pa[i], x), vv);
        }
      }
    }

    __syncthreads();  // every thread is done with vs, ps and kf
    if (next) {
      load_v(c0 + BN);
      cp_async_commit();
    }
  }

  const int BH = gridDim.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 4 * rg + i;
    if (gr >= Lq) continue;
    const bool direct = part == nullptr;
    const float inv = direct ? 1.f / l_r[i] : 1.f;
    float* orow;
    if (direct) {
      orow = out + qmat + (size_t)gr * d;
    } else {
      orow = partials(part, blockIdx.z, BH, bh, Lq, d).acc + (size_t)gr * d;
    }
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      const int col = 4 * (cg + 16 * gg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) orow[col + e] = lane_of(o[i][gg], e) * inv;
    }
    if (cg == 0) {
      if (direct) {
        lse[(size_t)bh * Lq + gr] = m_r[i] + logf(l_r[i]);
      } else {
        const Partials pt = partials(part, blockIdx.z, BH, bh, Lq, d);
        pt.m[gr] = m_r[i];
        pt.l[gr] = l_r[i];
      }
    }
  }
}

// ---------------------------------------------------------------- combine

// One warp per (b, h, query row): the key ranges' partials, in split order.
template <typename T>
__global__ void __launch_bounds__(128) fused_attention_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out,
    float* __restrict__ lse, int BH, int L, int d, int S) {
  const size_t n = (size_t)BH * L;
  const size_t idx = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= n) return;
  const float* pm = part + (size_t)S * n * d;
  const float* pl = pm + (size_t)S * n;
  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[s * n + idx]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += expf(pm[s * n + idx] - m) * pl[s * n + idx];
  const float inv = 1.f / l;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += expf(pm[s * n + idx] - m) * part[(s * n + idx) * d + c];
    store(out + idx * d + c, acc * inv);
  }
  if (lane == 0) lse[idx] = m + logf(l);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *bias;
  const int32_t* mask;
  void* out;
  float *lse, *part;
  int B, H, Lq, Lk, d, splits, kps, vec, head0, qsplit, qoff;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
  cudaStream_t stream;
};

template <int DPAD>
int launch_bf16(const Args& a) {
  // a ring of three K/V stages up to d = 192 (196 KB), two above
  constexpr int STAGES = DPAD <= 192 ? 3 : 2;
  const size_t smem = 1024 + 2 * (size_t)64 * DPAD * 2 + STAGES * (2 * (size_t)64 * DPAD * 2 + 1024);
  auto kern = fused_attention_fwd_bf16_kernel<DPAD, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + BM_BF16 - 1) / BM_BF16, a.B * a.H, a.splits);
  kern<<<grid, 256, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.bias), a.mask,
      static_cast<bf16*>(a.out), a.lse, a.splits > 1 ? a.part : nullptr, a.H, a.Lq,
      a.Lk, a.d, a.kps, a.vec, a.head0, a.qsplit, a.qoff, a.scale, a.seed, a.threshold,
      a.keep_scale, a.dropout);
  return (int)cudaGetLastError();
}

template <int DMAX, int BN, int MINB>
int launch_f32(const Args& a) {
  const size_t smem = ((size_t)(BM + 2 * BN) * (DMAX + 4) + BM * (BN + 4) + BN) * sizeof(float);
  auto kern = fused_attention_fwd_f32_kernel<DMAX, BN, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + BM - 1) / BM, a.B * a.H, a.splits);
  kern<<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.bias), a.mask,
      static_cast<float*>(a.out), a.lse, a.splits > 1 ? a.part : nullptr, a.H, a.Lq,
      a.Lk, a.d, a.kps, a.vec, a.head0, a.qsplit, a.qoff, a.scale, a.seed, a.threshold,
      a.keep_scale, a.dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const Args& a) {
  const size_t rows = (size_t)a.B * a.H * a.Lq;
  fused_attention_combine_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, a.stream>>>(
      a.part, static_cast<T*>(a.out), a.lse, a.B * a.H, a.Lq, a.d, a.splits);
  return (int)cudaGetLastError();
}

int run(const Args& a, int dtype) {
  int err;
  if (dtype == 0) {
    // 32-key tiles from d = 192 up: two CTAs (110 KB each) share an SM
    if (a.d <= 64) err = launch_f32<64, 64, 2>(a);
    else if (a.d <= 128) err = launch_f32<128, 64, 1>(a);
    else if (a.d <= 192) err = launch_f32<192, 32, 2>(a);
    else err = launch_f32<256, 32, 1>(a);
  } else {
    if (a.d <= 64) err = launch_bf16<64>(a);
    else if (a.d <= 128) err = launch_bf16<128>(a);
    else if (a.d <= 192) err = launch_bf16<192>(a);
    else err = launch_bf16<256>(a);
  }
  if (err != 0 || a.splits == 1) return err;
  return dtype == 0 ? launch_combine<float>(a) : launch_combine<bf16>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q_u: (B, H, Lq, d) contiguous; k, v: (B, H, Lk, d); bias: (B, H, Lq, Lk);
// mask: (B, Lk) int32; out: (B, H, Lq, d) in the input type; lse: (B, H, Lq)
// fp32.  Local query row i is global row i + qoff below qsplit, i + Lk - Lq
// from there on (square: Lq = Lk = qsplit, qoff = 0).  splits > 1 splits the
// keys into ranges of kps keys (a multiple of 16), each range's partials going
// to part, (splits * B * H * Lq * (d + 2)) fp32, which a second launch
// combines.  dtype 0 = float32, 1 = bfloat16.  head0: the global index of head
// 0 in the dropout lanes.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_fused_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    const int32_t* mask, void* out, float* lse, float* part, int B, int H,
    int Lq, int Lk, int d, int dtype, int splits, int kps, int head0, int qsplit,
    int qoff, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk < Lq || d <= 0 || d > 256 || B * H > 65535 ||
      head0 < 0 || head0 + H > 4096 || qsplit < 0 || qsplit > Lq || qoff < 0 ||
      qoff > Lk - Lq || (long long)Lk * Lk > 0xFFFFFFFFLL ||
      (dtype != 0 && dtype != 1) || splits < 1 || splits > 65535 ||
      (splits > 1 && (part == nullptr || kps <= 0 || kps % 16 != 0 ||
                      (long long)(splits - 1) * kps >= Lk)))
    return (int)cudaErrorInvalidValue;
  const int chunk = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  const int vec = d % chunk == 0 && Lk % chunk == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(bias);
  Args a{q, k, v, bias, mask, out, lse, part, B, H, Lq, Lk, d, splits,
         splits > 1 ? kps : Lk, vec, head0, qsplit, qoff, scale, seed, threshold,
         keep_scale, dropout, static_cast<cudaStream_t>(stream)};
  return run(a, dtype);
}
