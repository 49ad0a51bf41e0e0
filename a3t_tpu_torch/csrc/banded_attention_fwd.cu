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
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256, tt=64):
//   operations: T (12 c d + 4 tt d) per (b, h) = 4.19e10 FLOP: 0.042 ms at
//          989 TFLOP/s in bf16, 0.63 ms at 67 TFLOP/s in fp32 on the CUDA
//          cores;
//   bytes: q, k, v, out (4 x 25 MB in bf16), text keys and values, masks and
//          lse: 0.10 GB in bf16 over 3.35 TB/s = 0.03 ms.
// Bound by operations in both types.
//
// Design, bf16 (the longformer's type; FlashAttention-2's forward on the
// tensor cores, in the structure of K4's dq pass, hopper.cuh):
//   * a CTA owns (b, h, chunk i, 128 query rows): two warpgroups of 64 rows,
//     each with its 64 x d fp32 output accumulator in registers (96 a thread
//     at d = 192), its running max and its (undropped) row sums; Q stays in
//     swizzled shared memory, loaded once by cp.async;
//   * the warpgroups share a ring of 64-key K/V tiles (three stages at d <=
//     192, cp.async, one barrier per tile): the band keys of chunks i-1, i,
//     i+1 in tiles that never straddle a chunk (the phantom neighbours of
//     chunks 0 and nc-1 read from the clipped chunk, masked), then the text
//     keys; a tile past a chunk's end or past tt is zero-filled and its keys
//     get a "none" flag (-inf: no part of the softmax);
//   * per tile S = Q.K^T (m64n64k16), the masks, the running max, the
//     rescale, exp and the dropout hash in registers, then O += P.V with P
//     rounded to bf16 as the register A operand (V MN-major).  No tile is
//     skipped: on a row whose every key is masked every score is -1e30, so
//     p = 1 on all 3c + tt keys, padding, phantoms and the stand-in text
//     block included; the first tile's rescale takes alpha = 0 (the running
//     max starts at -inf);
//   * epilogue: out = O / denom rounded to bf16, lse = max + log(denom).
// Design, fp32 (full fp32 on the CUDA cores, no TF32): a CTA owns 64 query
//   rows and streams the band and text keys in tiles of 32 through shared
//   memory with an online softmax, four threads per query row.
//
// A call may hold a part of one process's call (BandPlace, attention_common.cuh):
// heads from head0 of H_all and query chunks from chunk0 of nc_all, with K, V and
// the speech mask carrying a halo chunk on each side, which stands for the
// neighbour chunk unless it is a phantom at a global edge.  The halos travel as
// extra rows of the one K/V tensor, (B, H, L + 2c, d): the caller concatenates
// them (a copy of the rank's K and V, 2 x B H (L + 2c) d elements), so the
// kernel's loads keep one base pointer.  A single call's place (head0 = chunk0 =
// 0, no halos; band_place) reads the same rows, flags and lanes as a call
// without places.  The fp32 kernels take the place as a parameter in every
// call.  The bf16 kernels keep one body: a single call launches a kernel whose
// parameters are Args alone and builds its place inside (whole_place), where
// its constants fold; a placed call launches ``_placed_kernel`` with the place
// beside Args.  On the H100, every bf16 call with the place as a parameter cost
// K5 9% at dropout 0.2, and the place inside Args cost K3 8%, through ptxas's
// code choices.
//
// Dropout is the TPU kernel's interpret-mode rule (fused_attention.py:64-80):
// lane (b * H_all + head0 + h) * nc_all + chunk0 + i (BandPlace::lane; (b * H +
// h) * nc + i for a single call); counter row * 3c + col for the band draw and
// row * tt + col + 2^20 for the text draw (row, col local to the chunk); keep
// iff the bits are >= uint32(rate * 0xFFFFFFFF).  The counter depends on the
// position only, so the masks equal the Pallas interpret-mode masks bit for
// bit, and K4 and K5 regenerate them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr uint32_t TEXT_DRAW = 1u << 20;

struct Args {
  const void *q, *k, *v, *kt, *vt;
  const int32_t *txm, *spm;
  void* out;
  float* lse;
  int B, H, L, d, c, tt, vec;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- bf16

constexpr int QR = 128;  // query rows per CTA: two warpgroups of 64
constexpr int KT = 64;   // keys per K/V tile

template <int DPAD>
struct FwdBf16 {
  static constexpr int TILE = 64 * DPAD * 2;                    // one 64-row bf16 tile
  static constexpr int NST = DPAD <= 192 ? 3 : 2;               // K/V stages
  static constexpr int STAGE = (2 * TILE + KT * 4 + 1023) / 1024 * 1024;  // K, V, key flags
  static constexpr int SMEM = 1024 + 2 * TILE + NST * STAGE;
};

template <int DPAD, bool PLACED>
__device__ __forceinline__ void fwd_bf16(const Args& a, const BandPlace& place) {
  const BandPlace pl = PLACED ? place : whole_place(a.L, gridDim.y, a.H);
  using S = FwdBf16<DPAD>;
  constexpr int TILE = S::TILE, NST = S::NST, STAGE = S::STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);  // Q: rows 0-63, then rows 64-127
  uint8_t* stages = qs + 2 * TILE;    // NST x (K tile, V tile, key flags)

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* kt = static_cast<const bf16*>(a.kt);
  const bf16* vt = static_cast<const bf16*>(a.vt);
  const int L = a.L, d = a.d, c = a.c, tt = a.tt;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w = t >> 5, lane = tid & 31;
  const int g8 = lane >> 2, qd = lane & 3;
  const int ci = blockIdx.y, bh = blockIdx.z, b = bh / a.H;
  const int r0 = blockIdx.x * QR;  // the CTA's first query row within the chunk
  const int crow = ci * c;         // the chunk's first row
  const size_t mat = (size_t)bh * L * d;
  const size_t kmat = (size_t)bh * pl.Lk * d;  // K's and V's matrix
  const size_t tmat = (size_t)bh * tt * d;
  const uint32_t lane_id = pl.lane(b, bh - b * a.H, ci);
  const int nbt = (c + KT - 1) / KT;  // key tiles per band chunk
  const int nband = 3 * nbt;
  const int ntiles = nband + (tt + KT - 1) / KT;
  const bool vc = a.vec != 0;
  auto sw = [](int r, int col) { return sw64(r, col, 64); };

  // this thread's two query rows (chunk-local): element i of a score tile
  // is row qrow[(i / 2) % 2], key 8 (i / 4) + 2 qd + i % 2 of the tile
  int qrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) qrow[hr] = r0 + 64 * wg + 16 * w + g8 + 8 * hr;

#pragma unroll
  for (int x = 0; x < 2; ++x)
    load_tile<bf16, 256, 64, DPAD>(qs + x * TILE, q + mat, d, crow + r0 + 64 * x, crow + c, 0, d,
                                   vc, tid, sw);
  // tile it: band block blk = it / nbt (chunk i + blk - 1, keys w0 .. w0 +
  // 63 of it), then the text keys; key flags 0 = none, 1 = masked, 2 = valid
  auto load_stage = [&](int st, int it) {
    uint8_t* ks = stages + st * STAGE;
    uint8_t* vs = ks + TILE;
    int* kf = reinterpret_cast<int*>(vs + TILE);
    if (it < nband) {
      const int blk = it / nbt, w0 = (it - blk * nbt) * KT;
      const int nb = ci + blk - 1;
      const int src = pl.key_row(nb, c);  // a phantom reads the clipped chunk
      load_tile<bf16, 256, 64, DPAD>(ks, k + kmat, d, src + w0, src + c, 0, d, vc, tid, sw);
      load_tile<bf16, 256, 64, DPAD>(vs, v + kmat, d, src + w0, src + c, 0, d, vc, tid, sw);
      if (tid < KT) {
        const int within = w0 + tid;
        kf[tid] = within >= c ? 0
                  : (pl.real(nb) && a.spm[(size_t)b * pl.Lk + src + within] > 0) ? 2
                                                                                     : 1;
      }
    } else {
      const int w0 = (it - nband) * KT;
      load_tile<bf16, 256, 64, DPAD>(ks, kt + tmat, d, w0, tt, 0, d, vc, tid, sw);
      load_tile<bf16, 256, 64, DPAD>(vs, vt + tmat, d, w0, tt, 0, d, vc, tid, sw);
      if (tid < KT) {
        const int col = w0 + tid;
        kf[tid] = col >= tt ? 0 : a.txm[(size_t)b * tt + col] > 0 ? 2 : 1;
      }
    }
  };
  // the first NST - 1 tiles in flight, Q with the first; one group per tile
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) load_stage(s, s);
    cp_async_commit();
  }

  float o[DPAD / 2], sc[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of each row
  float l_r[2] = {0.f, 0.f};              // this thread's share of each row's sum

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<NST - 2>();
    fence_async_shared();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    {
      const int nx = it + NST - 1;  // into the stage that tile it - 1 left
      if (nx < ntiles) load_stage(nx % NST, nx);
      cp_async_commit();
    }
    const uint8_t* ks = stages + (it % NST) * STAGE;
    const uint8_t* vs = ks + TILE;
    const int* kf = reinterpret_cast<const int*>(vs + TILE);
    const bool text = it >= nband;
    // the tile's first column of the band (0 .. 3c) or of the text keys
    const int col0 = text ? (it - nband) * KT : (it / nbt) * c + (it % nbt) * KT;

    fence_regs(sc);
    wgmma_fence();
    wgmma_abt64<DPAD>(sc, qs + wg * TILE, ks);  // S = Q.K^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // masked, scaled scores and the tile's row max (over the four threads
    // that share a row)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = kf[8 * j + 2 * qd + e];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float x = f == 0 ? -INFINITY : f == 2 ? sc[i] * a.scale : NEG;
          sc[i] = x;
          mt[hr] = fmaxf(mt[hr], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      const float m_new = fmaxf(m_r[hr], mt[hr]);
      // the first tile holds key 0 of chunk i - 1's block, so m_new is
      // finite from there on; before it the running max is -inf and alpha 0
      alpha[hr] = m_r[hr] == -INFINITY ? 0.f : __expf(m_r[hr] - m_new);
      m_r[hr] = m_new;
      l_r[hr] *= alpha[hr];
    }
    // p (its undropped sum), then the dropped p that P.V takes
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * qd + e;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          float p = __expf(sc[i] - m_r[hr]);
          l_r[hr] += p;
          if (a.dropout) {
            const uint32_t col = (uint32_t)(col0 + kc);
            const uint32_t ctr = text ? (uint32_t)qrow[hr] * (uint32_t)tt + col + TEXT_DRAW
                                      : (uint32_t)qrow[hr] * (uint32_t)(3 * c) + col;
            p = hash_bits(ctr, a.seed, lane_id) >= a.threshold ? p * a.keep_scale : 0.f;
          }
          sc[i] = p;
        }
      }
#pragma unroll
    for (int i = 0; i < DPAD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    wgmma_acc_pb<DPAD>(o, sc, vs);  // O += P.V
  }

  // epilogue: the row sums over the four threads of a row, out = O / sum
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 1);
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 2);
    inv[hr] = 1.f / l_r[hr];
  }
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  const int nrows = c - r0 - 64 * wg;
  if (nrows > 0)
    store_acc_bf16<DPAD>(static_cast<bf16*>(a.out) + mat + (size_t)(crow + r0 + 64 * wg) * d, d,
                         nrows, o, t);
  if (qd == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (qrow[hr] < c) a.lse[(size_t)bh * L + crow + qrow[hr]] = m_r[hr] + logf(l_r[hr]);
  }
}

// a single call: its parameters are Args alone (with a place beside them, K5
// at dropout 0.2 ran 9% slower on the H100)
template <int DPAD>
__global__ void __launch_bounds__(256, 1) banded_attention_fwd_bf16_kernel(Args a) {
  fwd_bf16<DPAD, false>(a, BandPlace{});
}

// a call that holds part of one process's call
template <int DPAD>
__global__ void __launch_bounds__(256, 1)
    banded_attention_fwd_bf16_placed_kernel(Args a, BandPlace pl) {
  fwd_bf16<DPAD, true>(a, pl);
}

// ---------------------------------------------------------------- fp32

constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 32;       // keys per tile
constexpr int NT = 256;      // threads per CTA: four per query row
constexpr int PS = BN + 4;   // row stride of the probability tile

template <int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ kt, const float* __restrict__ vt,
    const int32_t* __restrict__ txm, const int32_t* __restrict__ spm,
    float* __restrict__ out, float* __restrict__ lse, int H, int L, int d, int c,
    int tt, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout, BandPlace pl) {
  constexpr int NG = DMAX / 16;  // float4 accumulator groups per thread
  extern __shared__ float4 smem4[];
  const int dp = padded_dim(d);
  float* qs = reinterpret_cast<float*>(smem4);  // BM x dp
  float* ks = qs + BM * dp;                     // BN x dp
  float* vs = ks + BN * dp;                     // BN x dp
  float* ps = vs + BN * dp;                     // BM x PS
  int* krow = reinterpret_cast<int*>(ps + BM * PS);  // BN: source row, -1 = none
  int* kval = krow + BN;                             // BN: key valid

  const int ci = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int r0 = blockIdx.x * BM;  // first row of the tile, within the chunk
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // this thread's query row in the tile
  const int j = tid & 3;   // its quarter of the row
  const int rloc = r0 + r;
  const size_t mat = (size_t)bh * L * d;
  const size_t kmat = (size_t)bh * pl.Lk * d;
  const size_t tmat = (size_t)bh * tt * d;
  const uint32_t lane = pl.lane(b, bh - b * H, ci);
  const int d4 = (d + 3) / 4;
  const int nband = 3 * c;
  const int nbt = (nband + BN - 1) / BN;
  const int ntiles = nbt + (tt + BN - 1) / BN;

  for (int e = tid; e < BM * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, lr = r0 + rr;
    qs[e] = (lr < c && cc < d) ? q[mat + (size_t)(ci * c + lr) * d + cc] : 0.f;
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
          src = pl.key_row(nb, c) + within;
          valid = pl.real(nb) && spm[(size_t)b * pl.Lk + src] > 0;
        }
      }
      krow[tid] = src;
      kval[tid] = valid;
    }
    __syncthreads();
    const float* kb = text ? kt + tmat : k + kmat;
    const float* vb = text ? vt + tmat : v + kmat;
    for (int e = tid; e < BN * dp; e += NT) {
      const int rr = e / dp, cc = e - rr * dp, src = krow[rr];
      const bool in = src >= 0 && cc < d;
      const size_t off = (size_t)src * d + cc;
      ks[e] = in ? kb[off] : 0.f;
      vs[e] = in ? vb[off] : 0.f;
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
    float* ob = out + mat + (size_t)grow * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 4 * (j + 4 * g);
      if (col < d) {
        const float vals[4] = {acc[g].x, acc[g].y, acc[g].z, acc[g].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) ob[col + e] = vals[e] * inv;
      }
    }
    if (j == 0) lse[(size_t)bh * L + grow] = m_i + logf(l_i);
  }
}

template <int DPAD>
int run_bf16(const Args& a, const BandPlace& pl, bool placed) {
  constexpr int smem = FwdBf16<DPAD>::SMEM;
  const dim3 grid((a.c + QR - 1) / QR, a.L / a.c, a.B * a.H);
  if (placed)
    return launch256(banded_attention_fwd_bf16_placed_kernel<DPAD>, grid, smem, a.stream, a, pl);
  return launch256(banded_attention_fwd_bf16_kernel<DPAD>, grid, smem, a.stream, a);
}

template <int DMAX>
int run_f32(const Args& a, const BandPlace& pl) {
  const int dp = padded_dim(a.d);
  const size_t smem = (size_t)(BM * dp + 2 * BN * dp + BM * PS) * sizeof(float)
                      + 2 * BN * sizeof(int);
  auto kern = banded_attention_fwd_f32_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c + BM - 1) / BM, a.L / a.c, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.kt),
      static_cast<const float*>(a.vt), a.txm, a.spm, static_cast<float*>(a.out), a.lse, a.H,
      a.L, a.d, a.c, a.tt, a.scale, a.seed, a.threshold, a.keep_scale, a.dropout, pl);
  return (int)cudaGetLastError();
}

int run(const Args& a, const BandPlace& pl, bool placed, int dtype) {
  const int d = a.d;
  if (dtype == 0) {
    if (d <= 64) return run_f32<64>(a, pl);
    if (d <= 128) return run_f32<128>(a, pl);
    if (d <= 192) return run_f32<192>(a, pl);
    return run_f32<256>(a, pl);
  }
  if (dtype == 1) {
    if (d <= 64) return run_bf16<64>(a, pl, placed);
    if (d <= 128) return run_bf16<128>(a, pl, placed);
    if (d <= 192) return run_bf16<192>(a, pl, placed);
    return run_bf16<256>(a, pl, placed);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q: (B, H, L, d) contiguous, L a multiple of c; k, v: (B, H, Lk, d), Lk = L,
// or L + 2c with the halos (halo = 1); kt, vt: (B, H, tt, d); txm: (B, tt)
// int32; spm: (B, Lk) int32.  head0, H_all, chunk0, nc_all: the call's place
// (BandPlace).  out: (B, H, L, d) in the input type; lse: (B, H, L) fp32.
// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error code (0 = ok).
extern "C" int a3t_banded_attention_fwd(
    const void* q, const void* k, const void* v, const void* kt,
    const void* vt, const int32_t* txm, const int32_t* spm, void* out,
    float* lse, int B, int H, int L, int d, int c, int tt, int dtype,
    int head0, int H_all, int chunk0, int nc_all, int halo,
    float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || c <= 0 || tt <= 0 ||
      L % c != 0 || L / c > 65535 || B * H > 65535 ||
      !band_place_ok(B, H, L, c, head0, H_all, chunk0, nc_all))
    return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(kt) &&
                  aligned16(vt);
  const Args a{q, k, v, kt, vt, txm, spm, out, lse, B, H, L, d, c, tt, vec,
               scale, seed, threshold, keep_scale, dropout, static_cast<cudaStream_t>(stream)};
  return run(a, band_place(L, c, head0, H_all, chunk0, nc_all, halo),
             band_placed(H, L, c, head0, H_all, chunk0, nc_all, halo), dtype);
}
