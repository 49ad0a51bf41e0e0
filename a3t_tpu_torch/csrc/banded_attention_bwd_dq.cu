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
// Bound at the training shape (B=4, H=2, T=8192, d=192, c=256, tt=64):
//   operations: T (18 c d + 10 tt d) per (b, h) = 6.60e10 FLOP (s, dp and dq
//          over 3c band keys, those and dk_text, dv_text over the text keys):
//          0.067 ms at 989 TFLOP/s in bf16, 0.99 ms at 67 TFLOP/s in fp32;
//   bytes: q, k, v, g, dq (5 x 25 MB in bf16), lse, delta, text keys, values
//          and gradients: 0.13 GB over 3.35 TB/s = 0.04 ms (plus the partial
//          buffers, which no bound counts).
// Bound by operations in both types.
//
// Design, bf16 (the longformer's type; FlashAttention-2's query-major dq
// loop on the tensor cores, hopper.cuh):
//   * a CTA owns (b, h, chunk i, 128 query rows): two warpgroups of 64 rows,
//     each with its 64 x d fp32 dq accumulator in registers (96 a thread at
//     d = 192), written once;
//   * Q and G of the 128 rows stay in swizzled shared memory; the warpgroups
//     share a double-buffered ring of 64-key K/V tiles (cp.async): the band
//     keys of chunks i-1, i, i+1 in tiles that never straddle a chunk (the
//     phantom neighbours of chunks 0 and nc-1 read from the clipped chunk,
//     masked), then the text keys; a tile past a chunk's end or past tt is
//     zero-filled and its keys get p = 0;
//   * per tile S = Q.K^T and dP = G.V^T (m64n64k16, one wait for both), p,
//     keep and ds in registers, then dq += dS.K with dS rounded to bf16 as
//     the register A operand (K MN-major).  No tile is skipped: on a row
//     whose every key is masked p = exp(-1e30 - (-1e30)) = 1 on all 3c + tt
//     keys, padding, phantoms and the stand-in text block included;
//   * the text gradients reduce over all query rows of a (b, h), spread over
//     CTAs.  On a text tile the CTA writes its rows' ds, then p_d, in fp32
//     to the tile's shared-memory stage (free once dq's product is done),
//     and its 256 threads form the 128-row partials ds_t^T.Q and
//     p_d,t^T.G in fp32 on the CUDA cores (a bf16 operand would miss the
//     1e-4 the text gradients are held to), 4 keys x 4-column groups a
//     thread, rows in order.  Each CTA writes its partial to a buffer of
//     its own (64 per (b, h) at the training shape, 50 MB), and a second
//     launch sums them in a fixed order, so the result is the same bit for
//     bit from run to run (no atomics).  The caller may skip the text
//     gradients (the fully masked block that stands in for missing text has
//     none that are used).
// Design, fp32 (full fp32 on the CUDA cores, no TF32): a CTA owns 32 query
//   rows and streams the band and text keys in tiles of 32 through shared
//   memory, eight threads per query row; the text gradients through
//   per-CTA partials and the same fixed-order sum.
//
// Dropout regenerates the forward's masks bit for bit: lane BandPlace::lane
// ((b * H + h) * nc + i for a single call), counter row * 3c + col (band) and
// row * tt + col + 2^20 (text).
//
// A call may hold a part of one process's call, as K3's may (BandPlace,
// attention_common.cuh): its lanes are one process's lanes of its heads and
// query chunks, its band keys come from K/V with a halo chunk each side, and
// its text gradients sum over its own query chunks only (the mesh's seq group
// sums the rest with the parameters' gradients).

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
  const void* g;
  const float *lse, *delta;
  void* dq;
  float *dkt, *dvt, *parts;
  int B, H, L, d, c, tt, text_grads, vec;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- bf16

constexpr int QR = 128;     // query rows per CTA: two warpgroups of 64
constexpr int KT = 64;      // keys per K/V tile
constexpr int XS = KT + 8;  // row stride (floats) of the text-gradient scratch

template <int DPAD>
struct DqBf16 {
  static constexpr int TILE = 64 * DPAD * 2;          // one 64-row bf16 tile
  static constexpr int NST = DPAD <= 192 ? 2 : 1;     // K/V stages
  static constexpr int KV = 2 * TILE + KT * 4;        // K, V, key flags
  static constexpr int X = QR * XS * 4;               // the text scratch
  static constexpr int STAGE = ((KV > X ? KV : X) + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + 4 * TILE + NST * STAGE;
};

// out[key][col] = sum over rows r = 0..127, in order, of xs[r][key] *
// src[r][col]: xs the 128 x 64 fp32 scratch, src two 64-row swizzled bf16
// tiles (Q or G).  Thread tid: keys 4 kg .. 4 kg + 3, columns 4 cg + 64 jj
// + 0..3; keys below nk and columns below d are written (leading dim d).
template <int DPAD>
__device__ __forceinline__ void text_partial(const float* xs, const uint8_t* src, float* out,
                                             int d, int nk, int tid) {
  constexpr int TILE = DqBf16<DPAD>::TILE;
  constexpr int NJ = DPAD / 64;
  const int kg = tid >> 4, cg = tid & 15;
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += 2) {
    float acc[4][8];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[x][e] = 0.f;
#pragma unroll 2
    for (int r = 0; r < QR; ++r) {
      const float4 xw = *reinterpret_cast<const float4*>(xs + r * XS + 4 * kg);
      const uint8_t* tile = src + (r >> 6) * TILE;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (j0 + u < NJ) {
          const uint2 raw =
              *reinterpret_cast<const uint2*>(tile + sw64(r & 63, 4 * cg + 64 * (j0 + u), 64));
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          const float val[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[x][4 * u + e] = fmaf(lane_of(xw, x), val[e], acc[x][4 * u + e]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int key = 4 * kg + x;
      if (key >= nk) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (j0 + u >= NJ) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * cg + 64 * (j0 + u) + e;
          if (col < d) out[(size_t)key * d + col] = acc[x][4 * u + e];
        }
      }
    }
  }
}

template <int DPAD, bool PLACED>
__device__ __forceinline__ void bwd_dq_bf16(const Args& a, const BandPlace& place) {
  const BandPlace pl = PLACED ? place : whole_place(a.L, gridDim.y, a.H);
  using S = DqBf16<DPAD>;
  constexpr int TILE = S::TILE, NST = S::NST, STAGE = S::STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);  // Q: rows 0-63, then rows 64-127
  uint8_t* gs = qs + 2 * TILE;        // G: the same
  uint8_t* stages = gs + 2 * TILE;    // NST x (K tile, V tile, key flags)

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* kt = static_cast<const bf16*>(a.kt);
  const bf16* vt = static_cast<const bf16*>(a.vt);
  const bf16* g = static_cast<const bf16*>(a.g);
  const int L = a.L, d = a.d, c = a.c, tt = a.tt;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, w = t >> 5, lane = tid & 31;
  const int g8 = lane >> 2, qd = lane & 3;
  const int ci = blockIdx.y, bh = blockIdx.z, b = bh / a.H;
  const int r0 = blockIdx.x * QR;  // the CTA's first query row within the chunk
  const int crow = ci * c;         // the chunk's first row
  const size_t mat = (size_t)bh * L * d;
  const size_t kmat = (size_t)bh * pl.Lk * d;
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
  bool row_ok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qrow[hr] = r0 + 64 * wg + 16 * w + g8 + 8 * hr;
    row_ok[hr] = qrow[hr] < c;
    const size_t o = (size_t)bh * L + crow + qrow[hr];
    lse_r[hr] = row_ok[hr] ? a.lse[o] : 0.f;
    delta_r[hr] = row_ok[hr] ? a.delta[o] : 0.f;
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    load_tile<bf16, 256, 64, DPAD>(qs + x * TILE, q + mat, d, crow + r0 + 64 * x, crow + c, 0, d,
                                   vc, tid, sw);
    load_tile<bf16, 256, 64, DPAD>(gs + x * TILE, g + mat, d, crow + r0 + 64 * x, crow + c, 0, d,
                                   vc, tid, sw);
  }
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
  load_stage(0, 0);
  cp_async_commit();

  float dq[DPAD / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const int n_parts = gridDim.y * gridDim.x;
  const int part = ci * gridDim.x + blockIdx.x;

  for (int it = 0; it < ntiles; ++it) {
    const int st = NST == 2 ? (it & 1) : 0;
    if (NST == 2 && it + 1 < ntiles) {
      load_stage(st ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint8_t* ks = stages + st * STAGE;
    const uint8_t* vs = ks + TILE;
    const int* kf = reinterpret_cast<const int*>(vs + TILE);
    const bool text = it >= nband;
    // the tile's first column of the band (0 .. 3c) or of the text keys
    const int col0 = text ? (it - nband) * KT : (it / nbt) * c + (it % nbt) * KT;

    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    wgmma_abt64<DPAD>(sc, qs + wg * TILE, ks);  // S = Q.K^T
    wgmma_abt64<DPAD>(dp, gs + wg * TILE, vs);  // dP = G.V^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // sc <- ds (scaled), dp <- p_d
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * qd + e;
        const int f = kf[kc];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          float ds = 0.f, pd = 0.f;
          if (f != 0 && row_ok[hr]) {
            const float x = f == 2 ? sc[i] * a.scale : NEG;
            const float p = __expf(x - lse_r[hr]);
            float dpk = dp[i];
            pd = p;
            if (a.dropout) {
              const uint32_t col = (uint32_t)(col0 + kc);
              const uint32_t ctr = text ? (uint32_t)qrow[hr] * (uint32_t)tt + col + TEXT_DRAW
                                        : (uint32_t)qrow[hr] * (uint32_t)(3 * c) + col;
              const bool keep = hash_bits(ctr, a.seed, lane_id) >= a.threshold;
              pd = keep ? p * a.keep_scale : 0.f;
              dpk = keep ? dpk * a.keep_scale : 0.f;
            }
            ds = p * (dpk - delta_r[hr]) * a.scale;
          }
          sc[i] = ds;
          dp[i] = pd;
        }
      }

    wgmma_acc_pb<DPAD>(dq, sc, ks);  // dq += dS.K

    if (text && a.text_grads) {
      __syncthreads();  // both warpgroups are done with this stage: it becomes the scratch
      float* xs = reinterpret_cast<float*>(stages + st * STAGE);
      const int nk = min(KT, tt - col0);
#pragma unroll
      for (int round = 0; round < 2; ++round) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 64 * wg + 16 * w + g8 + 8 * hr, i = 4 * j + 2 * hr;
            *reinterpret_cast<float2*>(xs + r * XS + 8 * j + 2 * qd) =
                round == 0 ? make_float2(sc[i], sc[i + 1]) : make_float2(dp[i], dp[i + 1]);
          }
        __syncthreads();
        float* out = a.parts + ((size_t)(round * a.B * a.H + bh) * n_parts + part) * tt * d +
                     (size_t)col0 * d;
        text_partial<DPAD>(xs, round == 0 ? qs : gs, out, d, nk, tid);
        __syncthreads();  // the scratch is read
      }
    }
    __syncthreads();  // this stage is free
    if (NST == 1 && it + 1 < ntiles) {
      load_stage(0, it + 1);
      cp_async_commit();
    }
  }

  const int nrows = c - r0 - 64 * wg;
  if (nrows > 0)
    store_acc_bf16<DPAD>(static_cast<bf16*>(a.dq) + mat + (size_t)(crow + r0 + 64 * wg) * d, d,
                         nrows, dq, t);
}

// a single call: its parameters are Args alone (with a place beside them, K5
// at dropout 0.2 ran 9% slower on the H100)
template <int DPAD>
__global__ void __launch_bounds__(256, 1) banded_attention_bwd_dq_bf16_kernel(Args a) {
  bwd_dq_bf16<DPAD, false>(a, BandPlace{});
}

// a call that holds part of one process's call
template <int DPAD>
__global__ void __launch_bounds__(256, 1)
    banded_attention_bwd_dq_bf16_placed_kernel(Args a, BandPlace pl) {
  bwd_dq_bf16<DPAD, true>(a, pl);
}

// ---------------------------------------------------------------- fp32

constexpr int BM = 32;       // query rows per CTA
constexpr int BN = 32;       // keys per tile
constexpr int NT = 256;      // threads per CTA: eight per query row
constexpr int PS = BN + 4;   // row stride of the ds / p tiles

template <int DMAX>
__global__ void __launch_bounds__(NT) banded_attention_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ kt, const float* __restrict__ vt,
    const int32_t* __restrict__ txm, const int32_t* __restrict__ spm,
    const float* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    float* __restrict__ parts, int H, int L, int d, int c, int tt,
    int text_grads, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dropout, BandPlace pl) {
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
  const size_t kmat = (size_t)bh * pl.Lk * d;
  const size_t tmat = (size_t)bh * tt * d;
  const uint32_t lane = pl.lane(b, bh - b * H, ci);
  const int nband = 3 * c;
  const int nbt = (nband + BN - 1) / BN;
  const int ntiles = nbt + (tt + BN - 1) / BN;
  const int n_parts = nc * gridDim.x;
  const int part = ci * gridDim.x + blockIdx.x;

  for (int e = tid; e < BM * dp; e += NT) {
    const int rr = e / dp, cc = e - rr * dp, lr = r0 + rr;
    const bool in = lr < c && cc < d;
    const size_t off = mat + (size_t)(ci * c + lr) * d + cc;
    qs[e] = in ? q[off] : 0.f;
    gs[e] = in ? g[off] : 0.f;
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
    float* dqr = dq + mat + (size_t)(ci * c + rloc) * d;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * (lo + 8 * j);
      const float vals[4] = {dq_acc[j].x, dq_acc[j].y, dq_acc[j].z, dq_acc[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) dqr[col + e] = vals[e];
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

// the second launch: the fixed-order sum of n_parts partials per (b, h)
int sum_text_grads(const Args& a, int n_parts) {
  const int n = a.tt * a.d;
  const dim3 grid((n + NT - 1) / NT, a.B * a.H, 2);
  banded_text_grad_sum_kernel<<<grid, NT, 0, a.stream>>>(a.parts, a.dkt, a.dvt, n_parts, n);
  return (int)cudaGetLastError();
}

template <int DPAD>
int run_bf16(const Args& a, const BandPlace& pl, bool placed) {
  constexpr int smem = DqBf16<DPAD>::SMEM;
  const int row_tiles = (a.c + QR - 1) / QR;
  const dim3 grid(row_tiles, a.L / a.c, a.B * a.H);
  const int err =
      placed ? launch256(banded_attention_bwd_dq_bf16_placed_kernel<DPAD>, grid, smem, a.stream,
                         a, pl)
             : launch256(banded_attention_bwd_dq_bf16_kernel<DPAD>, grid, smem, a.stream, a);
  if (err != 0 || !a.text_grads) return err;
  return sum_text_grads(a, row_tiles * (a.L / a.c));
}

template <int DMAX>
int run_f32(const Args& a, const BandPlace& pl) {
  const int dp = padded_dim(a.d);
  const size_t smem = (size_t)(2 * BM * dp + 2 * BN * dp + 2 * BM * PS + 2 * BM) * sizeof(float)
                      + 2 * BN * sizeof(int);
  auto kern = banded_attention_bwd_dq_f32_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.c + BM - 1) / BM;
  const dim3 grid(row_tiles, a.L / a.c, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.kt),
      static_cast<const float*>(a.vt), a.txm, a.spm, static_cast<const float*>(a.g), a.lse,
      a.delta, static_cast<float*>(a.dq), a.parts, a.H, a.L, a.d, a.c, a.tt, a.text_grads,
      a.scale, a.seed, a.threshold, a.keep_scale, a.dropout, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.text_grads) return (int)err;
  return sum_text_grads(a, row_tiles * (a.L / a.c));
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

// q, g: (B, H, L, d) contiguous, L a multiple of c; k, v: (B, H, Lk, d), Lk =
// L, or L + 2c with the halos (halo = 1); kt, vt: (B, H, tt, d); txm: (B, tt)
// int32; spm: (B, Lk) int32; lse, delta: (B, H, L) fp32.  head0, H_all,
// chunk0, nc_all: the call's place (BandPlace).
// dq: (B, H, L, d) in the input type.  With text_grads: dkt, dvt (B, H, tt, d)
// fp32 and the scratch parts (2, B, H, (L / c) * ceil(c / R), tt, d) fp32,
// R = 32 query rows per CTA in fp32 and 128 in bf16; without, all three may
// be null.  dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error code
// (0 = ok).
extern "C" int a3t_banded_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* kt,
    const void* vt, const int32_t* txm, const int32_t* spm, const void* g,
    const float* lse, const float* delta, void* dq, float* dkt, float* dvt,
    float* parts, int B, int H, int L, int d, int c, int tt, int dtype,
    int text_grads, int head0, int H_all, int chunk0, int nc_all, int halo, float scale,
    uint32_t seed, uint32_t threshold, float keep_scale, int dropout, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || d <= 0 || d > 256 || c <= 0 || tt <= 0 ||
      L % c != 0 || L / c > 65535 || B * H > 65535 ||
      !band_place_ok(B, H, L, c, head0, H_all, chunk0, nc_all))
    return (int)cudaErrorInvalidValue;
  if (text_grads && (!dkt || !dvt || !parts)) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(kt) &&
                  aligned16(vt) && aligned16(g);
  const Args a{q, k, v, kt, vt, txm, spm, g, lse, delta, dq, dkt, dvt, parts, B, H, L, d, c, tt,
               text_grads, vec, scale,
               seed, threshold, keep_scale, dropout, static_cast<cudaStream_t>(stream)};
  return run(a, band_place(L, c, head0, H_all, chunk0, nc_all, halo),
             band_placed(H, L, c, head0, H_all, chunk0, nc_all, halo), dtype);
}
