// Device helpers shared by the attention kernels (fused_attention_fwd/_bwd,
// banded_attention_fwd/_bwd_dq/_bwd_dkv): the output store, the dropout
// counter hash, float4 products and the padded row stride of shared-memory
// tiles.  The hash must stay bit-identical across all five kernels and equal
// to the plain versions' ``ops/fused_attention.py::hash_bits``.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;   // the masked score of the TPU kernels

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The TPU kernels' interpret-mode dropout bits (a3t_tpu/ops/fused_attention.py
// :64-80): a multiply-xorshift hash of (counter, seed, lane).
__device__ __forceinline__ uint32_t hash_bits(uint32_t ctr, uint32_t seed, uint32_t lane) {
  uint32_t x = ctr * 2654435761u + seed * 2246822519u + lane * 374761393u;
  x ^= x >> 15;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc + a . b as four chained fused multiply-adds
__device__ __forceinline__ float fdot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float lane_of(const float4& v, int x) {
  return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}

// A banded call's place in one process's call (ops/banded_attention.py::
// Place): its heads from head0 of H_all, its nc query chunks from chunk0 of
// nc_all, and with the halos K, V and the speech mask hold one extra chunk of
// c rows on each side.  Neighbour chunk nb of query chunk i (in the call's
// chunk numbers, -1 and nc the halos) is read from K row kb0 + nb * c; the
// neighbours nlo .. nhi are real, and one outside is a phantom: read, masked,
// as the clipped copy of the edge chunk.  Without a place (head0 = chunk0 = 0,
// H_all = H, nc_all = nc, no halos) these are the single-call values.
struct BandPlace {
  int Lk;        // rows of K, V and the speech mask: L, or L + 2c with the halos
  int kb0;       // K's row of the call's first query chunk: 0, or c
  int nlo, nhi;  // the real neighbour chunks
  int head0, H_all, chunk0, nc_all;

  __device__ __forceinline__ uint32_t lane(int b, int h, int chunk) const {
    return (uint32_t)((b * H_all + head0 + h) * nc_all + chunk0 + chunk);
  }
  // K's first row of neighbour nb, clipped to the real ones
  __device__ __forceinline__ int key_row(int nb, int c) const {
    return kb0 + min(max(nb, nlo), nhi) * c;
  }
  __device__ __forceinline__ bool real(int nb) const { return nb >= nlo && nb <= nhi; }
};

// A single call's place (nc query chunks), built in the kernel so that its
// constants fold.
__device__ __forceinline__ BandPlace whole_place(int L, int nc, int H) {
  return BandPlace{L, 0, 0, nc - 1, 0, H, 0, nc};
}

inline BandPlace band_place(int L, int c, int head0, int H_all, int chunk0, int nc_all,
                            int halo) {
  const int nc = L / c;
  BandPlace p;
  p.Lk = halo ? L + 2 * c : L;
  p.kb0 = halo ? c : 0;
  p.nlo = halo && chunk0 > 0 ? -1 : 0;
  p.nhi = halo && chunk0 + nc < nc_all ? nc : nc - 1;
  p.head0 = head0;
  p.H_all = H_all;
  p.chunk0 = chunk0;
  p.nc_all = nc_all;
  return p;
}

// Whether a call holds only part of one process's call: the bf16 kernels
// launch a kernel of their own for it.
inline bool band_placed(int H, int L, int c, int head0, int H_all, int chunk0, int nc_all,
                        int halo) {
  return halo || head0 != 0 || H_all != H || chunk0 != 0 || nc_all != L / c;
}

// Whether a place fits the call: the heads and chunks inside one process's
// call, and every lane and index in 32 bits.
inline bool band_place_ok(int B, int H, int L, int c, int head0, int H_all, int chunk0,
                          int nc_all) {
  const long long nc = L / c;
  return head0 >= 0 && H_all >= H && head0 + H <= H_all && chunk0 >= 0 &&
         chunk0 + nc <= nc_all && (long long)B * H_all * nc_all < (1ll << 31);
}

// Launch a 256-thread kernel with ``smem`` bytes of dynamic shared memory;
// the CUDA error code.
template <typename K, typename... T>
int launch256(K kern, dim3 grid, int smem, cudaStream_t stream, T... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 256, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Row stride (floats) of the q/k/v/g tiles: d rounded up to 4, plus padding
// so that the stride in 16-byte units is odd and float4 reads of 8 different
// rows hit distinct banks.
__host__ __device__ inline int padded_dim(int d) {
  int m = (d + 3) / 4;
  return 4 * (m + 1 + (m & 1));
}

}  // namespace
