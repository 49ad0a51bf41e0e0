// Device helpers shared by the attention kernels (fused_attention_fwd/_bwd,
// banded_attention_fwd/_bwd_dq/_bwd_dkv): element conversion, the dropout
// counter hash, float4 products and the padded row stride of shared-memory
// tiles.  The hash must stay bit-identical across all five kernels and equal
// to the plain versions' ``ops/fused_attention.py::hash_bits``.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;   // the masked score of the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
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

// Row stride (floats) of the q/k/v/g tiles: d rounded up to 4, plus padding
// so that the stride in 16-byte units is odd and float4 reads of 8 different
// rows hit distinct banks.
__host__ __device__ inline int padded_dim(int d) {
  int m = (d + 3) / 4;
  return 4 * (m + 1 + (m & 1));
}

}  // namespace
