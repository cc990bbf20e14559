// Element access for the CUDA-core (SIMT) attention kernels: the fp32
// forward, the bf16 forward at head_dim 32, and every backward kernel keep
// their tiles as fp32 in shared memory and read or write the tensors in
// their own type, four elements at a time.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mx {

// Four consecutive elements as fp32; `p` is 16-byte (fp32) or 8-byte
// (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Whether query `qpos` sees key `kpos`: inside both lengths, and for causal
// attention at or before the query and (window > 0) among its last `window`
// keys. Queries start at position 0, as the wrapper's callers place them.
__device__ __forceinline__ bool sees(int qpos, int kpos, int Sq, int Sk, int causal, int window) {
  return qpos < Sq && kpos < Sk &&
         (!causal || (kpos <= qpos && (window <= 0 || kpos > qpos - window)));
}

}  // namespace mx
