// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel modelx_tpu/ops/attention.py:83 _flash_kernel
// (wrapped by flash_attention at :149, pl.pallas_call at :175). It computes
// the same function: softmax(scale * q k^T) v with an online softmax whose
// state (m, l, acc) is fp32, an optional tanh logit softcap applied BEFORE
// the mask, causal masking with an optional sliding window whose p is
// zeroed after the exp, k blocks that are fully masked skipped, and the
// output acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on this card: causal attention at the serving shape
// [1, 32, 2048, 128] does 2*B*H*S^2*D ~ 34 GFLOP (QK^T and PV, half of the
// square each) ~ 35 us at 989 TFLOP/s bf16, and moves ~42 MB (q, k, v
// read once at 8 kv heads, o written once) ~ 12.5 us at 3.35 TB/s, so it
// is bound by operations. This first version does those operations as fp32
// FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor cores: it is
// written to be right and simple; a wgmma/TMA version is later work.
//
// What the design does about it, GPU first rather than block-by-block from
// the TPU:
// - one thread block per (batch*head, 64-row q tile); the TPU's sequential
//   grid over q blocks becomes blocks in parallel, heaviest causal tiles
//   launched first;
// - the kv tiles (32 keys) are staged in shared memory as fp32, shared by
//   all 256 threads; the q tile is staged once, pre-scaled as the TPU
//   kernel pre-scales q;
// - each thread owns 2 query rows x 4 keys of the score tile and 2 rows x
//   D/8 columns of the output, so the online-softmax state and acc live in
//   registers; a row's 8 threads are neighbouring lanes and reduce its max
//   and sum with three xor shuffles;
// - GQA reads kv head h / (H / Hkv) in place (no repeated copy), and the
//   ragged edge (Sq or Sk not a multiple of the tile) is masked here, so no
//   shape falls back to the plain version;
// - shared-memory rows are padded by 4 floats so the float4 reads of the
//   4 query rows (or 8 key rows) a warp touches land in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per staged kv tile
constexpr int NT = 256;        // threads per block
constexpr int RG = NT / 8;     // row groups (8 threads each)
constexpr int RM = BQ / RG;    // query rows per thread
constexpr int CN = BK / 8;     // score columns per thread
constexpr int LDP = BK + 4;    // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Stage rows [row0, row0 + nrows) of a contiguous [S, D] slab into shared
// memory as fp32 times `mul`, row stride `ld`; rows at or past `valid` are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0, int nrows,
                                      int valid, float* dst, int ld, float mul) {
  constexpr int V = Vec<T>::N;
  constexpr int PER_ROW = D / V;
  for (int idx = threadIdx.x; idx < nrows * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    float f[V];
    if (row0 + r < valid) {
      Vec<T>::load(src + (size_t)(row0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int Hkv, int Sq, int Sk, float scale,
          float softcap, int causal, int window) {
  constexpr int LDQ = D + 4, LDK = D + 4, LDV = D;
  constexpr int OC = D / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDK;
  float* sP = sV + BK * LDV;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * BQ;
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + ((size_t)b * Hkv + kvh) * Sk * D;
  const T* vp = v + ((size_t)b * Hkv + kvh) * Sk * D;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg, rg + RG
  const int cg = tid & 7;   // column group: keys cg + 8j, out cols 4cg + 32jj

  stage<T, D>(qp, q0, BQ, Sq, sQ, LDQ, scale);

  int nk = (Sk + BK - 1) / BK;
  int lo = 0;
  if (causal) {
    // exact ceiling of the last visible key over BK (a floor here would
    // skip the diagonal block whenever BK > BQ and zero those rows)
    const int q_end = min(q0 + BQ, Sq);
    nk = min(nk, (q_end + BK - 1) / BK);
    if (window > 0) {
      // the earliest key any row of this tile can see is q0 - window + 1
      const int first = q0 - window + 1;
      lo = first > 0 ? first / BK : 0;
    }
  }

  float acc[RM][OC * 4];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kb = lo; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's PV product is done with sV/sP
    stage<T, D>(kp, k0, BK, Sk, sK, LDK, 1.f);
    stage<T, D>(vp, k0, BK, Sk, sV, LDV, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + RG * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (cg + 8 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = rg + RG * i;
      const int qpos = q0 + row;
      bool vis[CN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Sk;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        x = ok ? x : NEG_INF;
        vis[j] = ok;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        // invisible keys contribute exactly 0 (also in a fully masked
        // window block, where exp(NEG_INF - NEG_INF) would be 1)
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[row * LDP + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg + RG * i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float4 vv[OC];
#pragma unroll
        for (int jj = 0; jj < OC; ++jj)
          vv[jj] = *reinterpret_cast<const float4*>(sV + (kk + t) * LDV + 4 * cg + 32 * jj);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < OC; ++jj) {
            acc[i][4 * jj + 0] = fmaf(p, vv[jj].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv[jj].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv[jj].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv[jj].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + rg + RG * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[4 * cg + 32 * jj + e] = Vec<T>::store(acc[i][4 * jj + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int Sq, int Sk, float scale, float softcap, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int Sq, int Sk, int D, float scale, float softcap,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, softcap, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, softcap, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, softcap, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, H, Sq, D], k/v: [B, Hkv, Sk, D], o: [B, H, Sq, D], all contiguous
// and 16-byte aligned; dtype 0 = float32, 1 = bfloat16. Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 = ok).
extern "C" int mx_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                                  float scale, float softcap, int causal, int window,
                                  void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, softcap, causal, window, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, scale, softcap, causal,
                                    window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
