// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The gradient of flash_attention.cu's forward: (dq, dk, dv) from q, k, v,
// the forward's output o and row log-sum-exp lse, and the output's gradient
// do, for the same options (scale, a tanh softcap before the mask, causal
// with an optional sliding window, GQA, any Sq and Sk). The TPU package has
// no kernel of its own for it: JAX would differentiate the Pallas call
// (modelx_tpu/ops/attention.py:149 flash_attention, pl.pallas_call at :175),
// so this replaces that derived gradient. It computes, per head, with the
// visible pairs only:
//   P  = exp(s_c - lse),  s_c = cap * tanh(s / cap) (or s), s = scale q k^T
//   dV = P^T dO,  dP = dO V^T,  D_i = rowsum(dO o O)
//   dS = P o (dP - D_i) o (1 - (s_c / cap)^2)   (the last factor with a cap)
//   dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the H / Hkv query heads of each kv head.
//
// What bounds it on this card: at the training shape q [1, 32, 2048, 128]
// bf16 with 8 kv heads, causal, the five products do 10 D FLOPs per visible
// pair and head, ~86 GFLOP, ~87 us at the dense bf16 tensor-core rate; the
// bytes (q, k, v, o, do, lse read once, dq, dk, dv written once) are
// ~84 MB, ~25 us at 3.35 TB/s: operations bound it.
//
// Design: simple and deterministic; no atomics, a fixed summation order.
// Three launches:
// - flash_bwd_delta: D_i, one warp per row;
// - dK/dV: one block per (b * Hkv, 64-key tile). k and v stay in shared
//   memory; the block walks every query head of the group and every 64-row
//   q tile that sees the keys (the causal mask and the window skip the
//   rest), recomputes S and dP, and accumulates dV and dK for its keys in
//   registers;
// - dQ: one block per (b * H, 64-row q tile). q and do stay in shared
//   memory; the block walks the kv tiles its rows see, recomputes S and
//   dP, and accumulates dQ in registers.
// S and dP are computed in both kernels: 7 products of the minimal 5, the
// price of no atomics. bf16 runs every product on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators, 4 warps a block: flash_bwd_*_mma
// below); fp32 runs on the CUDA cores in fp32 (flash_bwd_dkdv, flash_bwd_dq:
// 256 threads, each owning 2 rows x 8 keys of a score tile and 2 rows x
// D / 8 columns of an accumulator, the forward's CUDA-core layout), as the
// forward keeps fp32 off TF32. Head dims 32, 64, 96, 128 (256 is on no
// training path and is refused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "simt.cuh"

namespace {

constexpr int TB = 64;         // q rows of a q tile, keys of a kv tile
constexpr int NT = 256;        // threads per block
constexpr int RG = NT / 8;     // row groups of 8 threads: rows rg and rg + RG
constexpr int LDS = TB + 4;    // padded row stride of a [64 x 64] score tile
constexpr float NEG_INF = -1e30f;

// Stage rows [row0, row0 + 64) of a contiguous fp32 [S, D] slab into
// shared memory (row stride D + 4); rows at or past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int row0, int valid,
                                           float* dst) {
  constexpr int PER_ROW = D / 4;
  for (int idx = threadIdx.x; idx < TB * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < valid) f = mx::load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = f;
  }
}

// s = A B^T and dp = C E^T over one 64 x 64 tile: this thread's rows rg and
// rg + 32 of A and C against rows cg + 8 j (j < 8) of B and E. The rows of
// B and E a quarter warp reads sit D + 4 floats apart, 4 banks: no conflict.
template <int D>
__device__ __forceinline__ void two_products(const float* sA, const float* sB, const float* sC,
                                             const float* sE, int rg, int cg, float (&s)[2][8],
                                             float (&dp)[2][8]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[2], c[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = *reinterpret_cast<const float4*>(sA + (rg + RG * i) * LD + d);
      c[i] = *reinterpret_cast<const float4*>(sC + (rg + RG * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sB + (cg + 8 * j) * LD + d);
      const float4 e = *reinterpret_cast<const float4*>(sE + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[i][j] = mx::dot4(a[i], b, s[i][j]);
        dp[i][j] = mx::dot4(c[i], e, dp[i][j]);
      }
    }
  }
}

// P and dS of one (q row, key) pair from its raw q.k and dO.v, or 0 and 0
// when the query does not see the key.
__device__ __forceinline__ void p_and_ds(float qk, float dov, float lse, float delta, bool seen,
                                         float scale, float softcap, float& p, float& ds) {
  float x = qk * scale, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(x / softcap);
    x = softcap * t;
  }
  p = seen ? expf(x - lse) : 0.f;
  ds = p * (dov - delta);
  if (softcap > 0.f) ds *= 1.f - t * t;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                long long rows) {
  const long long row = ((long long)blockIdx.x * NT + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < D; c += 128)
    acc = mx::dot4(mx::load4(o + row * D + c), mx::load4(dout + row * D + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (size_t)(4 * TB * (D + 4) + 2 * TB * LDS + 2 * TB);
}

template <int D>
constexpr size_t smem_dq() {
  return sizeof(float) * (size_t)(4 * TB * (D + 4) + TB * LDS);
}

// fp32: one block per (b * Hkv, 64-key tile): dK and dV of those keys.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
               float scale, float softcap, int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int OC = D / 32;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + TB * LD;
  float* sQ = sV + TB * LD;
  float* sO = sQ + TB * LD;  // dO
  float* sP = sO + TB * LD;
  float* sS = sP + TB * LDS;  // dS
  float* sL = sS + TB * LDS;  // lse of the q tile's rows
  float* sD = sL + TB;        // D_i of the q tile's rows

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * TB;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;

  stage_tile<D>(k + (size_t)bkv * Sk * D, k0, Sk, sK);
  stage_tile<D>(v + (size_t)bkv * Sk * D, k0, Sk, sV);

  // the q tiles that see any of these keys
  const int nq = (Sq + TB - 1) / TB;
  int qlo = 0, qhi = nq;
  if (causal) {
    qlo = min(k0 / TB, nq);  // rows before k0 see none of them
    if (window > 0) {
      const long long last = (long long)min(k0 + TB, Sk) - 1 + window - 1;
      qhi = (int)min((long long)nq, last / TB + 1);
    }
  }

  float4 ak[2][OC], av[2][OC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) ak[i][jj] = av[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * H + (size_t)kvh * group + hh;
    const float* qp = q + bh * Sq * D;
    const float* op = dout + bh * Sq * D;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * TB;
      __syncthreads();  // the previous tile's products are done with sQ, sO, sP, sS
      stage_tile<D>(qp, q0, Sq, sQ);
      stage_tile<D>(op, q0, Sq, sO);
      if (tid < TB) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lse[bh * Sq + q0 + tid] : 0.f;
        sD[tid] = in ? delta[bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[2][8], dp[2][8];
      two_products<D>(sQ, sK, sO, sV, rg, cg, s, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + RG * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cg + 8 * j;
          float p, ds;
          p_and_ds(s[i][j], dp[i][j], sL[r], sD[r],
                   mx::sees(q0 + r, k0 + c, Sq, Sk, causal, window), scale, softcap, p, ds);
          sP[r * LDS + c] = p;
          sS[r * LDS + c] = ds;
        }
      }
      __syncthreads();

      // dV[key] += P[r, key] dO[r], dK[key] += dS[r, key] Q[r] over the
      // tile's rows r; this thread's keys are rg and rg + 32
#pragma unroll 4
      for (int r = 0; r < TB; ++r) {
        const float p0 = sP[r * LDS + rg], p1 = sP[r * LDS + rg + RG];
        const float g0 = sS[r * LDS + rg], g1 = sS[r * LDS + rg + RG];
#pragma unroll
        for (int jj = 0; jj < OC; ++jj) {
          const float4 o4 = *reinterpret_cast<const float4*>(sO + r * LD + 4 * cg + 32 * jj);
          const float4 q4 = *reinterpret_cast<const float4*>(sQ + r * LD + 4 * cg + 32 * jj);
          av[0][jj].x = fmaf(p0, o4.x, av[0][jj].x);
          av[0][jj].y = fmaf(p0, o4.y, av[0][jj].y);
          av[0][jj].z = fmaf(p0, o4.z, av[0][jj].z);
          av[0][jj].w = fmaf(p0, o4.w, av[0][jj].w);
          av[1][jj].x = fmaf(p1, o4.x, av[1][jj].x);
          av[1][jj].y = fmaf(p1, o4.y, av[1][jj].y);
          av[1][jj].z = fmaf(p1, o4.z, av[1][jj].z);
          av[1][jj].w = fmaf(p1, o4.w, av[1][jj].w);
          ak[0][jj].x = fmaf(g0, q4.x, ak[0][jj].x);
          ak[0][jj].y = fmaf(g0, q4.y, ak[0][jj].y);
          ak[0][jj].z = fmaf(g0, q4.z, ak[0][jj].z);
          ak[0][jj].w = fmaf(g0, q4.w, ak[0][jj].w);
          ak[1][jj].x = fmaf(g1, q4.x, ak[1][jj].x);
          ak[1][jj].y = fmaf(g1, q4.y, ak[1][jj].y);
          ak[1][jj].z = fmaf(g1, q4.z, ak[1][jj].z);
          ak[1][jj].w = fmaf(g1, q4.w, ak[1][jj].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rg + RG * i;
    if (key >= Sk) continue;
    float* kp = dk + ((size_t)bkv * Sk + key) * D;
    float* vp = dv + ((size_t)bkv * Sk + key) * D;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) {
      const int col = 4 * cg + 32 * jj;
      const float4 a = ak[i][jj];
      *reinterpret_cast<float4*>(kp + col) =
          make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
      *reinterpret_cast<float4*>(vp + col) = av[i][jj];
    }
  }
}

// fp32: one block per (b * H, 64-row q tile): dQ of those rows.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale, float softcap,
             int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int OC = D / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + TB * LD;  // dO
  float* sK = sO + TB * LD;
  float* sV = sK + TB * LD;
  float* sS = sV + TB * LD;  // dS

  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const size_t bkv = (size_t)b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.y * TB;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;

  stage_tile<D>(q + bh * Sq * D, q0, Sq, sQ);
  stage_tile<D>(dout + bh * Sq * D, q0, Sq, sO);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rg + RG * i;
    row_lse[i] = r < Sq ? lse[bh * Sq + r] : 0.f;
    row_delta[i] = r < Sq ? delta[bh * Sq + r] : 0.f;
  }

  // the kv tiles this q tile's rows see (as the forward walks them)
  int nk = (Sk + TB - 1) / TB, lo = 0;
  if (causal) {
    nk = min(nk, (min(q0 + TB, Sq) + TB - 1) / TB);
    if (window > 0) {
      const int first = q0 - window + 1;
      lo = first > 0 ? first / TB : 0;
    }
  }

  float4 aq[2][OC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) aq[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = lo; kt < nk; ++kt) {
    const int k0 = kt * TB;
    __syncthreads();  // the previous tile's product is done with sK and sS
    stage_tile<D>(k + bkv * Sk * D, k0, Sk, sK);
    stage_tile<D>(v + bkv * Sk * D, k0, Sk, sV);
    __syncthreads();

    float s[2][8], dp[2][8];
    two_products<D>(sQ, sK, sO, sV, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + RG * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], row_lse[i], row_delta[i],
                 mx::sees(q0 + r, k0 + c, Sq, Sk, causal, window), scale, softcap, p, ds);
        sS[r * LDS + c] = ds;
      }
    }
    __syncthreads();

    // dQ[r] += dS[r, key] K[key] over the tile's keys; rows rg and rg + 32
#pragma unroll 4
    for (int c = 0; c < TB; ++c) {
      const float g0 = sS[rg * LDS + c], g1 = sS[(rg + RG) * LDS + c];
#pragma unroll
      for (int jj = 0; jj < OC; ++jj) {
        const float4 k4 = *reinterpret_cast<const float4*>(sK + c * LD + 4 * cg + 32 * jj);
        aq[0][jj].x = fmaf(g0, k4.x, aq[0][jj].x);
        aq[0][jj].y = fmaf(g0, k4.y, aq[0][jj].y);
        aq[0][jj].z = fmaf(g0, k4.z, aq[0][jj].z);
        aq[0][jj].w = fmaf(g0, k4.w, aq[0][jj].w);
        aq[1][jj].x = fmaf(g1, k4.x, aq[1][jj].x);
        aq[1][jj].y = fmaf(g1, k4.y, aq[1][jj].y);
        aq[1][jj].z = fmaf(g1, k4.z, aq[1][jj].z);
        aq[1][jj].w = fmaf(g1, k4.w, aq[1][jj].w);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rg + RG * i;
    if (r >= Sq) continue;
    float* qp = dq + (bh * Sq + r) * D;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) {
      const float4 a = aq[i][jj];
      *reinterpret_cast<float4*>(qp + 4 * cg + 32 * jj) =
          make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
//
// The same two kernels with every product on the tensor cores. Tiles are
// bf16 in shared memory with rows padded to D + 8 elements (a row of 16-byte
// chunks shifted by one chunk from the row above: ldmatrix reads 8 rows
// without a bank conflict). 4 warps a block; each warp owns 16 rows of the
// 64-row output tile (16 keys in dK/dV, 16 queries in dQ) and runs 16 x 64
// score tiles. Fragments (PTX ISA, mma.m16n8k16 with .bf16): thread lane
// l, g = l / 4, t = l % 4; an accumulator tile holds rows g and g + 8,
// columns 2t and 2t + 1; the A operand of one k16 step holds rows g, g + 8
// and columns 2t, 2t + 1, 2t + 8, 2t + 9; so an accumulator row block
// becomes the next product's A operand in registers, as P does in the
// forward. P and dS go into their products as bf16 (P rounded once, 2^-9
// relative; the sums stay fp32).

constexpr int MW = 4;            // warps a block
constexpr int MT = 32 * MW;      // threads a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a contiguous bf16 [S, D] slab into a shared
// tile of row stride D + 8, 16 bytes a thread at a time; rows at or past
// `valid` are 0.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int row0,
                                           int valid, __nv_bfloat16* dst) {
  constexpr int PER_ROW = D / 8;
  for (int idx = threadIdx.x; idx < TB * PER_ROW; idx += MT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid) u = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = u;
  }
}

// acc[8][4] = A B^T over one 16 x 64 tile: rows r0 .. r0 + 15 of the
// row-major [row][d] tile sA against rows 0 .. 63 of the [row][d] tile sB
// (B's rows are the 64 output columns), all D columns.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const __nv_bfloat16* sA, int r0,
                                        const __nv_bfloat16* sB, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_addr(sA + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, smem_addr(sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += P C over the tile's 64 rows: P as A fragments (4 k16 steps
// over the 64 rows), C the row-major [row][d] tile (read transposed).
template <int D>
__device__ __forceinline__ void mma_pc(float (&acc)[D / 8][4], const uint32_t (&pa)[4][4],
                                       const __nv_bfloat16* sC, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_addr(sC + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                             (lane >> 4) * 8));
      mma_bf16(acc[2 * np], pa[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
}

// An accumulator [8][4] (16 rows x 64 columns) as the A fragments of the
// 4 k16 steps over those columns, in bf16.
__device__ __forceinline__ void to_a_frags(const float (&x)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

template <int D>
constexpr size_t smem_mma() {
  return sizeof(__nv_bfloat16) * (size_t)(4 * TB * (D + 8)) + sizeof(float) * 2 * TB;
}

// One block per (b * Hkv, 64-key tile), heaviest (earliest) key tiles
// first: dK and dV of those keys. Warp w owns keys w*16 .. w*16 + 15 and
// computes S^T = K Q^T and dP^T = V dO^T for them.
template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                   int Sq, int Sk, float scale, float softcap, int causal, int window) {
  constexpr int LD = D + 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sV = sK + TB * LD;
  __nv_bfloat16* sQ = sV + TB * LD;
  __nv_bfloat16* sO = sQ + TB * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + TB * LD);
  float* sD = sL + TB;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp * 16;  // this warp's first key in the tile

  stage_bf16<D>(k + (size_t)bkv * Sk * D, k0, Sk, sK);
  stage_bf16<D>(v + (size_t)bkv * Sk * D, k0, Sk, sV);

  const int nq = (Sq + TB - 1) / TB;
  int qlo = 0, qhi = nq;
  if (causal) {
    qlo = min(k0 / TB, nq);
    if (window > 0) {
      const long long last = (long long)min(k0 + TB, Sk) - 1 + window - 1;
      qhi = (int)min((long long)nq, last / TB + 1);
    }
  }

  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * H + (size_t)kvh * group + hh;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * TB;
      __syncthreads();  // the previous tile's products are done with sQ, sO
      stage_bf16<D>(q + bh * Sq * D, q0, Sq, sQ);
      stage_bf16<D>(dout + bh * Sq * D, q0, Sq, sO);
      if (tid < TB) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lse[bh * Sq + q0 + tid] : 0.f;
        sD[tid] = in ? delta[bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float x[8][4], dp[8][4];
      mma_abt<D>(x, sK, kw, sQ, lane);   // S^T: rows are keys, columns queries
      mma_abt<D>(dp, sV, kw, sO, lane);  // dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + (e >> 1) * 8;
          const int col = 8 * j + 2 * t + (e & 1);
          float p, ds;
          p_and_ds(x[j][e], dp[j][e], sL[col], sD[col],
                   mx::sees(q0 + col, key, Sq, Sk, causal, window), scale, softcap, p, ds);
          x[j][e] = p;
          dp[j][e] = ds;
        }
      uint32_t pa[4][4], sa[4][4];
      to_a_frags(x, pa);
      to_a_frags(dp, sa);
      mma_pc<D>(av, pa, sO, lane);  // dV += P^T dO
      mma_pc<D>(ak, sa, sQ, lane);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kw + g + half * 8;
    if (key >= Sk) continue;
    __nv_bfloat16* kp = dk + ((size_t)bkv * Sk + key) * D + 2 * t;
    __nv_bfloat16* vp = dv + ((size_t)bkv * Sk + key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(kp + 8 * j) =
          pack_bf16(ak[j][2 * half] * scale, ak[j][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(vp + 8 * j) = pack_bf16(av[j][2 * half], av[j][2 * half + 1]);
    }
  }
}

// One block per (b * H, 64-row q tile), heaviest (last) q tiles first: dQ
// of those rows. Warp w owns rows w*16 .. w*16 + 15.
template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale,
                 float softcap, int causal, int window) {
  constexpr int LD = D + 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sO = sQ + TB * LD;  // dO
  __nv_bfloat16* sK = sO + TB * LD;
  __nv_bfloat16* sV = sK + TB * LD;

  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const size_t bkv = (size_t)b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp * 16;

  stage_bf16<D>(q + bh * Sq * D, q0, Sq, sQ);
  stage_bf16<D>(dout + bh * Sq * D, q0, Sq, sO);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + qw + g + half * 8;
    row_lse[half] = r < Sq ? lse[bh * Sq + r] : 0.f;
    row_delta[half] = r < Sq ? delta[bh * Sq + r] : 0.f;
  }

  int nk = (Sk + TB - 1) / TB, lo = 0;
  if (causal) {
    nk = min(nk, (min(q0 + TB, Sq) + TB - 1) / TB);
    if (window > 0) {
      const int first = q0 - window + 1;
      lo = first > 0 ? first / TB : 0;
    }
  }

  float aq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[j][e] = 0.f;

  for (int kt = lo; kt < nk; ++kt) {
    const int k0 = kt * TB;
    __syncthreads();  // the previous tile's products are done with sK and sV
    stage_bf16<D>(k + bkv * Sk * D, k0, Sk, sK);
    stage_bf16<D>(v + bkv * Sk * D, k0, Sk, sV);
    __syncthreads();

    float x[8][4], dp[8][4];
    mma_abt<D>(x, sQ, qw, sK, lane);   // S: rows are queries, columns keys
    mma_abt<D>(dp, sO, qw, sV, lane);  // dP
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float p, ds;
        p_and_ds(x[j][e], dp[j][e], row_lse[half], row_delta[half],
                 mx::sees(q0 + qw + g + half * 8, k0 + 8 * j + 2 * t + (e & 1), Sq, Sk, causal,
                          window),
                 scale, softcap, p, ds);
        dp[j][e] = ds;
      }
    uint32_t sa[4][4];
    to_a_frags(dp, sa);
    mma_pc<D>(aq, sa, sK, lane);  // dQ += dS K
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + qw + g + half * 8;
    if (r >= Sq) continue;
    __nv_bfloat16* qp = dq + (bh * Sq + r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(qp + 8 * j) =
          pack_bf16(aq[j][2 * half] * scale, aq[j][2 * half + 1] * scale);
  }
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int B, int H, int Hkv, int Sq, int Sk, float scale, float softcap,
                           int causal, int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = smem_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<D><<<dim3(B * Hkv, (Sk + TB - 1) / TB), MT, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), H,
      Hkv, Sq, Sk, scale, softcap, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma<D><<<dim3(B * H, (Sq + TB - 1) / TB), MT, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), H, Hkv, Sq, Sk, scale,
      softcap, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                       float softcap, int causal, int window, cudaStream_t stream) {
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows * 32 + NT - 1) / NT;
  if (delta_blocks > 0x7fffffff || (Sq + TB - 1) / TB > 65535 || (Sk + TB - 1) / TB > 65535)
    return cudaErrorInvalidValue;
  flash_bwd_delta<T, D><<<(unsigned)delta_blocks, NT, 0, stream>>>(static_cast<const T*>(o), tdo,
                                                                   delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bwd_mma<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, Sq, Sk, scale,
                             softcap, causal, window, stream);
  } else {
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    constexpr size_t s_dkdv = smem_dkdv<D>(), s_dq = smem_dq<D>();
    static_assert(s_dkdv <= 232448 && s_dq <= 232448, "over the 227 KB a block may use");
    err = cudaFuncSetAttribute(flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_dq);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv<D><<<dim3(B * Hkv, (Sk + TB - 1) / TB), NT, s_dkdv, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv,
        Sq, Sk, scale, softcap, causal, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq<D><<<dim3(B * H, (Sq + TB - 1) / TB), NT, s_dq, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), H, Hkv, Sq, Sk, scale, softcap,
        causal, window);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_typed(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                         float softcap, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, Sq, Sk,
                                scale, softcap, causal, window, stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, Sq,
                                        Sk, scale, softcap, causal, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, do, dq: [B, H, Sq, D]; k, v, dk, dv: [B, Hkv, Sk, D]; lse, delta:
// fp32 [B, H, Sq] (lse from mx_flash_attention_lse, delta scratch). All
// contiguous and 16-byte aligned; dtype 0 = float32, 1 = bfloat16 for the
// tensors that are not lse or delta. D in {32, 64, 96, 128}. Launches three
// kernels on `stream` without synchronising and returns cudaGetLastError()
// (0 = ok).
extern "C" int mx_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* delta, void* dq,
                                      void* dk, void* dv, int dtype, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, float scale, float softcap,
                                      int causal, int window, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_typed<32>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                   Sq, Sk, scale, softcap, causal, window, s);
    case 64:
      return (int)launch_typed<64>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                   Sq, Sk, scale, softcap, causal, window, s);
    case 96:
      return (int)launch_typed<96>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                   Sq, Sk, scale, softcap, causal, window, s);
    case 128:
      return (int)launch_typed<128>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                    Sq, Sk, scale, softcap, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
