// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel modelx_tpu/ops/attention.py:83 _flash_kernel
// (wrapped by flash_attention at :149, pl.pallas_call at :175). It computes
// the same function: softmax(scale * q k^T) v with an online softmax whose
// state (m, l, acc) is fp32, an optional tanh logit softcap applied BEFORE
// the mask, causal masking with an optional sliding window, p = 0 for every
// invisible key, kv tiles that are wholly masked skipped (the exact causal
// ceiling and the window's lower tile), GQA by reading kv head h / (H/Hkv)
// in place, any Sq and Sk with the ragged edge masked here, and the output
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on this card: causal attention at the serving shape
// [1, 32, 2048, 128] bf16 does 4*D per visible (query, key) pair and head,
// ~34 GFLOP, ~35 us at 989 TFLOP/s, and moves ~42 MB (q, k, v read once at
// 8 kv heads, o written once), ~12.5 us at 3.35 TB/s: operations bound it.
// At [4, 32, 512, 128] the work is 4x smaller per byte and bytes bound it
// (~12.5 us against ~9 us of operations).
//
// bf16 (D = 64, 96, 128, 256; the serving path) runs on the tensor cores:
// - 3 warpgroups a block: warpgroup 0 is the producer (one thread issues
//   every TMA load; the group gives its registers away with setmaxnreg, 24
//   a thread, to the consumers' 240), warpgroups 1 and 2 each own 64 rows
//   of a 128-row q tile;
// - persistent: one block per SM walks the (batch*head, q tile) tiles,
//   heaviest causal tiles first, sweeping left to right then right to left
//   so that every block gets a like share of the causal work; the next
//   tile's q and kv loads overlap this tile's last product and stores;
// - TMA loads q and streams k and v tiles through a 2-stage ring in shared
//   memory with full and empty mbarriers. Each tensor is a 3-D map
//   (D, S, B*heads): a box past S zero-fills inside its own head;
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory,
//   K-major, 128-byte swizzled (a row of 64 bf16 is one swizzle row, so a
//   D = 128 tile is 2 boxes and D = 256 is 4). O += P V is wgmma m64nDk16
//   with P from registers, packed straight from S's accumulator
//   (pack_p_fragment), and V read MN-major through the transpose bit;
// - inside a warpgroup the loop is software-pipelined: QK^T of kv tile
//   j + 1 is issued before PV of tile j, and the softmax of tile j + 1 runs
//   on the CUDA cores while PV of tile j runs on the tensor cores; between
//   the warpgroups a ping-pong on two named barriers lets one issue its
//   products while the other runs its softmax;
// - the softmax works in the accumulator's own layout: a row lies across
//   the 4 threads of a quad, so its max takes 2 shuffles, and the row sum is
//   kept per thread and reduced once at the end. scale*log2(e) folds into
//   the exp2's FFMA; the scale is applied to fp32 S, not to q. Only
//   diagonal, window-edge and ragged tiles pay for the mask;
// - D = 96 (Phi-3-mini) runs as the D = 128 tile: the tensor maps' inner
//   extent is 96, so the second 64-column box of every row lands with its
//   columns 96-127 zero-filled by TMA. Q K^T takes only the D / 16 = 6
//   k16 steps that hold real columns; P V computes 128 output columns, of
//   which 96-127 are exact zeros, and the store writes the first 96. The
//   padding costs a quarter of the P V product's tensor-core work;
// - tiles: BK = 128 keys for D <= 128, 64 for D = 256. Shared memory:
//   q 128*D*2 B + 2 stages * (k + v) BK*D*2 B each = 80 KB at D = 64,
//   160 KB at D = 128 and 192 KB at D = 256 (the card allows 227 KB);
// - P goes into the PV product as two bf16 terms, hi + lo (~16 bits): one
//   bf16 P (2^-9 relative) moved outputs of rows with few visible keys by
//   up to ~1e-2 against the fp32 reference, past the smoke's tolerance.
//   The PV product is thus done twice, 1.5x the tensor-core work of a
//   bf16-P kernel.
//
// fp32 keeps the CUDA-core kernel below (fp32 FMA): TF32 tensor cores keep
// about 3 decimal digits and would break fp32's 2e-5 tolerance. fp32 is what
// the tests use; the served model is bf16. bf16 at D = 32 (the tiny test
// config's head) also runs there: a 64-byte row is half of the tensor-core
// path's 128-byte swizzle row.
//
// The training forward (mx_flash_attention_lse) also writes each row's
// log-sum-exp, fp32 in natural-log units, which the backward
// (flash_attention_bwd.cu) reads to rebuild P without a second softmax.
// mx_flash_attention passes a null pointer, and the kernels skip the store.
// The tensor-core kernel's store is a template flag: its training
// instantiations are compiled in flash_attention_lse.cu, which includes
// this file with MX_FLASH_LSE defined, so that nvcc builds them beside the
// serving ones (one nvcc per source, all at once).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "simt.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per staged kv tile
constexpr int NT = 256;        // threads per block
constexpr int RG = NT / 8;     // row groups (8 threads each)
constexpr int RM = BQ / RG;    // query rows per thread
constexpr int CN = BK / 8;     // score columns per thread
constexpr int LDP = BK + 4;    // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

// Stage rows [row0, row0 + nrows) of a contiguous [S, D] slab into shared
// memory as fp32 times `mul`, row stride `ld`; rows at or past `valid` are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0, int nrows,
                                      int valid, float* dst, int ld, float mul) {
  constexpr int PER_ROW = D / 4;
  for (int idx = threadIdx.x; idx < nrows * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < valid) f = mx::load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
  }
}

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (size_t)(BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * LDP);
}

// One block per (batch*head, 64-row q tile); 32-key kv tiles staged in
// shared memory as fp32; each of 256 threads owns 2 query rows x 4 keys of
// the score tile and 2 rows x D/8 output columns, so the softmax state and
// acc live in registers; a row's 8 threads reduce with three xor shuffles.
// T is float (every head dim) or bf16 (head_dim 32 only: its 64-byte rows
// are half a 128-byte swizzle row of the tensor-core path below). With a
// non-null `lse`, each row's log-sum-exp (natural log) goes there too.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
               float scale, float softcap, int causal, int window) {
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
      for (int e = 0; e < 4; ++e) mx::store1(op + 4 * cg + 32 * jj + e, acc[i][4 * jj + e] / denom);
    // a row that sees no key keeps NEG_INF, the plain version's value there
    if (lse != nullptr && cg == 0)
      lse[(size_t)bh * Sq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp-specialised pipeline
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // warpgroup 0: producer; 1 and 2: consumers
constexpr int WG_BQ = 128;       // query rows per block, 64 per consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns in shared memory (96 -> 128)
  static constexpr int BK = DP <= 128 ? 128 : 64; // keys per kv tile
  static constexpr int STAGES = 2;                // depth of the kv ring
  static constexpr int NB = DP / 64;              // 128-byte column boxes per row
  static constexpr int Q_BOX = 64 * 128;          // one box: 64 rows x 64 columns
  static constexpr int Q_BYTES = WG_BQ * DP * 2;
  static constexpr int KV_BOX = BK * 128;         // one box: BK rows x 64 columns
  static constexpr int KV_BYTES = BK * DP * 2;    // a k or a v tile (zero columns included)
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty for each stage
  static constexpr int BAR_BYTES = 8 * (2 + 4 * STAGES);
  // 1024: slack to put the tiles on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as two bf16x2 terms, hi + lo, good to ~16 significant bits: the
// rounding of hi alone (2^-9 relative) is what bf16 P would cost the output
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

// S's accumulator (wgmma m64nBK, fp32) -> P as the A operand of the PV
// wgmma (m64nDk16, bf16 from registers). The one place the two layouts meet.
//
// Accumulator: thread t of the warpgroup (warp w = t/32, lane l = t%32)
// holds rows r = 16w + l/4 and r + 8; for each 8-key block i, s[4i + 0..1]
// are row r, keys 8i + 2(l%4) + {0,1}, and s[4i + 2..3] are row r + 8, the
// same keys.
// A fragment of one k16 step kk (keys 16kk .. 16kk+15), four bf16x2
// registers with the lower key in the low half:
//   a[0] = row r,     keys 16kk + 2(l%4) + {0,1}
//   a[1] = row r + 8, keys 16kk + 2(l%4) + {0,1}
//   a[2] = row r,     keys 16kk + 8 + 2(l%4) + {0,1}
//   a[3] = row r + 8, keys 16kk + 8 + 2(l%4) + {0,1}
// So a thread's P fragment for step kk is its own blocks 2kk and 2kk + 1 of
// S: no shuffle and no shared memory. P goes out as hi + lo (split_bf16x2).
template <int BKT>
__device__ __forceinline__ void pack_p_fragment(const float (&p)[BKT / 2],
                                                uint32_t (&hi)[BKT / 16][4],
                                                uint32_t (&lo)[BKT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half;
      split_bf16x2(p[4 * i + 0], p[4 * i + 1], hi[kk][2 * half], lo[kk][2 * half]);
      split_bf16x2(p[4 * i + 2], p[4 * i + 3], hi[kk][2 * half + 1], lo[kk][2 * half + 1]);
    }
}

template <int N>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) mx::wgmma_ss_n64(d, da, db, scale_d);
  else mx::wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) mx::wgmma_rs_n64_tb(d, a, db, 1);
  else if constexpr (N == 128) mx::wgmma_rs_n128_tb(d, a, db, 1);
  else mx::wgmma_rs_n256_tb(d, a, db, 1);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk, int causal, int window) {
  return kpos < Sk && (!causal || (kpos <= qpos && (window <= 0 || kpos > qpos - window)));
}

// The tile at linear index t of a block's walk: heaviest causal q tiles
// first (all heads of the last q tile, then the one before, ...).
struct TileCoords {
  int bh, q0, lo, ntiles;  // kv tiles [lo, lo + ntiles) hold every key a row can see
};

template <int BKT>
__device__ __forceinline__ TileCoords tile_coords(int t, int BH, int Sq, int Sk, int causal,
                                                  int window) {
  const int nq = (Sq + WG_BQ - 1) / WG_BQ;
  TileCoords c;
  c.bh = t % BH;
  c.q0 = (nq - 1 - t / BH) * WG_BQ;
  int hi = (Sk + BKT - 1) / BKT;
  c.lo = 0;
  if (causal) {
    hi = min(hi, (min(c.q0 + WG_BQ, Sq) + BKT - 1) / BKT);  // exact ceiling
    if (window > 0 && c.q0 - window + 1 > 0) c.lo = (c.q0 - window + 1) / BKT;
  }
  c.ntiles = max(hi - c.lo, 0);
  return c;
}

// Persistent: gridDim.x blocks (at most one per SM) walk the BH * nq tiles
// in rounds of gridDim.x (see walk), so the producer loads the next tile's
// q and first kv tiles while the consumers finish the last product and the
// stores of this one.
template <int D, bool LSE>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int BH, int H, int Hkv, int Sq, int Sk, float scale,
               float softcap, int causal, int window) {
  using T = Tile<D>;
  constexpr int BKT = T::BK;
  constexpr int DP = T::DP;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (mx::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;          // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + S * T::KV_BYTES;     // stage s at sV + s * KV_BYTES
  const uint32_t bar = sV + S * T::KV_BYTES;
  const uint32_t q_full = bar;
  const uint32_t q_empty = bar + 8;
  const uint32_t k_full = bar + 16;             // + 8 * stage
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;
  const int ntotal = BH * ((Sq + WG_BQ - 1) / WG_BQ);
  const int group = H / Hkv;
  // this block's tile in round r: the blocks sweep the heaviest-first order
  // left to right, then right to left, so the causal work evens out
  auto walk = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mx::mbar_init(q_full, 1);
    mx::mbar_init(q_empty, 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < S; ++s) {
      mx::mbar_init(k_full + 8 * s, 1);
      mx::mbar_init(v_full + 8 * s, 1);
      mx::mbar_init(k_empty + 8 * s, 2);
      mx::mbar_init(v_empty + 8 * s, 2);
    }
    mx::mbar_fence_init();
  }
  __syncthreads();

  // One if/else for the whole kernel: the two roles never meet again, so
  // ptxas can honour setmaxnreg in each. Both roles walk the same tiles and
  // count kv tiles the same way, which keeps the ring's stages and phases
  // in step.
  if (tid < 128) {
    // ---- producer warpgroup: hands its registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int kv_count = 0, tile_count = 0;
      for (int r = 0; r * (int)gridDim.x < ntotal; ++r) {
        const int t = walk(r);
        if (t >= ntotal) continue;
        const TileCoords c = tile_coords<BKT>(t, BH, Sq, Sk, causal, window);
        const int bkv = (c.bh / H) * Hkv + (c.bh % H) / group;
        // q's buffer is free once both consumers' last QK^T of the tile before is done
        if (tile_count > 0) mx::mbar_wait(q_empty, (tile_count - 1) & 1);
        // a 64-row half of q wholly past Sq is not loaded: its rows are never stored
        const int halves = c.q0 + 64 < Sq ? 2 : 1;
        mx::mbar_arrive_expect_tx(q_full, halves * T::NB * T::Q_BOX);
        for (int g = 0; g < halves; ++g)
          for (int b = 0; b < T::NB; ++b)
            mx::tma_load_3d(sQ + (g * T::NB + b) * T::Q_BOX, &tq, q_full, 64 * b, c.q0 + 64 * g, c.bh);
        for (int it = 0; it < c.ntiles; ++it, ++kv_count) {
          const int s = kv_count % S;
          const uint32_t parity = ((kv_count / S) & 1) ^ 1;  // the first round finds the ring empty
          const int k0 = (c.lo + it) * BKT;
          mx::mbar_wait(k_empty + 8 * s, parity);
          mx::mbar_arrive_expect_tx(k_full + 8 * s, T::KV_BYTES);
          for (int b = 0; b < T::NB; ++b)
            mx::tma_load_3d(sK + s * T::KV_BYTES + b * T::KV_BOX, &tk, k_full + 8 * s, 64 * b, k0, bkv);
          mx::mbar_wait(v_empty + 8 * s, parity);
          mx::mbar_arrive_expect_tx(v_full + 8 * s, T::KV_BYTES);
          for (int b = 0; b < T::NB; ++b)
            mx::tma_load_3d(sV + s * T::KV_BYTES + b * T::KV_BOX, &tv, v_full + 8 * s, 64 * b, k0, bkv);
        }
        ++tile_count;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = tid / 128 - 1;
    const int warp = (tid / 32) & 3, lane = tid & 31;
    const int row = 16 * warp + (lane >> 2);      // this thread's first row in the warpgroup's 64
    const int kcol = 2 * (lane & 3);              // this thread's key offset in an 8-key block
    const bool leader = (tid & 127) == 0;
    const float scale_log2 = scale * LOG2E;
    const float cap_inv = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_log2 = softcap * LOG2E;
    const uint32_t q_base = sQ + g * T::NB * T::Q_BOX;

    // per tile: this warpgroup's first row, this thread's two rows
    int qw0 = 0, qpos0 = 0, qpos1 = 0;
    float acc[DP / 2];            // O, zero past column D
    float m0, m1;                 // running max of rows qpos0, qpos1 (log2 units)
    float l0, l1;                 // this thread's share of their row sums
    float sc[BKT / 2];            // S of one tile, then its p = exp2(x - m) in place
    uint32_t ph[BKT / 16][4];     // P = ph + pl as the PV product's A operand
    uint32_t pl[BKT / 16][4];
    float alpha0 = 1.f, alpha1 = 1.f;

    // S = Q K^T for the tile in stage s: D/16 steps of m64nBKk16 (the first
    // overwrites sc; columns past D are zeros and take no step), committed
    // as one wgmma group and not waited for
    auto issue_qk = [&](int s) {
      mx::fence_regs(sc);
      mx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;
        const uint64_t da = mx::sw128_desc(q_base + box * T::Q_BOX + col, 16, 1024);
        const uint64_t db = mx::sw128_desc(sK + s * T::KV_BYTES + box * T::KV_BOX + col, 16, 1024);
        mma_qk<BKT>(sc, da, db, kk > 0);
      }
      mx::wgmma_commit();
    };

    // O += P V for the tile in stage s: BK/16 steps of m64nDPk16, each twice
    // (P's high and low bf16 terms), P from registers
    auto issue_pv = [&](int s) {
      mx::fence_regs(acc);
      mx::fence_regs(ph);
      mx::fence_regs(pl);
      mx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        const uint64_t db = mx::sw128_desc(sV + s * T::KV_BYTES + kk * 16 * 128, T::KV_BOX, 1024);
        mma_pv<DP>(acc, ph[kk], db);
        mma_pv<DP>(acc, pl[kk], db);
      }
      mx::wgmma_commit();
    };

    // the online softmax of the tile at key k0, in log2 units and in the
    // accumulator's layout: sc becomes p, l takes the tile's sums, and
    // alpha is the factor that moves O to the new running max. MASK, CAP
    // and FOLD are compile-time (one dispatch a tile, below), so an
    // interior tile runs straight-line code with no per-element branch.
    // FOLD (no softcap, scale > 0): the max is taken over raw S and the
    // scale folds into the exp2's FFMA, one multiply a value fewer.
    // Maxima and sums run over 4 partial accumulators: 4 short dependency
    // chains instead of one of BK/4 operations.
    auto softmax_tile = [&](int k0, auto mask_c, auto cap_c, auto fold_c) {
      constexpr bool MASK = decltype(mask_c)::value, CAP = decltype(cap_c)::value;
      constexpr bool FOLD = decltype(fold_c)::value;
      constexpr int NI = BKT / 8;  // 8-key blocks in the tile
      float pm0[4], pm1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pm0[j] = pm1[j] = -INFINITY;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x0 = sc[4 * i + c], x1 = sc[4 * i + 2 + c];
          if constexpr (CAP) {
            x0 = cap_log2 * tanhf(x0 * cap_inv);
            x1 = cap_log2 * tanhf(x1 * cap_inv);
          } else if constexpr (!FOLD) {
            x0 *= scale_log2;
            x1 *= scale_log2;
          }
          if constexpr (MASK) {
            const int kpos = k0 + 8 * i + kcol + c;
            if (!visible(kpos, qpos0, Sk, causal, window)) x0 = -INFINITY;
            if (!visible(kpos, qpos1, Sk, causal, window)) x1 = -INFINITY;
          }
          sc[4 * i + c] = x0;
          sc[4 * i + 2 + c] = x1;
          const int j = (2 * i + c) % 4;
          pm0[j] = fmaxf(pm0[j], x0);
          pm1[j] = fmaxf(pm1[j], x1);
        }
      float mx0 = fmaxf(fmaxf(pm0[0], pm0[1]), fmaxf(pm0[2], pm0[3]));
      float mx1 = fmaxf(fmaxf(pm1[0], pm1[1]), fmaxf(pm1[2], pm1[3]));
      if constexpr (FOLD) {  // raw S -> log2 units (scale > 0 keeps the max)
        mx0 *= scale_log2;
        mx1 *= scale_log2;
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing visible yet keeps p = 0 (exp2(-inf - 0)), not NaN
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      alpha0 = mx::exp2_ftz(m0 - mu0);
      alpha1 = mx::exp2_ftz(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      const float mul = FOLD ? scale_log2 : 1.f;
      float ps0[4] = {0.f, 0.f, 0.f, 0.f}, ps1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = (2 * i + c) % 4;
          sc[4 * i + c] = mx::exp2_ftz(fmaf(sc[4 * i + c], mul, -mu0));
          sc[4 * i + 2 + c] = mx::exp2_ftz(fmaf(sc[4 * i + 2 + c], mul, -mu1));
          ps0[j] += sc[4 * i + c];
          ps1[j] += sc[4 * i + 2 + c];
        }
      l0 = l0 * alpha0 + ((ps0[0] + ps0[1]) + (ps0[2] + ps0[3]));
      l1 = l1 * alpha1 + ((ps1[0] + ps1[1]) + (ps1[2] + ps1[3]));
      // keep all of it above the wgmma wait that follows: the compiler may
      // otherwise sink the arithmetic past it, out from under the PV product
      mx::fence_regs(sc);
      mx::fence_reg(l0);
      mx::fence_reg(l1);
      mx::fence_reg(alpha0);
      mx::fence_reg(alpha1);
    };
    auto softmax = [&](int k0) {
      using yes = std::true_type;
      using no = std::false_type;
      const bool masked = k0 + BKT > Sk ||
                          (causal && (k0 + BKT - 1 > qw0 || (window > 0 && k0 <= qw0 + 63 - window)));
      if (softcap > 0.f) {
        if (masked) softmax_tile(k0, yes{}, yes{}, no{});
        else softmax_tile(k0, no{}, yes{}, no{});
      } else if (scale > 0.f) {
        if (masked) softmax_tile(k0, yes{}, no{}, yes{});
        else softmax_tile(k0, no{}, no{}, yes{});
      } else {
        if (masked) softmax_tile(k0, yes{}, no{}, no{});
        else softmax_tile(k0, no{}, no{}, no{});
      }
    };

    // O *= alpha, skipped when no row of the warp moved its max (alpha = 1)
    auto rescale_o = [&]() {
      if (__all_sync(0xffffffffu, alpha0 == 1.f && alpha1 == 1.f)) return;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        acc[4 * i + 0] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }
    };

    // Software pipeline inside the warpgroup: while the tensor cores run
    // PV of kv tile j, the threads run the softmax of kv tile j + 1, whose
    // QK^T was issued just before. P of tile j + 1 stays fp32 in sc until
    // PV of tile j has finished reading ph/pl. The first QK^T and the last
    // PV of a q tile are peeled off, so the steady-state body issues and
    // waits for the same wgmma groups on every path: ptxas can then see
    // which group each wait retires and keeps the wgmmas asynchronous.
    //
    // Between the warpgroups, a ping-pong: each issues its products only
    // after the other has issued its own (named barriers 1 and 2, 256
    // threads), so one warpgroup's softmax runs under the other's products.
    // Both warpgroups take ntiles + 1 turns a q tile, so the turns stay in
    // step across tiles; the last pass of one tile opens the next.
    const int my_turn = 1 + g, their_turn = 2 - g;
    auto take_turn = [&]() { mx::named_sync(my_turn, 256); };
    auto pass_turn = [&]() { mx::named_arrive(their_turn, 256); };
    if (g == 1) pass_turn();  // warpgroup 1 goes first

    int kv_count = 0, tile_count = 0;
    for (int r = 0; r * (int)gridDim.x < ntotal; ++r) {
      const int t = walk(r);
      if (t >= ntotal) continue;
      const TileCoords c = tile_coords<BKT>(t, BH, Sq, Sk, causal, window);
      qw0 = c.q0 + 64 * g;
      qpos0 = qw0 + row;
      qpos1 = qpos0 + 8;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      const int n = c.ntiles;
      const int k00 = c.lo * BKT;

      mx::mbar_wait(q_full, tile_count & 1);
      if (n > 0) {
        const int s = kv_count % S;
        mx::mbar_wait(k_full + 8 * s, (kv_count / S) & 1);
        take_turn();
        issue_qk(s);
        pass_turn();
        mx::wgmma_wait<0>();
        mx::fence_regs(sc);
        if (leader) {
          mx::mbar_arrive(k_empty + 8 * s);
          if (n == 1) mx::mbar_arrive(q_empty);  // the tile's last QK^T is done
        }
        softmax(k00);
        pack_p_fragment<BKT>(sc, ph, pl);
      } else if (leader) {
        mx::mbar_arrive(q_empty);
      }
      for (int it = 0; it + 1 < n; ++it) {
        const int j = kv_count + it, s = j % S, s1 = (j + 1) % S;
        mx::mbar_wait(k_full + 8 * s1, ((j + 1) / S) & 1);
        take_turn();
        issue_qk(s1);
        mx::mbar_wait(v_full + 8 * s, (j / S) & 1);
        issue_pv(s);
        pass_turn();
        mx::wgmma_wait<1>();  // QK^T of tile j + 1 is done; PV of tile j may run on
        mx::fence_regs(sc);
        if (leader) {
          mx::mbar_arrive(k_empty + 8 * s1);
          if (it + 2 == n) mx::mbar_arrive(q_empty);
        }
        softmax(k00 + (it + 1) * BKT);
        mx::wgmma_wait<0>();
        mx::fence_regs(acc);
        mx::fence_regs(ph);
        mx::fence_regs(pl);
        if (leader) mx::mbar_arrive(v_empty + 8 * s);
        rescale_o();
        pack_p_fragment<BKT>(sc, ph, pl);
      }
      if (n > 0) {
        const int j = kv_count + n - 1, s = j % S;
        mx::mbar_wait(v_full + 8 * s, (j / S) & 1);
        take_turn();
        issue_pv(s);
        pass_turn();
        mx::wgmma_wait<0>();
        mx::fence_regs(acc);
        mx::fence_regs(ph);
        mx::fence_regs(pl);
        if (leader) mx::mbar_arrive(v_empty + 8 * s);
      }
      kv_count += n;

      // epilogue: finish the row sums across the quad, divide, store the
      // rows below Sq and the columns below D
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      // the training forward's row log-sum-exp (LSE, a compile-time switch:
      // the serving instantiation has no such code): m is in log2 units of
      // the scaled (softcapped) logits; one thread of the quad writes it
      if (LSE && (lane & 3) == 0) {
        float* lp = lse + (size_t)c.bh * Sq;
        if (qpos0 < Sq) lp[qpos0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : NEG_INF;
        if (qpos1 < Sq) lp[qpos1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : NEG_INF;
      }
      __nv_bfloat16* op = o + (size_t)c.bh * Sq * D + kcol;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        if (qpos0 < Sq)
          *reinterpret_cast<uint32_t*>(op + (size_t)qpos0 * D + 8 * i) =
              pack_bf16x2(acc[4 * i + 0] * inv0, acc[4 * i + 1] * inv0);
        if (qpos1 < Sq)
          *reinterpret_cast<uint32_t*>(op + (size_t)qpos1 * D + 8 * i) =
              pack_bf16x2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
      ++tile_count;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, bool LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int H, int Hkv, int Sq, int Sk, float scale, float softcap, int causal,
                        int window, cudaStream_t stream) {
  using T = Tile<D>;
  mx::EncodeTiledFn enc = mx::encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!mx::make_map(enc, &tq, q, D, Sq, B * H, 64) ||
      !mx::make_map(enc, &tk, k, D, Sk, B * Hkv, T::BK) ||
      !mx::make_map(enc, &tv, v, D, Sk, B * Hkv, T::BK))
    return cudaErrorInvalidValue;
  // once per device: allow the shared memory, and read the SM count (the
  // persistent grid is one block per SM, or fewer when there are fewer tiles)
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(flash_fwd_bf16<D, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  const long long ntotal = (long long)B * H * ((Sq + WG_BQ - 1) / WG_BQ);
  if (ntotal > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(ntotal < sms[dev] ? ntotal : sms[dev]);
  flash_fwd_bf16<D, LSE><<<grid, WG_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B * H, H, Hkv, Sq, Sk, scale, softcap,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// bf16 on the tensor cores with the log-sum-exp store (LSE = true), for
// D = 64, 96, 128, 256: defined in flash_attention_lse.cu's translation unit.
cudaError_t mx_launch_bf16_lse(int D, const void* q, const void* k, const void* v, void* o,
                               float* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
                               float softcap, int causal, int window, cudaStream_t stream);

#ifdef MX_FLASH_LSE

cudaError_t mx_launch_bf16_lse(int D, const void* q, const void* k, const void* v, void* o,
                               float* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
                               float softcap, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_bf16<64, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                   window, stream);
    case 96:
      return launch_bf16<96, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                   window, stream);
    case 128:
      return launch_bf16<128, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                    window, stream);
    case 256:
      return launch_bf16<256, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                    window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

#else  // the serving instantiations, the CUDA-core kernel and the C entries

namespace {

template <typename E, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int H, int Hkv, int Sq, int Sk, float scale, float softcap, int causal,
                        int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_simt<E, D><<<grid, NT, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(o), lse, H, Hkv, Sq, Sk, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int Hkv, int Sq, int Sk, float scale, float softcap, int causal,
                   int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<float, D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                 window, stream);
  if (dtype == 1) {
    if constexpr (D == 32)  // the CUDA cores: see flash_fwd_simt
      return launch_simt<__nv_bfloat16, 32>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap,
                                            causal, window, stream);
    else if (lse != nullptr)
      return mx_launch_bf16_lse(D, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                window, stream);
    else
      return launch_bf16<D, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                                   window, stream);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
             int H, int Hkv, int Sq, int Sk, int D, float scale, float softcap, int causal,
             int window, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch<32>(dtype, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                             window, s);
    case 64:
      return (int)launch<64>(dtype, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                             window, s);
    case 96:
      return (int)launch<96>(dtype, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                             window, s);
    case 128:
      return (int)launch<128>(dtype, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                              window, s);
    case 256:
      return (int)launch<256>(dtype, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale, softcap, causal,
                              window, s);
    default:
      return (int)cudaErrorInvalidValue;
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
  return dispatch(q, k, v, o, nullptr, dtype, B, H, Hkv, Sq, Sk, D, scale, softcap, causal,
                  window, stream);
}

// The training forward: mx_flash_attention, and each row's log-sum-exp of
// its scaled (softcapped, masked) logits, natural log, into the fp32
// [B, H, Sq] tensor `lse` (the backward's P = exp(s - lse)).
extern "C" int mx_flash_attention_lse(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int dtype, int B, int H, int Hkv, int Sq,
                                      int Sk, int D, float scale, float softcap, int causal,
                                      int window, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, lse, dtype, B, H, Hkv, Sq, Sk, D, scale, softcap, causal, window,
                  stream);
}

#endif  // MX_FLASH_LSE
