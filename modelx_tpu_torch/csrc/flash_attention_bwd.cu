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
// pair and head, 85.9 GFLOP, 0.0869 ms at the dense bf16 tensor-core rate
// (989 TFLOP/s); the bytes (q, k, v, o, do, lse read once, dq, dk, dv
// written once) are ~84 MB, ~25 us at 3.35 TB/s: operations bound it.
//
// bf16 at D = 64, 96, 128 (the training path) runs on the tensor cores,
// three launches on the stream:
// - flash_bwd_prep: D_i = rowsum(dO o O) and lse * log2(e) for every q row,
//   into the fp32 workspace at a row stride padded to 64, and zeros in the
//   fp32 dQ accumulator [B, H, Sq, D] (and, under GQA, the dK and dV ones,
//   [B, Hkv, Sk, D] each);
// - flash_bwd_wgmma, compiled once per head dim in
//   flash_attention_bwd_d{64,96,128}.cu (one nvcc each, all at once). What
//   it does about what held the mma.sync version (one dK/dV kernel per kv
//   tile, one dQ kernel per q tile) back:
//   1. grid: one tile per (batch, query head, 128-key block), 512 tiles at
//      the training shape against that version's 256 blocks, each of which
//      walked its GQA group serially (4 to 128 tile steps a block);
//      persistent, one block per SM walking the tiles heaviest first (key
//      block 0 sees every causal q tile) and sweeping left to right then
//      right to left, as the forward does;
//   2. every product on wgmma (m64nNk16, fp32 accumulators), with both
//      operands in shared memory: no ldmatrix re-reads by 4-warp blocks;
//   3. loads by TMA: a producer warpgroup (setmaxnreg gives its registers
//      to the consumers, 24 / 240; one thread issues every load) loads K
//      and V of the tile once (3-D maps (D, S, B*heads), 128-byte swizzle,
//      zeros past S and past D) and streams the 64-row Q and dO tiles of the
//      q tiles that see the keys (the causal ceiling and the window's edge
//      skip the rest) through a 2-stage ring with full/empty mbarriers, each
//      with its 64 lse and D_i values (bulk copies); no thread stages a
//      tile, and step j + 1's loads run under step j;
//   4. five products a step, not seven (S and dP are not computed again for
//      dQ): two consumer warpgroups own 64 keys each; S^T = K Q^T and dP^T =
//      V dO^T (K-major operands), so P^T and dS^T land with keys as rows; P
//      is formed while the tensor cores run dP^T (the mask is paid only on
//      diagonal, window-edge and ragged tiles); dV += P^T dO is issued
//      before dS is formed and runs under it; then dK += dS^T Q and, for
//      each warpgroup's 64 of dQ's columns over all 128 keys (D = 64: all
//      columns over its own keys), dQ = dS K (dS^T and K MN-major, through
//      the transpose bits). dK and dV stay in registers across the q tiles.
//      A warp of the producer warpgroup reduce-adds each step's dQ, staged
//      by the consumers in shared memory, into the fp32 accumulator with
//      TMA (cp.reduce.async.bulk.tensor), so no consumer waits on an atomic
//      (per-element red.global.add cost ~0.06 ms at the training shape on
//      an H100 SXM at 700 W).
//      dK, dV are stored in bf16 when H == Hkv and under GQA added into the
//      fp32 accumulators (a float2 atomicAdd each) once a tile;
//   5. no spills at D = 64; at D = 96 and 128 ptxas spills a few bytes
//      (8 stores, 48 loads) where the consumers hold dK, dV, S^T, dP^T
//      and dQ (224 fp32 registers) under their 240;
//   . precision: P and dS enter their products as two bf16 terms, hi + lo
//     (~16 bits; the forward's split_bf16x2), both from shared memory. One
//     bf16 term (2^-9 relative) missed BWD_TOL on rows and keys with few
//     visible partners, where large terms cancel: dQ at [2, 8, 200, 128]
//     GQA 4 (as the mma.sync version did, bit for bit), dK and dV at
//     Sq = 7 and 63. The lo terms make 8 products of the 5: 1.6x the
//     tensor work, 0.209 -> 0.294 ms for this kernel at the training shape
//     (H100 SXM, 700 W);
//   . D = 96 runs as the D = 128 tile (TMA zero-fills columns 96-127): the
//     zero columns cost 1/3 more tensor work in dV, dK and warpgroup 1's
//     dQ columns (S and dP take only the 6 k16 steps with real columns);
//   . shared memory at D = 128: K, V 64 KB, the ring 64 KB, dS^T and P^T
//     hi + lo 64 KB, the dQ tile 32 KB: 226 KB of the 227;
// - flash_bwd_finish: dq = scale * dQ_acc (and under GQA dk = scale *
//   dK_acc, dv = dV_acc) in bf16.
// Determinism: the accumulators are summed by atomics (the TMA reduce, the
// vector reductions) in the order the blocks arrive, so their fp32 sums
// differ from run to run in the last bits; two runs agree within bf16
// rounding, not bit for bit. The fp32 and head_dim 32 kernels are
// deterministic.
//
// bf16 at D = 32 (the tiny test config, launch-bound) keeps the earlier
// mma.sync pair, instantiated for 32 only: a D_i kernel, one dK/dV block
// per (b * Hkv, 64-key tile), one dQ block per (b * H, 64-row q tile), S
// and dP computed in both (7 products), no atomics. fp32 runs on the CUDA
// cores in fp32 (flash_bwd_dkdv, flash_bwd_dq: 256 threads, each owning 2
// rows x 8 keys of a score tile and 2 rows x D / 8 columns of an
// accumulator, the forward's CUDA-core layout), as the forward keeps fp32
// off TF32; deterministic. Head dims 32, 64, 96, 128 (256 is on no
// training path and is refused).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "simt.cuh"

namespace mx {

// The tensor-core path's operands: the wrapper's tensors and the fp32
// workspace's parts (see mx_flash_attention_bwd), shared by the
// translation units.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse2, *delta;  // [B * H, Sqp]: lse * log2(e), D_i
  float *dq_acc;              // [B, H, Sq, D]
  float *dk_acc, *dv_acc;     // [B, Hkv, Sk, D] each under GQA, else null
  void *dk, *dv;              // bf16 outputs (written here when H == Hkv)
  int B, H, Hkv, Sq, Sk;
  float scale, softcap;
  int causal, window;
};

// flash_bwd_wgmma<D> on the stream; defined in flash_attention_bwd_d<D>.cu
template <int D>
cudaError_t launch_bwd_wgmma(const BwdArgs& a, cudaStream_t stream);

}  // namespace mx

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace

#ifdef MX_BWD_WGMMA
// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp-specialised, persistent
// ---------------------------------------------------------------------------

namespace {

constexpr int BW_THREADS = 384;  // warpgroup 0: producer; 1 and 2: consumers
constexpr int BW_BK = 128;       // keys per tile, 64 per consumer warpgroup
constexpr int BW_BQ = 64;        // query rows per step
// named barriers (0 is __syncthreads'): both halves of dS^T written (the
// two consumer warpgroups); the dQ tile written (consumers arrive, the
// writer warp waits) and read (the writer arrives, consumers wait)
constexpr int BAR_DS = 1, BAR_DQ_FULL = 2, BAR_DQ_EMPTY = 3;
constexpr int BAR_WG = 4;  // + g: one consumer warpgroup's 128 threads
constexpr int DQ_SYNC = 256 + 32;

template <int D>
struct BwdTile {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns in shared memory (96 -> 128)
  static constexpr int NB = DP / 64;              // 128-byte column boxes per row
  static constexpr int STAGES = 2;                // depth of the Q/dO ring
  // dQ = dS K: at D = 64 each consumer warpgroup takes all columns over its
  // own 64 keys, else 64 columns over all 128 keys
  static constexpr bool KSPLIT = DP == 64;
  static constexpr int KV_BOX = BW_BK * 128;      // one box: 128 rows x 64 columns
  static constexpr int KV_BYTES = BW_BK * DP * 2;
  static constexpr int Q_BOX = BW_BQ * 128;       // one box: 64 rows x 64 columns
  static constexpr int Q_BYTES = BW_BQ * DP * 2;
  static constexpr int ROW_BYTES = BW_BQ * 4;     // 64 fp32 row values (lse or D_i)
  // dS^T as two bf16 terms, hi then lo: a 128-byte row of 64 queries a key
  static constexpr int DS_TERM = BW_BK * 128;
  static constexpr int DS_BYTES = 2 * DS_TERM;
  // dQ of a step for the writer warp's reduce: each consumer warpgroup's
  // 64 rows x 64 fp32 columns as two boxes of 32 columns (128-byte swizzle)
  static constexpr int DQ_BOX = BW_BQ * 128;
  static constexpr int DQ_BYTES = 2 * 2 * DQ_BOX;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;                   // stage s at + s * Q_BYTES
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int DS_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int P_OFF = DS_OFF + DS_BYTES;              // P^T, hi then lo, as dS^T
  static constexpr int DQ_OFF = P_OFF + DS_BYTES;              // warpgroup g at + g * 2 * DQ_BOX
  static constexpr int LSE_OFF = DQ_OFF + DQ_BYTES;            // stage s at + s * ROW_BYTES
  static constexpr int DEL_OFF = LSE_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = DEL_OFF + STAGES * ROW_BYTES;
  // kv_full, kv_empty, then q_full and q_empty for each stage; 1024: slack
  // to put the tiles on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 + 2 * STAGES);
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// The tile at linear index t: key block t / BH of head t % BH, so the
// heaviest causal key blocks (the first) come first; the q tiles
// [qlo, qlo + nq) hold every row that sees one of its keys.
struct BwdCoords {
  int bh, bkv, k0, qlo, nq;
};

__device__ __forceinline__ BwdCoords bwd_coords(int t, const mx::BwdArgs& a) {
  const int BH = a.B * a.H;
  BwdCoords c;
  c.bh = t % BH;
  c.k0 = (t / BH) * BW_BK;
  c.bkv = (c.bh / a.H) * a.Hkv + (c.bh % a.H) / (a.H / a.Hkv);
  const int nqt = (a.Sq + BW_BQ - 1) / BW_BQ;
  int lo = 0, hi = nqt;
  if (a.causal) {
    lo = min(c.k0 / BW_BQ, nqt);  // rows before k0 see none of the keys
    if (a.window > 0) {           // the last row that sees the last key
      const long long last = (long long)min(c.k0 + BW_BK, a.Sk) - 1 + a.window - 1;
      hi = (int)min((long long)nqt, last / BW_BQ + 1);
    }
  }
  c.qlo = lo;
  c.nq = max(hi - lo, 0);
  return c;
}

// D[64 x N] += (A_hi + A_lo) B over 64 K: A's hi term at `a` and its lo
// term DS_TERM bytes on, 64 rows of 64 K-values each (K-major, 128-byte
// swizzle), B 64 K-rows of N values (MN-major, boxes of 64 rows); 4 k16
// steps, each twice
template <int N>
__device__ __forceinline__ void mma_split(float (&d)[N / 2], uint32_t a, uint32_t b) {
  constexpr int TERM = BW_BK * 128, BOX = BW_BQ * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mx::sw128_desc(b + kk * 2048, BOX, 1024);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint64_t da = mx::sw128_desc(a + t * TERM + kk * 32, 16, 1024);
      if constexpr (N == 64) mx::wgmma_ss_n64_tb(d, da, db, 1);
      else mx::wgmma_ss_n128_tb(d, da, db, 1);
    }
  }
}

// Two bf16 pairs of one 16-byte chunk, (a, b) of one row and (c, d) of the
// row 8 below, as hi terms at `p` and lo terms (what the hi terms lose) a
// DS_TERM on: hi + lo holds ~16 significant bits (the forward's
// split_bf16x2)
__device__ __forceinline__ void store_split(uint8_t* p, float a, float b, float c, float d) {
  constexpr int TERM = BW_BK * 128;
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b), h1 = __floats2bfloat162_rn(c, d);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  *reinterpret_cast<__nv_bfloat162*>(p) = h0;
  *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) = h1;
  *reinterpret_cast<uint32_t*>(p + TERM) = pack_bf16(a - f0.x, b - f0.y);
  *reinterpret_cast<uint32_t*>(p + TERM + 8 * 128) = pack_bf16(c - f1.x, d - f1.y);
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq, const mx::BwdArgs a) {
  using T = BwdTile<D>;
  constexpr int DP = T::DP;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (mx::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - mx::smem_u32(smem_raw));  // the same bytes, generic
  const uint32_t sK = base + T::K_OFF, sV = base + T::V_OFF;
  const uint32_t kv_full = base + T::BAR_OFF, kv_empty = kv_full + 8;
  const uint32_t q_full = kv_full + 16;  // + 8 * stage
  const uint32_t q_empty = q_full + 8 * S;
  const int ntotal = a.B * a.H * ((a.Sk + BW_BK - 1) / BW_BK);
  // this block's tile in round r: the blocks sweep the heaviest-first order
  // left to right, then right to left, so the causal work evens out
  auto walk = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mx::mbar_init(kv_full, 1);
    mx::mbar_init(kv_empty, 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < S; ++s) {
      mx::mbar_init(q_full + 8 * s, 1);
      mx::mbar_init(q_empty + 8 * s, 2);
    }
    mx::mbar_fence_init();
  }
  __syncthreads();

  // One if/else for the whole kernel, as in the forward: both roles walk the
  // same tiles and count tiles and q steps the same way, which keeps the
  // barriers' phases in step.
  if (tid < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      const int Sqp = (a.Sq + BW_BQ - 1) / BW_BQ * BW_BQ;
      int kv_count = 0, q_count = 0;
      for (int r = 0; r * (int)gridDim.x < ntotal; ++r) {
        const int t = walk(r);
        if (t >= ntotal) continue;
        const BwdCoords c = bwd_coords(t, a);
        if (c.nq == 0) continue;
        // K and V are free once both consumers' last products of the tile before are done
        if (kv_count > 0) mx::mbar_wait(kv_empty, (kv_count - 1) & 1);
        mx::mbar_arrive_expect_tx(kv_full, 2 * T::KV_BYTES);
        for (int b = 0; b < T::NB; ++b) {
          mx::tma_load_3d(sK + b * T::KV_BOX, &tk, kv_full, 64 * b, c.k0, c.bkv);
          mx::tma_load_3d(sV + b * T::KV_BOX, &tv, kv_full, 64 * b, c.k0, c.bkv);
        }
        for (int it = 0; it < c.nq; ++it) {
          const int j = q_count + it, s = j % S;
          const int q0 = (c.qlo + it) * BW_BQ;
          const uint32_t full = q_full + 8 * s;
          mx::mbar_wait(q_empty + 8 * s, ((j / S) & 1) ^ 1);  // the first round finds the ring empty
          mx::mbar_arrive_expect_tx(full, 2 * T::Q_BYTES + 2 * T::ROW_BYTES);
          for (int b = 0; b < T::NB; ++b) {
            mx::tma_load_3d(base + T::Q_OFF + s * T::Q_BYTES + b * T::Q_BOX, &tq, full, 64 * b, q0, c.bh);
            mx::tma_load_3d(base + T::DO_OFF + s * T::Q_BYTES + b * T::Q_BOX, &tdo, full, 64 * b, q0,
                            c.bh);
          }
          const size_t row0 = (size_t)c.bh * Sqp + q0;
          mx::bulk_load(base + T::LSE_OFF + s * T::ROW_BYTES, a.lse2 + row0, T::ROW_BYTES, full);
          mx::bulk_load(base + T::DEL_OFF + s * T::ROW_BYTES, a.delta + row0, T::ROW_BYTES, full);
        }
        q_count += c.nq;
        ++kv_count;
      }
    } else if (tid >= 32 && tid < 64) {
      // the dQ writer warp: each step's dQ tiles, staged by the consumers,
      // reduce-added into the fp32 accumulator by TMA (rows past Sq and
      // columns past D are skipped); its lane 0 issues
      const bool issuer = tid == 32;
      bool first = true;
      for (int r = 0; r * (int)gridDim.x < ntotal; ++r) {
        const int t = walk(r);
        if (t >= ntotal) continue;
        const BwdCoords c = bwd_coords(t, a);
        for (int it = 0; it < c.nq; ++it) {
          if (issuer && !first) mx::bulk_wait<0, true>();  // the last reduce has read the tiles
          __syncwarp();
          first = false;
          mx::named_arrive(BAR_DQ_EMPTY, DQ_SYNC);
          mx::named_sync(BAR_DQ_FULL, DQ_SYNC);
          if (issuer) {
            const int q0 = (c.qlo + it) * BW_BQ;
            for (int g = 0; g < 2; ++g)
              for (int b = 0; b < 2; ++b) {
                const int col = (T::KSPLIT ? 0 : 64 * g) + 32 * b;
                if (col < D)
                  mx::tma_reduce_add_3d(&tdq, base + T::DQ_OFF + (2 * g + b) * T::DQ_BOX, col, q0,
                                        c.bh);
              }
            mx::bulk_commit();
          }
        }
      }
      if (issuer) mx::bulk_wait<0, false>();  // every reduce is done before the block exits
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = tid / 128 - 1;
    const int warp = (tid / 32) & 3, lane = tid & 31;
    const int row = 16 * warp + (lane >> 2);  // this thread's first accumulator row (of 64)
    const int col = 2 * (lane & 3);           // its first column in each 8-column block
    const int phase = lane >> 2;              // (row % 8) of both its rows: the swizzle phase
    const bool leader = (tid & 127) == 0;
    const float scale_log2 = a.scale * LOG2E;
    const float cap_inv = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
    const float cap_log2 = a.softcap * LOG2E;
    const bool gqa = a.H != a.Hkv;

    float dk[DP / 2], dv[DP / 2];  // this warpgroup's 64 keys x DP columns, over the tile
    float st[32], dpt[32];         // S^T and dP^T of one step, then P^T and dS^T in place
    float dq[32];                  // this warpgroup's share of the step's dQ

    // P of the step from S^T and the q rows' lse (log2 units), in the
    // accumulator's layout (rows are keys, columns queries): into shared
    // memory as bf16 hi + lo for dV (rows 64g + row and + 8 of P^T, laid out
    // as dS^T), and left in st as the factor dS takes from it (P, times the
    // softcap's 1 - tanh^2). MASK and CAP are compile-time (one dispatch a
    // step), so an interior step runs straight-line code.
    auto probs = [&](int q0, int kw0, const float* sl, auto mask_c, auto cap_c) {
      constexpr bool MASK = decltype(mask_c)::value, CAP = decltype(cap_c)::value;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * i + col);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          const float lv = (e & 1) ? l2.y : l2.x;
          float th = 0.f;
          if constexpr (CAP) {
            th = tanhf(st[x] * cap_inv);
            p[e] = mx::exp2_ftz(fmaf(th, cap_log2, -lv));
          } else {
            p[e] = mx::exp2_ftz(fmaf(st[x], scale_log2, -lv));
          }
          if constexpr (MASK) {
            if (!mx::sees(q0 + 8 * i + col + (e & 1), kw0 + row + 8 * (e >> 1), a.Sq, a.Sk,
                          a.causal, a.window))
              p[e] = 0.f;
          }
          st[x] = CAP ? p[e] * (1.f - th * th) : p[e];
        }
        store_split(smem + T::P_OFF + (64 * g + row) * 128 + 4 * (lane & 3) + ((i ^ phase) << 4),
                    p[0], p[1], p[2], p[3]);
      }
    };
    // dS = P (dP - D_i) (times the softcap's factor, already in st) in
    // place of dP^T, from the q rows' D_i
    auto dscores = [&](const float* sd) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * i + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          dpt[x] = st[x] * (dpt[x] - ((e & 1) ? d2.y : d2.x));
        }
      }
    };

    int kv_count = 0, q_count = 0;
    for (int r = 0; r * (int)gridDim.x < ntotal; ++r) {
      const int t = walk(r);
      if (t >= ntotal) continue;
      const BwdCoords c = bwd_coords(t, a);
      const int kw0 = c.k0 + 64 * g;  // this warpgroup's first key
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
      if (c.nq > 0) {
        mx::mbar_wait(kv_full, kv_count & 1);
        const uint32_t k_rows = sK + 64 * g * 128, v_rows = sV + 64 * g * 128;
        for (int it = 0; it < c.nq; ++it) {
          const int j = q_count + it, s = j % S;
          const int q0 = (c.qlo + it) * BW_BQ;
          const uint32_t sq = base + T::Q_OFF + s * T::Q_BYTES;
          const uint32_t sdo = base + T::DO_OFF + s * T::Q_BYTES;
          mx::mbar_wait(q_full + 8 * s, (j / S) & 1);

          // S^T = K Q^T, then dP^T = V dO^T, each its own wgmma group: D/16
          // steps of m64n64k16 (columns past D are zeros and take no step)
          mx::fence_regs(st);
          mx::fence_regs(dpt);
          mx::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * T::KV_BOX + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * T::Q_BOX + (kk % 4) * 32;
            mx::wgmma_ss_n64(st, mx::sw128_desc(k_rows + off, 16, 1024),
                             mx::sw128_desc(sq + qoff, 16, 1024), kk > 0);
          }
          mx::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * T::KV_BOX + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * T::Q_BOX + (kk % 4) * 32;
            mx::wgmma_ss_n64(dpt, mx::sw128_desc(v_rows + off, 16, 1024),
                             mx::sw128_desc(sdo + qoff, 16, 1024), kk > 0);
          }
          mx::wgmma_commit();

          // P while the tensor cores run dP^T
          mx::wgmma_wait<1>();
          mx::fence_regs(st);
          {
            using yes = std::true_type;
            using no = std::false_type;
            const float* sl = reinterpret_cast<const float*>(smem + T::LSE_OFF + s * T::ROW_BYTES);
            const bool masked = kw0 + 64 > a.Sk || q0 + BW_BQ > a.Sq ||
                                (a.causal && (kw0 + 63 > q0 ||
                                              (a.window > 0 && kw0 <= q0 + BW_BQ - 1 - a.window)));
            if (a.softcap > 0.f) {
              if (masked) probs(q0, kw0, sl, yes{}, yes{});
              else probs(q0, kw0, sl, no{}, yes{});
            } else {
              if (masked) probs(q0, kw0, sl, yes{}, no{});
              else probs(q0, kw0, sl, no{}, no{});
            }
          }

          // dV += (P_hi + P_lo)^T dO: 4 steps (64 queries) of m64nDPk16
          // each, P^T K-major and dO MN-major in shared memory; it runs while
          // the threads form dS
          mx::fence_proxy_async();  // the P stores, before the async proxy reads them
          mx::named_sync(BAR_WG + g, 128);
          mx::fence_regs(dv);
          mx::wgmma_fence();
          mma_split<DP>(dv, base + T::P_OFF + 64 * g * 128, sdo);
          mx::wgmma_commit();
          mx::wgmma_wait<1>();  // dP^T is done
          mx::fence_regs(dpt);
          dscores(reinterpret_cast<const float*>(smem + T::DEL_OFF + s * T::ROW_BYTES));

          // dS^T into shared memory as hi + lo, rows 64g + row and + 8. The
          // step's other dQ products are done with it: both warpgroups
          // passed BAR_DQ_EMPTY after theirs (KSPLIT: its own).
#pragma unroll
          for (int i = 0; i < 8; ++i)
            store_split(smem + T::DS_OFF + (64 * g + row) * 128 + 4 * (lane & 3) + ((i ^ phase) << 4),
                        dpt[4 * i], dpt[4 * i + 1], dpt[4 * i + 2], dpt[4 * i + 3]);

          // dK += (dS_hi + dS_lo)^T Q as dV (this warpgroup's rows of dS^T),
          // then dQ = (dS_hi + dS_lo) K for this warpgroup's share, dS^T and
          // K both MN-major, each k16 step twice; one group
          mx::fence_proxy_async();  // the dS^T stores, before the async proxy reads them
          if constexpr (T::KSPLIT) mx::named_sync(BAR_WG + g, 128);
          else mx::named_sync(BAR_DS, 256);  // both halves of dS^T are in
          mx::fence_regs(dk);
          mx::fence_regs(dq);
          mx::wgmma_fence();
          mma_split<DP>(dk, base + T::DS_OFF + 64 * g * 128, sq);
          if constexpr (T::KSPLIT) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t rows = (64 * g + 16 * kk) * 128;
              const uint64_t kd = mx::sw128_desc(sK + rows, T::KV_BOX, 1024);
              mx::wgmma_ss_n64_tt(dq, mx::sw128_desc(base + T::DS_OFF + rows, T::DS_TERM, 1024), kd,
                                  kk > 0);
              mx::wgmma_ss_n64_tt(
                  dq, mx::sw128_desc(base + T::DS_OFF + T::DS_TERM + rows, T::DS_TERM, 1024), kd, 1);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < BW_BK / 16; ++kk) {
              const uint64_t kd = mx::sw128_desc(sK + g * T::KV_BOX + kk * 2048, T::KV_BOX, 1024);
              mx::wgmma_ss_n64_tt(
                  dq, mx::sw128_desc(base + T::DS_OFF + kk * 2048, T::DS_TERM, 1024), kd, kk > 0);
              mx::wgmma_ss_n64_tt(
                  dq, mx::sw128_desc(base + T::DS_OFF + T::DS_TERM + kk * 2048, T::DS_TERM, 1024),
                  kd, 1);
            }
          }
          mx::wgmma_commit();
          mx::wgmma_wait<0>();
          mx::fence_regs(dq);
          mx::fence_regs(dv);
          mx::fence_regs(dk);
          if (leader) mx::mbar_arrive(q_empty + 8 * s);  // this step's Q, dO, lse, D_i are read

          // dQ into shared memory for the writer warp: this warpgroup's two
          // boxes of 32 columns, row r's 16-byte chunk j at j ^ (r % 8)
          mx::named_sync(BAR_DQ_EMPTY, DQ_SYNC);
          {
            uint8_t* tile = smem + T::DQ_OFF + g * 2 * T::DQ_BOX + row * 128 + 8 * (lane & 1);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int off = (i / 4) * T::DQ_BOX + (((2 * (i % 4) + ((lane & 3) >> 1)) ^ phase) << 4);
              *reinterpret_cast<float2*>(tile + off) = make_float2(dq[4 * i], dq[4 * i + 1]);
              *reinterpret_cast<float2*>(tile + 8 * 128 + off) = make_float2(dq[4 * i + 2], dq[4 * i + 3]);
            }
          }
          mx::fence_proxy_async();
          mx::named_arrive(BAR_DQ_FULL, DQ_SYNC);
        }
        q_count += c.nq;
        ++kv_count;
        if (leader) mx::mbar_arrive(kv_empty);  // every product of the tile is done with K and V
      }

      // dK, dV of keys kw0 + row (+ 8) below Sk: stored when each kv head has
      // one query head, else added into the accumulators (a tile no query
      // sees stores zeros or adds nothing)
      const int key0 = kw0 + row;
      if (!gqa) {
        __nv_bfloat16* kp = static_cast<__nv_bfloat16*>(a.dk) + ((size_t)c.bkv * a.Sk + key0) * D + col;
        __nv_bfloat16* vp = static_cast<__nv_bfloat16*>(a.dv) + ((size_t)c.bkv * a.Sk + key0) * D + col;
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          if (8 * i >= D) continue;
          if (key0 < a.Sk) {
            *reinterpret_cast<uint32_t*>(kp + 8 * i) = pack_bf16(dk[4 * i] * a.scale, dk[4 * i + 1] * a.scale);
            *reinterpret_cast<uint32_t*>(vp + 8 * i) = pack_bf16(dv[4 * i], dv[4 * i + 1]);
          }
          if (key0 + 8 < a.Sk) {
            *reinterpret_cast<uint32_t*>(kp + 8 * D + 8 * i) =
                pack_bf16(dk[4 * i + 2] * a.scale, dk[4 * i + 3] * a.scale);
            *reinterpret_cast<uint32_t*>(vp + 8 * D + 8 * i) = pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
          }
        }
      } else if (c.nq > 0) {
        float* kp = a.dk_acc + ((size_t)c.bkv * a.Sk + key0) * D + col;
        float* vp = a.dv_acc + ((size_t)c.bkv * a.Sk + key0) * D + col;
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          if (8 * i >= D) continue;
          if (key0 < a.Sk) {
            mx::red_add_f32x2(kp + 8 * i, dk[4 * i], dk[4 * i + 1]);
            mx::red_add_f32x2(vp + 8 * i, dv[4 * i], dv[4 * i + 1]);
          }
          if (key0 + 8 < a.Sk) {
            mx::red_add_f32x2(kp + 8 * D + 8 * i, dk[4 * i + 2], dk[4 * i + 3]);
            mx::red_add_f32x2(vp + 8 * D + 8 * i, dv[4 * i + 2], dv[4 * i + 3]);
          }
        }
      }
    }
  }
}

// Internal linkage on purpose: the per-device cache below is then this
// library's own, where several builds of the kernels are loaded side by
// side (scripts/torch_flash_ab.py) and a shared one would skip another
// build's shared-memory attribute.
template <int D>
cudaError_t launch(const mx::BwdArgs& a, cudaStream_t stream) {
  using mx::encode_tiled;
  using mx::EncodeTiledFn;
  using mx::make_map;
  using T = BwdTile<D>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const int BH = a.B * a.H, BHkv = a.B * a.Hkv;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!make_map(enc, &tq, a.q, D, a.Sq, BH, BW_BQ) || !make_map(enc, &tdo, a.dout, D, a.Sq, BH, BW_BQ) ||
      !make_map(enc, &tk, a.k, D, a.Sk, BHkv, BW_BK) || !make_map(enc, &tv, a.v, D, a.Sk, BHkv, BW_BK) ||
      !make_map(enc, &tdq, a.dq_acc, D, a.Sq, BH, BW_BQ, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4))
    return cudaErrorInvalidValue;
  // once per device: allow the shared memory, and read the SM count (the
  // persistent grid is one block per SM, or fewer when there are fewer tiles)
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(flash_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  const long long ntotal = (long long)BH * ((a.Sk + BW_BK - 1) / BW_BK);
  if (ntotal > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(ntotal < sms[dev] ? ntotal : sms[dev]);
  flash_bwd_wgmma<D><<<grid, BW_THREADS, T::SMEM, stream>>>(tq, tk, tv, tdo, tdq, a);
  return cudaGetLastError();
}

}  // namespace

namespace mx {

template <int D>
cudaError_t launch_bwd_wgmma(const BwdArgs& a, cudaStream_t stream) {
  return launch<D>(a, stream);
}

template cudaError_t launch_bwd_wgmma<MX_BWD_WGMMA>(const BwdArgs& a, cudaStream_t stream);

}  // namespace mx

#else  // the D_i, fp32 and head_dim 32 kernels, the pre- and post-passes, the C entry

namespace {

constexpr int TB = 64;         // q rows of a q tile, keys of a kv tile
constexpr int NT = 256;        // threads per block
constexpr int RG = NT / 8;     // row groups of 8 threads: rows rg and rg + RG
constexpr int LDS = TB + 4;    // padded row stride of a [64 x 64] score tile

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
// bf16 at head_dim 32: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
//
// The fp32 kernels' two-kernel form with every product on the tensor cores,
// instantiated for D = 32 only (its 64-byte rows are half of the wgmma
// kernel's 128-byte swizzle row; the shape is launch-bound). Tiles are
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

// ---------------------------------------------------------------------------
// bf16 at D = 64, 96, 128: the wgmma kernel's pre- and post-pass
// ---------------------------------------------------------------------------

// One warp per q row of the padded [B * H, Sqp] layout: D_i = rowsum(dO o O)
// and lse * log2(e) (both 0 on the padding rows, which no step reads
// unmasked), and zeros in the row's dQ accumulator; then every thread
// zeroes a grid-stride share of the GQA dK/dV accumulators (kv4 float4s).
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ lse2,
               float* __restrict__ dq_acc, float4* __restrict__ dkv_acc, int Sq, int Sqp,
               long long rows, long long kv4) {
  const long long gtid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long w = gtid / 32;
  const int lane = threadIdx.x & 31;
  if (w < rows) {
    const long long bh = w / Sqp;
    const int qi = (int)(w % Sqp);
    float acc = 0.f, l2 = 0.f;
    if (qi < Sq) {
      const long long r = bh * Sq + qi;
      for (int c = lane * 4; c < D; c += 128) {
        acc = mx::dot4(mx::load4(o + r * D + c), mx::load4(dout + r * D + c), acc);
        *reinterpret_cast<float4*>(dq_acc + r * D + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      l2 = lse[r] * LOG2E;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta[w] = acc;
      lse2[w] = l2;
    }
  }
  for (long long i = gtid; i < kv4; i += (long long)gridDim.x * NT)
    dkv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = scale * dQ_acc in bf16, then (under GQA) dk = scale * dK_acc and
// dv = dV_acc: four elements a thread a turn.
__global__ void __launch_bounds__(NT)
flash_bwd_finish(const float4* __restrict__ dq_acc, uint2* __restrict__ dq, long long nq4,
                 const float4* __restrict__ dk_acc, const float4* __restrict__ dv_acc,
                 uint2* __restrict__ dk, uint2* __restrict__ dv, long long nkv4, float scale) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < nq4 + nkv4;
       i += (long long)gridDim.x * NT) {
    if (i < nq4) {
      const float4 x = dq_acc[i];
      dq[i] = make_uint2(pack_bf16(x.x * scale, x.y * scale), pack_bf16(x.z * scale, x.w * scale));
    } else {
      const long long j = i - nq4;
      const float4 x = dk_acc[j], y = dv_acc[j];
      dk[j] = make_uint2(pack_bf16(x.x * scale, x.y * scale), pack_bf16(x.z * scale, x.w * scale));
      dv[j] = make_uint2(pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
    }
  }
}

// The workspace (fp32): D_i and lse * log2(e), [B * H, Sqp] each (Sqp = Sq
// rounded up to 64), the dQ accumulator [B, H, Sq, D], and under GQA the
// dK and dV accumulators [B, Hkv, Sk, D] each: prep, wgmma, finish.
template <int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* ws, void* dq, void* dk,
                          void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                          float softcap, int causal, int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int Sqp = (Sq + 63) / 64 * 64;
  const long long rows = (long long)B * H * Sqp;
  const long long nq = (long long)B * H * Sq * D, nkv = H == Hkv ? 0 : (long long)B * Hkv * Sk * D;
  mx::BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  float* delta = ws;
  float* lse2 = ws + rows;
  a.delta = delta;
  a.lse2 = lse2;
  a.dq_acc = lse2 + rows;
  a.dk_acc = nkv ? a.dq_acc + nq : nullptr;
  a.dv_acc = nkv ? a.dq_acc + nq + nkv : nullptr;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window;
  const long long prep_blocks = (rows * 32 + NT - 1) / NT;
  if (prep_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_prep<D><<<(unsigned)prep_blocks, NT, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, delta, lse2, a.dq_acc,
      reinterpret_cast<float4*>(a.dk_acc), Sq, Sqp, rows, 2 * nkv / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = mx::launch_bwd_wgmma<D>(a, stream);
  if (err != cudaSuccess) return err;
  const long long n4 = (nq + nkv) / 4;
  const long long finish_blocks = (n4 + NT - 1) / NT < 132 * 16 ? (n4 + NT - 1) / NT : 132 * 16;
  flash_bwd_finish<<<(unsigned)finish_blocks, NT, 0, stream>>>(
      reinterpret_cast<const float4*>(a.dq_acc), static_cast<uint2*>(dq), nq / 4,
      reinterpret_cast<const float4*>(a.dk_acc), reinterpret_cast<const float4*>(a.dv_acc),
      static_cast<uint2*>(dk), static_cast<uint2*>(dv), nkv / 4, scale);
  return cudaGetLastError();
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

// fp32 at every head dim and bf16 at D = 32: the D_i kernel into the
// workspace's first B * H * Sq floats, then the two-kernel form
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
                         const void* dout, const float* lse, float* ws, void* dq, void* dk,
                         void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                         float softcap, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<float, D>(q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale,
                                softcap, causal, window, stream);
  if (dtype == 1) {
    if constexpr (D == 32)
      return launch_bwd<__nv_bfloat16, 32>(q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq,
                                           Sk, scale, softcap, causal, window, stream);
    else
      return launch_bwd_tc<D>(q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq, Sk, scale,
                              softcap, causal, window, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, do, dq: [B, H, Sq, D]; k, v, dk, dv: [B, Hkv, Sk, D]; lse: fp32
// [B, H, Sq] from mx_flash_attention_lse; ws: fp32 scratch the kernels
// take (ops/attention.py backward_workspace_floats): B * H * Sq floats (D_i)
// for fp32 and bf16 at D = 32; for bf16 at D = 64, 96, 128, 2 * B * H * Sqp
// (Sqp = Sq rounded up to 64) + B * H * Sq * D, + 2 * B * Hkv * Sk * D when
// H != Hkv. All contiguous and 16-byte aligned; dtype 0 = float32, 1 =
// bfloat16 for the tensors that are not lse or ws. D in {32, 64, 96, 128}.
// Launches three kernels on `stream` without synchronising and returns
// cudaGetLastError() (0 = ok).
extern "C" int mx_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* ws, void* dq,
                                      void* dk, void* dv, int dtype, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, float scale, float softcap,
                                      int causal, int window, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (Hkv < 1 || H % Hkv != 0 || B < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_typed<32>(dtype, q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq,
                                   Sk, scale, softcap, causal, window, s);
    case 64:
      return (int)launch_typed<64>(dtype, q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq,
                                   Sk, scale, softcap, causal, window, s);
    case 96:
      return (int)launch_typed<96>(dtype, q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq,
                                   Sk, scale, softcap, causal, window, s);
    case 128:
      return (int)launch_typed<128>(dtype, q, k, v, o, dout, lse, ws, dq, dk, dv, B, H, Hkv, Sq,
                                    Sk, scale, softcap, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#endif  // MX_BWD_WGMMA
