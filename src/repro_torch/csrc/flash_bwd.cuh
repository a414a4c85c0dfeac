// The block flash-attention backward kernels shared by B3 (flash_bwd.cu)
// and B7 (ragged_bwd.cu): dq, and dk/dv, of one Q block against one K/V
// block, from the global lse and delta = rowsum(dO * O).
//
// Semantics (kept op for op from the Pallas kernels' _bwd_dq_accumulate /
// _bwd_dkv_accumulate):
//   s = q k^T * scale; masked entries set to -1e30 BEFORE the exp (a masked
//   raw score can exceed lse, and exp would overflow); p = exp(s - lse),
//   with p = 0 on rows whose lse is dead (<= -1e30 / 2); dp = dO v^T;
//   ds = p (dp - delta) * scale; dq += ds k; dv += p^T dO; dk += ds^T q.
// A K (or Q) tile whose min/max positions show it fully masked is skipped
// (_tile_live). Dead rows give dq = 0 and add nothing to dk, dv, exactly.
// Sq and Sk need not be multiples of the tile: the ragged edge is masked.
// Layouts: q, dO (B,Sq,Hq,D), k, v (B,Sk,Hkv,D) in f32 or bf16; lse, delta
// (B,Hq,Sq) f32; dq (B,Sq,Hq,D), dk, dv (B,Sk,Hkv,D) f32; GQA via
// kv_head = h / G. Positions are read at pos_q + b * pos_q_bstride (and
// likewise for keys): a batch stride of 0 shares one (S,) vector over the
// batch (B3), a stride of S reads per-row (B,S) positions (B7), so tile
// liveness is decided per (b, tile).
//
// Two kernels, each a loop inside one CTA in place of the TPU's sequential
// grid axis, in a fixed order and without atomics, so two runs give the
// same bits (as the JAX two-kernel design does):
//   dq kernel: one CTA per (b, h, 64-row query tile); it loops over the
//     live K tiles.
//   dk/dv kernel: one CTA per (b, kv head, 64-key tile); it loops over the
//     G query heads of the group and, for each, every live query tile, in
//     the order t = g * n_q + iq; dk and dv stay in registers in f32.
//
// bf16 inputs (the main path) run on the tensor cores (flash_bwd_*_mma):
// - 128 threads, four warps, each owning 16 rows of the CTA's 64-row tile
//   (query rows in the dq kernel, key rows in the dk/dv kernel). Every
//   product is mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix
//   from bf16 tiles in shared memory; the tiles have a row stride of D + 8
//   elements, so the eight 16-byte rows of each ldmatrix phase fall in
//   distinct banks.
// - dq kernel: S = Q K^T and dP = dO V^T per warp (16 x 64), p and ds in
//   registers, then dQ += dS K with dS taken straight from the S
//   accumulator fragments as the A operand (two adjacent n8 tiles form one
//   k16 tile) and K read by ldmatrix.trans.
// - dk/dv kernel: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//   dK += dS^T Q, P^T and dS^T again from registers, dO and Q by
//   ldmatrix.trans. At D >= 128 the 64 query columns go in two passes of 32
//   to hold the register count.
// - P and dS enter their products as a bf16 hi/lo pair (split_bf16x2, two
//   MMAs): one bf16 rounding of them would put dq, dk, dv ~3e-3 off the
//   f32 result (over 1 + |value|), ten times the 3e-4 bound; the pair
//   keeps them near 1e-5 (tests/test_torch_bwd_split.py emulates this
//   arithmetic on the CPU). The other operands (q, k, v, dO) are bf16 already, so the
//   products are exact and sums are f32. scale is applied to dq and dk once,
//   in the epilogue; p is exp2(s * scale * log2 e - lse * log2 e).
// - The tensor cores' f32 accumulation truncates, so an accumulator that
//   every MMA of a long block feeds drifts (~1e-4 of the result at 4096
//   keys, past 3e-4 at 12288). Each tile's dq (dk, dv) share is therefore
//   summed in a fresh MMA accumulator and added to the running registers
//   with one f32 add.
// - The streamed tiles (K, V and key positions in the dq kernel; Q, dO,
//   lse, delta and query positions in the dk/dv kernel) are double-buffered
//   with cp.async: the next live tile's copy overlaps this tile's MMAs.
//   Which tiles are live (and which have every pair visible, so the
//   per-element mask is skipped without changing a bit) is decided once per
//   CTA from the min/max positions of each tile, into a byte per tile in
//   shared memory.
// - Heaviest tiles first under causal masking: the dq kernel issues its
//   query tiles from the last (grid z = n_q - 1 - iq), the dk/dv kernel
//   its key tiles from the first; the tile index is the slowest grid axis.
// - 68-69 KB of shared memory at D = 80 (two K/V or Q/dO buffers, the
//   resident pair, positions and row stats): the dq kernel fits three CTAs
//   on an SM, the dk/dv kernel two (its registers, not shared memory, are
//   the limit).
//
// - Head size 256 (paligemma-3b): the f32 accumulators (dq 16 x 256, dk
//   and dv 16 x 256 each per warp) cannot sit in registers beside S, dP
//   and their fragments. So above D = 128 the outputs' D is split over
//   CTAs (bwd_dq_dv: 128 dq columns a CTA; bwd_dkv_dv: 64 dk and dv
//   columns a CTA; the grid's x axis multiplied by D / DV): every CTA
//   recomputes the whole S and dP over D = 256 from full tiles and forms
//   only its columns' products, reading the K (dq) or Q and dO (dk/dv)
//   tiles at the column offset. Six 64 x 264 bf16 tiles take ~203 KB of
//   shared memory: one CTA per SM. The dk/dv split also gives a one kv
//   head shape D / 64 = 4 times the CTAs (ROADMAP §B item 6's under-fill).
//
// f32 inputs (never on the main path; they keep the f32 tests exact) run
// the CUDA-core kernels below (flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// 256 threads, four adjacent lanes per row, f32 tiles of 64 x (D+1) in
// shared memory (~100 KB dq, ~117 KB dk/dv at D = 80), every product a
// scalar FMA loop. At D = 256 four such tiles would not fit, so the tiles
// there have 32 rows (f32_rows) with eight lanes per row (~136 KB dq,
// ~140 KB dk/dv).
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per CTA
constexpr int TPR = 4;          // threads per row (adjacent lanes)
constexpr int COLS = 64 / TPR;  // score columns per thread
constexpr int LDP = 64 + 1;     // padded stride of the P / dS tiles
static_assert(BQ == 64 && BK == 64 && NT == BQ * TPR, "tile shape");

// rows per tile of the f32 kernels: 64, or 32 above D = 128 (shared memory)
template <int D>
__host__ __device__ constexpr int f32_rows() { return D > 128 ? 32 : 64; }

// the f32 kernels' tile shape at head size D (shadowing the 64-row
// constants above inside them)
#define F32_TILE_SHAPE(D)                                            \
  constexpr int BQ = f32_rows<D>(), BK = BQ; /* rows per tile */     \
  constexpr int TPR = NT / BQ;    /* threads per row (adjacent) */   \
  constexpr int COLS = BK / TPR;  /* score columns per thread */     \
  constexpr int LDP = BK + 1      /* padded stride of P / dS */

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* pos_q;
  const int* pos_k;
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, Hq, Hkv;
  int pos_q_bstride, pos_k_bstride;  // 0: shared (S,) positions
  Mask mask;
  float scale;
};

// lse, delta and positions of query rows [q0, q0 + nq) of head h (a tile of
// ROWS); rows past nq are dead (lse = -1e30), so they contribute p = 0
template <int ROWS>
__device__ inline void load_row_stats(const BwdArgs& a, int b, int h, int q0,
                                      int nq, int tid, float* sLse,
                                      float* sDelta, int* sPosQ) {
  if (tid < ROWS) {
    const bool ok = tid < nq;
    const size_t li = ((size_t)b * a.Hq + h) * a.Sq + q0 + tid;
    sLse[tid] = ok ? a.lse[li] : NEG_INF;
    sDelta[tid] = ok ? a.delta[li] : 0.0f;
    const int* pos_q = a.pos_q + (size_t)b * a.pos_q_bstride;
    sPosQ[tid] = ok ? pos_q[q0 + tid] : 0;
  }
}

// p and ds of one (query row, key) pair from the raw dot products
__device__ inline void prob_and_ds(const BwdArgs& a, bool vis, float qk,
                                   float dp, float lse, float delta, float& p,
                                   float& ds) {
  const float s = vis ? qk * a.scale : NEG_INF;  // mask BEFORE the exp
  const bool dead = lse <= DEAD;
  p = dead ? 0.0f : expf(s - lse);
  ds = p * (dp - delta) * a.scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(BwdArgs a) {
  F32_TILE_SHAPE(D);
  constexpr int LD = D + 1;
  constexpr int DPT = (D + TPR - 1) / TPR;      // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                             // BQ x LD
  float* sO = sQ + BQ * LD;                     // BQ x LD   (dO)
  float* sK = sO + BQ * LD;                     // BK x LD
  float* sV = sK + BK * LD;                     // BK x LD
  float* sS = sV + BK * LD;                     // BQ x LDP  (ds)
  float* sLse = sS + BQ * LDP;                  // BQ
  float* sDelta = sLse + BQ;                    // BQ
  int* sPosQ = reinterpret_cast<int*>(sDelta + BQ);
  int* sPosK = sPosQ + BQ;
  __shared__ int sQmin, sQmax, sLive;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;
  const int nq = min(BQ, a.Sq - q0);
  const int row = tid / TPR;
  const int cg = tid % TPR;

  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t q_off = ((size_t)(b * a.Sq + q0) * a.Hq + h) * D;
  load_rows<T, D>(sQ, LD, static_cast<const T*>(a.q) + q_off,
                  (size_t)a.Hq * D, nq, BQ, tid, NT);
  load_rows<T, D>(sO, LD, static_cast<const T*>(a.dout) + q_off,
                  (size_t)a.Hq * D, nq, BQ, tid, NT);
  load_row_stats<BQ>(a, b, h, q0, nq, tid, sLse, sDelta, sPosQ);
  __syncthreads();
  if (tid < 32) {
    int lo, hi;
    warp_range(sPosQ, nq, tid, lo, hi);
    if (tid == 0) { sQmin = lo; sQmax = hi; }
  }
  const float lse = sLse[row];
  const float delta = sDelta[row];
  const int pq = sPosQ[row];
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.0f;

  const int n_k = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, a.Sk - k0);
    __syncthreads();  // the previous tile's smem reads are done
    if (tid < BK) sPosK[tid] = tid < nk ? pos_k[k0 + tid] : 0;
    __syncthreads();
    if (tid < 32) {
      int lo, hi;
      warp_range(sPosK, nk, tid, lo, hi);
      if (tid == 0) sLive = a.mask.live(sQmin, sQmax, lo, hi);
    }
    __syncthreads();
    if (!sLive) continue;  // uniform across the CTA
    const size_t kv_off = ((size_t)(b * a.Sk + k0) * a.Hkv + kvh) * D;
    load_rows<T, D>(sK, LD, k + kv_off, (size_t)a.Hkv * D, nk, BK, tid, NT);
    load_rows<T, D>(sV, LD, v + kv_off, (size_t)a.Hkv * D, nk, BK, tid, NT);
    __syncthreads();

    // q.k and dO.v of this row against the thread's columns c = cg + TPR*i
    float qk[COLS], dp[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) qk[i] = dp[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[row * LD + d];
      const float ov = sO[row * LD + d];
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int kc = (cg + TPR * i) * LD + d;
        qk[i] += qv * sK[kc];
        dp[i] += ov * sV[kc];
      }
    }
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int c = cg + TPR * i;
      float p, ds;
      prob_and_ds(a, c < nk && a.mask.visible(pq, sPosK[c]), qk[i], dp[i],
                  lse, delta, p, ds);
      sS[row * LDP + c] = ds;
    }
    __syncwarp();  // the row's dS entries come from the same warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = sS[row * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = cg + TPR * j;
        if (d < D) acc[j] += ds * sK[c * LD + d];
      }
    }
  }

  if (row >= nq) return;
  const size_t o_row = ((size_t)(b * a.Sq + q0 + row) * a.Hq + h) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = cg + TPR * j;
    if (d < D) a.dq[o_row + d] = acc[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(BwdArgs a) {
  F32_TILE_SHAPE(D);
  constexpr int LD = D + 1;
  constexpr int DPT = (D + TPR - 1) / TPR;      // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                             // BK x LD
  float* sV = sK + BK * LD;                     // BK x LD
  float* sQ = sV + BK * LD;                     // BQ x LD
  float* sO = sQ + BQ * LD;                     // BQ x LD   (dO)
  float* sP = sO + BQ * LD;                     // BK x LDP  (p^T)
  float* sS = sP + BK * LDP;                    // BK x LDP  (ds^T)
  float* sLse = sS + BK * LDP;                  // BQ
  float* sDelta = sLse + BQ;                    // BQ
  int* sPosQ = reinterpret_cast<int*>(sDelta + BQ);
  int* sPosK = sPosQ + BQ;
  __shared__ int sKmin, sKmax, sLive;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;
  const int nk = min(BK, a.Sk - k0);
  const int key = tid / TPR;
  const int cg = tid % TPR;

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const size_t kv_off = ((size_t)(b * a.Sk + k0) * a.Hkv + kvh) * D;
  load_rows<T, D>(sK, LD, static_cast<const T*>(a.k) + kv_off,
                  (size_t)a.Hkv * D, nk, BK, tid, NT);
  load_rows<T, D>(sV, LD, static_cast<const T*>(a.v) + kv_off,
                  (size_t)a.Hkv * D, nk, BK, tid, NT);
  if (tid < BK) sPosK[tid] = tid < nk ? pos_k[k0 + tid] : 0;
  __syncthreads();
  if (tid < 32) {
    int lo, hi;
    warp_range(sPosK, nk, tid, lo, hi);
    if (tid == 0) { sKmin = lo; sKmax = hi; }
  }
  const int pk = sPosK[key];
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.0f;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  // t = g * n_q + iq, the order of the TPU grid's last axis
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int iq = 0; iq < n_q; ++iq) {
      const int q0 = iq * BQ;
      const int nq = min(BQ, a.Sq - q0);
      __syncthreads();  // the previous tile's smem reads are done
      load_row_stats<BQ>(a, b, h, q0, nq, tid, sLse, sDelta, sPosQ);
      __syncthreads();
      if (tid < 32) {
        int lo, hi;
        warp_range(sPosQ, nq, tid, lo, hi);
        if (tid == 0) sLive = a.mask.live(lo, hi, sKmin, sKmax);
      }
      __syncthreads();
      if (!sLive) continue;  // uniform across the CTA
      const size_t q_off = ((size_t)(b * a.Sq + q0) * a.Hq + h) * D;
      load_rows<T, D>(sQ, LD, q + q_off, (size_t)a.Hq * D, nq, BQ, tid, NT);
      load_rows<T, D>(sO, LD, dout + q_off, (size_t)a.Hq * D, nq, BQ, tid,
                      NT);
      __syncthreads();

      // k.q and v.dO of this key against the thread's query rows
      // r = cg + TPR*i
      float qk[COLS], dp[COLS];
#pragma unroll
      for (int i = 0; i < COLS; ++i) qk[i] = dp[i] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = sK[key * LD + d];
        const float vv = sV[key * LD + d];
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int qr = (cg + TPR * i) * LD + d;
          qk[i] += sQ[qr] * kv;
          dp[i] += sO[qr] * vv;
        }
      }
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int r = cg + TPR * i;
        float p, ds;
        prob_and_ds(a, r < nq && a.mask.visible(sPosQ[r], pk), qk[i], dp[i],
                    sLse[r], sDelta[r], p, ds);
        sP[key * LDP + r] = p;
        sS[key * LDP + r] = ds;
      }
      __syncwarp();  // the key's P / dS entries come from the same warp

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float p = sP[key * LDP + r];
        const float ds = sS[key * LDP + r];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int d = cg + TPR * j;
          if (d < D) {
            dv[j] += p * sO[r * LD + d];
            dk[j] += ds * sQ[r * LD + d];
          }
        }
      }
    }
  }

  if (key >= nk) return;
  const size_t o_row = ((size_t)(b * a.Sk + k0 + key) * a.Hkv + kvh) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = cg + TPR * j;
    if (d < D) {
      a.dk[o_row + d] = dk[j];
      a.dv[o_row + d] = dv[j];
    }
  }
}

template <typename Kern>
cudaError_t launch_one(Kern kern, dim3 grid, int threads, size_t smem,
                       const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  F32_TILE_SHAPE(D);
  constexpr int LD = D + 1;
  // four f32 tiles of BQ x (D+1), the dS (and P) tiles, row stats,
  // positions
  const size_t stats = 2 * sizeof(float) * BQ + sizeof(int) * (BQ + BK);
  const size_t smem_dq =
      sizeof(float) * (4 * (size_t)BQ * LD + (size_t)BQ * LDP) + stats;
  const size_t smem_dkv =
      sizeof(float) * (4 * (size_t)BQ * LD + 2 * (size_t)BK * LDP) + stats;
  cudaError_t err = launch_one(flash_bwd_dq_kernel<T, D>,
                               dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B), NT,
                               smem_dq, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(flash_bwd_dkv_kernel<T, D>,
                    dim3((a.Sk + BK - 1) / BK, a.Hkv, a.B), NT, smem_dkv, a,
                    stream);
}

template <typename T>
cudaError_t launch_bwd_d(const BwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_bwd<T, 32>(a, stream);
    case 64: return launch_bwd<T, 64>(a, stream);
    case 80: return launch_bwd<T, 80>(a, stream);
    case 128: return launch_bwd<T, 128>(a, stream);
    case 256: return launch_bwd<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: the tensor-core kernels --------------------------------------
// (their tiles, cp.async loads, tile flags and the P / dS products are in
// common.cuh, shared with the forward's flash_fwd_mma)

// s = A1 B1^T and dp = A2 B2^T for the warp's 16 rows of a1, a2 against
// NCOL rows of b1, b2 from row col0 (all 64 x D bf16 tiles in shared
// memory): both as the m16n8 accumulator fragments of NCOL / 8 n8 tiles.
template <int D, int NCOL>
__device__ __forceinline__ void score_products(
    float (&s)[NCOL / 8][4], float (&dp)[NCOL / 8][4], const bf16* a1,
    const bf16* a2, const bf16* b1, const bf16* b2, int warp, int col0,
    int lane) {
  constexpr int LDS = MmaTile<D>::LDS;
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t x1[4], x2[4];
    const int arow = (16 * warp + (lane & 15)) * LDS + kk * 16 +
                     (lane >> 4) * 8;
    ldsm_x4(x1, a1 + arow);
    ldsm_x4(x2, a2 + arow);
#pragma unroll
    for (int np = 0; np < NCOL / 16; ++np) {
      const int boff = (col0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                           LDS + kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t y1[4], y2[4];
      ldsm_x4(y1, b1 + boff);
      ldsm_x4(y2, b2 + boff);
      mma_bf16(s[2 * np], x1, y1[0], y1[1]);
      mma_bf16(s[2 * np + 1], x1, y1[2], y1[3]);
      mma_bf16(dp[2 * np], x2, y2[0], y2[1]);
      mma_bf16(dp[2 * np + 1], x2, y2[2], y2[3]);
    }
  }
}

// acc += (hi + lo) B over KC k16 chunks, for the warp's 16 rows and the DN
// columns of B from `tile` (a 64 x D tile, or one offset to a column)
// (pair_products). Each n8-tile pair's share is summed in a fresh
// accumulator and added with one f32 add: the tensor cores' accumulation
// truncates, so one chain over a long block would drift.
template <int D, int KC, int DN = D>
__device__ __forceinline__ void add_products(float (&acc)[DN / 8][4],
                                             const uint32_t (&hi)[KC][4],
                                             const uint32_t (&lo)[KC][4],
                                             const bf16* tile, int row0,
                                             int lane) {
#pragma unroll
  for (int dn = 0; dn < DN / 16; ++dn) {
    float part[2][4];
    pair_products<D, KC>(part, hi, lo, tile, row0, dn, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dn][e] += part[0][e];
      acc[2 * dn + 1][e] += part[1][e];
    }
  }
}

// dq columns of one CTA of flash_bwd_dq_mma, and dk/dv columns of one CTA
// of flash_bwd_dkv_mma: all D up to 128; above, D is split over CTAs (the
// register budget, module doc)
template <int D>
__host__ __device__ constexpr int bwd_dq_dv() { return D > 128 ? 128 : D; }
template <int D>
__host__ __device__ constexpr int bwd_dkv_dv() { return D > 128 ? 64 : D; }

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dq_mma(BwdArgs a) {
  constexpr int TILE = MmaTile<D>::ELEMS;
  constexpr int DV = bwd_dq_dv<D>();  // dq columns [d0, d0 + DV) here
  constexpr int NDS = D / DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + TILE;                   // dO
  bf16* sK = sO + TILE;                   // two buffers
  bf16* sV = sK + 2 * TILE;               // two buffers
  int* sPosK = reinterpret_cast<int*>(sV + 2 * TILE);  // two buffers of BK
  unsigned char* sFlag = reinterpret_cast<unsigned char*>(sPosK + 2 * BK);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // fragment row (and + 8)
  const int tq = lane & 3;   // fragment column pair
  const int h = blockIdx.x / NDS;
  const int d0 = (blockIdx.x % NDS) * DV;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int kvh = h / (a.Hq / a.Hkv);
  const int nq = min(BQ, a.Sq - q0);
  const int n_k = (a.Sk + BK - 1) / BK;
  const int* pos_q = a.pos_q + (size_t)b * a.pos_q_bstride;
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;
  const size_t kv_stride = (size_t)a.Hkv * D;
  const bf16* k = static_cast<const bf16*>(a.k) +
                  (size_t)b * a.Sk * kv_stride + (size_t)kvh * D;
  const bf16* v = static_cast<const bf16*>(a.v) +
                  (size_t)b * a.Sk * kv_stride + (size_t)kvh * D;

  const size_t q_off = ((size_t)(b * a.Sq + q0) * a.Hq + h) * D;
  tile_async<D>(sQ, static_cast<const bf16*>(a.q) + q_off,
                (size_t)a.Hq * D, nq, tid);
  tile_async<D>(sO, static_cast<const bf16*>(a.dout) + q_off,
                (size_t)a.Hq * D, nq, tid);

  // this thread's query rows 16 warp + gr and + 8: -lse log2 e (-inf on a
  // dead row or past nq, so p = 0 there), delta, position
  float nlse[2], delta[2];
  int pq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + gr + 8 * i;
    const bool ok = row < nq;
    const size_t li = ((size_t)b * a.Hq + h) * a.Sq + q0 + (ok ? row : 0);
    const float lse = ok ? a.lse[li] : NEG_INF;
    nlse[i] = lse <= DEAD ? -INFINITY : -lse * LOG2E;
    delta[i] = ok ? a.delta[li] : 0.0f;
    pq[i] = ok ? pos_q[q0 + row] : 0;
  }
  int qlo, qhi;
  warp_range(pos_q + q0, nq, lane, qlo, qhi);
  tile_flags(sFlag, pos_k, a.Sk, false, qlo, qhi, a.mask, warp, lane);
  __syncthreads();

  auto next_live = [&](int t) {
    while (t < n_k && !(sFlag[t] & TILE_LIVE)) ++t;
    return t;
  };
  auto fetch = [&](int t, int buf) {
    const int k0 = t * BK;
    const int nk = min(BK, a.Sk - k0);
    tile_async<D>(sK + buf * TILE, k + k0 * kv_stride, kv_stride, nk, tid);
    tile_async<D>(sV + buf * TILE, v + k0 * kv_stride, kv_stride, nk, tid);
    if (tid < BK)
      cp_async_4(sPosK + buf * BK + tid, pos_k + k0 + (tid < nk ? tid : 0),
                 tid < nk);
  };

  int t = next_live(0);
  if (t < n_k) fetch(t, 0);
  cp_async_commit();  // with Q and dO

  const float sl2 = a.scale * LOG2E;
  float acc[DV / 8][4] = {};  // dq of the warp's 16 rows, n8 tiles over DV

  for (int buf = 0; t < n_k; buf ^= 1) {
    const int tn = next_live(t + 1);
    if (tn < n_k) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q, dO) landed
    __syncthreads();
    const bf16* kt = sK + buf * TILE;
    const bf16* vt = sV + buf * TILE;
    const int* pk = sPosK + buf * BK;
    const int nk = min(BK, a.Sk - t * BK);
    const bool full = sFlag[t] & TILE_FULL;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
    score_products<D, BK>(s, dp, sQ, sO, kt, vt, warp, 0, lane);

    // ds = p (dp - delta) (scale comes in the epilogue), as hi/lo A
    // fragments: n8 tiles 2c and 2c + 1 form k16 chunk c
    uint32_t dsh[4][4], dsl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      const int2 pk2 = *reinterpret_cast<const int2*>(pk + c);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;  // row gr or gr + 8
        const int cc = c + (e & 1);
        const bool vis =
            full || (cc < nk && a.mask.visible(pq[i], (e & 1) ? pk2.y : pk2.x));
        const float p = vis ? exp2f(fmaf(s[j][e], sl2, nlse[i])) : 0.0f;
        ds[e] = p * (dp[j][e] - delta[i]);
      }
      split_bf16x2(ds[0], ds[1], dsh[j >> 1][(j & 1) * 2],
                   dsl[j >> 1][(j & 1) * 2]);
      split_bf16x2(ds[2], ds[3], dsh[j >> 1][(j & 1) * 2 + 1],
                   dsl[j >> 1][(j & 1) * 2 + 1]);
    }

    // dQ += dS K (K's columns [d0, d0 + DV) as the k x n operand)
    add_products<D, 4, DV>(acc, dsh, dsl, kt + d0, 0, lane);
    __syncthreads();  // buf is refilled by the next iteration's fetch
    t = tn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + gr + 8 * i;
    if (row >= nq) continue;
    float* out =
        a.dq + ((size_t)(b * a.Sq + q0 + row) * a.Hq + h) * D + d0;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * tq) = make_float2(
          acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dkv_mma(BwdArgs a) {
  constexpr int TILE = MmaTile<D>::ELEMS;
  constexpr int DV = bwd_dkv_dv<D>();  // dk/dv columns [d0, d0 + DV) here
  constexpr int NDS = D / DV;
  constexpr int NC = D > 80 ? 32 : 64;  // query columns per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;                   // two buffers
  bf16* sO = sQ + 2 * TILE;               // two buffers (dO)
  float* sLse = reinterpret_cast<float*>(sO + 2 * TILE);  // two of BQ
  float* sDelta = sLse + 2 * BQ;          // two buffers of BQ
  int* sPosQ = reinterpret_cast<int*>(sDelta + 2 * BQ);  // two of BQ
  unsigned char* sFlag = reinterpret_cast<unsigned char*>(sPosQ + 2 * BQ);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int kvh = blockIdx.x / NDS;
  const int d0 = (blockIdx.x % NDS) * DV;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // key tile 0 (heaviest when causal) first
  const int G = a.Hq / a.Hkv;
  const int nk = min(BK, a.Sk - k0);
  const int n_q = (a.Sq + BQ - 1) / BQ;
  const int* pos_q = a.pos_q + (size_t)b * a.pos_q_bstride;
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;
  const size_t q_stride = (size_t)a.Hq * D;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const size_t kv_off = ((size_t)(b * a.Sk + k0) * a.Hkv + kvh) * D;
  tile_async<D>(sK, static_cast<const bf16*>(a.k) + kv_off,
                (size_t)a.Hkv * D, nk, tid);
  tile_async<D>(sV, static_cast<const bf16*>(a.v) + kv_off,
                (size_t)a.Hkv * D, nk, tid);
  int pk[2];  // this thread's key rows 16 warp + gr and + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + gr + 8 * i;
    pk[i] = row < nk ? pos_k[k0 + row] : 0;
  }
  int klo, khi;
  warp_range(pos_k + k0, nk, lane, klo, khi);
  tile_flags(sFlag, pos_q, a.Sq, true, klo, khi, a.mask, warp, lane);
  __syncthreads();

  // (g, iq) -> the next live query tile in the order g * n_q + iq
  auto advance = [&](int& g, int& iq) {
    while (g < G && !(sFlag[iq] & TILE_LIVE)) {
      if (++iq == n_q) {
        iq = 0;
        ++g;
      }
    }
  };
  auto fetch = [&](int g, int iq, int buf) {
    const int h = kvh * G + g;
    const int q0 = iq * BQ;
    const int nq = min(BQ, a.Sq - q0);
    const size_t q_off = ((size_t)(b * a.Sq + q0) * a.Hq + h) * D;
    tile_async<D>(sQ + buf * TILE, q + q_off, q_stride, nq, tid);
    tile_async<D>(sO + buf * TILE, dout + q_off, q_stride, nq, tid);
    if (tid < BQ) {
      const bool ok = tid < nq;
      const int r = ok ? tid : 0;
      const size_t li = ((size_t)b * a.Hq + h) * a.Sq + q0 + r;
      cp_async_4(sLse + buf * BQ + tid, a.lse + li, ok);
      cp_async_4(sDelta + buf * BQ + tid, a.delta + li, ok);
      cp_async_4(sPosQ + buf * BQ + tid, pos_q + q0 + r, ok);
    }
  };

  int g = 0, iq = 0;
  advance(g, iq);
  if (g < G) fetch(g, iq, 0);
  cp_async_commit();  // with K and V

  const float sl2 = a.scale * LOG2E;
  float dk[DV / 8][4] = {}, dv[DV / 8][4] = {};  // the warp's 16 keys

  for (int buf = 0; g < G; buf ^= 1) {
    int gn = g, iqn = iq + 1;
    if (iqn == n_q) {
      iqn = 0;
      ++gn;
    }
    advance(gn, iqn);
    if (gn < G) fetch(gn, iqn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile (g, iq) (and K, V) landed
    __syncthreads();
    const bf16* qt = sQ + buf * TILE;
    const bf16* ot = sO + buf * TILE;
    const float* lt = sLse + buf * BQ;
    const float* dt = sDelta + buf * BQ;
    const int* pt = sPosQ + buf * BQ;
    const int nq = min(BQ, a.Sq - iq * BQ);
    const bool full = sFlag[iq] & TILE_FULL;

#pragma unroll
    for (int hc = 0; hc < BQ / NC; ++hc) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x NC queries
      float s[NC / 8][4], dp[NC / 8][4];
      score_products<D, NC>(s, dp, sK, sV, qt, ot, warp, hc * NC, lane);

      // p^T and ds^T = p (dp - delta) as hi/lo A fragments; rows are keys,
      // columns queries
      uint32_t ph[NC / 16][4], pl[NC / 16][4], dsh[NC / 16][4],
          dsl[NC / 16][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int c = hc * NC + 8 * j + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
        const int2 p2 = *reinterpret_cast<const int2*>(pt + c);
        const float nl[2] = {l2.x <= DEAD ? -INFINITY : -l2.x * LOG2E,
                             l2.y <= DEAD ? -INFINITY : -l2.y * LOG2E};
        const float dl[2] = {d2.x, d2.y};
        const int pqc[2] = {p2.x, p2.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;  // key row gr or gr + 8
          const int u = e & 1;   // query column c or c + 1
          const bool vis =
              full || (c + u < nq && a.mask.visible(pqc[u], pk[i]));
          p[e] = vis ? exp2f(fmaf(s[j][e], sl2, nl[u])) : 0.0f;
          ds[e] = p[e] * (dp[j][e] - dl[u]);
        }
        const int f = j >> 1, r = (j & 1) * 2;
        split_bf16x2(p[0], p[1], ph[f][r], pl[f][r]);
        split_bf16x2(p[2], p[3], ph[f][r + 1], pl[f][r + 1]);
        split_bf16x2(ds[0], ds[1], dsh[f][r], dsl[f][r]);
        split_bf16x2(ds[2], ds[3], dsh[f][r + 1], dsl[f][r + 1]);
      }

      // dV += P^T dO, then dK += dS^T Q (dO, Q as the k x n operands):
      // P's fragments are dead before dK's products start
      add_products<D, NC / 16, DV>(dv, ph, pl, ot + d0, hc * NC, lane);
      add_products<D, NC / 16, DV>(dk, dsh, dsl, qt + d0, hc * NC, lane);
    }
    __syncthreads();  // buf is refilled by the next iteration's fetch
    g = gn;
    iq = iqn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + gr + 8 * i;
    if (row >= nk) continue;
    const size_t o_row =
        ((size_t)(b * a.Sk + k0 + row) * a.Hkv + kvh) * D + d0;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(a.dk + o_row + d) = make_float2(
          dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + o_row + d) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// Dynamic shared memory of the two tensor-core kernels: six bf16 tiles
// (dq: Q, dO and two buffers of K and V; dk/dv: K, V and two buffers of
// Q and dO), the streamed positions (and, for dk/dv, lse and delta), and
// one flag byte per streamed tile.
template <int D>
size_t smem_dq_mma(const BwdArgs& a) {
  return 6 * MmaTile<D>::BYTES + 2 * sizeof(int) * BK + (a.Sk + BK - 1) / BK;
}

template <int D>
size_t smem_dkv_mma(const BwdArgs& a) {
  return 6 * MmaTile<D>::BYTES + 2 * (2 * sizeof(float) + sizeof(int)) * BQ +
         (a.Sq + BQ - 1) / BQ;
}

template <int D>
cudaError_t launch_bwd_mma(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = launch_one(
      flash_bwd_dq_mma<D>,
      dim3(a.Hq * (D / bwd_dq_dv<D>()), a.B, (a.Sq + BQ - 1) / BQ), MMA_NT,
      smem_dq_mma<D>(a), a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(
      flash_bwd_dkv_mma<D>,
      dim3(a.Hkv * (D / bwd_dkv_dv<D>()), a.B, (a.Sk + BK - 1) / BK), MMA_NT,
      smem_dkv_mma<D>(a), a, stream);
}

inline cudaError_t launch_bwd_mma_d(const BwdArgs& a, int D,
                                    cudaStream_t stream) {
  switch (D) {
    case 32: return launch_bwd_mma<32>(a, stream);
    case 64: return launch_bwd_mma<64>(a, stream);
    case 80: return launch_bwd_mma<80>(a, stream);
    case 128: return launch_bwd_mma<128>(a, stream);
    case 256: return launch_bwd_mma<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Resident CTAs per SM (the CUDA occupancy API) and dynamic shared memory
// of the bf16 kernels for the shape in `a`: out = {dq CTAs, dk/dv CTAs, dq
// bytes, dk/dv bytes}.
template <int D>
cudaError_t bwd_occupancy_mma(const BwdArgs& a, int* out) {
  out[2] = (int)smem_dq_mma<D>(a);
  out[3] = (int)smem_dkv_mma<D>(a);
  cudaError_t err = occupancy_of(flash_bwd_dq_mma<D>, out[2], out);
  if (err != cudaSuccess) return err;
  return occupancy_of(flash_bwd_dkv_mma<D>, out[3], out + 1);
}

inline cudaError_t bwd_occupancy(const BwdArgs& a, int D, int* out) {
  switch (D) {
    case 32: return bwd_occupancy_mma<32>(a, out);
    case 64: return bwd_occupancy_mma<64>(a, out);
    case 80: return bwd_occupancy_mma<80>(a, out);
    case 128: return bwd_occupancy_mma<128>(a, out);
    case 256: return bwd_occupancy_mma<256>(a, out);
    default: return cudaErrorInvalidValue;
  }
}

// Both kernels of one backward call. dtype: 0 = float32 (the CUDA-core
// kernels), 1 = bfloat16 (the tensor-core kernels); q, k, v and dout share
// it. Returns the cudaError_t of the first launch that fails, else
// cudaSuccess.
inline cudaError_t run_bwd(const BwdArgs& a, int D, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bwd_mma_d(a, D, st);
  if (dtype == 0) return launch_bwd_d<float>(a, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch
