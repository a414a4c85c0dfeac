// The block flash-attention forward kernel shared by B1/B2
// (flash_fwd.cu) and B5 (ragged_prefill.cu).
//
// Semantics (kept op for op from the Pallas kernels' _fwd_kernel,
// _fwd_merge_kernel and ragged_prefill._fwd_kernel): the mask comes from
// position vectors (causal, sliding window, prefix-LM: _mask_tile); a K tile
// whose min/max positions show it fully masked is skipped (_tile_live;
// min/max because zigzag positions are not sorted); the online softmax keeps
// the guards of _fwd_accumulate (m_safe, p *= mask, alpha = 0 while the row
// is dead); the finalize follows _block_partial and the MERGE epilogue
// follows _fwd_merge_kernel. Dead rows give o = 0 and lse = -1e30 exactly.
// Sq and Sk need not be multiples of the tile: the ragged edge is masked.
// Layouts: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in f32 or bf16; o, o_acc
// (B,Sq,Hq,D) f32; lse, lse_acc (B,Hq,Sq) f32; GQA via kv_head = h / G.
// Positions are read at pos_q + b * pos_q_bstride (and likewise for keys):
// a batch stride of 0 shares one (S,) vector over the batch (B1/B2), a
// stride of S reads per-row (B,S) positions (B5), so tile liveness is
// decided per (b, tile).
//
// Design, simple first: the TPU's sequential K grid axis becomes a loop
// inside one CTA. One CTA of 256 threads owns a (b, h, 64-row query tile);
// four threads share a query row (16 score columns and D/4 output columns
// each). Q, K and V tiles are staged in shared memory as f32 with a padded
// row stride (D+1) that spreads the banks; loads move 16 bytes a thread.
// Products run on the CUDA cores in f32, not on the tensor cores, so the
// kernel is far from the operations bound; wgmma/TMA tiles are later work.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per K/V tile
constexpr int NT = 256;         // threads per CTA
constexpr int TPR = NT / BQ;    // threads per query row (4, adjacent lanes)
constexpr int COLS = BK / TPR;  // score columns per thread
constexpr int LDP = BK + 1;     // padded stride of the P tile

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos_q;
  const int* pos_k;
  const float* o_acc;
  const float* lse_acc;
  float* o;
  float* lse;
  int B, Sq, Sk, Hq, Hkv;
  int pos_q_bstride, pos_k_bstride;  // 0: shared (S,) positions
  Mask mask;
  float scale;
};

// One K/V tile's online-softmax update of a query row (_fwd_accumulate,
// guards op for op): the row's scores against the thread's 16 columns
// c = cg + TPR*i of the staged tile, masked by visible(c); then the row's
// running max m, sum l and D/TPR output columns acc. The P tile goes
// through shared memory: the row's four threads are adjacent lanes.
template <int D, typename Visible>
__device__ inline void tile_update(const float* sQ, const float* sK,
                                   const float* sV, float* sP, int row,
                                   int cg, float scale, Visible visible,
                                   float& m_i, float& l_i,
                                   float (&acc)[(D + TPR - 1) / TPR]) {
  constexpr int LD = D + 1;
  constexpr int DPT = (D + TPR - 1) / TPR;
  float s[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) s[i] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qv = sQ[row * LD + d];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] += qv * sK[(cg + TPR * i) * LD + d];
  }
  bool mk[COLS];
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    mk[i] = visible(cg + TPR * i);
    s[i] = mk[i] ? s[i] * scale : NEG_INF;
    mx = fmaxf(mx, s[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_cur = fmaxf(m_i, mx);
  const float m_safe = m_cur <= DEAD ? 0.0f : m_cur;
  float psum = 0.0f;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const float p = mk[i] ? expf(s[i] - m_safe) : 0.0f;
    psum += p;
    sP[row * LDP + cg + TPR * i] = p;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  psum += __shfl_xor_sync(0xffffffffu, psum, 2);
  const float alpha = m_i <= DEAD ? 0.0f : expf(m_i - m_safe);
  l_i = l_i * alpha + psum;
  __syncwarp();  // the row's P entries come from the same warp

  float pv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) pv[j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    const float p = sP[row * LDP + c];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = cg + TPR * j;
      if (d < D) pv[j] += p * sV[c * LD + d];
    }
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = acc[j] * alpha + pv[j];
  m_i = m_cur;
}

template <typename T, int D, bool MERGE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(FwdArgs a) {
  constexpr int LD = D + 1;                     // padded smem row stride
  constexpr int DPT = (D + TPR - 1) / TPR;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                             // BQ x LD
  float* sK = sQ + BQ * LD;                     // BK x LD
  float* sV = sK + BK * LD;                     // BK x LD
  float* sP = sV + BK * LD;                     // BQ x LDP
  int* sPosQ = reinterpret_cast<int*>(sP + BQ * LDP);
  int* sPosK = sPosQ + BQ;
  __shared__ int sQmin, sQmax, sLive;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int nq = min(BQ, a.Sq - q0);
  const int row = tid / TPR;
  const int cg = tid % TPR;
  const int* pos_q = a.pos_q + (size_t)b * a.pos_q_bstride;
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  load_rows<T, D>(sQ, LD, q + ((size_t)(b * a.Sq + q0) * a.Hq + h) * D,
                  (size_t)a.Hq * D, nq, BQ, tid, NT);
  if (tid < BQ) sPosQ[tid] = tid < nq ? pos_q[q0 + tid] : 0;
  __syncthreads();
  if (tid < 32) {
    int lo, hi;
    warp_range(sPosQ, nq, tid, lo, hi);
    if (tid == 0) { sQmin = lo; sQmax = hi; }
  }

  const int pq = sPosQ[row];
  float m_i = NEG_INF, l_i = 0.0f;
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
      // _tile_live over this tile's valid keys
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

    tile_update<D>(sQ, sK, sV, sP, row, cg, a.scale,
                   [&](int c) {
                     return c < nk && a.mask.visible(pq, sPosK[c]);
                   },
                   m_i, l_i, acc);
  }

  if (row >= nq) return;
  // _block_partial
  const bool dead = m_i <= DEAD;
  const float l_safe = l_i == 0.0f ? 1.0f : l_i;
  float lse_out = dead ? NEG_INF : m_i + logf(l_safe);
  const size_t o_row = ((size_t)(b * a.Sq + q0 + row) * a.Hq + h) * D;
  const size_t l_idx = ((size_t)b * a.Hq + h) * a.Sq + q0 + row;
  float w1 = 0.0f, w2 = 1.0f, denom_safe = 1.0f;
  if (MERGE) {
    // combine_pair(o_acc, lse_acc, o_blk, lse_blk), op for op
    const float lse_prev = a.lse_acc[l_idx];
    const float m2 = fmaxf(lse_prev, lse_out);
    const bool both_dead = m2 <= DEAD;
    const float m2_safe = both_dead ? 0.0f : m2;
    w1 = expf(lse_prev - m2_safe);
    w2 = expf(lse_out - m2_safe);
    const float denom = w1 + w2;
    denom_safe = denom == 0.0f ? 1.0f : denom;
    lse_out = both_dead ? NEG_INF : m2_safe + logf(denom_safe);
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = cg + TPR * j;
    if (d < D) {
      const float o_blk = acc[j] / l_safe;
      a.o[o_row + d] =
          MERGE ? (w1 * a.o_acc[o_row + d] + w2 * o_blk) / denom_safe : o_blk;
    }
  }
  if (cg == 0) a.lse[l_idx] = lse_out;
}

template <typename T, int D, bool MERGE>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)BK * LD + BQ * LDP) +
      sizeof(int) * (BQ + BK);
  auto kern = flash_fwd_kernel<T, D, MERGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool MERGE>
cudaError_t launch_fwd_d(const FwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fwd<T, 32, MERGE>(a, stream);
    case 64: return launch_fwd<T, 64, MERGE>(a, stream);
    case 80: return launch_fwd<T, 80, MERGE>(a, stream);
    case 128: return launch_fwd<T, 128, MERGE>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch
