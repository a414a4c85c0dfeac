// Block flash-attention backward (B3): dq, and dk/dv, of one Q block
// against one K/V block, from the global lse and delta = rowsum(dO * O).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_attention_bwd -> _bwd_dq_kernel   (dq: grid (B, Hq, n_q, n_k),
//                                             accumulate over the K tiles)
//                       -> _bwd_dkv_kernel  (dk, dv: grid (B, Hkv, n_k,
//                                             G * n_q), accumulate over the
//                                             group's query heads and tiles)
// Semantics (kept op for op from _bwd_dq_accumulate / _bwd_dkv_accumulate):
//   s = q k^T * scale; masked entries set to -1e30 BEFORE the exp (a masked
//   raw score can exceed lse, and exp would overflow); p = exp(s - lse),
//   with p = 0 on rows whose lse is dead (<= -1e30 / 2); dp = dO v^T;
//   ds = p (dp - delta) * scale; dq += ds k; dv += p^T dO; dk += ds^T q.
// A K (or Q) tile whose min/max positions show it fully masked is skipped
// (_tile_live). Dead rows give dq = 0 and add nothing to dk, dv, exactly.
// Sq and Sk need not be multiples of the tile: the ragged edge is masked.
// Layouts: q, dO (B,Sq,Hq,D), k, v (B,Sk,Hkv,D) in f32 or bf16; lse, delta
// (B,Hq,Sq) f32; dq (B,Sq,Hq,D), dk, dv (B,Sk,Hkv,D) f32; GQA via
// kv_head = h / G.
//
// Bound on an H100: at the training slice's shape (Sq = Sk = 4096, 32 query
// heads of D = 80, 8 kv heads, causal, bf16 in) the five products (the
// recomputed scores, dp, dq, dk, dv) are 10*D FLOPs per visible (q, k) pair
// and query head: 0.21 TFLOP, 0.22 ms at the bf16 tensor-core peak; the
// ~116 MB moved (q, k, v, dO, lse, delta in; dq, dk, dv out in f32) take
// 0.035 ms at 3.35 TB/s. So it is bound by operations.
//
// Design, simple first: two kernels, each a loop inside one CTA in place of
// the TPU's sequential grid axis, in a fixed order and without atomics, so
// two runs give the same bits (as the JAX two-kernel design does).
//   dq kernel: one CTA of 256 threads per (b, h, 64-row query tile); it
//     loops over the K tiles. Four adjacent lanes share a query row: each
//     takes 16 of the tile's 64 key columns for s and dp, and D/4 columns
//     of dq.
//   dk/dv kernel: one CTA per (b, kv head, 64-key tile); it loops over the
//     G query heads of the group and, for each, every query tile. Four
//     lanes share a key row: each takes 16 query columns for s and dp, and
//     D/4 columns of dk and dv, kept in registers in f32.
// Tiles are staged in shared memory as f32 with a padded row stride (D+1).
// At D = 80 that is ~100 KB (dq) and ~117 KB (dk/dv), past the 48 KB
// default, so each launch first raises cudaFuncAttributeMaxDynamicShared-
// MemorySize. Products run on the CUDA cores in f32, not on the tensor
// cores: the kernel is far from its operations bound (wgmma/TMA are later
// work).

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
  Mask mask;
  float scale;
};

// lse, delta and positions of query rows [q0, q0 + nq) of head h; rows past
// nq are dead (lse = -1e30), so they contribute p = 0
__device__ inline void load_row_stats(const BwdArgs& a, int b, int h, int q0,
                                      int nq, int tid, float* sLse,
                                      float* sDelta, int* sPosQ) {
  if (tid < BQ) {
    const bool ok = tid < nq;
    const size_t li = ((size_t)b * a.Hq + h) * a.Sq + q0 + tid;
    sLse[tid] = ok ? a.lse[li] : NEG_INF;
    sDelta[tid] = ok ? a.delta[li] : 0.0f;
    sPosQ[tid] = ok ? a.pos_q[q0 + tid] : 0;
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
  load_row_stats(a, b, h, q0, nq, tid, sLse, sDelta, sPosQ);
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
    if (tid < BK) sPosK[tid] = tid < nk ? a.pos_k[k0 + tid] : 0;
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
  if (tid < BK) sPosK[tid] = tid < nk ? a.pos_k[k0 + tid] : 0;
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
      load_row_stats(a, b, h, q0, nq, tid, sLse, sDelta, sPosQ);
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
cudaError_t launch_one(Kern kern, dim3 grid, size_t smem, const BwdArgs& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int LD = D + 1;
  // four f32 tiles of 64 x (D+1), the dS (and P) tiles, row stats, positions
  const size_t stats = 2 * sizeof(float) * BQ + sizeof(int) * (BQ + BK);
  const size_t smem_dq =
      sizeof(float) * (4 * (size_t)64 * LD + (size_t)BQ * LDP) + stats;
  const size_t smem_dkv =
      sizeof(float) * (4 * (size_t)64 * LD + 2 * (size_t)BK * LDP) + stats;
  cudaError_t err = launch_one(flash_bwd_dq_kernel<T, D>,
                               dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B), smem_dq,
                               a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(flash_bwd_dkv_kernel<T, D>,
                    dim3((a.Sk + BK - 1) / BK, a.Hkv, a.B), smem_dkv, a,
                    stream);
}

template <typename T>
cudaError_t launch_d(const BwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout
// share it). Launches the dq kernel, then the dk/dv kernel, on `stream`.
// Returns the cudaError_t of the first launch that fails, else 0.
extern "C" int repro_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* pos_q, const int* pos_k,
    float* dq, float* dk, float* dv, int B, int Sq, int Sk, int Hq, int Hkv,
    int D, int dtype, int causal, int has_window, int window, int has_prefix,
    int prefix_len, float scale, void* stream) {
  using namespace repro_torch;
  BwdArgs a{q, k, v, dout, lse, delta, pos_q, pos_k, dq, dk, dv, B, Sq, Sk,
            Hq, Hkv, Mask{causal, has_window, window, has_prefix, prefix_len},
            scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(a, D, st);
  } else if (dtype == 0) {
    err = launch_d<float>(a, D, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
