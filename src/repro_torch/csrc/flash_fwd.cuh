// The block flash-attention forward kernels shared by B1/B2
// (flash_fwd.cu) and B5 (ragged_prefill.cu), and, through the paged K/V
// source, by B4 (paged_decode.cu) and B6 (paged_prefill.cu) on bf16 inputs.
//
// Semantics (kept op for op from the Pallas kernels' _fwd_kernel,
// _fwd_merge_kernel and ragged_prefill._fwd_kernel): the mask comes from
// position vectors (causal, sliding window, prefix-LM: _mask_tile); a K tile
// whose min/max positions show it fully masked is skipped (_tile_live;
// min/max because zigzag positions are not sorted); the online softmax keeps
// the guards of _fwd_accumulate (masked s = -1e30 before the max, m_safe,
// p = 0 where masked, alpha = 0 while the row is dead); the finalize follows
// _block_partial and the MERGE epilogue follows _fwd_merge_kernel
// (combine_pair). Dead rows give o = 0 and lse = -1e30 exactly. Sq and Sk
// need not be multiples of the tile: the ragged edge is masked.
// Layouts: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in f32 or bf16; o, o_acc
// (B,Sq,Hq,D) f32; lse, lse_acc (B,Hq,Sq) f32; GQA via kv_head = h / G.
// Positions are read at pos_q + b * pos_q_bstride (and likewise for keys):
// a batch stride of 0 shares one (S,) vector over the batch (B1/B2), a
// stride of S reads per-row (B,S) positions (B5), so tile liveness is
// decided per (b, tile). No atomics: two runs give the same bits.
//
// What bounds it on an H100: at the main path's shapes the work is
// 4*D FLOPs per visible (query, key) pair and query head against a few
// bytes per key: bound by operations at long sequences (seq 4096: 0.087 ms
// at the bf16 tensor-core peak) and by bytes near 1K tokens, where the two
// nearly meet (~5.5 us); at the decode shape (Sq = 1) by bytes, the K/V
// cache read once.
//
// bf16 inputs (the main path) run on the tensor cores (flash_fwd_mma):
// - Rows are packed (query, head) pairs: the Sq * G rows of one kv group
//   are R = i * G + g (query i of head kv_head * G + g), and one CTA of 128
//   threads (four warps, 16 rows each) owns 64 consecutive packed rows of
//   one (b, kv head). Each K/V tile is then read once for the G heads that
//   use it (the f32 kernel reads it G times), and at the decode shape
//   (Sq = 1) a CTA holds G live rows, not one. G need not divide 64: a
//   tile may start inside a query; its query range for masking and
//   liveness is [R0 / G, (R0 + 63) / G]. Warps whose 16 rows all lie past
//   Sq * G only help load.
// - When every live row fits one 16-row slab (Sq * G <= 16: the decode
//   shape) and there is no merge (B1, B5), the keys are split inside the
//   CTA instead: each of 4 warps (2 at D = 128, 256) computes those rows
//   against every 4th live K/V tile with its own cp.async double buffer,
//   and the warps' (m, l, acc) are merged in warp order at the end (the
//   same merge as alpha's, so dead rows stay exact and two runs give the
//   same bits). A per-CTA walk would hold one warp's work and one tile in
//   flight on each of B * Hkv SMs.
// - S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate). Q's A
//   fragments are read once per CTA by ldmatrix and stay in registers; K
//   comes from a bf16 tile in shared memory with a row stride of D + 8, so
//   the eight 16-byte rows of each ldmatrix phase fall in distinct banks.
// - K, V and key positions are double-buffered with cp.async: the next
//   live tile's copy overlaps this tile's MMAs; rows past Sk are
//   zero-filled (a garbage V row times p = 0 could give NaN). Which tiles
//   are live, and which have every pair visible (the per-element mask is
//   then skipped, without changing a bit), is decided once per CTA from the
//   min/max positions of each tile. The heaviest query tiles go first under
//   causal masking (the packed-row tile is the slowest grid axis, issued
//   from the last).
// - The online softmax runs in registers on the S accumulator fragments:
//   s is scaled by scale * log2 e and exponentiated with ex2.approx, the
//   row max and row sum are reduced over the four lanes of a quad, and l
//   sums the f32 p. A tile whose every pair is visible takes a path without
//   the per-element mask.
// - P enters P V as a bf16 hi/lo pair (split_bf16x2, two MMAs), taken from
//   the S fragments as the A operand (two adjacent n8 tiles form one k16
//   tile); V is read by ldmatrix.trans. One bf16 rounding of P would put o
//   ~1e-3 off on short rows, ten times the 1e-4 bound
//   (tests/test_torch_fwd_split.py emulates this arithmetic on the CPU).
// - The tensor cores' f32 accumulation truncates, so each tile's P V goes
//   into a fresh accumulator and then acc = acc * alpha + pv with one f32
//   multiply-add: no MMA chain runs longer than one tile.
// - ~57 KB of dynamic shared memory at D = 80 (Q, two K and two V tiles,
//   positions, a flag byte per K tile): three CTAs per SM at ~166
//   registers; ~194 KB with the keys split (one CTA per SM).
// - Head size 256 (paligemma-3b): Q's fragments alone would be 64
//   registers a thread and the f32 output accumulator 128, past the 255
//   limit with S and P. So above D = 128 the output's D is split over
//   CTAs (fwd_dv: 128 output columns each, the grid's x axis Hkv * 2):
//   each CTA computes the whole S = Q K^T (QK^T twice over the pair, the
//   price of the split) but P V and the accumulator only for its 128
//   columns, from a V tile of those columns; Q's fragments are read from
//   shared memory by ldmatrix for each K tile instead of being held. Both
//   CTAs compute the same softmax state bit for bit; the first writes lse.
//   Shared memory: Q (64 x 264), two K tiles (64 x 264) and two half V
//   tiles (64 x 136), ~136 KB, one CTA per SM; with the keys split the Q
//   tile is the 16 live rows, so two walking warps' buffers fit (~214 KB).
// - The paged source (PAGED, B4 and B6): K and V are read from the pools
//   (pages_loc, page_size, Hkv, D) through a page table. Pages of up to 64
//   keys: a 64-key tile is 64 / page_size (floor) consecutive table
//   entries, row r being slot r % page_size of entry r / page_size. Larger
//   pages: a page spans ceil(page_size / 64) tiles, each a 64-row slice of
//   it, the rows past the page's end holding no key. The CTA reads the
//   row's entries into shared memory once, testing each as the Pallas
//   kernels' pl.when does (a dead or out-of-pool entry is never
//   dereferenced), and each tile row is fetched by cp.async from its pool
//   row, zero-filled where it holds no valid key. Query positions are
//   computed (lens[b] + i), key positions too ((w * sp + rank) * page_size
//   + slot, or past every query of the CTA when the row holds no valid
//   key, so the causal mask drops it), and the tile flags come from them
//   (so a window that starts inside a large page skips the slices wholly
//   out of it). A table too long for shared memory goes in chunks
//   (paged_chunk_tiles: at most 4,096 key tiles and 2,048 entries), each
//   read, flagged and walked in turn, the walkers dealt each chunk's live
//   tiles afresh. Above D = 128 the output's D is split over CTAs as for the
//   dense source (each CTA fetches every K column and its own 128 V
//   columns). With SPLIT (B4) the live tiles are also split over gridDim.z
//   CTAs per (b, kv head, D slice) (split-KV), whose partials the last CTA
//   to finish merges in split order from a workspace.
//
// f32 inputs (never on the main path; they keep the f32 tests exact) run
// the CUDA-core kernel flash_fwd_kernel: one CTA of 256 threads per
// (b, h, 64-row query tile), four threads per query row, Q, K and V staged
// in shared memory as f32 with a D+1 stride, every product a scalar FMA
// (~214 KB of shared memory at D = 256, one CTA per SM).
// tile_update serves only f32 inputs: flash_fwd_kernel's and B6's
// (paged_prefill.cu: paged_prefill_kernel).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per K/V tile
// The paged source's keys go in chunks of at most FLAG_CAP key tiles whose
// table entries number at most TABLE_CAP (paged_chunk_tiles): the chunk's
// flags and entries are what flash_fwd_mma holds of them in shared memory
constexpr int FLAG_CAP = 4096;
constexpr int TABLE_CAP = 2048;
constexpr int NT = 256;         // threads per CTA
constexpr int TPR = NT / BQ;    // threads per query row (4, adjacent lanes)
constexpr int COLS = BK / TPR;  // score columns per thread
constexpr int LDP = BK + 1;     // padded stride of the P tile

// The paged K/V source of flash_fwd_mma<..., PAGED = true> (B4, B6): k and
// v point at the pools (pages_loc, ps, Hkv, D), read through this shard's
// page table (B, W) (-1 = unallocated; page w of row b covers positions
// [(w * sp + rank) * ps, ... + ps)); query i of row b sits at position
// lens[b] + i, and a key is valid below lens[b] + lim_off (B4: p <=
// cache_len, lim_off 1; B6: p < cached_len, lim_off 0). ws and tickets are
// B4's split-KV workspace (gridDim.z > 1): the CTAs' partial (m, l, acc)
// and one zeroed counter per (b, kv head).
struct Paged {
  const int* table;
  const int* lens;
  float* ws;
  int* tickets;
  int pages_loc, ps, W, sp, rank, lim_off;
};

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
  Paged pg;  // PAGED kernels only; zero otherwise
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

// ---- bf16: the tensor-core kernel ---------------------------------------

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp, results below 2^-126 flushed
// to 0; 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Warps that walk the K/V tiles apart when the live rows of a CTA fit one
// 16-row slab (Sq * G <= 16, the decode shape): 4, or 2 at D = 128 and
// 256, where 4 warps' double buffers would not fit in shared memory
template <int D>
__host__ __device__ constexpr int fwd_ksplit() { return D > 80 ? 2 : 4; }

// Output columns per CTA: all D up to 128; above, the output's D is split
// over D / 128 CTAs (the register budget, module doc)
template <int D>
__host__ __device__ constexpr int fwd_dv() { return D > 128 ? 128 : D; }

// CTAs over the output's D (D / fwd_dv<D>()) at a head size known only at
// run time
__host__ __device__ constexpr int fwd_d_slices(int D) {
  return D > 128 ? D / 128 : 1;
}

// Rows of the Q tile in shared memory: 64, or with the keys split above
// D = 128 only the 16 rows of slab 0 (the others are never live there)
template <int D, bool SPLIT>
__host__ __device__ constexpr int fwd_qrows() {
  return SPLIT && D > 128 ? 16 : BQ;
}

__host__ __device__ inline bool fwd_split(const FwdArgs& a) {
  return (long long)a.Sq * (a.Hq / a.Hkv) <= 16;
}

// K/V tiles of the paged source. Pages of up to 64 keys: a 64-key tile
// holds 64 / ps (floor) consecutive table entries, row r being slot r % ps
// of entry r / ps, the rows past the tile's whole pages holding no key.
// Larger pages: page w spans tpp = ceil(ps / 64) tiles, tile t being rows
// [64 (t % tpp), + 64) of entry t / tpp, the rows past the page's end
// holding no key. paged_slot gives row r of tile t as (entry w, slot), and
// false where the row lies in no page (w may then be past the table).
__host__ __device__ inline int paged_tiles(int ps, int W) {
  return ps <= BK ? (W + BK / ps - 1) / (BK / ps) : W * ((ps + BK - 1) / BK);
}

__host__ __device__ __forceinline__ bool paged_slot(int ps, int t, int r,
                                                    int& w, int& slot) {
  if (ps <= BK) {
    const int ppt = BK / ps;
    const int j = r / ps;
    w = t * ppt + j;
    slot = r - j * ps;
    return j < ppt;
  }
  const int tpp = (ps + BK - 1) / BK;
  w = t / tpp;
  slot = (t - w * tpp) * BK + r;
  return slot < ps;
}

__host__ __device__ inline int n_key_tiles(const FwdArgs& a, bool paged) {
  return paged ? paged_tiles(a.pg.ps, a.pg.W) : (a.Sk + BK - 1) / BK;
}

// Key tiles of a chunk of the paged source: at most FLAG_CAP, and so few
// that the table entries they read number at most TABLE_CAP (64 / ps
// entries a tile up to 64 keys a page; above, ceil(ps / 64) tiles an
// entry, and a chunk that starts inside a page reads one entry more)
__host__ __device__ inline int paged_chunk_tiles(int ps) {
  return ps <= BK ? min(FLAG_CAP, TABLE_CAP / (BK / ps))
                  : min(FLAG_CAP, (TABLE_CAP - 1) * ((ps + BK - 1) / BK));
}

// The table entries [w0, w1) that key tiles [c0, c1) read (w1 may pass W)
__host__ __device__ inline void paged_entries(int ps, int c0, int c1,
                                              int& w0, int& w1) {
  if (ps <= BK) {
    w0 = c0 * (BK / ps);
    w1 = c1 * (BK / ps);
  } else {
    const int tpp = (ps + BK - 1) / BK;
    w0 = c0 / tpp;
    w1 = (c1 - 1) / tpp + 1;
  }
}

// Shared memory of flash_fwd_mma: the Q tile, double buffers of K and V
// tiles (bf16, row stride D + 8; V holds the CTA's fwd_dv columns) and of
// their key positions (one pair per CTA, or per walking warp when the keys
// are split), one flag byte per K tile; with PAGED, a chunk's table
// entries and flags (at most TABLE_CAP and FLAG_CAP: nothing grows with
// the table past them).
template <int D, bool SPLIT, bool PAGED = false>
size_t smem_fwd_mma(const FwdArgs& a) {
  const int pairs = 2 * (SPLIT ? fwd_ksplit<D>() : 1);
  const int n_k = n_key_tiles(a, PAGED);
  return sizeof(bf16) * fwd_qrows<D, SPLIT>() * MmaTile<D>::LDS +
         pairs * (MmaTile<D>::BYTES + MmaTile<fwd_dv<D>()>::BYTES) +
         pairs * sizeof(int) * BK +
         (PAGED ? sizeof(int) * min(a.pg.W, TABLE_CAP) +
                      min(n_k, paged_chunk_tiles(a.pg.ps))
                : n_k);
}

// The paged source's entries [w0, w1) of row b into sPage[w - w0] as the
// Pallas kernels' pl.when tests them: the page id, or -1 if the entry is
// unallocated or out of the pool, if the page starts at or past the key
// limit, or, with a window, if its newest key is out of the window of the
// CTA's oldest query qlo (the f32 kernels' tests in paged_decode.cu and
// paged_prefill.cu). No page id read here is dereferenced unless it
// passes.
__device__ inline void paged_pages(int* sPage, const FwdArgs& a, int b,
                                   int w0, int w1, int limit, int qlo,
                                   int tid) {
  const Paged& pg = a.pg;
  for (int w = w0 + tid; w < min(w1, pg.W); w += MMA_NT) {
    const int e = pg.table[(size_t)b * pg.W + w];
    const int base = (w * pg.sp + pg.rank) * pg.ps;
    bool live = e >= 0 && e < pg.pages_loc && base < limit;
    if (a.mask.has_window) live &= qlo - (base + pg.ps - 1) < a.mask.window;
    sPage[w - w0] = live ? e : -1;
  }
}

// Row r of paged key tile t of the chunk whose entries start at w0: its
// pool row (page * ps + slot), or -1 when it holds no valid key (in no
// page, past the table, a dead page, or a position at or past `limit`);
// pos gets its key position.
__device__ __forceinline__ int paged_row(const int* sPage, int w0,
                                         const Paged& pg, int t, int r,
                                         int limit, int& pos) {
  int w, slot;
  const bool in = paged_slot(pg.ps, t, r, w, slot);
  pos = (w * pg.sp + pg.rank) * pg.ps + slot;
  if (!in || w >= pg.W) return -1;
  const int page = sPage[w - w0];
  return page >= 0 && pos < limit ? page * pg.ps + slot : -1;
}

// tile_flags for the paged source, over the chunk's key tiles [t0, t1)
// (flags[t - t0]): TILE_LIVE if the tile holds a valid key and the min/max
// of its valid positions allow a visible pair with the CTA's queries
// [lo, hi]; TILE_FULL if all 64 rows are valid keys and every pair is
// visible.
__device__ inline void paged_tile_flags(unsigned char* flags,
                                        const int* sPage, int w0,
                                        const Paged& pg, int t0, int t1,
                                        int limit, int lo, int hi,
                                        const Mask& m, int warp, int lane) {
  for (int t = t0 + warp; t < t1; t += MMA_NT / 32) {
    int kmin = INT_MAX, kmax = INT_MIN, n = 0;
    for (int r = lane; r < BK; r += 32) {
      int pos;
      if (paged_row(sPage, w0, pg, t, r, limit, pos) >= 0) {
        kmin = min(kmin, pos);
        kmax = max(kmax, pos);
        ++n;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
      n += __shfl_xor_sync(0xffffffffu, n, off);
    }
    const bool live = n > 0 && m.live(lo, hi, kmin, kmax);
    const bool full = n == BK && m.full(lo, hi, kmin, kmax);
    if (lane == 0)
      flags[t - t0] = (live ? TILE_LIVE : 0) | (full ? TILE_FULL : 0);
  }
}

// SPLIT: the live rows fit slab 0 (Sq * G <= 16), and every walking warp
// computes them against its own share of the K/V tiles; the shares are
// merged at the end. It is taken only without MERGE, in its own
// instantiation, so the merge and the split-key loop do not share one
// kernel's registers.
// PAGED: K and V come from the paged source (a.pg; B4, B6) and the query
// positions are computed, not loaded. With SPLIT as well (B4), the grid's z
// axis splits the live K/V tiles over CTAs too (split-KV): CTA z's warp w
// walks live tiles z * KSPLIT + w, ... in steps of gridDim.z * KSPLIT, and
// the last CTA of a (b, kv head) merges the CTAs' partials in split order.
// Above D = 128 (fwd_dv) the grid's x axis is Hkv * D / DV: CTA x takes
// kv head x / (D / DV) and output columns [d0, d0 + DV), d0 = DV (x % (D /
// DV)); Q's fragments are then read from shared memory for each K tile.
template <int D, bool MERGE, bool SPLIT, bool PAGED = false>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma(FwdArgs a) {
  constexpr int LDS = MmaTile<D>::LDS;
  constexpr int TILE = MmaTile<D>::ELEMS;
  constexpr int DV = fwd_dv<D>();           // output columns of this CTA
  constexpr int NDS = D / DV;               // CTAs over the output's D
  constexpr bool QREG = DV == D;            // Q's fragments in registers
  constexpr int VTILE = MmaTile<DV>::ELEMS;
  constexpr int QROWS = fwd_qrows<D, SPLIT>();
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr float LN2 = 0.6931471805599453f;
  constexpr int KSPLIT = fwd_ksplit<D>();
  constexpr int pairs = 2 * (SPLIT ? KSPLIT : 1);  // K/V buffer pairs
  static_assert(QROWS * CPR % MMA_NT == 0, "whole Q chunks per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  // K/V buffer pair j: K at j (TILE + VTILE), V (DV columns) after it
  bf16* sKV = sQ + QROWS * LDS;
  int* sPosK = reinterpret_cast<int*>(sKV + pairs * (TILE + VTILE));
  // PAGED: the current chunk's table entries [w0, w1), entry w at
  // sPage[w - w0], -1 = dead page
  int* sPage = sPosK + pairs * BK;
  // a flag byte per key tile (PAGED: of the current chunk [c0, c1), tile
  // t at sFlag[t - c0])
  unsigned char* sFlag = reinterpret_cast<unsigned char*>(
      sPage + (PAGED ? min(a.pg.W, TABLE_CAP) : 0));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // fragment row (and + 8)
  const int tq = lane & 3;   // fragment column pair
  const int kvh = blockIdx.x / NDS;
  const int d0 = (blockIdx.x % NDS) * DV;   // this CTA's output columns
  const int b = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int rows = a.Sq * G;                           // packed rows
  // packed rows [R0, R0 + 64): heaviest first; with split-KV z is the split
  const int R0 = PAGED && SPLIT ? 0 : (gridDim.z - 1 - blockIdx.z) * BQ;
  const int i_lo = R0 / G;
  const int i_hi = min((R0 + BQ - 1) / G, a.Sq - 1);
  const int n_k = n_key_tiles(a, PAGED);
  // PAGED: query i at len_b + i; keys valid below limit
  const int len_b = PAGED ? a.pg.lens[b] : 0;
  const int limit = len_b + a.pg.lim_off;
  const int* pos_q = a.pos_q + (size_t)b * a.pos_q_bstride;
  const int* pos_k = a.pos_k + (size_t)b * a.pos_k_bstride;
  const size_t kv_stride = (size_t)a.Hkv * D;
  // PAGED: the pools, row p of the pool at p * kv_stride from here
  const size_t kv_b = PAGED ? 0 : (size_t)b * a.Sk * kv_stride;
  const bf16* k = static_cast<const bf16*>(a.k) + kv_b + (size_t)kvh * D;
  const bf16* v = static_cast<const bf16*>(a.v) + kv_b + (size_t)kvh * D;
  // packed row R of this (b, kv head) is q row (R / G) * Hq + R % G here
  const bf16* q = static_cast<const bf16*>(a.q) +
                  ((size_t)b * a.Sq * a.Hq + (size_t)kvh * G) * D;

  // Q: 64 (QROWS) packed rows; the rows past Sq * G are zero-filled
#pragma unroll
  for (int it = 0; it < QROWS * CPR / MMA_NT; ++it) {
    const int e = tid + it * MMA_NT;
    const int r = e / CPR;
    const int c = e - r * CPR;
    const int R = R0 + r;
    const bool ok = R < rows;
    const size_t row = ok ? (size_t)(R / G) * a.Hq + R % G : 0;
    cp_async_16(sQ + r * LDS + c * 8, q + row * D + c * 8, ok);
  }
  cp_async_commit();

  // this thread's packed rows 16 slab + gr and + 8: query position (a
  // row past Sq * G is computed on zeros at query i_lo's, never written;
  // its output row is recomputed in the epilogue, not held across the key
  // loop: at D = 256 holding it spilled the merge kernel's registers)
  const int slab = SPLIT ? 0 : warp;
  int pq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = R0 + 16 * slab + gr + 8 * i;
    const int qr = R < rows ? R / G : i_lo;
    pq[i] = PAGED ? len_b + qr : pos_q[qr];
  }
  const bool warp_live = SPLIT ? warp < KSPLIT : R0 + 16 * warp < rows;
  int qlo, qhi;
  if constexpr (PAGED) {
    qlo = len_b + i_lo;
    qhi = len_b + i_hi;
  } else {
    warp_range(pos_q + i_lo, i_hi - i_lo + 1, lane, qlo, qhi);
  }
  // PAGED: the position of a row that holds no valid key, past every query
  // of the CTA, so the causal mask drops it (kernels/paged_decode.py)
  const int pos_dead = qhi + 1;

  // The key tiles [c0, c1) whose flags sFlag holds (all of them, or with
  // PAGED a chunk of paged_chunk_tiles) are walked by the whole CTA in
  // order, or, with SPLIT, by each of the first KSPLIT warps alone: warp w
  // takes live tiles c0 + w, + KSPLIT, ... into its own buffer pairs 2 w
  // and 2 w + 1 (with split-KV, walker z * KSPLIT + w of gridDim.z *
  // KSPLIT)
  const int walker = SPLIT ? (PAGED ? blockIdx.z * KSPLIT : 0) + warp : 0;
  const int step = SPLIT ? (PAGED ? gridDim.z : 1) * KSPLIT : 1;
  int w0 = 0;  // PAGED: the current chunk's first table entry
  auto fetch = [&](int t, int buf) {
    const int slot = SPLIT ? 2 * warp + buf : buf;
    bf16* kd = sKV + slot * (TILE + VTILE);
    if constexpr (PAGED) {
      // two threads per row, each with every other 16-byte chunk: the row's
      // pool row through the table (every K column, the CTA's DV columns of
      // V), zero-filled where it holds no valid key (a garbage V row times
      // p = 0 could give NaN); the even thread of the pair stores the row's
      // position
      constexpr int NTHR = SPLIT ? 32 : MMA_NT;
      constexpr int CPRV = DV / 8;
      constexpr int LDV = MmaTile<DV>::LDS;
      static_assert(CPR % 2 == 0 && CPRV % 2 == 0, "whole chunk pairs");
      const int me = SPLIT ? lane : tid;
#pragma unroll
      for (int it = 0; it < 2 * BK / NTHR; ++it) {
        const int r = me / 2 + it * (NTHR / 2);
        int pos;
        const int prow = paged_row(sPage, w0, a.pg, t, r, limit, pos);
        const bool ok = prow >= 0;
        if ((me & 1) == 0) sPosK[slot * BK + r] = ok ? pos : pos_dead;
        const size_t off = (size_t)(ok ? prow : 0) * kv_stride;
#pragma unroll
        for (int j = 0; j < CPR / 2; ++j) {
          const int c = 2 * j + (me & 1);
          cp_async_16(kd + r * LDS + c * 8, k + off + c * 8, ok);
        }
#pragma unroll
        for (int j = 0; j < CPRV / 2; ++j) {
          const int c = 2 * j + (me & 1);
          cp_async_16(kd + TILE + r * LDV + c * 8, v + off + d0 + c * 8, ok);
        }
      }
    } else {
      const int k0 = t * BK;
      const int nk = min(BK, a.Sk - k0);
      const bf16* ks = k + k0 * kv_stride;
      const bf16* vs = v + k0 * kv_stride + d0;
      if (SPLIT) {
        tile_async<D, 32>(kd, ks, kv_stride, nk, lane);
        tile_async<DV, 32>(kd + TILE, vs, kv_stride, nk, lane);
      } else {
        tile_async<D>(kd, ks, kv_stride, nk, tid);
        tile_async<DV>(kd + TILE, vs, kv_stride, nk, tid);
      }
      for (int r = SPLIT ? lane : tid; r < BK; r += SPLIT ? 32 : MMA_NT)
        cp_async_4(sPosK + slot * BK + r, pos_k + k0 + (r < nk ? r : 0),
                   r < nk);
    }
  };
  auto sync = [&]() {  // the threads that walk the tiles together
    if (SPLIT)
      __syncwarp();
    else
      __syncthreads();
  };

  // Q's A fragments, k16 chunks over D: held in registers up to D = 128,
  // read from shared memory for each K tile above
  const bf16* qa_row = sQ + (16 * slab + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t qf[QREG ? D / 16 : 1][4];
  const float sl2 = a.scale * LOG2E;
  // running max (log2 units: s * scale * log2 e), sum and output of the
  // thread's two rows; acc holds n8 tiles over the CTA's DV columns
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[DV / 8][4] = {};

  // walk key tiles [c0, c1) (tile t's flags at sFlag[t - c0]); the first
  // walk (c0 = 0) waits for Q and takes its fragments
  auto walk = [&](const int c0, const int c1) {
    auto next_live = [&](int t) {
      while (t < c1 && !(sFlag[t - c0] & TILE_LIVE)) ++t;
      return t;
    };
    auto advance = [&](int t, int n) {  // n live tiles on from live tile t
      for (; n > 0 && t < c1; --n) t = next_live(t + 1);
      return t;
    };
    int t = warp_live || !SPLIT ? advance(next_live(c0), walker) : c1;
    if (t < c1) fetch(t, 0);
    cp_async_commit();
    if (c0 == 0) {
      cp_async_wait<1>();  // Q landed
      __syncthreads();
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], qa_row + kk * 16);
      }
    }

    for (int buf = 0; t < c1; buf ^= 1) {
      const int tn = advance(t, step);
      if (tn < c1) fetch(tn, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t landed
      sync();
      if (warp_live) {
        const int slot = SPLIT ? 2 * warp + buf : buf;
        const bf16* kt = sKV + slot * (TILE + VTILE);
        const bf16* vt = kt + TILE;
        const int* pk = sPosK + slot * BK;
        const int nk = PAGED ? BK : min(BK, a.Sk - t * BK);
        const bool full = sFlag[t - c0] & TILE_FULL;

        // S = Q K^T: the warp's 16 rows x 64 keys, eight n8 tiles
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4];
          if constexpr (QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
          } else {
            ldsm_x4(qa, qa_row + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t y[4];
            ldsm_x4(y, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qa, y[0], y[1]);
            mma_bf16(s[2 * np + 1], qa, y[2], y[3]);
          }
        }

        // the online-softmax update of the warp's rows from S, and P as
        // hi/lo A fragments: n8 tiles 2c and 2c + 1 form k16 chunk c. MASKED
        // is false on a tile whose every pair is visible (no per-element
        // mask, the same bits)
        uint32_t ph[4][4], pl[4][4];
        float alpha[2];
        auto update = [&](auto masked) {
          constexpr bool MASKED = decltype(masked)::value;
          uint32_t vis = 0xffffffffu;  // bit 4 j + e: pair visible
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * tq;
            int2 pk2 = make_int2(0, 0);
            if (MASKED) pk2 = *reinterpret_cast<const int2*>(pk + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;  // row gr or gr + 8
              bool ok = true;
              if (MASKED) {
                ok = c + (e & 1) < nk &&
                     a.mask.visible(pq[i], (e & 1) ? pk2.y : pk2.x);
                if (!ok) vis &= ~(1u << (4 * j + e));
              }
              // scaled to log2 units; masked s = -1e30 before the max
              s[j][e] = ok ? s[j][e] * sl2 : NEG_INF;
              mx[i] = fmaxf(mx[i], s[j][e]);
            }
          }
          float m_safe[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_cur = fmaxf(m[i], mx[i]);
            m_safe[i] = m_cur <= DEAD ? 0.0f : m_cur;
            alpha[i] = m[i] <= DEAD ? 0.0f : ex2(m[i] - m_safe[i]);
            m[i] = m_cur;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              // p = 0 where masked
              p[e] = !MASKED || (vis >> (4 * j + e)) & 1u
                         ? ex2(s[j][e] - m_safe[i])
                         : 0.0f;
              psum[i] += p[e];
            }
            const int f = j >> 1, r = (j & 1) * 2;
            split_bf16x2(p[0], p[1], ph[f][r], pl[f][r]);
            split_bf16x2(p[2], p[3], ph[f][r + 1], pl[f][r + 1]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
            psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
            l[i] = l[i] * alpha[i] + psum[i];
          }
        };
        if (full)
          update(std::false_type{});
        else
          update(std::true_type{});

        // acc = acc * alpha + P V, this tile's P V in a fresh accumulator
#pragma unroll
        for (int dn = 0; dn < DV / 16; ++dn) {
          float part[2][4];
          pair_products<DV, 4>(part, ph, pl, vt, 0, dn, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[2 * dn][e] = fmaf(acc[2 * dn][e], alpha[e >> 1], part[0][e]);
            acc[2 * dn + 1][e] =
                fmaf(acc[2 * dn + 1][e], alpha[e >> 1], part[1][e]);
          }
        }
      }
      sync();  // buf is refilled by the next iteration's fetch
      t = tn;
    }
  };
  if constexpr (PAGED) {
    // chunk by chunk: its table entries, its flags, then its walk
    const int chunk = paged_chunk_tiles(a.pg.ps);
    int c0 = 0;
    do {
      const int c1 = min(n_k, c0 + chunk);
      int w1;
      paged_entries(a.pg.ps, c0, c1, w0, w1);
      if (c0 > 0) __syncthreads();  // the last chunk's entries, tiles read
      paged_pages(sPage, a, b, w0, w1, limit, qlo, tid);
      __syncthreads();
      paged_tile_flags(sFlag, sPage, w0, a.pg, c0, c1, limit, qlo, qhi,
                       a.mask, warp, lane);
      __syncthreads();
      walk(c0, c1);
      c0 = c1;
    } while (c0 < n_k);
  } else {
    tile_flags(sFlag, pos_k, a.Sk, false, qlo, qhi, a.mask, warp, lane);
    __syncthreads();
    walk(0, n_k);
  }
  cp_async_wait<0>();

  if (SPLIT) {
    // merge the walking warps' (m, l, acc) of slab 0 in warp order
    // through shared memory (the K/V buffers are free now)
    float* sM = reinterpret_cast<float*>(sKV);  // [KSPLIT][16]
    float* sL = sM + KSPLIT * 16;               // [KSPLIT][16]
    float* sA = sL + KSPLIT * 16;               // [KSPLIT][16][DV]
    __syncthreads();
    if (warp_live) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + gr + 8 * i;
        if (tq == 0) {
          sM[r] = m[i];
          sL[r] = l[i];
        }
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
          *reinterpret_cast<float2*>(sA + r * DV + 8 * n + 2 * tq) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gr + 8 * i;
        float m_tot = NEG_INF;
#pragma unroll
        for (int w = 0; w < KSPLIT; ++w) m_tot = fmaxf(m_tot, sM[w * 16 + r]);
        const float m_safe = m_tot <= DEAD ? 0.0f : m_tot;
        float wt[KSPLIT], l_tot = 0.0f;
#pragma unroll
        for (int w = 0; w < KSPLIT; ++w) {
          const float mw = sM[w * 16 + r];
          wt[w] = mw <= DEAD ? 0.0f : ex2(mw - m_safe);
          l_tot += wt[w] * sL[w * 16 + r];
        }
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int w = 0; w < KSPLIT; ++w) {
            const float2 x = *reinterpret_cast<const float2*>(
                sA + (w * 16 + r) * DV + 8 * n + 2 * tq);
            sum.x += wt[w] * x.x;
            sum.y += wt[w] * x.y;
          }
          acc[n][2 * i] = sum.x;
          acc[n][2 * i + 1] = sum.y;
        }
        m[i] = m_tot;
        l[i] = l_tot;
      }
    }
  }

  if constexpr (PAGED && SPLIT) {
    if (gridDim.z > 1) {
      // split-KV: warp 0's (m, l, acc) of slab 0 go to the workspace, and
      // the last CTA of this (b, kv head, D slice) to arrive (a ticket
      // counter, which it resets for the next call) merges the gridDim.z
      // partials in split order, as the warps' were merged: a split with no
      // live tile (m = -1e30, l = 0) weighs 0, and two runs give the same
      // bits. Workspace: (m, l) [B Hkv NDS S 16], then acc [.. 16][DV]
      const int S = gridDim.z;
      const size_t bk = ((size_t)b * a.Hkv + kvh) * NDS + blockIdx.x % NDS;
      float2* ws_ml = reinterpret_cast<float2*>(a.pg.ws);
      float* ws_acc = a.pg.ws + (size_t)a.B * a.Hkv * NDS * S * 16 * 2;
      __shared__ int sLast;
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const size_t row = (bk * S + blockIdx.z) * 16 + gr + 8 * i;
          if (tq == 0) ws_ml[row] = make_float2(m[i], l[i]);
#pragma unroll
          for (int n = 0; n < DV / 8; ++n)
            *reinterpret_cast<float2*>(ws_acc + row * DV + 8 * n + 2 * tq) =
                make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) sLast = atomicAdd(a.pg.tickets + bk, 1) == S - 1;
      __syncthreads();
      if (!sLast) return;
      __threadfence();
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const size_t row0 = bk * S * 16 + gr + 8 * i;  // + 16 z
          float m_tot = NEG_INF;
          for (int z = 0; z < S; ++z)
            m_tot = fmaxf(m_tot, __ldcg(ws_ml + row0 + 16 * z).x);
          const float m_safe = m_tot <= DEAD ? 0.0f : m_tot;
          float l_tot = 0.0f;
#pragma unroll
          for (int n = 0; n < DV / 8; ++n)
            acc[n][2 * i] = acc[n][2 * i + 1] = 0.0f;
          for (int z = 0; z < S; ++z) {
            const size_t row = row0 + 16 * z;
            const float2 ml = __ldcg(ws_ml + row);
            const float wt = ml.x <= DEAD ? 0.0f : ex2(ml.x - m_safe);
            l_tot += wt * ml.y;
#pragma unroll
            for (int n = 0; n < DV / 8; ++n) {
              const float2 x = __ldcg(reinterpret_cast<const float2*>(
                  ws_acc + row * DV + 8 * n + 2 * tq));
              acc[n][2 * i] += wt * x.x;
              acc[n][2 * i + 1] += wt * x.y;
            }
          }
          m[i] = m_tot;
          l[i] = l_tot;
        }
      }
      if (tid == 0) a.pg.tickets[bk] = 0;
    }
  }

  // _block_partial, then (MERGE) combine_pair with the running accumulator
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = R0 + 16 * slab + gr + 8 * i;  // the output row
    if (R >= rows || (SPLIT && warp != 0)) continue;
    const int qi = R / G, hh = kvh * G + R % G;
    const bool dead = m[i] <= DEAD;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
    float lse_out = dead ? NEG_INF : m[i] * LN2 + logf(l_safe);
    const size_t o_row = ((size_t)(b * a.Sq + qi) * a.Hq + hh) * D + d0;
    const size_t l_idx = ((size_t)b * a.Hq + hh) * a.Sq + qi;
    float w1 = 0.0f, w2 = 1.0f, denom_safe = 1.0f;
    if (MERGE) {
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
    for (int n = 0; n < DV / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      float2 o = make_float2(acc[n][2 * i] / l_safe,
                             acc[n][2 * i + 1] / l_safe);
      if (MERGE) {
        const float2 prev =
            *reinterpret_cast<const float2*>(a.o_acc + o_row + d);
        o = make_float2((w1 * prev.x + w2 * o.x) / denom_safe,
                        (w1 * prev.y + w2 * o.y) / denom_safe);
      }
      *reinterpret_cast<float2*>(a.o + o_row + d) = o;
    }
    if (tq == 0 && d0 == 0) a.lse[l_idx] = lse_out;
  }
}

template <int D, bool MERGE, bool SPLIT>
cudaError_t launch_fwd_mma_as(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = smem_fwd_mma<D, SPLIT>(a);
  auto kern = flash_fwd_mma<D, MERGE, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)a.Sq * (a.Hq / a.Hkv) + BQ - 1) / BQ;
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  kern<<<dim3(a.Hkv * (D / fwd_dv<D>()), a.B, (unsigned)tiles), MMA_NT, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool MERGE>
cudaError_t launch_fwd_mma(const FwdArgs& a, cudaStream_t stream) {
  if (!MERGE && fwd_split(a))
    return launch_fwd_mma_as<D, false, true>(a, stream);
  return launch_fwd_mma_as<D, MERGE, false>(a, stream);
}

// B4 (SPLIT: Sq * G <= 16, the keys split over `splits` CTAs per (b, kv
// head, D slice) and over their warps; G > 16 runs unsplit, as B6 does at
// Sq = 1) and B6 (64 packed rows per CTA) on bf16 inputs: flash_fwd_mma
// over the paged source a.pg, grid (Hkv * D / DV, B, splits or row tiles).
template <int D, bool SPLIT>
cudaError_t launch_paged_mma(const FwdArgs& a, int splits,
                             cudaStream_t stream) {
  const size_t smem = smem_fwd_mma<D, SPLIT, true>(a);
  auto kern = flash_fwd_mma<D, false, SPLIT, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long z =
      SPLIT ? splits
            : ((long long)a.Sq * (a.Hq / a.Hkv) + BQ - 1) / BQ;
  if (z < 1 || z > 65535) return cudaErrorInvalidConfiguration;
  kern<<<dim3(a.Hkv * (D / fwd_dv<D>()), a.B, (unsigned)z), MMA_NT, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch_paged_mma_d(const FwdArgs& a, int D, int splits,
                               cudaStream_t stream) {
  switch (D) {
    case 32: return launch_paged_mma<32, SPLIT>(a, splits, stream);
    case 64: return launch_paged_mma<64, SPLIT>(a, splits, stream);
    case 80: return launch_paged_mma<80, SPLIT>(a, splits, stream);
    case 128: return launch_paged_mma<128, SPLIT>(a, splits, stream);
    case 256: return launch_paged_mma<256, SPLIT>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The forward of one call, by input type: bf16 runs flash_fwd_mma, f32
// the CUDA-core flash_fwd_kernel.
template <typename T, bool MERGE>
cudaError_t launch_fwd_d(const FwdArgs& a, int D, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  switch (D) {
    case 32: return TC ? launch_fwd_mma<32, MERGE>(a, stream)
                       : launch_fwd<float, 32, MERGE>(a, stream);
    case 64: return TC ? launch_fwd_mma<64, MERGE>(a, stream)
                       : launch_fwd<float, 64, MERGE>(a, stream);
    case 80: return TC ? launch_fwd_mma<80, MERGE>(a, stream)
                       : launch_fwd<float, 80, MERGE>(a, stream);
    case 128: return TC ? launch_fwd_mma<128, MERGE>(a, stream)
                        : launch_fwd<float, 128, MERGE>(a, stream);
    case 256: return TC ? launch_fwd_mma<256, MERGE>(a, stream)
                        : launch_fwd<float, 256, MERGE>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch
