// Paged suffix-prefill attention (B6): a block of suffix queries against the
// cached prefix in this SP shard's page-table-indexed slice of the pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_prefill.py:
// paged_prefill_attention -> _kernel. Row b's query i sits at global
// position cached_len[b] + i. Page w of row b covers the global positions
// [(w*sp + rank)*page_size, ... + page_size) (the round-robin layout of
// engine/paged_cache.py). A page is skipped, with the Pallas kernel's
// scalar tests, when it is unallocated (table < 0), when it starts at or
// past cached_len (suffix pages being written by this very prefill), or,
// with a window, when its newest key is already out of the window of the
// tile's oldest query. A key at position p is visible iff p < cached_len
// (strict: the suffix scores itself through the dense B1 partial) and, with
// a window, pos_q - p < window; causality against the suffix queries is
// then automatic. Rows with no visible key (every row at cached_len = 0, all
// rows of a window that slid past the prefix) finalise to o = 0 and
// lse = -1e30 exactly, so combine_pair with the suffix partial stays exact.
// Layouts: q (B,Sq,Hq,D); pool_k/pool_v (pages_loc,page_size,Hkv,D); table
// (B,W) int32, -1 = unallocated; cached_len (B,) int32; o (B,Sq,Hq,D) f32;
// lse (B,Hq,Sq) f32.
//
// Bound on an H100: at the engine's shapes (a 256-query chunk of 32 heads of
// 80 against a 1024-token prefix, bf16) the ~2.7 GFLOP (4*D per visible
// pair and query head) at the bf16 peak take ~2.7 us and the ~6.6 MB moved
// (q and the live pages in, o and lse out in f32) ~2 us: bound by
// operations, nearly balanced.
//
// bf16 inputs (the main path) run flash_fwd.cuh's tensor-core forward
// (flash_fwd_mma) over its paged K/V source: B1's tile with a page-table
// loader. One CTA of 128 threads owns 64 packed (query, head) rows of one
// (b, kv head) (grid (Hkv, B, ceil(Sq * G / 64))), so each cached page is
// read once per kv group, not once per query head. Each 64-key tile is
// 64 / page_size (floor) consecutive table entries; the CTA reads and tests
// them itself (the page test uses the CTA's oldest query for the window), never
// dereferences -1, and fetches each valid key row straight from the pool by
// cp.async into double buffers (no dense gather), zero-filling rows that
// hold no valid key; a tile with no live page is skipped whole. Pages larger
// than 64 keys span several tiles, each a 64-row slice of the page; at head
// size 256 the output's D is split over 2 CTAs of 128 columns. S and P V
// run on mma.sync with P as a bf16 hi/lo pair, and the partial finalises as
// _block_partial (the caller combines it with the suffix's B1 partial).
// f32 inputs (never on the main path; they keep the f32 tests exact at
// 2e-5) run paged_prefill_kernel below: one CTA of 256 threads per (b,
// query head, 64-query tile), each 64-key tile (flash_fwd.cuh's paged tile
// mapping, any page size) staged in shared memory as f32 with a D+1 stride,
// products on the CUDA cores through flash_fwd.cuh's tile_update.

#include "flash_fwd.cuh"

namespace repro_torch {
namespace {

struct PrefillArgs {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* table;
  const int* cached_len;
  float* o;
  float* lse;
  int B, Sq, Hq, Hkv, pages_loc, page_size, W, sp, rank;
  int has_window, window;
  float scale;
};

// Stage BK key rows of one kv head: tile row r is pool row sRow[r] (page *
// ps + slot), zero-filled where it holds no valid key (sRow < 0).
template <typename T, int D>
__device__ inline void load_pool_rows(float* dst, int ld, const T* pool,
                                      const int* sRow, int Hkv, int kvh,
                                      int tid) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int e = tid; e < BK * CPR; e += NT) {
    const int r = e / CPR;
    const int c = e - r * CPR;
    const int prow = sRow[r];
    float vals[VEC];
    if (prow >= 0) {
      const size_t row = (size_t)prow * Hkv + kvh;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(pool + row * D + c * VEC);
      Vec16<T>::unpack(raw, vals);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) vals[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[r * ld + c * VEC + u] = vals[u];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_prefill_kernel(PrefillArgs a) {
  constexpr int LD = D + 1;                     // padded smem row stride
  constexpr int DPT = (D + TPR - 1) / TPR;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                             // BQ x LD
  float* sK = sQ + BQ * LD;                     // BK x LD
  float* sV = sK + BK * LD;                     // BK x LD
  float* sP = sV + BK * LD;                     // BQ x LDP
  int* sPosK = reinterpret_cast<int*>(sP + BQ * LDP);  // BK; -1 = invalid
  int* sRow = sPosK + BK;                       // BK pool rows; -1 = none
  __shared__ int sAny;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int nq = min(BQ, a.Sq - q0);
  const int row = tid / TPR;
  const int cg = tid % TPR;
  const int ps = a.page_size;
  const int cl = a.cached_len[b];
  const int pq = cl + q0 + row;                 // this row's position
  const int* table = a.table + (size_t)b * a.W;

  const T* q = static_cast<const T*>(a.q);
  const T* pk = static_cast<const T*>(a.pool_k);
  const T* pv = static_cast<const T*>(a.pool_v);
  load_rows<T, D>(sQ, LD, q + ((size_t)(b * a.Sq + q0) * a.Hq + h) * D,
                  (size_t)a.Hq * D, nq, BQ, tid, NT);

  float m_i = NEG_INF, l_i = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.0f;

  const int n_t = paged_tiles(ps, a.W);
  for (int t = 0; t < n_t; ++t) {
    __syncthreads();  // the previous tile's smem reads are done
    if (tid == 0) sAny = 0;
    __syncthreads();
    if (tid < BK) {
      // row tid of the tile, its page under the Pallas kernel's pl.when
      // test; the oldest query of the tile sits at cl + q0
      int w, slot, prow = -1, pos = -1;
      if (paged_slot(ps, t, tid, w, slot) && w < a.W) {
        const int entry = table[w];
        const int base = (w * a.sp + a.rank) * ps;
        bool live = entry >= 0 && entry < a.pages_loc && base < cl;
        if (a.has_window) live &= (cl + q0 - (base + ps - 1)) < a.window;
        if (live && base + slot < cl) {
          prow = entry * ps + slot;
          pos = base + slot;
        }
      }
      sRow[tid] = prow;
      sPosK[tid] = pos;
      if (prow >= 0) sAny = 1;
    }
    __syncthreads();
    if (!sAny) continue;  // uniform: no row of the tile holds a valid key
    load_pool_rows<T, D>(sK, LD, pk, sRow, a.Hkv, kvh, tid);
    load_pool_rows<T, D>(sV, LD, pv, sRow, a.Hkv, kvh, tid);
    __syncthreads();

    tile_update<D>(sQ, sK, sV, sP, row, cg, a.scale,
                   [&](int c) {
                     const int pos = sPosK[c];
                     return pos >= 0 &&
                            (!a.has_window || (pq - pos) < a.window);
                   },
                   m_i, l_i, acc);
  }

  if (row >= nq) return;
  const bool dead = m_i <= DEAD;
  const float l_safe = l_i == 0.0f ? 1.0f : l_i;
  const size_t o_row = ((size_t)(b * a.Sq + q0 + row) * a.Hq + h) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = cg + TPR * j;
    if (d < D) a.o[o_row + d] = acc[j] / l_safe;
  }
  if (cg == 0)
    a.lse[((size_t)b * a.Hq + h) * a.Sq + q0 + row] =
        dead ? NEG_INF : m_i + logf(l_safe);
}

template <typename T, int D>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)BK * LD + BQ * LDP) +
      sizeof(int) * 2 * BK;
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const PrefillArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry for ctypes. dtype: 0 = float32 (paged_prefill_kernel), 1 =
// bfloat16 (flash_fwd_mma over the paged source); q and the pools share
// it. Any page size. Returns the cudaError_t of the launch.
extern "C" int repro_paged_prefill(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* cached_len, float* o, float* lse, int B, int Sq, int Hq,
    int Hkv, int D, int pages_loc, int page_size, int W, int sp, int rank,
    int has_window, int window, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (Hkv < 1 || Hq % Hkv || page_size < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    FwdArgs f{q, pool_k, pool_v, nullptr, nullptr, nullptr, nullptr, o, lse,
              B, Sq, 0, Hq, Hkv, 0, 0, Mask{1, has_window, window, 0, 0},
              scale,
              Paged{table, cached_len, nullptr, nullptr, pages_loc,
                    page_size, W, sp, rank, 0}};
    return (int)launch_paged_mma_d<false>(f, D, 1, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, pool_k, pool_v, table, cached_len, o, lse, B, Sq, Hq,
                Hkv, pages_loc, page_size, W, sp, rank, has_window, window,
                scale};
  return (int)launch_d<float>(a, D, st);
}
