// Paged decode attention (B4): one query token per sequence against this
// SP shard's page-table-indexed slice of the paged KV pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py:
// paged_decode_attention -> _kernel. Page w of row b covers the global
// positions [(w*sp + rank)*page_size, ... + page_size) (the round-robin
// layout of engine/paged_cache.py). A page is live iff its table entry is
// >= 0, it does not start in the causal future (base <= cache_len) and,
// with a window, its newest key is inside it (paged_decode.py:65-68). A
// key at position p is visible iff p <= cache_len and, with a window,
// cache_len - p < window. Returns the partial (o, lse) in f32; a row with no
// visible key (an inactive engine slot: cache_len 0, no pages) gives o = 0
// and lse = -1e30 exactly, so the cross-shard combine drops it.
// Layouts: q (B,1,Hq,D); pool_k/pool_v (pages_loc,page_size,Hkv,D); table
// (B,W) int32, -1 = unallocated; cache_len (B,) int32; o (B,1,Hq,D) f32;
// lse (B,Hq,1) f32.
//
// Bound on an H100: bytes. Each live page's K and V (page_size*Hkv*D
// elements each) must be read once; the arithmetic is 4*G*D FLOPs per key
// and head group, far below the card's ratio of operations to bytes.
//
// bf16 inputs (the main path) run flash_fwd.cuh's tensor-core forward
// (flash_fwd_mma) over its paged K/V source, the kernel of B5 at the decode
// shape with a page-table loader:
// - One CTA per (b, kv head) holds the G query heads of the group as
//   packed rows of one 16-row slab (G <= 16), read from Q once; each 64-key
//   tile is 64 / page_size (floor) consecutive table entries, or a 64-row
//   slice of one page when pages are larger, its rows fetched from the pool
//   by cp.async through the table (the CTA reads and tests the entries
//   itself and never dereferences -1), zero-filled where a row holds no
//   valid key, into double buffers; S and P V on mma.sync, P as a bf16
//   hi/lo pair, each tile's P V in a fresh accumulator.
// - The keys are split twice (split-KV): over `splits` CTAs per (b, kv
//   head), sized by the wrapper so that B * Hkv * splits fills the SMs
//   (one CTA per (b, kv head) gave 32 CTAs on 132 SMs at the engine's batch
//   of 4), and over the 4 warps of each CTA (2 at D = 128 and 256); each of
//   the splits * 4 walkers takes every (splits * 4)-th live tile. The warps
//   merge in warp order, then the CTAs' partials go to a workspace and the
//   last CTA of the (b, kv head), found by a ticket counter that it resets,
//   merges them in split order: one launch per call, no atomics on values,
//   the same bits twice.
// - Head size 256: the output's D is split over 2 CTAs of 128 columns (as
//   for B1-B5), each with its own split-KV merge; both compute S over all
//   of D.
// - G > 16 (more query heads than one slab holds): the unsplit kernel of
//   B6 at Sq = 1, 64 packed rows (four 16-row slabs) per CTA, the keys
//   walked by the whole CTA.
// f32 inputs (never on the main path; they keep the f32 tests exact at
// 2e-5) run paged_decode_kernel below on the CUDA cores: one CTA of 4 warps
// per (b, kv head, 16 query heads) walks the live pages in turn, staging
// each page's K and V, 64 rows at a time, in shared memory as f32; each
// warp runs the online softmax of its query heads, lane i scoring key i.

#include "flash_fwd.cuh"

namespace repro_torch {
namespace {

constexpr int NWARP = 4;
constexpr int DEC_NT = 32 * NWARP;
constexpr int MAX_HPW = 4;              // query heads per warp
constexpr int HPC = NWARP * MAX_HPW;    // query heads per CTA (16)
constexpr int MAX_KPL = 2;              // keys per lane
constexpr int KPS = 32 * MAX_KPL;       // keys per staged slice of a page

struct DecodeArgs {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* table;
  const int* cache_len;
  float* o;
  float* lse;
  int B, Hq, Hkv, pages_loc, page_size, W, sp, rank;
  int has_window, window;
  float scale;
};

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (Hkv, B, ceil(G / 16)): CTA z holds query heads [16 z, 16 z + 16)
// of the group; a page is staged in slices of up to 64 rows
template <typename T, int D>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_kernel(DecodeArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  const int G = a.Hq / a.Hkv;
  const int ps = a.page_size;
  float* sQ = smem;              // HPC x D
  float* sK = sQ + HPC * D;      // KPS x LD
  float* sV = sK + KPS * LD;     // KPS x LD

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * HPC;
  const int ng = min(HPC, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* pk = static_cast<const T*>(a.pool_k);
  const T* pv = static_cast<const T*>(a.pool_v);

  load_rows<T, D>(sQ, D, q + ((size_t)b * a.Hq + (size_t)kvh * G + g0) * D,
                  D, ng, ng, tid, DEC_NT);
  const int cl = a.cache_len[b];

  float m[MAX_HPW], l[MAX_HPW], acc[MAX_HPW][DPL];
#pragma unroll
  for (int hh = 0; hh < MAX_HPW; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[hh][j] = 0.0f;
  }

  for (int w = 0; w < a.W; ++w) {
    const int page = a.table[(size_t)b * a.W + w];
    const int base = (w * a.sp + a.rank) * ps;
    bool live = page >= 0 && page < a.pages_loc && base <= cl;
    // newest visible position is cl; oldest is cl - window + 1
    if (a.has_window) live &= (cl - (base + ps - 1)) < a.window;
    if (!live) continue;  // uniform: every thread read the same entry
    for (int s0 = 0; s0 < ps; s0 += KPS) {
      const int n = min(KPS, ps - s0);
      __syncthreads();    // the previous slice's smem reads are done
      const size_t off = (((size_t)page * ps + s0) * a.Hkv + kvh) * D;
      const size_t stride = (size_t)a.Hkv * D;
      load_rows<T, D>(sK, LD, pk + off, stride, n, n, tid, DEC_NT);
      load_rows<T, D>(sV, LD, pv + off, stride, n, n, tid, DEC_NT);
      __syncthreads();

#pragma unroll
      for (int hh = 0; hh < MAX_HPW; ++hh) {
        const int g = warp + NWARP * hh;
        if (g >= ng) break;
        float s[MAX_KPL];
        bool valid[MAX_KPL];
        float mx = NEG_INF;
#pragma unroll
        for (int kk = 0; kk < MAX_KPL; ++kk) {
          const int i = lane + 32 * kk;
          const int pos = base + s0 + i;
          valid[kk] = i < n && pos <= cl &&
                      (!a.has_window || (cl - pos) < a.window);
          float dot = 0.0f;
          if (i < n) {
#pragma unroll 8
            for (int d = 0; d < D; ++d) dot += sQ[g * D + d] * sK[i * LD + d];
          }
          s[kk] = valid[kk] ? dot * a.scale : NEG_INF;
          mx = fmaxf(mx, s[kk]);
        }
        mx = warp_max(mx);
        const float m_cur = fmaxf(m[hh], mx);
        const float m_safe = m_cur <= DEAD ? 0.0f : m_cur;
        float p[MAX_KPL], psum = 0.0f;
#pragma unroll
        for (int kk = 0; kk < MAX_KPL; ++kk) {
          p[kk] = valid[kk] ? expf(s[kk] - m_safe) : 0.0f;
          psum += p[kk];
        }
        psum = warp_sum(psum);
        const float alpha = m[hh] <= DEAD ? 0.0f : expf(m[hh] - m_safe);
        l[hh] = l[hh] * alpha + psum;
        float t[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) t[j] = 0.0f;
        for (int i = 0; i < n; ++i) {
          const float pi =
              __shfl_sync(0xffffffffu, i < 32 ? p[0] : p[1], i & 31);
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < D) t[j] += pi * sV[i * LD + d];
          }
        }
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[hh][j] = acc[hh][j] * alpha + t[j];
        m[hh] = m_cur;
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < MAX_HPW; ++hh) {
    const int g = warp + NWARP * hh;
    if (g >= ng) break;
    const int h = kvh * G + g0 + g;
    const bool dead = m[hh] <= DEAD;
    const float l_safe = l[hh] == 0.0f ? 1.0f : l[hh];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) a.o[((size_t)b * a.Hq + h) * D + d] = acc[hh][j] / l_safe;
    }
    if (lane == 0)
      a.lse[(size_t)b * a.Hq + h] = dead ? NEG_INF : m[hh] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)HPC * D + 2 * (size_t)KPS * (D + 1));
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, (G + HPC - 1) / HPC);
  kern<<<grid, DEC_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 launch splits the keys over CTAs (split-KV) when the G query
// heads of a group fit one 16-row slab and splits > 1; else it runs
// unsplit and takes no scratch
bool split_kv(int Hq, int Hkv, int splits, int dtype) {
  return dtype == 1 && Hq / Hkv <= 16 && splits > 1;
}

}  // namespace
}  // namespace repro_torch

// Scratch of repro_paged_decode at these sizes and `splits`: out[0] floats
// of workspace (the CTAs' partial (m, l, acc): B * Hkv * splits * 16 *
// (D + 2 * NDS), NDS the CTAs over the output's D) and out[1] ticket ints
// (B * Hkv * NDS, zeroed by the caller once: the kernel leaves them at
// zero), both 0 where the launch takes none (f32, G > 16, splits 1).
// Returns 0, or cudaErrorInvalidValue for sizes the launch refuses.
extern "C" int repro_paged_decode_scratch(int B, int Hq, int Hkv, int D,
                                          int splits, int dtype,
                                          long long* out) {
  using namespace repro_torch;
  if (B < 0 || Hkv < 1 || Hq % Hkv || splits < 1)
    return (int)cudaErrorInvalidValue;
  out[0] = out[1] = 0;
  if (split_kv(Hq, Hkv, splits, dtype)) {
    const long long nds = fwd_d_slices(D);
    out[0] = (long long)B * Hkv * splits * 16 * (D + 2 * nds);
    out[1] = (long long)B * Hkv * nds;
  }
  return 0;
}

// C entry for ctypes. dtype: 0 = float32 (paged_decode_kernel), 1 =
// bfloat16 (flash_fwd_mma over the paged source, split over `splits` CTAs
// per (b, kv head, D slice) where split_kv holds, with ws and tickets as
// repro_paged_decode_scratch sizes them; else unsplit, and `splits` is
// not read). q and the pools share the dtype. Returns the cudaError_t of
// the launch.
extern "C" int repro_paged_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* cache_len, float* o, float* lse, float* ws, int* tickets,
    int B, int Hq, int Hkv, int D, int pages_loc, int page_size, int W,
    int sp, int rank, int has_window, int window, int splits, float scale,
    int dtype, void* stream) {
  using namespace repro_torch;
  if (Hkv < 1 || Hq % Hkv || page_size < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool split = split_kv(Hq, Hkv, splits, dtype);
    if (split && (ws == nullptr || tickets == nullptr))
      return (int)cudaErrorInvalidValue;
    FwdArgs f{q, pool_k, pool_v, nullptr, nullptr, nullptr, nullptr, o, lse,
              B, 1, 0, Hq, Hkv, 0, 0, Mask{1, has_window, window, 0, 0},
              scale,
              Paged{table, cache_len, ws, tickets, pages_loc, page_size, W,
                    sp, rank, 1}};
    if (Hq / Hkv <= 16)  // one slab: the split-key layout, one CTA a split
      return (int)launch_paged_mma_d<true>(f, D, split ? splits : 1, st);
    return (int)launch_paged_mma_d<false>(f, D, 1, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, pool_k, pool_v, table, cache_len, o, lse, B, Hq, Hkv,
               pages_loc, page_size, W, sp, rank, has_window, window, scale};
  return (int)launch_d<float>(a, D, st);
}
