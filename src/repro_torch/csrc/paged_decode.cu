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
//   tile is 64 / page_size (floor) consecutive table entries, its rows
//   fetched from the pool by cp.async through the table (the CTA reads and
//   tests the entries itself and never dereferences -1), zero-filled where
//   a row holds no valid key, into double buffers; S and P V on mma.sync,
//   P as a bf16 hi/lo pair, each tile's P V in a fresh accumulator.
// - The keys are split twice (split-KV): over `splits` CTAs per (b, kv
//   head), sized by the wrapper so that B * Hkv * splits fills the SMs
//   (one CTA per (b, kv head) gave 32 CTAs on 132 SMs at the engine's batch
//   of 4), and over the 4 warps of each CTA (2 at D = 128); each of the
//   splits * 4 walkers takes every (splits * 4)-th live tile. The warps
//   merge in warp order, then the CTAs' partials go to a workspace and the
//   last CTA of the (b, kv head), found by a ticket counter that it resets,
//   merges them in split order: one launch per call, no atomics on values,
//   the same bits twice.
// f32 inputs (never on the main path; they keep the f32 tests exact at
// 2e-5) run paged_decode_kernel below on the CUDA cores: one CTA of 4 warps
// per (b, kv head) walks the live pages in turn, staging each page's K and
// V in shared memory as f32; each warp runs the online softmax of one query
// head, lane i scoring key i.

#include "flash_fwd.cuh"

namespace repro_torch {
namespace {

constexpr int NWARP = 4;
constexpr int DEC_NT = 32 * NWARP;
constexpr int MAX_HPW = 4;   // query heads per warp -> G <= 16
constexpr int MAX_KPL = 2;   // keys per lane -> page_size <= 64

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

template <typename T, int D>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_kernel(DecodeArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  const int G = a.Hq / a.Hkv;
  const int ps = a.page_size;
  float* sQ = smem;              // G x D
  float* sK = sQ + G * D;        // ps x LD
  float* sV = sK + ps * LD;      // ps x LD

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* pk = static_cast<const T*>(a.pool_k);
  const T* pv = static_cast<const T*>(a.pool_v);

  load_rows<T, D>(sQ, D, q + ((size_t)b * a.Hq + (size_t)kvh * G) * D, D, G,
                  G, tid, DEC_NT);
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
    __syncthreads();      // the previous page's smem reads are done
    const size_t off = ((size_t)page * ps * a.Hkv + kvh) * D;
    const size_t stride = (size_t)a.Hkv * D;
    load_rows<T, D>(sK, LD, pk + off, stride, ps, ps, tid, DEC_NT);
    load_rows<T, D>(sV, LD, pv + off, stride, ps, ps, tid, DEC_NT);
    __syncthreads();

#pragma unroll
    for (int hh = 0; hh < MAX_HPW; ++hh) {
      const int g = warp + NWARP * hh;
      if (g >= G) break;
      float s[MAX_KPL];
      bool valid[MAX_KPL];
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < MAX_KPL; ++kk) {
        const int i = lane + 32 * kk;
        const int pos = base + i;
        valid[kk] = i < ps && pos <= cl &&
                    (!a.has_window || (cl - pos) < a.window);
        float dot = 0.0f;
        if (i < ps) {
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
      for (int i = 0; i < ps; ++i) {
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

#pragma unroll
  for (int hh = 0; hh < MAX_HPW; ++hh) {
    const int g = warp + NWARP * hh;
    if (g >= G) break;
    const int h = kvh * G + g;
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
  const size_t smem = sizeof(float) * ((size_t)G * D + 2 * (size_t)a.page_size * (D + 1));
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B);
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C entry for ctypes. dtype: 0 = float32 (paged_decode_kernel), 1 =
// bfloat16 (flash_fwd_mma over the paged source, split over `splits` CTAs
// per (b, kv head); with splits > 1, ws holds B * Hkv * splits * 16 * (D + 2)
// floats and tickets B * Hkv zeroed ints, left zeroed). q and the pools
// share the dtype. Returns the cudaError_t of the launch.
extern "C" int repro_paged_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* cache_len, float* o, float* lse, float* ws, int* tickets,
    int B, int Hq, int Hkv, int D, int pages_loc, int page_size, int W,
    int sp, int rank, int has_window, int window, int splits, float scale,
    int dtype, void* stream) {
  using namespace repro_torch;
  if (Hq % Hkv || Hq / Hkv > NWARP * MAX_HPW || page_size > 32 * MAX_KPL ||
      page_size < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (splits < 1 || (splits > 1 && (ws == nullptr || tickets == nullptr)))
      return (int)cudaErrorInvalidValue;
    FwdArgs f{q, pool_k, pool_v, nullptr, nullptr, nullptr, nullptr, o, lse,
              B, 1, 0, Hq, Hkv, 0, 0, Mask{1, has_window, window, 0, 0},
              scale,
              Paged{table, cache_len, ws, tickets, pages_loc, page_size, W,
                    sp, rank, 1}};
    return (int)launch_paged_mma_d<true>(f, D, splits, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, pool_k, pool_v, table, cache_len, o, lse, B, Hq, Hkv,
               pages_loc, page_size, W, sp, rank, has_window, window, scale};
  return (int)launch_d<float>(a, D, st);
}
