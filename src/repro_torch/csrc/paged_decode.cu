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
// Design, simple first: the TPU's sequential page axis becomes a loop inside
// one CTA. One CTA of 4 warps owns a (b, kv_head) pair and serves all G
// query heads of that group, so each live page's K/V is read from memory
// once (not G times). The CTA reads table[b, w] itself, never dereferences
// -1, stages the page's K and V in shared memory (16-byte loads, f32,
// padded stride), and each warp runs the online softmax of one query head:
// lane i scores key i, the warp reduces max/sum with shuffles, and each
// lane accumulates D/32 output columns. One CTA per (b, kv_head) leaves most
// SMs idle at small batch; splitting the page loop across CTAs is later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;
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
__global__ void __launch_bounds__(NT)
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
                  G, tid, NT);
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
    load_rows<T, D>(sK, LD, pk + off, (size_t)a.Hkv * D, ps, ps, tid, NT);
    load_rows<T, D>(sV, LD, pv + off, (size_t)a.Hkv * D, ps, ps, tid, NT);
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
  kern<<<grid, NT, smem, stream>>>(a);
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

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q and the pools
// share it). Returns the cudaError_t of the launch.
extern "C" int repro_paged_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* cache_len, float* o, float* lse, int B, int Hq, int Hkv,
    int D, int pages_loc, int page_size, int W, int sp, int rank,
    int has_window, int window, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (Hq % Hkv || Hq / Hkv > NWARP * MAX_HPW || page_size > 32 * MAX_KPL ||
      page_size < 1)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, pool_k, pool_v, table, cache_len, o, lse, B, Hq, Hkv,
               pages_loc, page_size, W, sp, rank, has_window, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) err = launch_d<__nv_bfloat16>(a, D, st);
  else if (dtype == 0) err = launch_d<float>(a, D, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
