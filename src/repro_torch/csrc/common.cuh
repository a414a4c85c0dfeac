// Shared helpers of the repro_torch CUDA kernels (sm_90a).
//
// The CUDA-core kernels stage their tiles in shared memory as float32
// whatever the input type (load_rows), so every product and reduction runs
// in f32, as in the JAX package's kernels. The tensor-core kernels (the
// bf16 forward of flash_fwd.cuh and backward of flash_bwd.cuh) keep bf16
// tiles of 64 rows in shared memory, filled by cp.async, and multiply with
// mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix: the
// primitives and tile helpers at the end of this file.
#pragma once

#include <climits>
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// finite stand-in for -inf (core/combine.py): keeps every merge NaN-free
constexpr float NEG_INF = -1e30f;
constexpr float DEAD = NEG_INF / 2.0f;

// The mask of the JAX kernels: _mask_tile for one (query, key) pair and
// _tile_live for a tile (causal / sliding window / prefix-LM).
struct Mask {
  int causal, has_window, window, has_prefix, prefix_len;

  __device__ inline bool visible(int pq, int pk) const {
    bool m = true;
    if (causal) {
      bool cm = pk <= pq;
      if (has_prefix) cm |= pk < prefix_len;
      m &= cm;
    }
    if (has_window) {
      bool wm = (pq - pk) < window;
      if (!causal) wm &= (pk - pq) < window;
      if (has_prefix) wm |= pk < prefix_len;
      m &= wm;
    }
    return m;
  }

  // does a tile whose positions span [qmin, qmax] x [kmin, kmax] have any
  // visible pair? (min/max because zigzag positions are not sorted)
  __device__ inline bool live(int qmin, int qmax, int kmin, int kmax) const {
    bool l = true;
    if (causal) l &= kmin <= qmax;
    if (has_window) {
      l &= (qmin - kmax) < window;
      if (!causal) l &= (kmin - qmax) < window;
    }
    if (has_prefix) l |= kmin < prefix_len;
    return l;
  }

  // is every pair of such a tile visible? (then visible() may be skipped:
  // it would return true for each pair)
  __device__ inline bool full(int qmin, int qmax, int kmin, int kmax) const {
    const bool pre = has_prefix && kmax < prefix_len;
    bool f = true;
    if (causal) f &= kmax <= qmin || pre;
    if (has_window) {
      bool w = (qmax - kmin) < window;
      if (!causal) w &= (kmax - qmin) < window;
      f &= w || pre;
    }
    return f;
  }
};

// [min, max] of pos[0..n) over one warp (every lane gets the result)
__device__ inline void warp_range(const int* pos, int n, int lane, int& lo,
                                  int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = lane; i < n; i += 32) {
    lo = min(lo, pos[i]);
    hi = max(hi, pos[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static inline void unpack(const uint4& raw, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
  __device__ static inline float to_float(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static inline void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static inline float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// Copy `nrows` rows of D elements (row r at src + r * src_stride) into
// shared memory as f32 with row stride `ld`; rows >= nvalid are zero-filled
// so masked products stay finite. The row length in bytes is a multiple of
// 16 for every type and head size the wrappers accept, so each thread moves
// 16 bytes per load (the wrappers check that the base pointers are 16-byte
// aligned).
template <typename T, int D>
__device__ inline void load_rows(float* dst, int ld, const T* src,
                                 size_t src_stride, int nvalid, int nrows,
                                 int tid, int nthreads) {
  constexpr int VEC = Vec16<T>::N;
  static_assert((D * sizeof(T)) % 16 == 0, "rows must be whole 16-byte chunks");
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int e = tid; e < nrows * CPR; e += nthreads) {
    const int r = e / CPR;
    const int c = e - r * CPR;
    float vals[VEC];
    if (r < nvalid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)r * src_stride + c * VEC);
      Vec16<T>::unpack(raw, vals);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) vals[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[r * ld + c * VEC + u] = vals[u];
  }
}

// ---- tensor-core primitives: cp.async, ldmatrix, mma.sync (bf16) ----

// 16 bytes global -> shared, asynchronously; valid = false zero-fills them
// (src must still be a mapped address: callers pass the tile's first row)
__device__ inline void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one int or float) global -> shared, zero-filled if !valid
__device__ inline void cp_async_4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory; lane i addresses row i % 8 of
// matrix i / 8. Plain: lane l gets row l / 4, columns 2 (l % 4) + {0, 1};
// .trans: column l / 4, rows 2 (l % 4) + {0, 1}.
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b for a 16x16 bf16 A fragment (row-major), a 16x8 bf16 B fragment
// (b0: k rows 0-7, b1: k rows 8-15) and a 16x8 f32 accumulator. Lane l
// holds c rows l / 4 (c[0], c[1]) and l / 4 + 8 (c[2], c[3]), columns
// 2 (l % 4) + {0, 1}; a[0..3] are the same rows for k columns
// 2 (l % 4) + {0, 1} (a[0], a[1]) and + 8 (a[2], a[3]).
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair hi = bf16(x, y) and the pair of what it left out,
// lo = bf16(x - hi.x, y - hi.y): hi + lo carries x and y to ~2^-16 of
// their size, so two MMAs (hi, then lo) keep an f32 operand's precision.
// Zero splits into (0, 0).
__device__ inline void split_bf16x2(float x, float y, uint32_t& hi,
                                    uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}


// ---- 64-row bf16 tiles of the tensor-core kernels (flash_fwd.cuh,
// flash_bwd.cuh) ----

using bf16 = __nv_bfloat16;

constexpr int MMA_NT = 128;  // four warps, 16 rows of the 64-row tile each
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned char TILE_LIVE = 1;  // the tile has a visible pair
constexpr unsigned char TILE_FULL = 2;  // 64 rows, every pair visible

// smem row stride (elements) and size (bytes) of a 64 x D bf16 tile
template <int D>
struct MmaTile {
  static constexpr int LDS = D + 8;
  static constexpr int ELEMS = 64 * LDS;
  static constexpr size_t BYTES = sizeof(bf16) * ELEMS;
};

// Asynchronous copy of rows [0, nvalid) of a 64 x D bf16 tile (row r at
// src + r * stride) into shared memory with row stride D + 8, by NTHR
// threads (tid in [0, NTHR)); the rows past nvalid are zero-filled, so
// masked products stay finite.
template <int D, int NTHR = MMA_NT>
__device__ inline void tile_async(bf16* dst, const bf16* src, size_t stride,
                                  int nvalid, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((64 * CPR) % NTHR == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NTHR; ++it) {
    const int e = tid + it * NTHR;
    const int r = e / CPR;
    const int c = e - r * CPR;
    const bool ok = r < nvalid;
    cp_async_16(dst + r * MmaTile<D>::LDS + c * 8,
                src + (size_t)(ok ? r : 0) * stride + c * 8, ok);
  }
}

// One flag byte per streamed 64-row tile of positions pos[0..S): TILE_LIVE
// if some pair with the CTA's own tile (positions [lo, hi]) is visible,
// TILE_FULL if the tile has 64 rows and every pair is. `streamed_q`: the
// streamed tiles are query tiles (the dk/dv kernel), else key tiles.
__device__ inline void tile_flags(unsigned char* flags, const int* pos,
                                  int S, bool streamed_q, int lo, int hi,
                                  const Mask& m, int warp, int lane) {
  const int n_t = (S + 63) / 64;
  for (int t = warp; t < n_t; t += MMA_NT / 32) {
    const int n = min(64, S - t * 64);
    int tlo, thi;
    warp_range(pos + t * 64, n, lane, tlo, thi);
    const bool live = streamed_q ? m.live(tlo, thi, lo, hi)
                                 : m.live(lo, hi, tlo, thi);
    const bool full = n == 64 && (streamed_q ? m.full(tlo, thi, lo, hi)
                                             : m.full(lo, hi, tlo, thi));
    if (lane == 0) flags[t] = (live ? TILE_LIVE : 0) | (full ? TILE_FULL : 0);
  }
}

// part = (hi + lo) B for the warp's 16 rows and the 16 columns
// [16 dn, 16 dn + 16) of B (two n8 tiles), over KC k16 chunks: hi, lo are
// A fragments (a bf16 hi/lo pair, e.g. taken from S accumulator fragments,
// two adjacent n8 tiles per k16 chunk), B is rows row0 .. row0 + 16 KC of
// a 64 x D bf16 tile read by ldmatrix.trans. `part` starts at zero: the
// caller adds it to its running sum with one f32 operation, so no MMA
// chain runs longer than 2 KC products.
template <int D, int KC>
__device__ __forceinline__ void pair_products(float (&part)[2][4],
                                              const uint32_t (&hi)[KC][4],
                                              const uint32_t (&lo)[KC][4],
                                              const bf16* tile, int row0,
                                              int dn, int lane) {
  constexpr int LDS = MmaTile<D>::LDS;
#pragma unroll
  for (int e = 0; e < 4; ++e) part[0][e] = part[1][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int off =
        (row0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
        dn * 16 + (lane >> 4) * 8;
    uint32_t b[4];
    ldsm_x4_t(b, tile + off);
    mma_bf16(part[0], hi[kc], b[0], b[1]);
    mma_bf16(part[0], lo[kc], b[0], b[1]);
    mma_bf16(part[1], hi[kc], b[2], b[3]);
    mma_bf16(part[1], lo[kc], b[2], b[3]);
  }
}

// Resident CTAs per SM (the CUDA occupancy API) of a kernel of MMA_NT
// threads with `smem` bytes of dynamic shared memory
template <typename Kern>
cudaError_t occupancy_of(Kern kern, size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, MMA_NT,
                                                       smem);
}

}  // namespace repro_torch
