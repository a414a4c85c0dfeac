// Shared helpers of the repro_torch CUDA kernels (sm_90a).
//
// Tiles are staged in shared memory as float32 whatever the input type, so
// every product and reduction runs in f32, as in the JAX package's kernels.
#pragma once

#include <climits>

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

}  // namespace repro_torch
