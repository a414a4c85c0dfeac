// Ragged block flash-attention forward (B5): per-row (B, S) positions.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ragged_prefill.py:
// ragged_prefill_fwd -> _fwd_kernel. It is B1 with every batch row reading
// its own position window: pos_q (B,Sq) and pos_k (B,Sk) int32, where
// validity is positional (an unfilled cache slot's key position is pushed
// past every query, so the causal mask drops it). The kernel is
// flash_fwd.cuh's with batch strides Sq and Sk on the positions, so the
// min/max tile skip is taken per (b, tile) and a row whose keys are all
// masked (a zero-length row) finalises to o = 0, lse = -1e30 exactly.
// Layouts: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) f32 or bf16; o (B,Sq,Hq,D) f32;
// lse (B,Hq,Sq) f32.
//
// On the static-batch serve path (launch.serve --legacy) it runs once per
// layer and decode step at q (B,1,32,80) against the capacity-sized
// contiguous cache k/v (B,capacity,8,80) bf16. Bound on an H100 there:
// bytes (the cache's K and V read once; 4*D FLOPs per key and query head is
// far below the card's ratio of operations to bytes).
//
// Design: the kernels of flash_fwd.cuh (bf16: flash_fwd_mma). Rows are
// packed (query, head) pairs of one kv group, so at the decode shape
// (Sq = 1, G = 4) one CTA per (b, kv head) holds the group's 4 live rows
// and reads each K/V tile once for them, where a per-head 64-query tile
// held 1 live row and read the cache G times. That gives only B * Hkv = 32
// CTAs on 132 SMs, so at Sq * G <= 16 the CTA's 4 warps split its K/V
// tiles among them and merge their partial softmax states at the end.
// Splitting the keys across CTAs as well is later work.

#include "flash_fwd.cuh"

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int repro_ragged_prefill(
    const void* q, const void* k, const void* v, const int* pos_q,
    const int* pos_k, float* o, float* lse, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, int dtype, int causal, int has_window, int window,
    int has_prefix, int prefix_len, float scale, void* stream) {
  using namespace repro_torch;
  FwdArgs a{q, k, v, pos_q, pos_k, nullptr, nullptr, o, lse, B, Sq, Sk, Hq,
            Hkv, Sq, Sk,
            Mask{causal, has_window, window, has_prefix, prefix_len}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) err = launch_fwd_d<__nv_bfloat16, false>(a, D, st);
  else if (dtype == 0) err = launch_fwd_d<float, false>(a, D, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
