// Block flash-attention backward (B3): dq, and dk/dv, of one Q block
// against one K/V block, from the global lse and delta = rowsum(dO * O).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_attention_bwd -> _bwd_dq_kernel   (dq: grid (B, Hq, n_q, n_k),
//                                             accumulate over the K tiles)
//                       -> _bwd_dkv_kernel  (dk, dv: grid (B, Hkv, n_k,
//                                             G * n_q), accumulate over the
//                                             group's query heads and tiles)
// It is the kernel pair of flash_bwd.cuh with shared (S,) positions (batch
// strides 0). Semantics and design are described there: on bf16 inputs
// mma.sync tensor-core tiles fed by ldmatrix from cp.async double buffers,
// P and dS as bf16 hi/lo pairs; on f32 inputs CUDA-core f32 tiles.
//
// Bound on an H100: at the training slice's shape (Sq = Sk = 4096, 32 query
// heads of D = 80, 8 kv heads, causal, bf16 in) the five products (the
// recomputed scores, dp, dq, dk, dv) are 10*D FLOPs per visible (q, k) pair
// and query head: 0.21 TFLOP, 0.22 ms at the bf16 tensor-core peak; the
// ~116 MB moved (q, k, v, dO, lse, delta in; dq, dk, dv out in f32) take
// 0.035 ms at 3.35 TB/s. So it is bound by operations. The hi/lo pairs
// double the dq, dk and dv products: the kernels issue 20*D FLOPs of MMA
// per visible pair and query head, twice what the bound counts.

#include "flash_bwd.cuh"

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
            Hq, Hkv, 0, 0,
            Mask{causal, has_window, window, has_prefix, prefix_len}, scale};
  return (int)run_bwd(a, D, dtype, stream);
}

// Resident CTAs per SM and dynamic shared memory (bytes) of the bf16 dq and
// dk/dv kernels at (Sq, Sk, D): out[0..3] = dq CTAs, dk/dv CTAs, dq bytes,
// dk/dv bytes. Returns the cudaError_t of the first query that fails, else
// 0.
extern "C" int repro_flash_bwd_occupancy(int Sq, int Sk, int D, int* out) {
  using namespace repro_torch;
  BwdArgs a{};
  a.Sq = Sq;
  a.Sk = Sk;
  return (int)bwd_occupancy(a, D, out);
}
