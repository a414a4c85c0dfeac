// Ragged block flash-attention backward (B7): per-row (B, S) positions.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
// _flash_attention_bwd_ragged -> _bwd_dq_ragged_kernel (dq) and
// _bwd_dkv_ragged_kernel (dk, dv), the scalar-prefetch form of B3 in which
// every batch row reads its own position window: pos_q (B,Sq) and pos_k
// (B,Sk) int32 (the wrapper broadcasts a shared (S,) vector). Validity is
// positional: a key pushed past every query of its row is never seen. The
// kernels are flash_bwd.cuh's with batch strides Sq and Sk on the
// positions, so the min/max tile skip is taken per (b, tile), and a row
// whose keys are all masked (a zero-length row, lse = -1e30) gives dq = 0
// exactly and adds nothing to dk and dv. No atomics: two runs give the same
// bits. Sq and Sk need not be powers of two or multiples of the 64-row
// tile (the Pallas wrapper's choose_block): the ragged edge is masked.
// Layouts: q, dO (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) f32 or bf16; lse, delta
// (B,Hq,Sq) f32; dq, dk, dv f32 in the shapes of q, k, v.
//
// Bound on an H100: as B3, the five products at 10*D FLOPs per visible
// (q, k) pair and query head; at 4 rows of 1024 tokens with 32 query heads
// of 80 (causal) that is 0.054 ms at the bf16 tensor-core peak against
// 0.034 ms for the ~115 MB moved (q, k, v, dO, lse, delta and positions in;
// dq, dk, dv out in f32), so it is bound by operations. The design is B3's
// (tensor-core tiles on bf16 inputs, CUDA-core f32 tiles on f32 inputs),
// shared through flash_bwd.cuh so the two stay in step.

#include "flash_bwd.cuh"

// C entry for ctypes, the arguments of repro_flash_bwd with (B,Sq) and
// (B,Sk) positions. Returns the cudaError_t of the first launch that
// fails, else 0.
extern "C" int repro_ragged_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* pos_q, const int* pos_k,
    float* dq, float* dk, float* dv, int B, int Sq, int Sk, int Hq, int Hkv,
    int D, int dtype, int causal, int has_window, int window, int has_prefix,
    int prefix_len, float scale, void* stream) {
  using namespace repro_torch;
  BwdArgs a{q, k, v, dout, lse, delta, pos_q, pos_k, dq, dk, dv, B, Sq, Sk,
            Hq, Hkv, Sq, Sk,
            Mask{causal, has_window, window, has_prefix, prefix_len}, scale};
  return (int)run_bwd(a, D, dtype, stream);
}
