// Block flash-attention forward (B1) and its fused ring-merge form (B2).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   B1  flash_attention_fwd -> _fwd_kernel        (partial (o, lse) of one
//       Q block against one K/V block)
//   B2  flash_attention_fwd(o_acc=, lse_acc=) -> _fwd_merge_kernel (B1, then
//       combine_pair with the running ring accumulator in the epilogue)
// Both are the kernel of flash_fwd.cuh with shared (S,) positions; MERGE is
// a template flag. Semantics and design are described there.
//
// Bound on an H100: at the serving slice's shapes (Sq = Sk = 1024, 32 heads,
// D = 80, causal, bf16 in) the two bounds nearly meet: ~4*D*Hq*Sq*Sk/2 =
// 5.4 GFLOP at the bf16 tensor-core peak is 5.4 us, and the ~18.5 MB moved
// (q, k, v in; o and lse out in f32) at 3.35 TB/s is 5.5 us, so bytes lead
// by a hair (B2 adds the f32 accumulator in and is bound by bytes). With f32
// inputs the f32 peak makes it bound by operations.

#include "flash_fwd.cuh"

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. o_acc/lse_acc NULL
// selects B1, non-NULL selects B2. Returns the cudaError_t of the launch.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, const int* pos_q,
    const int* pos_k, const float* o_acc, const float* lse_acc, float* o,
    float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype,
    int causal, int has_window, int window, int has_prefix, int prefix_len,
    float scale, void* stream) {
  using namespace repro_torch;
  FwdArgs a{q, k, v, pos_q, pos_k, o_acc, lse_acc, o, lse, B, Sq, Sk, Hq,
            Hkv, 0, 0,
            Mask{causal, has_window, window, has_prefix, prefix_len}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool merge = o_acc != nullptr;
  cudaError_t err;
  if (dtype == 1) {
    err = merge ? launch_fwd_d<__nv_bfloat16, true>(a, D, st)
                : launch_fwd_d<__nv_bfloat16, false>(a, D, st);
  } else if (dtype == 0) {
    err = merge ? launch_fwd_d<float, true>(a, D, st)
                : launch_fwd_d<float, false>(a, D, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
