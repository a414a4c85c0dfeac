// Block flash-attention forward (B1) and its fused ring-merge form (B2).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   B1  flash_attention_fwd -> _fwd_kernel        (partial (o, lse) of one
//       Q block against one K/V block)
//   B2  flash_attention_fwd(o_acc=, lse_acc=) -> _fwd_merge_kernel (B1, then
//       combine_pair with the running ring accumulator in the epilogue)
// Both are the kernels of flash_fwd.cuh with shared (S,) positions; MERGE
// is a template flag. Semantics and design are described there: on bf16
// inputs flash_fwd_mma (packed (query, head) rows of one kv group per CTA,
// mma.sync tensor-core tiles fed by ldmatrix from cp.async double buffers,
// P as a bf16 hi/lo pair), on f32 inputs the CUDA-core flash_fwd_kernel.
//
// Bound on an H100: at the serving slice's shapes (Sq = Sk = 1024, 32 heads,
// D = 80, causal, bf16 in) the two bounds nearly meet: ~4*D*Hq*Sq*Sk/2 =
// 5.4 GFLOP at the bf16 tensor-core peak is 5.4 us, and the ~18.5 MB moved
// (q, k, v in; o and lse out in f32) at 3.35 TB/s is 5.5 us, so bytes lead
// by a hair (B2 adds the f32 accumulator in and is bound by bytes). At the
// training shape (seq 4096) B2 is bound by operations: 86 GFLOP, 0.087 ms.
// The hi/lo pair doubles the P V products, so the kernel issues 6*D MMA
// FLOPs per visible pair and query head against the bound's 4*D (at
// D = 256, whose output is split over two CTAs that each recompute S,
// 8*D). With f32 inputs the f32 peak makes it bound by operations.

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

namespace {

template <int D>
cudaError_t fwd_occupancy(const repro_torch::FwdArgs& a, int* out) {
  using namespace repro_torch;
  const bool split = fwd_split(a);
  out[2] = (int)(split ? smem_fwd_mma<D, true>(a) : smem_fwd_mma<D, false>(a));
  cudaError_t err =
      split ? occupancy_of(flash_fwd_mma<D, false, true>, out[2], out)
            : occupancy_of(flash_fwd_mma<D, false, false>, out[2], out);
  if (err != cudaSuccess) return err;
  // B2 never takes the split-key layout
  const size_t smem2 = smem_fwd_mma<D, false>(a);
  return occupancy_of(flash_fwd_mma<D, true, false>, smem2, out + 1);
}

}  // namespace

// Resident CTAs per SM and dynamic shared memory (bytes) of the bf16
// forward kernel flash_fwd_mma for Sq queries of G heads per kv head
// against Sk keys (Sq * G <= 16 takes the split-key layout, but not in
// B2): out[0..2] = B1 CTAs, B2 (MERGE) CTAs, B1's bytes. Returns the
// cudaError_t of the first query that fails, else 0.
extern "C" int repro_flash_fwd_occupancy(int Sq, int G, int Sk, int D,
                                         int* out) {
  using namespace repro_torch;
  FwdArgs a{};
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = G;
  a.Hkv = 1;
  switch (D) {
    case 32: return (int)fwd_occupancy<32>(a, out);
    case 64: return (int)fwd_occupancy<64>(a, out);
    case 80: return (int)fwd_occupancy<80>(a, out);
    case 128: return (int)fwd_occupancy<128>(a, out);
    case 256: return (int)fwd_occupancy<256>(a, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
