// Fused slided matmul for Hopper (sm_90a): the paper's GPU path in one
// kernel, per-token quantization and lifting in the GEMM prologue.
//
// Replaces the TPU kernel repro/kernels/fused_slide_matmul.py::
// fused_slided_matmul_pallas (_kernel).  Computes
//
//   y[R, M] = act((Psi(q(x)) @ Phi(W)^T) * s_x * s_w + bias)
//
// x [R, K] bf16/f32; Phi(W) the slided weights [M, gamma*K] int8, or
// [M, gamma*K/2] nibble-packed int4 ('w4'); q int8 or e4m3 per token.
//
// The TPU kernel quantizes and lifts a row block once, at the first step
// of its sequential M loop, into a VMEM scratch of br x gamma*K bytes
// that every later M tile reuses.  GPU blocks run in parallel and share
// nothing, and that scratch (1.9 MB for the down projection at prefill)
// is far over 227 KB of shared memory, so here every block derives its
// own rows' quantizers in a first pass over x (deterministic, so the same
// in every block) and then quantizes and lifts each 1536-byte stage of
// the gamma*K contraction into shared memory as the dot walks it
// (quant_lift.cuh, shared with fused_quant_slide.cu).  The lifted
// activations never reach device memory.  The dot and the epilogue are
// quant_gemm.cuh, shared with quant_matmul.cu.
//
// What bounds it on the H100: at decode (R <= 4) the slided weight
// stream, gamma = 1.5 bytes per original int8 weight at 6:8, against
// 3.35 TB/s; the design answers with 16-byte weight loads and one warp
// per weight row in blocks of four (M/4 blocks: 240 to 8000 on the main
// path's shapes for 132 SMs).  At prefill (R = 128) the dp4a operations
// and the re-quantization of x by each block of 32 weight rows.  No
// tensor cores yet: the 2:4 mma.sp path is later work.
#include "quant_gemm.cuh"

namespace {

cudaError_t dispatch(int fp8, int packed, const void* x, int x_bf16,
                     const uint8_t* w, const float* sw, const float* bias,
                     void* out, int R, int M, int K, int Kc, int n_fam,
                     int out_bf16, int act, cudaStream_t s) {
  using quant_gemm::launch;
  switch (fp8 * 2 + (packed ? 1 : 0)) {
    case 0:
      return launch<true, false, false, false>(
          x, x_bf16, nullptr, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16,
          act, s);
    case 1:
      return launch<true, false, false, true>(
          x, x_bf16, nullptr, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16,
          act, s);
    case 2:
      return launch<true, true, false, false>(
          x, x_bf16, nullptr, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16,
          act, s);
    default:
      return launch<true, true, false, true>(
          x, x_bf16, nullptr, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16,
          act, s);
  }
}

}  // namespace

// C entry point (bound with ctypes).  x: [R, K] bf16 (x_bf16) or f32;
// w: slided weights, [M, Kc] int8 or [M, Kc/2] packed; sw: [M] fp32;
// bias: [M] fp32 or null; out: [R, M] bf16 (out_bf16) or f32.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int fused_slided_matmul_launch(const void* x, int x_bf16,
                                          const void* w, const void* sw,
                                          const void* bias, void* out, int R,
                                          int M, int K, int n_fam, int fp8,
                                          int packed, int out_bf16, int act,
                                          void* stream) {
  if (n_fam < 2 || n_fam > 4 || R <= 0 || M <= 0 || K <= 0
      || K % (2 * n_fam))
    return cudaErrorInvalidValue;
  const int Kc = K / (2 * n_fam) * (n_fam - 1) * 4;
  return dispatch(fp8, packed, x, x_bf16, static_cast<const uint8_t*>(w),
                  static_cast<const float*>(sw),
                  static_cast<const float*>(bias), out, R, M, K, Kc, n_fam,
                  out_bf16, act, static_cast<cudaStream_t>(stream));
}
