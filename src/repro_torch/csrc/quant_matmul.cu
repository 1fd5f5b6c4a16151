// Dense quantized matmul for Hopper (sm_90a): the w8a8 / fp8 baseline GEMM,
// and the second half of the two-kernel slided pipeline
// (fused_quant_slide.cu -> this kernel over the gamma*K contraction).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::
// quant_matmul_pallas (_kernel).  Computes
//
//   y[R, M] = act((q_x[R, K] @ q_w[M, K]^T) * s_x * s_w + bias)
//
// q_x and q_w int8 or e4m3 (int32-exact accumulation when both are int8,
// fp32 with any e4m3 operand); s_x [R, 1], s_w [M, 1] fp32.
//
// The TPU kernel carries an accumulator in VMEM scratch across its
// sequential K grid axis; here a block walks K itself, in 1536-byte
// stages of activations copied to shared memory, and keeps the sums in
// registers.  The dot and the epilogue are quant_gemm.cuh; on the same
// lifted operands it sums the same integers as the fused slided matmul
// (exact int32, so in any order) and rounds the same way.
//
// What bounds it on the H100: at decode the weight stream (1 byte per
// weight) against 3.35 TB/s, met with 16-byte loads and M/4 blocks; at
// prefill the dp4a (int8) or fp32 FMA (e4m3) operations.  No tensor
// cores yet.
#include "quant_gemm.cuh"

using quant_gemm::launch;

// C entry point (bound with ctypes).  qx: [R, K] bytes (int8, or e4m3 when
// x_fp8); sx: [R] fp32; qw: [M, K] bytes (e4m3 when w_fp8); sw: [M] fp32;
// bias: [M] fp32 or null; out: [R, M] bf16 (out_bf16) or f32.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int quant_matmul_launch(const void* qx, const void* sx,
                                   const void* qw, const void* sw,
                                   const void* bias, void* out, int R, int M,
                                   int K, int x_fp8, int w_fp8, int out_bf16,
                                   int act, void* stream) {
  if (R <= 0 || M <= 0 || K <= 0) return cudaErrorInvalidValue;
  const auto* fsx = static_cast<const float*>(sx);
  const auto* wb = static_cast<const uint8_t*>(qw);
  const auto* fsw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((x_fp8 ? 2 : 0) + (w_fp8 ? 1 : 0)) {
    case 0:
      return launch<false, false, false, false>(
          qx, 0, fsx, wb, fsw, fb, out, R, M, K, K, 0, out_bf16, act, s);
    case 1:
      return launch<false, false, true, false>(
          qx, 0, fsx, wb, fsw, fb, out, R, M, K, K, 0, out_bf16, act, s);
    case 2:
      return launch<false, true, false, false>(
          qx, 0, fsx, wb, fsw, fb, out, R, M, K, K, 0, out_bf16, act, s);
    default:
      return launch<false, true, true, false>(
          qx, 0, fsx, wb, fsw, fb, out, R, M, K, K, 0, out_bf16, act, s);
  }
}
