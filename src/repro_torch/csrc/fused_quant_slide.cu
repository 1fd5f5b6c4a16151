// Fused per-token quantization + activation lifting for Hopper (sm_90a):
// paper Algorithm 1, one read of x and one write of the lifted rows.
//
// Replaces the TPU kernel repro/kernels/fused_quant_slide.py::
// fused_quant_slide_pallas (_kernel).  Computes
//
//   q[R, gamma*K] = Psi(quantize(x)),  scale[R, 1]
//
// x [R, K] bf16/f32; q int8 or e4m3.  The quantizer and the lift are the
// device functions of quant_lift.cuh, the same code the fused slided
// matmul runs in its prologue, so this kernel followed by quant_matmul.cu
// gives that kernel's result bit for bit (int8).
//
// What bounds it on the H100: bytes (R*K*2 in, R*gamma*K + 4R out against
// 3.35 TB/s).  One block of 256 threads per row: a max-reduction over the
// row (16-byte loads), then each thread writes whole lifted 4-byte words,
// each read from four neighbouring source columns.  At decode (R <= 4)
// only R blocks run, so the kernel is latency-bound; it is off the
// serving path (the engine's slided linears run the fused matmul).
#include "quant_lift.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool FP8>
__global__ void __launch_bounds__(THREADS) fused_quant_slide_kernel(
    const void* __restrict__ x, int x_bf16, uint8_t* __restrict__ q,
    float* __restrict__ scale, int K, int Kc, int n_fam) {
  __shared__ float part[THREADS / 32];
  __shared__ quant_lift::RowQuant rq;
  const int r = blockIdx.x, tid = threadIdx.x;
  const uint8_t* row = static_cast<const uint8_t*>(x)
                       + static_cast<size_t>(r) * K * (x_bf16 ? 2 : 4);
  float a = quant_lift::partial_absmax(row, K, x_bf16, tid, THREADS);
  a = quant_lift::warp_max(a);
  if ((tid & 31) == 0) part[tid >> 5] = a;
  __syncthreads();
  if (tid == 0) {
    float m = part[0];
    for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, part[i]);
    rq = quant_lift::row_quant<FP8>(m);
    scale[r] = rq.scale;
  }
  __syncthreads();
  uint32_t* out = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(r) * Kc);
  for (int w = tid; w < Kc / 4; w += THREADS)
    out[w] = quant_lift::quant_lift_word<FP8>(row, w, n_fam, x_bf16, rq);
}

}  // namespace

// C entry point (bound with ctypes).  x: [R, K] bf16 (x_bf16) or f32;
// q: [R, gamma*K] bytes (int8, or e4m3 when fp8); scale: [R] fp32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_quant_slide_launch(const void* x, int x_bf16, void* q,
                                        void* scale, int R, int K, int n_fam,
                                        int fp8, void* stream) {
  if (n_fam < 2 || n_fam > 4 || R <= 0 || K <= 0 || K % (2 * n_fam))
    return cudaErrorInvalidValue;
  const int Kc = K / (2 * n_fam) * (n_fam - 1) * 4;
  auto* qb = static_cast<uint8_t*>(q);
  auto* fs = static_cast<float*>(scale);
  auto s = static_cast<cudaStream_t>(stream);
  if (fp8)
    fused_quant_slide_kernel<true><<<R, THREADS, 0, s>>>(x, x_bf16, qb, fs,
                                                         K, Kc, n_fam);
  else
    fused_quant_slide_kernel<false><<<R, THREADS, 0, s>>>(x, x_bf16, qb, fs,
                                                          K, Kc, n_fam);
  return cudaGetLastError();
}
