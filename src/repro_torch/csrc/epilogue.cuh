// The dequant epilogue of the quantized GEMMs, shared by the fused slided
// matmul (B3, fused_slided_matmul.cu) and the dense quantized matmul (B5,
// quant_matmul.cu):
//
//   y = act(acc * s_x * s_w + bias), cast to bf16 or f32
//
// in the JAX order (acc -> f32, * s_x, * s_w, + bias, activation, cast),
// with __fmul_rn/__fadd_rn so nvcc cannot contract the multiply and add
// into an FMA, which would break the integer recipes' bit-equality with
// the plain PyTorch versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace epi {

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

// not inlined: a kernel that unrolls its epilogue over many outputs
// would otherwise carry one copy of expf/tanhf per output, enough code to
// miss the instruction cache through the whole epilogue
__device__ __noinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  if (act == ACT_GELU) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

// one int8 or e4m3 byte as fp32 (exact)
template <bool FP8>
__device__ __forceinline__ float byte_to_f(uint32_t b) {
  if constexpr (FP8) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  } else {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
  }
}

// output m of a row whose sum is ``acc``
__device__ __forceinline__ float apply(float acc, float sx, float sw,
                                       const float* bias, int m, int act) {
  float y = __fmul_rn(__fmul_rn(acc, sx), sw);
  if (bias != nullptr) y = __fadd_rn(y, bias[m]);
  return act == ACT_NONE ? y : activate(y, act);
}

// output m of a row, stored at out[off]
__device__ __forceinline__ void store(float acc, float sx, float sw,
                                      const float* bias, int m, int act,
                                      void* out, size_t off, int out_bf16) {
  const float y = apply(acc, sx, sw, bias, m, act);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[off] = y;
}

// outputs m and m + 1 of a row, stored at out[off], out[off + 1] in one
// store (off even)
__device__ __forceinline__ void store2(float a0, float a1, float sx,
                                       float sw0, float sw1,
                                       const float* bias, int m, int act,
                                       void* out, size_t off, int out_bf16) {
  const float y0 = apply(a0, sx, sw0, bias, m, act);
  const float y1 = apply(a1, sx, sw1, bias, m + 1, act);
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       off) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(y0, y1);
}

}  // namespace epi
