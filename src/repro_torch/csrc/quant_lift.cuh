// Per-row quantization + activation lifting (paper Alg. 1), the device
// functions shared by the fused slided matmul's prologue
// (fused_slided_matmul.cu) and the standalone quant+lift kernel
// (fused_quant_slide.cu), so the two cannot drift apart.  Both lift one
// source group of 2N columns at a time: each pair quantized once
// (quant_pair), the N - 1 lifted words of the group built from
// neighbouring pairs (lifted_word).
//
// Bit-exact against repro_torch.core.quant (and so against the JAX
// quantize_rows of repro/kernels/fused_quant_slide.py):
//   absmax  a = max(max_k |x_k|, 1e-8)              (a max: any order)
//   int8    q = clamp(rint(x * (127 / a)), -127, 127), scale = a / 127
//   e4m3    scale = a / 448, q = e4m3(clamp(x / scale, -448, 448))
// The quotients and the product use the _rn intrinsics (IEEE, never the
// fast approximations) and rintf rounds half to even, as torch.round does.
//
// Lifting Psi for (2N-2):2N -> 2:4: lifted word w = (group g, window j),
// g = w / (N-1), j = w % (N-1), holds the four source columns starting at
// 2N*g + 2j (window j covers source pairs j and j+1), one byte each.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace quant_lift {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load1(const void* row, int k, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(row)[k])
              : static_cast<const float*>(row)[k];
}

// 8 consecutive elements of a bf16 or f32 row from column k, as fp32 (0
// past K); one or two 16-byte loads when ``vec`` says the row allows them
__device__ __forceinline__ void load8(const void* row, int k, int K,
                                      bool bf16, bool vec, float v[8]) {
  if (vec && k + 8 <= K) {
    if (bf16) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(row) + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(row) + k);
      const float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = k + i < K ? load1(row, k + i, bf16) : 0.f;
  }
}

// whether a row of K elements starts 16-byte aligned (rows are packed
// back to back from an aligned base)
__device__ __forceinline__ bool rows_vectorizable(int K, bool bf16) {
  return bf16 ? (K % 8 == 0) : (K % 4 == 0);
}

// this thread's share of max|x| over a row: 8-column chunks t, t+nt, ...
__device__ __forceinline__ float partial_absmax(const void* row, int K,
                                                bool bf16, int t, int nt) {
  const bool vec = rows_vectorizable(K, bf16);
  float a = 0.f;
  for (int k = 8 * t; k < K; k += 8 * nt) {
    float v[8];
    load8(row, k, K, bf16, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(v[i]));
  }
  return a;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(FULL, a, off));
  return a;
}

// a row's quantizer: ``mul`` = 127 / a (int8) and ``scale`` = a / 127
// (int8) or a / 448 (e4m3), the scale the dequant epilogue multiplies by
struct RowQuant {
  float mul;
  float scale;
};

template <bool FP8>
__device__ __forceinline__ RowQuant row_quant(float absmax) {
  const float a = fmaxf(absmax, 1e-8f);
  if constexpr (FP8) {
    return {0.f, __fdiv_rn(a, 448.0f)};
  } else {
    return {__fdiv_rn(127.0f, a), __fdiv_rn(a, 127.0f)};
  }
}

template <bool FP8>
__device__ __forceinline__ uint32_t quant1(float x, RowQuant q) {
  if constexpr (FP8) {
    const float v = fminf(fmaxf(__fdiv_rn(x, q.scale), -448.0f), 448.0f);
    return static_cast<uint32_t>(
        __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  } else {
    const float v = fminf(fmaxf(rintf(__fmul_rn(x, q.mul)), -127.0f), 127.0f);
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(__float2int_rn(v))));
  }
}

// a source pair (x0, x1), quantized: two bytes, x0 in the low one
template <bool FP8>
__device__ __forceinline__ uint32_t quant_pair(float2 f, RowQuant q) {
  return quant1<FP8>(f.x, q) | (quant1<FP8>(f.y, q) << 8);
}

// the lifted word of window (g, j), made of the quantized source pairs j
// and j + 1 of group g
__device__ __forceinline__ uint32_t lifted_word(uint32_t pair_j,
                                                uint32_t pair_j1) {
  return pair_j | (pair_j1 << 16);
}

// lifted word w of a row of the (2n-2):2n family: its four quantized
// bytes, little-endian (one word at a time: each source pair is quantized
// once per word that holds it)
template <bool FP8>
__device__ __forceinline__ uint32_t quant_lift_word(const void* row, int w,
                                                    int n, bool bf16,
                                                    RowQuant q) {
  const int g = w / (n - 1);
  const int src = 2 * n * g + 2 * (w - g * (n - 1));  // even: 4-byte aligned
  float v[4];
  if (bf16) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(row) + src);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float2* p =
        reinterpret_cast<const float2*>(static_cast<const float*>(row) + src);
    const float2 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  uint32_t out = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) out |= quant1<FP8>(v[d], q) << (8 * d);
  return out;
}

}  // namespace quant_lift
