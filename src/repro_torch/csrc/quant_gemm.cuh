// The quantized GEMM body of the dense quantized matmul (B5,
// quant_matmul.cu), and the epilogue helpers (activate, byte_to_f) that
// the fused slided matmul (B3, fused_slided_matmul.cu) shares with it:
//
//   y[R, M] = act((a[R, Kc] @ w[M, Kc]^T) * s_x * s_w + bias)
//
// where ``a`` is either quantized and lifted from float x in the prologue
// (LIFT, the first port's B3: Kc = gamma*K; no longer instantiated, B3
// runs on the 2:4 sparse tensor cores) or read as given (B5: Kc = K, s_x
// given).
//
// Layout.  A block has W warps; each warp owns WR weight rows and the
// block RB activation rows, so a block covers (W*WR) x RB outputs.  The
// contraction is walked in stages of 1536 bytes: the block fills a
// [RB, 1536] tile of int8/e4m3 activations in shared memory, then every
// lane takes three 16-byte pieces of the stage (lane, lane+32, lane+64),
// loads the matching 16 bytes of each of its weight rows straight from
// device memory (one coalesced 512-byte load per warp; a 'w4' row gives 8
// bytes that unpack to 16 sign-extended int4 values) and multiplies them
// against the RB activation rows held in registers.  A warp sums its lanes
// with shuffles at the end.  int8 x int8 accumulates exactly in int32 via
// __dp4a (|sum| <= 127^2 * Kc < 2^31 for Kc < 133,000), so any summation
// order gives the same integer; any e4m3 operand accumulates in fp32.
//
// The epilogue runs in the JAX order: acc -> f32, * s_x, * s_w, + bias,
// activation, cast, with __fmul_rn/__fadd_rn so nvcc cannot contract the
// multiply and add into an FMA (which would break int8 bit-equality).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant_lift.cuh"

namespace quant_gemm {

constexpr int STAGE = 1536;            // contraction bytes per stage
constexpr int CHUNKS = STAGE / 512;    // 16-byte pieces per lane per stage

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  if (act == ACT_GELU) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

__device__ __forceinline__ uint32_t sext_nibble(uint32_t b) {
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4));
}

// 16 contraction bytes of a quantized row from column kc (0 past Kc).  A
// 'w4' row stores element 2i in the low and 2i+1 in the high nibble of
// byte i.  ``vec``: rows are 16-byte (int8) / 8-byte (w4) aligned.
template <bool PACKED>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                          int kc, int Kc, bool vec) {
  uint4 out = make_uint4(0, 0, 0, 0);
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
  if constexpr (PACKED) {
    uint2 p = make_uint2(0, 0);
    if (vec && kc + 16 <= Kc) {
      p = *reinterpret_cast<const uint2*>(row + kc / 2);
    } else {
      uint8_t* pb = reinterpret_cast<uint8_t*>(&p);
      for (int i = 0; i < 8; ++i)
        if (kc + 2 * i < Kc) pb[i] = row[kc / 2 + i];
    }
    const uint8_t* pb = reinterpret_cast<const uint8_t*>(&p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = pb[i];
      const uint32_t pair = sext_nibble(b & 0xfu) | (sext_nibble(b >> 4) << 8);
      o[i / 2] |= pair << (16 * (i % 2));
    }
  } else {
    if (vec && kc + 16 <= Kc) {
      out = *reinterpret_cast<const uint4*>(row + kc);
    } else {
      uint8_t* ob = reinterpret_cast<uint8_t*>(&out);
      for (int i = 0; i < 16; ++i)
        if (kc + i < Kc) ob[i] = row[kc + i];
    }
  }
  return out;
}

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

__device__ __forceinline__ float acc_to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_f(float v) { return v; }

// W warps; RB activation rows; WR weight rows per warp; XF8/WF8: e4m3
// activations/weights; PACKED: 'w4' weights; n_fam: the lift's family
// (LIFT only).
//
// x: LIFT -> [R, K] bf16 (x_bf16) or f32; else [R, Kc] int8/e4m3 bytes
// with sx_in [R] fp32.  w: [M, Kc] bytes, or [M, Kc/2] when PACKED.
template <int W, int RB, int WR, bool LIFT, bool XF8, bool WF8, bool PACKED>
__global__ void __launch_bounds__(32 * W) quant_gemm_kernel(
    const void* __restrict__ x, int x_bf16, const float* __restrict__ sx_in,
    const uint8_t* __restrict__ w, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out, int R, int M,
    int K, int Kc, int n_fam, int out_bf16, int act) {
  constexpr bool INT = !XF8 && !WF8;
  using AT = std::conditional_t<INT, int, float>;
  constexpr int THREADS = 32 * W;
  constexpr int BM = W * WR;
  constexpr int WORDS = STAGE / 4;

  __shared__ __align__(16) uint8_t xs[RB][STAGE];
  __shared__ quant_lift::RowQuant rq[RB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * RB;
  const int m0 = blockIdx.x * BM;
  const int nr = min(RB, R - r0);
  const size_t x_row = LIFT ? static_cast<size_t>(K) * (x_bf16 ? 2 : 4)
                            : static_cast<size_t>(Kc);
  const uint8_t* xb = static_cast<const uint8_t*>(x);

  // prologue: each row's quantizer (LIFT: absmax pass over the row; a
  // block re-derives it for its own rows, deterministically) or its scale
  if constexpr (LIFT) {
    for (int rr = warp; rr < RB; rr += W) {
      float a = 0.f;
      if (rr < nr)
        a = quant_lift::partial_absmax(xb + (r0 + rr) * x_row, K, x_bf16,
                                       lane, 32);
      a = quant_lift::warp_max(a);
      if (lane == 0) rq[rr] = quant_lift::row_quant<XF8>(a);
    }
  } else {
    if (tid < RB) rq[tid] = {0.f, tid < nr ? sx_in[r0 + tid] : 0.f};
  }
  __syncthreads();

  AT acc[WR][RB];
#pragma unroll
  for (int i = 0; i < WR; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = AT(0);

  const bool wvec = Kc % 16 == 0;
  const size_t w_row = PACKED ? Kc / 2 : Kc;
  const int stages = (Kc + STAGE - 1) / STAGE;
  for (int s = 0; s < stages; ++s) {
    const int base = s * STAGE;
    // activation tile [RB, STAGE], zero past R and Kc
    if constexpr (LIFT) {
      for (int i = tid; i < RB * WORDS; i += THREADS) {
        const int rr = i / WORDS, wi = i % WORDS;
        const int word = base / 4 + wi;
        uint32_t v = 0;
        if (rr < nr && 4 * word < Kc)
          v = quant_lift::quant_lift_word<XF8>(xb + (r0 + rr) * x_row, word,
                                               n_fam, x_bf16, rq[rr]);
        *reinterpret_cast<uint32_t*>(&xs[rr][4 * wi]) = v;
      }
    } else {
      for (int i = tid; i < RB * (STAGE / 16); i += THREADS) {
        const int rr = i / (STAGE / 16), ci = i % (STAGE / 16);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (rr < nr)
          v = load16<false>(xb + (r0 + rr) * x_row, base + 16 * ci, Kc,
                            wvec);
        *reinterpret_cast<uint4*>(&xs[rr][16 * ci]) = v;
      }
    }
    __syncthreads();

    // the integer path unrolls the chunks (three weight loads in flight);
    // the fp32 path's code is 16x larger per chunk and stays rolled
#pragma unroll(INT ? CHUNKS : 1)
    for (int c = 0; c < CHUNKS; ++c) {
      const int off = 16 * (lane + 32 * c);
      const int kc = base + off;
      if (kc >= Kc) continue;
      uint4 xr[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j)
        xr[j] = *reinterpret_cast<const uint4*>(&xs[j][off]);
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        const int m = m0 + warp * WR + i;
        if (m >= M) continue;
        const uint4 wv = load16<PACKED>(w + m * w_row, kc, Kc, wvec);
        if constexpr (INT) {
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            acc[i][j] = __dp4a(static_cast<int>(xr[j].x),
                               static_cast<int>(wv.x), acc[i][j]);
            acc[i][j] = __dp4a(static_cast<int>(xr[j].y),
                               static_cast<int>(wv.y), acc[i][j]);
            acc[i][j] = __dp4a(static_cast<int>(xr[j].z),
                               static_cast<int>(wv.z), acc[i][j]);
            acc[i][j] = __dp4a(static_cast<int>(xr[j].w),
                               static_cast<int>(wv.w), acc[i][j]);
          }
        } else {
          const uint32_t* ww = reinterpret_cast<const uint32_t*>(&wv);
          float wf[16];
#pragma unroll
          for (int q = 0; q < 16; ++q)
            wf[q] = byte_to_f<WF8>((ww[q / 4] >> (8 * (q % 4))) & 0xffu);
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xr[j]);
#pragma unroll
            for (int q = 0; q < 16; ++q)
              acc[i][j] = fmaf(
                  byte_to_f<XF8>((xw[q / 4] >> (8 * (q % 4))) & 0xffu),
                  wf[q], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the lanes; lane j writes activation row r0 + j
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int m = m0 + warp * WR + i;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      AT v = acc[i][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(quant_lift::FULL, v, o);
      if (lane == j && j < nr && m < M) {
        const int r = r0 + j;
        float y = __fmul_rn(__fmul_rn(acc_to_f(v), rq[j].scale), sw[m]);
        if (bias != nullptr) y = __fadd_rn(y, bias[m]);
        y = activate(y, act);
        const size_t o_ = static_cast<size_t>(r) * M + m;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o_] = __float2bfloat16_rn(y);
        else
          static_cast<float*>(out)[o_] = y;
      }
    }
  }
}

template <int W, int RB, int WR, bool LIFT, bool XF8, bool WF8, bool PACKED>
void launch_tiles(const void* x, int x_bf16, const float* sx,
                  const uint8_t* w, const float* sw, const float* bias,
                  void* out, int R, int M, int K, int Kc, int n_fam,
                  int out_bf16, int act, cudaStream_t stream) {
  const dim3 grid((M + W * WR - 1) / (W * WR), (R + RB - 1) / RB);
  quant_gemm_kernel<W, RB, WR, LIFT, XF8, WF8, PACKED>
      <<<grid, 32 * W, 0, stream>>>(x, x_bf16, sx, w, sw, bias, out, R, M, K,
                                    Kc, n_fam, out_bf16, act);
}

// Decode-sized row counts take blocks of 4 warps, one weight row each, over
// 4 activation rows: M/4 blocks, at least 240 on the main path's shapes for
// the card's 132 SMs, and one warp per row in the absmax pass.  Larger row
// counts take 8 warps of 4 weight rows over 16 activation rows, which reads
// each weight row R/16 times and re-quantizes x once per 32 weight rows.
template <bool LIFT, bool XF8, bool WF8, bool PACKED>
cudaError_t launch(const void* x, int x_bf16, const float* sx,
                   const uint8_t* w, const float* sw, const float* bias,
                   void* out, int R, int M, int K, int Kc, int n_fam,
                   int out_bf16, int act, cudaStream_t stream) {
  if (R <= 4)
    launch_tiles<4, 4, 1, LIFT, XF8, WF8, PACKED>(
        x, x_bf16, sx, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16, act,
        stream);
  else
    launch_tiles<8, 16, 4, LIFT, XF8, WF8, PACKED>(
        x, x_bf16, sx, w, sw, bias, out, R, M, K, Kc, n_fam, out_bf16, act,
        stream);
  return cudaGetLastError();
}

}  // namespace quant_gemm
