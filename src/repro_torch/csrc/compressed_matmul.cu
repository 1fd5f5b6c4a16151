// Compressed-weight matmul for Hopper (sm_90a): the SlideSparse linear.
//
// Replaces the TPU kernel repro/kernels/slide_matmul.py::
// compressed_matmul_pallas (_mm_kernel, decompress_tile).  Computes
//
//   y[R, M] = act((x[R, K] @ decompress(values, indices)[M, K]^T)
//                 (* s_x * s_w) (+ bias))
//
// where (values, indices) is the slided (2N-2):2N -> 2:4 compressed
// operand: per window group of L = 2N source columns, S = 2(N-1) slots,
// each a value plus its int8 position (0..3) inside a 4-wide window that
// starts at column 2j of the group (j = slot / 2).  Each block decompresses
// its (BM x BK) weight tile straight into the ORIGINAL K layout in shared
// memory (the slide is undone on the way in, as decompress_tile does) and
// runs a dense tile product against the activation tile.
//
// Recipes (template MODE): int8 activations x int8 (or nibble-packed int4,
// sign-extended) weights accumulate exactly in int32 via __dp4a; e4m3
// activations x int8/int4 weights and the bf16/f32 float path accumulate
// in fp32.  The epilogue runs in the JAX order: acc -> f32, * s_x, * s_w,
// + bias, activation, cast; the multiplies and the add use the _rn
// intrinsics so nvcc cannot contract them into an FMA, which keeps the
// integer recipes bit-equal to the plain PyTorch version.
//
// What bounds it on the H100: at decode (R <= 4) the weight stream
// (1.5 bytes per original int8 weight: 0.75 of values, 0.75 of positions)
// against 3.35 TB/s; at prefill (R = 128) the int8 operations.  This
// first version is deliberately simple: CUDA-core dp4a/FMA, no tensor
// cores, no TMA, and every row block decompresses its weight tiles again
// (R / BR times per call, counted by the wrapper).  It keeps the weight
// stream compressed in device memory, which is what moves the decode
// bound; wgmma and a decompress-once pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // weight rows (output columns) per block
constexpr int THREADS = 256;  // 16 x 16 threads, 4 output columns each
constexpr int BK_MAX = 64;    // dense K per stage (whole window groups)

enum XMode { X_INT8 = 0, X_FP8 = 1, X_BF16 = 2, X_F32 = 3 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

template <int MODE> struct Traits;
template <> struct Traits<X_INT8> {
  using XT = int8_t; using WT = int8_t; using ST = int8_t; using AT = int;
  static constexpr bool INT = true; static constexpr bool QUANT = true;
};
template <> struct Traits<X_FP8> {
  using XT = __nv_fp8_e4m3; using WT = int8_t; using ST = float;
  using AT = float;
  static constexpr bool INT = false; static constexpr bool QUANT = true;
};
template <> struct Traits<X_BF16> {
  using XT = __nv_bfloat16; using WT = __nv_bfloat16; using ST = float;
  using AT = float;
  static constexpr bool INT = false; static constexpr bool QUANT = false;
};
template <> struct Traits<X_F32> {
  using XT = float; using WT = float; using ST = float; using AT = float;
  static constexpr bool INT = false; static constexpr bool QUANT = false;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}

template <typename ST, typename T>
__device__ __forceinline__ ST to_smem(T v) {
  if constexpr (sizeof(ST) == 1) {
    return v;  // integer path: int8 stays int8
  } else {
    return to_f(v);
  }
}

// slot value of weight row `row` (stored width `kcv`), nibble-unpacked
// with arithmetic-shift sign extension for the 'w4' store
template <int MODE, bool PACKED>
__device__ __forceinline__ typename Traits<MODE>::WT load_w(
    const void* values, size_t row, int kcv, int slot) {
  using WT = typename Traits<MODE>::WT;
  if constexpr (PACKED) {
    const uint8_t b = static_cast<const uint8_t*>(values)[row * kcv
                                                           + (slot >> 1)];
    const int8_t lo = static_cast<int8_t>(static_cast<int8_t>(b << 4) >> 4);
    const int8_t hi = static_cast<int8_t>(static_cast<int8_t>(b) >> 4);
    return (slot & 1) ? hi : lo;
  } else {
    return static_cast<const WT*>(values)[row * kcv + slot];
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  if (act == ACT_GELU) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

__device__ __forceinline__ float acc_to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_f(float v) { return v; }

template <int N, int MODE, bool PACKED>
__global__ void __launch_bounds__(THREADS) compressed_matmul_kernel(
    const typename Traits<MODE>::XT* __restrict__ x,
    const void* __restrict__ values, const int8_t* __restrict__ indices,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out, int R, int M,
    int K, int tr, int out_bf16, int act) {
  using Tr = Traits<MODE>;
  using ST = typename Tr::ST;
  using AT = typename Tr::AT;
  constexpr int L = 2 * N;          // source window-group width
  constexpr int S = 2 * (N - 1);    // compressed slots per group
  constexpr int GT = BK_MAX / L;    // groups per K stage
  constexpr int BK = GT * L;        // a multiple of 4 for N in {2, 3, 4}
  // odd word count per shared row: neighbouring rows fall in other banks
  constexpr int LDS = Tr::INT ? ((BK / 4) | 1) * 4 : (BK | 1);
  static_assert(BK % 4 == 0, "dp4a needs K stages in multiples of 4");

  __shared__ __align__(16) ST xs[64][LDS];
  __shared__ __align__(16) ST ws[BM][LDS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output-column lane: columns tx + 16 j
  const int ty = tid / 16;  // row lane: rows ty + 16 i, i < tr
  const int br = 16 * tr;
  const int r0 = blockIdx.y * br;
  const int m0 = blockIdx.x * BM;
  const int G = K / L;
  const int kc = G * S;                   // slots per weight row
  const int kcv = PACKED ? kc / 2 : kc;   // stored value width

  AT acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = AT(0);

  for (int g0 = 0; g0 < G; g0 += GT) {
    // activation tile [br, BK], zero outside the matrix
    for (int i = tid; i < br * BK; i += THREADS) {
      const int rr = i / BK, kk = i % BK;
      const int r = r0 + rr, k = g0 * L + kk;
      ST v = ST(0);
      if (r < R && k < K) v = to_smem<ST>(x[static_cast<size_t>(r) * K + k]);
      xs[rr][kk] = v;
    }
    // weight tile [BM, BK]: one (row, group) per iteration, decompressed
    // in registers into the original column order of the group
    for (int i = tid; i < BM * GT; i += THREADS) {
      const int mm = i / GT, gg = i % GT;
      const int m = m0 + mm, g = g0 + gg;
      ST dense[L];
#pragma unroll
      for (int d = 0; d < L; ++d) dense[d] = ST(0);
      if (m < M && g < G) {
        const int8_t* ip = indices + static_cast<size_t>(m) * kc
                           + static_cast<size_t>(g) * S;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const ST v = to_smem<ST>(load_w<MODE, PACKED>(values, m, kcv,
                                                        g * S + t));
          const int pos = 2 * (t / 2) + ip[t];  // window t/2 starts at 2j
#pragma unroll
          for (int d = 0; d < L; ++d)
            if (pos == d) dense[d] += v;  // at most one non-zero per column
        }
      }
#pragma unroll
      for (int d = 0; d < L; ++d) ws[mm][gg * L + d] = dense[d];
    }
    __syncthreads();

    if constexpr (Tr::INT) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        int wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < tr) {
            const int xv = *reinterpret_cast<const int*>(&xs[ty + 16 * i][kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv, wv[j], acc[i][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < tr) {
            const float xv = xs[ty + 16 * i][kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= tr) continue;
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m >= M) continue;
      float o = acc_to_f(acc[i][j]);
      if constexpr (Tr::QUANT) o = __fmul_rn(__fmul_rn(o, sx[r]), sw[m]);
      if (bias != nullptr) o = __fadd_rn(o, bias[m]);
      o = activate(o, act);
      const size_t off = static_cast<size_t>(r) * M + m;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(out)[off] = o;
    }
  }
}

template <int N, int MODE, bool PACKED>
cudaError_t launch(const void* x, const void* values, const int8_t* indices,
                   const float* sx, const float* sw, const float* bias,
                   void* out, int R, int M, int K, int out_bf16, int act,
                   cudaStream_t stream) {
  const int tr = R > 16 ? 4 : 1;  // 64-row blocks for prefill, 16 for decode
  const dim3 grid((M + BM - 1) / BM, (R + 16 * tr - 1) / (16 * tr));
  compressed_matmul_kernel<N, MODE, PACKED><<<grid, THREADS, 0, stream>>>(
      static_cast<const typename Traits<MODE>::XT*>(x), values, indices, sx,
      sw, bias, out, R, M, K, tr, out_bf16, act);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch_mode(int xmode, int packed, const void* x,
                          const void* values, const int8_t* indices,
                          const float* sx, const float* sw, const float* bias,
                          void* out, int R, int M, int K, int out_bf16,
                          int act, cudaStream_t s) {
  switch (xmode * 2 + (packed ? 1 : 0)) {
    case X_INT8 * 2:
      return launch<N, X_INT8, false>(x, values, indices, sx, sw, bias, out,
                                      R, M, K, out_bf16, act, s);
    case X_INT8 * 2 + 1:
      return launch<N, X_INT8, true>(x, values, indices, sx, sw, bias, out,
                                     R, M, K, out_bf16, act, s);
    case X_FP8 * 2:
      return launch<N, X_FP8, false>(x, values, indices, sx, sw, bias, out,
                                     R, M, K, out_bf16, act, s);
    case X_FP8 * 2 + 1:
      return launch<N, X_FP8, true>(x, values, indices, sx, sw, bias, out,
                                    R, M, K, out_bf16, act, s);
    case X_BF16 * 2:
      return launch<N, X_BF16, false>(x, values, indices, sx, sw, bias, out,
                                      R, M, K, out_bf16, act, s);
    case X_F32 * 2:
      return launch<N, X_F32, false>(x, values, indices, sx, sw, bias, out,
                                     R, M, K, out_bf16, act, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers; sx/sw
// are ignored by the float modes; bias may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int compressed_matmul_launch(
    const void* x, const void* values, const void* indices, const void* sx,
    const void* sw, const void* bias, void* out, int R, int M, int K,
    int n_fam, int xmode, int packed, int out_bf16, int act, void* stream) {
  const auto* idx = static_cast<const int8_t*>(indices);
  const auto* fsx = static_cast<const float*>(sx);
  const auto* fsw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || M <= 0 || K <= 0) return cudaErrorInvalidValue;
  switch (n_fam) {
    case 2:
      return dispatch_mode<2>(xmode, packed, x, values, idx, fsx, fsw, fb,
                              out, R, M, K, out_bf16, act, s);
    case 3:
      return dispatch_mode<3>(xmode, packed, x, values, idx, fsx, fsw, fb,
                              out, R, M, K, out_bf16, act, s);
    case 4:
      return dispatch_mode<4>(xmode, packed, x, values, idx, fsx, fsw, fb,
                              out, R, M, K, out_bf16, act, s);
    default:
      return cudaErrorInvalidValue;
  }
}
