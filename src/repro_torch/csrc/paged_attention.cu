// Paged flash attention for Hopper (sm_90a): attention over the page table.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_flash_pallas
// (_flash_kernel + _merge_splits).  One block per (sequence b, KV head g,
// tile of QT query rows).  Query rows are grouped GQA-natively: row
// ``lane * rep + r`` of KV head g is query head ``g * rep + r`` at lane
// ``lane`` (decode L = 1, prefill chunk L = C), so K/V are read once per
// KV head and never repeated.  The block walks the sequence's positions in
// chunks of TK tokens, reading each token's physical page from the page
// table, and folds every chunk into an fp32 online softmax (running max m,
// sum l, unnormalized accumulator) with q pre-scaled by hd^-0.5.  Row
// ``lane`` sees positions ``< kv_len[b] + lane`` and, with a sliding
// window, ``>= row_len - window``; masked scores take NEG_INF and their
// probabilities are forced to 0, which is the all-masked-chunk guard of the
// oracle.  int8 pages are dequantized from their fp32 scale pages before
// each dot, in the oracle's order.  Unallocated table entries point at page
// 0 and lie at positions >= row_len, where the mask kills them.  One pass
// covers the whole sequence, so no split merge is needed.
//
// head_dim is padded to 128 in shared memory and registers only (120 at
// h2o-danube width); the pool is read at its real width.
//
// What bounds it on the H100: the K/V bytes of the valid tokens
// (2 * kv_len * KVH * hd * itemsize per sequence) against 3.35 TB/s.  This
// first version uses CUDA-core FMAs on fp32 shared-memory tiles and one
// block per (b, g, row tile); with few sequences at decode that is few
// blocks, so it does not reach the bound (a split over pages with a merge
// pass is the next step).  Chunks wholly below every row's window are
// skipped, so work tracks the window, not the cache.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;        // query rows per block
constexpr int TK = 32;        // tokens per chunk (one warp lane each)
constexpr int HDP = 128;      // head_dim padded in shared memory
constexpr int THREADS = 128;  // one thread per padded head-dim column
constexpr float NEG_INF = -1e30f;

enum KVMode { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int KV>
__device__ __forceinline__ float load_kv(const void* pool, size_t off) {
  if constexpr (KV == KV_F32) return static_cast<const float*>(pool)[off];
  if constexpr (KV == KV_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[off]);
  return static_cast<float>(static_cast<const int8_t*>(pool)[off]);
}

template <typename QType, int KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const QType* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ page_table,
    const int* __restrict__ kv_len, QType* __restrict__ out, int L, int H,
    int KVH, int hd, int P, int maxp, int window, float scale) {
  __shared__ float qs[QT][HDP + 1];
  __shared__ float ks[TK][HDP + 1];
  __shared__ float vs[TK][HDP + 1];
  __shared__ float ps[QT][TK + 1];
  __shared__ float m_s[QT], l_s[QT], alpha_s[QT];

  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = H / KVH;
  const int lr = L * rep;            // query rows of this (b, g)
  const int row0 = blockIdx.z * QT;
  const int tid = threadIdx.x;
  const int kl = kv_len[b];

  for (int i = tid; i < QT * HDP; i += THREADS) {
    const int qq = i / HDP, d = i % HDP;
    const int row = row0 + qq;
    float v = 0.0f;
    if (row < lr && d < hd) {
      const int lane = row / rep, r = row % rep;
      const size_t off =
          ((static_cast<size_t>(b) * L + lane) * H + g * rep + r) * hd + d;
      v = to_f(q[off]) * scale;
    }
    qs[qq][d] = v;
  }
  if (tid < QT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) acc[qq] = 0.0f;

  // positions any row of this tile can see: [begin, end)
  const int last_row = min(row0 + QT, lr) - 1;
  const int end = min(kl + last_row / rep, maxp * P);
  int begin = 0;
  if (window >= 0) begin = max(0, kl + row0 / rep - window) / TK * TK;
  __syncthreads();

  const int warp = tid / 32, wl = tid % 32;
  for (int c0 = begin; c0 < end; c0 += TK) {
    for (int i = tid; i < TK * HDP; i += THREADS) {
      const int kk = i / HDP, d = i % HDP;
      const int pos = c0 + kk;
      float kv = 0.0f, vv = 0.0f;
      if (d < hd && pos < maxp * P) {
        const int page = page_table[static_cast<size_t>(b) * maxp + pos / P];
        const size_t tok = (static_cast<size_t>(page) * P + pos % P) * KVH + g;
        kv = load_kv<KV>(kpool, tok * hd + d);
        vv = load_kv<KV>(vpool, tok * hd + d);
        if constexpr (KV == KV_INT8) {
          kv = kv * kscale[tok];
          vv = vv * vscale[tok];
        }
      }
      ks[kk][d] = kv;
      vs[kk][d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < QT * TK; i += THREADS) {
      const int qq = i / TK, kk = i % TK;
      const int row = row0 + qq, pos = c0 + kk;
      float s = NEG_INF;
      if (row < lr) {
        const int row_len = kl + row / rep;
        bool ok = pos < row_len;
        if (window >= 0) ok = ok && pos >= row_len - window;
        if (ok) {
          float dot = 0.0f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qs[qq][d], ks[kk][d], dot);
          s = dot;
        }
      }
      ps[qq][kk] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per token of the chunk
    for (int qq = warp; qq < QT; qq += THREADS / 32) {
      const float s = ps[qq][wl];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[qq];
      const float m_new = fmaxf(m_old, mx);
      // masked scores hold NEG_INF exactly; their weight is 0, never
      // exp(NEG_INF - NEG_INF) = 1
      const float p = s > 0.5f * NEG_INF ? expf(s - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[qq][wl] = p;
      __syncwarp();
      if (wl == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[qq] = a;
        l_s[qq] = l_s[qq] * a + sum;
        m_s[qq] = m_new;
      }
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        float u = 0.0f;
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) u = fmaf(ps[qq][kk], vs[kk][tid], u);
        acc[qq] = acc[qq] * alpha_s[qq] + u;
      }
    }
    __syncthreads();
  }

  if (tid < hd) {
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      const int row = row0 + qq;
      if (row >= lr) continue;
      const int lane = row / rep, r = row % rep;
      const size_t off =
          ((static_cast<size_t>(b) * L + lane) * H + g * rep + r) * hd + tid;
      store(out + off, acc[qq] / fmaxf(l_s[qq], 1e-30f));
    }
  }
}

template <typename QType, int KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pt,
                   const int* kvl, void* out, int B, int L, int H, int KVH,
                   int hd, int P, int maxp, int window, float scale,
                   cudaStream_t stream) {
  const int lr = L * (H / KVH);
  const dim3 grid(B, KVH, (lr + QT - 1) / QT);
  paged_attention_kernel<QType, KV><<<grid, THREADS, 0, stream>>>(
      static_cast<const QType*>(q), k, v, ks, vs, pt, kvl,
      static_cast<QType*>(out), L, H, KVH, hd, P, maxp, window, scale);
  return cudaGetLastError();
}

template <typename QType>
cudaError_t dispatch_kv(int kv_mode, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        const int* pt, const int* kvl, void* out, int B,
                        int L, int H, int KVH, int hd, int P, int maxp,
                        int window, float scale, cudaStream_t s) {
  switch (kv_mode) {
    case KV_F32:
      return launch<QType, KV_F32>(q, k, v, ks, vs, pt, kvl, out, B, L, H,
                                   KVH, hd, P, maxp, window, scale, s);
    case KV_BF16:
      return launch<QType, KV_BF16>(q, k, v, ks, vs, pt, kvl, out, B, L, H,
                                    KVH, hd, P, maxp, window, scale, s);
    case KV_INT8:
      return launch<QType, KV_INT8>(q, k, v, ks, vs, pt, kvl, out, B, L, H,
                                    KVH, hd, P, maxp, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  q/out: [B, L, H, hd] (bf16 when
// q_bf16, else f32); k/v pools [num_pages, P, KVH, hd] (kv_mode 0 f32,
// 1 bf16, 2 int8 with k/v scale pools [num_pages, P, KVH, 1] f32);
// page_table [B, maxp] int32; kv_len [B] int32; window < 0 means none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* kv_len,
    void* out, int B, int L, int H, int KVH, int hd, int P, int maxp,
    int window, float scale, int q_bf16, int kv_mode, void* stream) {
  if (B <= 0 || L <= 0 || KVH <= 0 || H % KVH || hd <= 0 || hd > HDP ||
      P <= 0 || maxp <= 0)
    return cudaErrorInvalidValue;
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* kvl = static_cast<const int*>(kv_len);
  auto s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return dispatch_kv<__nv_bfloat16>(kv_mode, q, k, v, ks, vs, pt, kvl, out,
                                      B, L, H, KVH, hd, P, maxp, window,
                                      scale, s);
  return dispatch_kv<float>(kv_mode, q, k, v, ks, vs, pt, kvl, out, B, L, H,
                            KVH, hd, P, maxp, window, scale, s);
}
