// Paged flash attention for Hopper (sm_90a): attention over the page table.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_flash_pallas
// (_flash_kernel, then _merge_splits) with its own dataflow: the page
// table is cut into S contiguous ranges of pps = ceil(maxp / S) pages, one
// attend block per (sequence b, KV head g, split s, tile of query rows)
// folds its range into an fp32 online softmax (running max m, sum l,
// unnormalized accumulator), and a second small kernel merges the S
// partials of each row in split order (m* = max m_s, w = exp(m_s - m*),
// out = sum acc_s w / max(sum l_s w, 1e-30)).  With S = 1 the attend
// block normalizes and writes the output itself (the same bits: w = 1).
// No atomics anywhere, so a call gives the same bits every time.
//
// Query rows are grouped GQA-natively: row ``lane * rep + r`` of KV head g
// is query head ``g * rep + r`` at lane ``lane`` (decode L = 1, prefill
// chunk L = C).  Row ``lane`` sees positions ``< kv_len[b] + lane`` and,
// with a sliding window, ``>= row_len - window``; masked scores take
// NEG_INF and weight 0.  Unallocated table entries point at page 0 and lie
// at positions >= row_len, where the mask kills them.  A split that lies
// wholly past every row or below every row's window runs no chunk but
// still writes its partial (m = NEG_INF, l = 0, acc = 0).
//
// What bounds it on the H100: the K/V bytes of the valid tokens
// (2 * tokens * KVH * hd * itemsize) against 3.35 TB/s, a few MB per
// decode call, so a couple of microseconds: launch latency and the
// latency of each block's load chain are what remain.  The design
// answers with width and depth of loads in flight:
// - S is chosen by the wrapper so that about two blocks per SM are in
//   flight at decode (B x KVH = 32 blocks alone would leave 100 SMs idle);
// - each block streams its chunks of 32 tokens through a 3-stage
//   cp.async ring (16-byte pieces for f32/bf16 rows, 8-byte pieces for
//   int8 rows, whose 120-byte rows are only 8-byte aligned; the fp32
//   scale rows 4 bytes per token), so two chunks are in flight during
//   each chunk's dots; the page table is read once per page per warp and
//   handed to the lanes by shuffles;
// - decode (the CUDA-core instance, also every fp32-query call): a tile
//   of 4 query rows (rep at L = 1), one warp per row for the scores and
//   the softmax, one thread per head-dim column for P.V, fp32 FMAs;
// - a prefill chunk with bf16 queries (bf16 or int8 pool): 64 query rows
//   per block, 16 per warp, QK^T and P.V on mma.sync.m16n8k16 bf16 with
//   fp32 accumulation (head_dim zero-padded 120 -> 128 for QK^T, n = 15
//   x 8 for P.V); int8 pages are exact in bf16, k_scale multiplies the
//   score after the dot and v_scale is folded into P before P is rounded
//   to bf16.
//
// head_dim is padded to 128 in shared memory and registers only (120 at
// h2o-danube width); the pool is read at its real width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HDP = 128;      // head_dim padded in shared memory
constexpr int TK = 32;        // tokens per chunk
constexpr int NSTAGE = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps
constexpr int MMA_ROWS = 64;  // query rows per tensor-core block
constexpr int KB_LD = HDP + 8;  // bf16 tile row stride (272 B: 17 x 16 B)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

enum KVMode { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2 };

struct Params {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* kvl;
  void* out;
  float* pacc;  // [B, KVH, S, Lr, hd] partial accumulators (S > 1)
  float* pm;    // [B, KVH, S, Lr] partial max
  float* pl;    // [B, KVH, S, Lr] partial sum
  int B, L, H, KVH, hd, P, maxp, window, splits, pps;
  float scale;
};

template <int KV> struct KVInfo;
template <> struct KVInfo<KV_F32> {
  static constexpr int SIZE = 4, VB = 16;
};
template <> struct KVInfo<KV_BF16> {
  static constexpr int SIZE = 2, VB = 16;
};
template <> struct KVInfo<KV_INT8> {
  static constexpr int SIZE = 1, VB = 8;
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy VB bytes (16, 8 or 4) global -> shared; zero-fill when !valid
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? VB : 0;
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(VB), "r"(n));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The positions a block of rows [row0, row_end) of split s visits:
// [begin, end), walked in chunks of TK from begin.
struct Range {
  int begin, end, nchunks;
};

__device__ __forceinline__ Range block_range(const Params& p, int kl,
                                             int rep, int row0, int row_end,
                                             int s) {
  const int ts = s * p.pps * p.P;
  const int te = min((s + 1) * p.pps, p.maxp) * p.P;
  // rows grow with their lane, so the first row has the lowest bound and
  // the last row the highest
  const int hi = min(kl + (row_end - 1) / rep, p.maxp * p.P);
  int lo = 0;
  if (p.window >= 0) lo = max(0, kl + row0 / rep - p.window);
  Range r;
  r.begin = ts + max(0, lo - ts) / TK * TK;
  r.end = min(hi, te);
  r.nchunks = r.end > r.begin ? (r.end - r.begin + TK - 1) / TK : 0;
  return r;
}

// Issue the cp.async of chunk [c0, c0 + TK) of (b, g) into one ring slot:
// K rows, V rows (row_bytes each, slot row stride ld bytes) and, for int8
// pools, the fp32 scales.  Tokens at or past ``end`` are zero-filled.  Each
// warp reads the page table once per page of the chunk (lane i holds page
// i of the chunk) and shuffles the page to the lanes that need it.
template <int KV>
__device__ __forceinline__ void issue_chunk(const Params& p, int b, int g,
                                            int c0, int end, uint8_t* kdst,
                                            uint8_t* vdst, float* ksdst,
                                            float* vsdst, int ld) {
  constexpr int VB = KVInfo<KV>::VB;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row_bytes = p.hd * KVInfo<KV>::SIZE;
  const int ppr = row_bytes / VB;  // pieces per token row
  const int first = c0 / p.P;
  const int last = (min(c0 + TK, end) - 1) / p.P;  // c0 < end always
  const int my_page = (first + lane <= last)
                          ? p.pt[static_cast<size_t>(b) * p.maxp + first +
                                 lane]
                          : 0;
  const int total = 2 * TK * ppr;
  for (int base = 0; base < total; base += THREADS) {
    const int i = base + tid;
    const int which = i / (TK * ppr);  // 0: K, 1: V
    const int rem = i % (TK * ppr);
    const int kk = rem / ppr, pc = rem % ppr;
    const int pos = c0 + kk;
    const int page = __shfl_sync(FULL, my_page, min(pos / p.P - first, 31));
    if (i < total) {
      const bool valid = pos < end;
      const size_t tok =
          (static_cast<size_t>(page) * p.P + pos % p.P) * p.KVH + g;
      const uint8_t* src = (which ? p.v : p.k) + tok * row_bytes + pc * VB;
      uint8_t* dst = (which ? vdst : kdst) + kk * ld + pc * VB;
      cp_async<VB>(dst, valid ? src : p.k, valid);
    }
  }
  if constexpr (KV == KV_INT8) {
    if (tid < 2 * TK) {  // warps 0 and 1: uniform per warp
      const int kk = tid % TK;
      const int pos = c0 + kk;
      const int page = __shfl_sync(FULL, my_page, min(pos / p.P - first, 31));
      const bool valid = pos < end;
      const size_t tok =
          (static_cast<size_t>(page) * p.P + pos % p.P) * p.KVH + g;
      const float* src = (tid < TK ? p.ks : p.vs) + tok;
      cp_async<4>((tid < TK ? ksdst : vsdst) + kk, valid ? src : p.ks, valid);
    }
  }
}

// write one row's result: normalized output (S == 1) or the fp32 partial
template <typename QType>
__device__ __forceinline__ size_t out_offset(const Params& p, int b, int g,
                                             int row, int rep) {
  const int lane = row / rep, r = row % rep;
  return ((static_cast<size_t>(b) * p.L + lane) * p.H + g * rep + r) * p.hd;
}

__device__ __forceinline__ size_t part_row(const Params& p, int b, int g,
                                           int s, int row, int lr) {
  return ((static_cast<size_t>(b) * p.KVH + g) * p.splits + s) * lr + row;
}

// ------------------------------------------------ CUDA-core attend kernel
// One block per (b, g, s, tile of QT rows); used at decode and for every
// fp32-query call.  Dynamic shared memory: the NSTAGE ring of K and V rows
// (ld bytes per row) and, for int8, the scale rows.
template <typename QType, int KV, int QT>
__global__ void __launch_bounds__(THREADS) attend_core_kernel(Params p,
                                                              int ld) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ __align__(16) float qs[QT][HDP];
  __shared__ float ps[QT][TK];
  __shared__ float alpha_s[QT], l_s[QT], m_s[QT];
  constexpr int RPW = (QT + 3) / 4;  // rows per warp

  const int b = blockIdx.x, g = blockIdx.y;
  const int s = blockIdx.z % p.splits, tile = blockIdx.z / p.splits;
  const int rep = p.H / p.KVH, lr = p.L * rep;
  const int row0 = tile * QT;
  const int row_end = min(row0 + QT, lr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kl = p.kvl[b];
  const int hd = p.hd;

  const QType* q = static_cast<const QType*>(p.q);
  for (int i = tid; i < QT * HDP; i += THREADS) {
    const int qq = i / HDP, d = i % HDP;
    const int row = row0 + qq;
    float v = 0.0f;
    if (row < lr && d < hd) v = to_f(q[out_offset<QType>(p, b, g, row, rep)
                                       + d]) * p.scale;
    qs[qq][d] = v;
  }

  const Range rg = block_range(p, kl, rep, row0, row_end, s);
  const int slot_bytes = 2 * TK * ld + (KV == KV_INT8 ? 2 * TK * 4 : 0);
  auto kslot = [&](int sl) { return ring + sl * slot_bytes; };
  auto vslot = [&](int sl) { return ring + sl * slot_bytes + TK * ld; };
  auto ksslot = [&](int sl) {
    return reinterpret_cast<float*>(ring + sl * slot_bytes + 2 * TK * ld);
  };
  auto issue = [&](int j) {
    const int sl = j % NSTAGE;
    issue_chunk<KV>(p, b, g, rg.begin + j * TK, rg.end, kslot(sl), vslot(sl),
                    ksslot(sl), ksslot(sl) + TK, ld);
  };
#pragma unroll
  for (int j = 0; j < NSTAGE - 1; ++j) {
    if (j < rg.nchunks) issue(j);
    cp_commit();
  }

  float m_r[RPW], l_r[RPW], acc[QT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.0f;

  for (int c = 0; c < rg.nchunks; ++c) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();  // chunk c landed; every thread is done with c - 1
    if (c + NSTAGE - 1 < rg.nchunks) issue(c + NSTAGE - 1);
    cp_commit();
    const int sl = c % NSTAGE;
    const uint8_t* kr = kslot(sl) + lane * ld;
    const float* ksc = ksslot(sl);
    const float* vsc = ksc + TK;
    const int pos = rg.begin + c * TK + lane;

    // scores and online softmax: warp w owns rows w, w + 4, ...
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qq = warp + 4 * i;
      if (qq >= QT) break;
      const int row = row0 + qq;
      float sc = NEG_INF;
      if (row < lr) {
        const int rl = kl + row / rep;
        bool ok = pos < rl && pos < rg.end;
        if (p.window >= 0) ok = ok && pos >= rl - p.window;
        if (ok) {
          // four independent FMA chains over the head dimension
          float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int d = 0; d < hd; d += 8) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[qq][d]);
            const float4 qb =
                *reinterpret_cast<const float4*>(&qs[qq][d + 4]);
            float kv[8];
            if constexpr (KV == KV_F32) {
              const float4 a = *reinterpret_cast<const float4*>(kr + 4 * d);
              const float4 bb =
                  *reinterpret_cast<const float4*>(kr + 4 * d + 16);
              kv[0] = a.x; kv[1] = a.y; kv[2] = a.z; kv[3] = a.w;
              kv[4] = bb.x; kv[5] = bb.y; kv[6] = bb.z; kv[7] = bb.w;
            } else if constexpr (KV == KV_BF16) {
              const uint4 a = *reinterpret_cast<const uint4*>(kr + 2 * d);
              const __nv_bfloat162* h =
                  reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h[e]);
                kv[2 * e] = f.x;
                kv[2 * e + 1] = f.y;
              }
            } else {
              const uint2 a = *reinterpret_cast<const uint2*>(kr + d);
              const int8_t* h = reinterpret_cast<const int8_t*>(&a);
#pragma unroll
              for (int e = 0; e < 8; ++e) kv[e] = static_cast<float>(h[e]);
            }
            dp[0] = fmaf(qa.x, kv[0], dp[0]);
            dp[1] = fmaf(qa.y, kv[1], dp[1]);
            dp[2] = fmaf(qa.z, kv[2], dp[2]);
            dp[3] = fmaf(qa.w, kv[3], dp[3]);
            dp[0] = fmaf(qb.x, kv[4], dp[0]);
            dp[1] = fmaf(qb.y, kv[5], dp[1]);
            dp[2] = fmaf(qb.z, kv[6], dp[2]);
            dp[3] = fmaf(qb.w, kv[7], dp[3]);
          }
          float dot = (dp[0] + dp[1]) + (dp[2] + dp[3]);
          if constexpr (KV == KV_INT8) dot *= ksc[lane];
          sc = dot;
        }
      }
      const float m_new = fmaxf(m_r[i], warp_max(sc));
      // masked scores hold NEG_INF exactly; their weight is 0, never
      // exp(NEG_INF - NEG_INF) = 1
      const float pr = sc > 0.5f * NEG_INF ? expf(sc - m_new) : 0.0f;
      const float sum = warp_sum(pr);
      const float a = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * a + sum;
      m_r[i] = m_new;
      ps[qq][lane] = KV == KV_INT8 ? pr * vsc[lane] : pr;
      if (lane == 0) alpha_s[qq] = a;
    }
    __syncthreads();

    // P.V: thread d owns column d of every row of the tile
    if (tid < hd) {
      const uint8_t* vr = vslot(sl);
      float u[QT];
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) u[qq] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        float v;
        if constexpr (KV == KV_F32)
          v = reinterpret_cast<const float*>(vr + kk * ld)[tid];
        else if constexpr (KV == KV_BF16)
          v = __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(vr + kk * ld)[tid]);
        else
          v = static_cast<float>(
              reinterpret_cast<const int8_t*>(vr + kk * ld)[tid]);
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) u[qq] = fmaf(ps[qq][kk], v, u[qq]);
      }
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) acc[qq] = acc[qq] * alpha_s[qq] + u[qq];
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qq = warp + 4 * i;
    if (qq < QT && lane == 0) {
      l_s[qq] = l_r[i];
      m_s[qq] = m_r[i];
    }
  }
  __syncthreads();
  if (tid < hd) {
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      const int row = row0 + qq;
      if (row >= lr) continue;
      if (p.splits == 1) {
        store(static_cast<QType*>(p.out) + out_offset<QType>(p, b, g, row, rep)
                  + tid,
              acc[qq] / fmaxf(l_s[qq], 1e-30f));
      } else {
        p.pacc[part_row(p, b, g, s, row, lr) * hd + tid] = acc[qq];
      }
    }
  }
  if (p.splits > 1 && tid < QT && row0 + tid < lr) {
    const size_t pr = part_row(p, b, g, s, row0 + tid, lr);
    p.pm[pr] = m_s[tid];
    p.pl[pr] = l_s[tid];
  }
}

// ---------------------------------------------- tensor-core attend kernel
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(ptr))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One block per (b, g, s, tile of 64 rows); warp w computes rows
// [16 w, 16 w + 16) of the tile with mma.sync.  bf16 queries against a bf16
// pool (ring slots are the bf16 tiles themselves, row stride KB_LD) or an
// int8 pool (ring slots hold the int8 rows; each chunk is converted into
// one bf16 K tile and one V tile, exactly).  Pad columns [hd, 128) of the
// bf16 tiles are zeroed once and never written again.
template <int KV>
__global__ void __launch_bounds__(THREADS) attend_mma_kernel(Params p,
                                                             int ld) {
  extern __shared__ __align__(16) uint8_t ring[];
  constexpr bool Q8 = KV == KV_INT8;

  const int b = blockIdx.x, g = blockIdx.y;
  const int s = blockIdx.z % p.splits, tile = blockIdx.z / p.splits;
  const int rep = p.H / p.KVH, lr = p.L * rep;
  const int row0 = tile * MMA_ROWS;
  const int row_end = min(row0 + MMA_ROWS, lr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kl = p.kvl[b];
  const int hd = p.hd;

  const int slot_bytes = 2 * TK * ld + (Q8 ? 2 * TK * 4 : 0);
  // int8: the bf16 tiles follow the ring
  __nv_bfloat16* kb8 =
      reinterpret_cast<__nv_bfloat16*>(ring + NSTAGE * slot_bytes);
  __nv_bfloat16* vb8 = kb8 + TK * KB_LD;
  if constexpr (Q8) {
    for (int i = tid; i < 2 * TK * (KB_LD - hd); i += THREADS) {
      const int r = i / (KB_LD - hd), c = hd + i % (KB_LD - hd);
      (r < TK ? kb8 + r * KB_LD : vb8 + (r - TK) * KB_LD)[c] =
          __float2bfloat16_rn(0.0f);
    }
  } else {
    for (int i = tid; i < NSTAGE * 2 * TK * (KB_LD - hd); i += THREADS) {
      const int r = i / (KB_LD - hd), c = hd + i % (KB_LD - hd);
      reinterpret_cast<__nv_bfloat16*>(ring + r * ld)[c] =
          __float2bfloat16_rn(0.0f);
    }
  }

  // Q fragments (bf16, unscaled; the scale multiplies the fp32 score)
  const int wrow0 = row0 + warp * 16;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  uint32_t qa[HDP / 16][4];
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wrow0 + gid + ((e & 1) ? 8 : 0);
      const int d = ks * 16 + 2 * tig + ((e & 2) ? 8 : 0);
      uint32_t v = 0;
      if (row < lr && d < hd)
        v = *reinterpret_cast<const uint32_t*>(
            q + out_offset<__nv_bfloat16>(p, b, g, row, rep) + d);
      qa[ks][e] = v;
    }
  }

  const Range rg = block_range(p, kl, rep, row0, row_end, s);
  auto kslot = [&](int sl) { return ring + sl * slot_bytes; };
  auto vslot = [&](int sl) { return ring + sl * slot_bytes + TK * ld; };
  auto ksslot = [&](int sl) {
    return reinterpret_cast<float*>(ring + sl * slot_bytes + 2 * TK * ld);
  };
  auto issue = [&](int j) {
    const int sl = j % NSTAGE;
    issue_chunk<KV>(p, b, g, rg.begin + j * TK, rg.end, kslot(sl), vslot(sl),
                    ksslot(sl), ksslot(sl) + TK, ld);
  };
#pragma unroll
  for (int j = 0; j < NSTAGE - 1; ++j) {
    if (j < rg.nchunks) issue(j);
    cp_commit();
  }

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int rl[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + gid + 8 * h;
    live[h] = row < lr;
    rl[h] = kl + row / rep;
  }
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  float acc[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int c = 0; c < rg.nchunks; ++c) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (c + NSTAGE - 1 < rg.nchunks) issue(c + NSTAGE - 1);
    cp_commit();
    const int sl = c % NSTAGE;
    const float* ksc = ksslot(sl);
    const float* vsc = ksc + TK;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (Q8) {
      const int8_t* k8 = reinterpret_cast<const int8_t*>(kslot(sl));
      const int8_t* v8 = reinterpret_cast<const int8_t*>(vslot(sl));
      for (int i = tid; i < TK * hd / 2; i += THREADS) {
        const int r = i / (hd / 2), cc = 2 * (i % (hd / 2));
        *reinterpret_cast<__nv_bfloat162*>(kb8 + r * KB_LD + cc) =
            __floats2bfloat162_rn(static_cast<float>(k8[r * ld + cc]),
                                  static_cast<float>(k8[r * ld + cc + 1]));
        *reinterpret_cast<__nv_bfloat162*>(vb8 + r * KB_LD + cc) =
            __floats2bfloat162_rn(static_cast<float>(v8[r * ld + cc]),
                                  static_cast<float>(v8[r * ld + cc + 1]));
      }
      __syncthreads();
      kt = kb8;
      vt = vb8;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(kslot(sl));
      vt = reinterpret_cast<const __nv_bfloat16*>(vslot(sl));
    }

    // S = Q K^T: 16 rows x 32 tokens per warp
    float sc[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        const __nv_bfloat16* kp = kt + (n * 8 + gid) * KB_LD + ks * 16 +
                                  2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16(sc[n], qa[ks], b0, b1);
      }
    }

    const int c0 = rg.begin + c * TK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = n * 8 + 2 * tig + (e & 1);
        const int pos = c0 + j;
        bool ok = live[h] && pos < rl[h] && pos < rg.end;
        if (p.window >= 0) ok = ok && pos >= rl[h] - p.window;
        float v = sc[n][e] * p.scale;
        if constexpr (Q8) v *= ksc[j];
        v = ok ? v : NEG_INF;
        sc[n][e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pr =
            sc[n][e] > 0.5f * NEG_INF ? expf(sc[n][e] - m_r[h]) : 0.0f;
        sum[h] += pr;
        // v_scale folds into P before P is rounded to bf16
        sc[n][e] = Q8 ? pr * vsc[n * 8 + 2 * tig + (e & 1)] : pr;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(FULL, sum[h], 1);
      sum[h] += __shfl_xor_sync(FULL, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P from the score registers, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = vt + (kk * 16 + (lane & 15)) * KB_LD;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        if (n * 8 < hd) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vrow + n * 8);
          mma_bf16(acc[n], pa, b0, b1);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + gid + 8 * h;
    if (!live[h]) continue;
    if (p.splits == 1) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) +
                         out_offset<__nv_bfloat16>(p, b, g, row, rep);
      const float den = fmaxf(l_r[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int d = n * 8 + 2 * tig;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
              acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
      }
    } else {
      const size_t pr = part_row(p, b, g, s, row, lr);
      float* o = p.pacc + pr * hd;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int d = n * 8 + 2 * tig;
        if (d < hd)
          *reinterpret_cast<float2*>(o + d) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
      if (tig == 0) {
        p.pm[pr] = m_r[h];
        p.pl[pr] = l_r[h];
      }
    }
  }
}

// ------------------------------------------------------------ merge kernel
// One warp per (b, g, row): the S partials in split order, JAX's formula.
template <typename QType>
__global__ void __launch_bounds__(THREADS) merge_kernel(Params p) {
  const int rep = p.H / p.KVH, lr = p.L * rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * (THREADS / 32) + warp;
  const int b = blockIdx.x / p.KVH, g = blockIdx.x % p.KVH;
  if (row >= lr) return;
  float m_star = NEG_INF;
  for (int s = 0; s < p.splits; ++s)
    m_star = fmaxf(m_star, p.pm[part_row(p, b, g, s, row, lr)]);
  float l_star = 0.0f, o[HDP / 32];
#pragma unroll
  for (int i = 0; i < HDP / 32; ++i) o[i] = 0.0f;
  for (int s = 0; s < p.splits; ++s) {
    const size_t pr = part_row(p, b, g, s, row, lr);
    const float w = expf(p.pm[pr] - m_star);
    l_star += p.pl[pr] * w;
#pragma unroll
    for (int i = 0; i < HDP / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < p.hd) o[i] += p.pacc[pr * p.hd + d] * w;
    }
  }
  QType* out = static_cast<QType*>(p.out) + out_offset<QType>(p, b, g, row,
                                                              rep);
#pragma unroll
  for (int i = 0; i < HDP / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < p.hd) store(out + d, o[i] / fmaxf(l_star, 1e-30f));
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t set_smem(Kernel k, int bytes, int& configured) {
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  return cudaSuccess;
}

template <typename QType, int KV, int QT>
cudaError_t launch_core(const Params& p, cudaStream_t st) {
  constexpr int VB = KVInfo<KV>::VB;
  // ring row stride: an odd number of VB-byte pieces, so the 32 lanes'
  // row reads of one column fall in distinct banks
  int ld = p.hd * KVInfo<KV>::SIZE;
  if ((ld / VB) % 2 == 0) ld += VB;
  const int smem = NSTAGE * (2 * TK * ld + (KV == KV_INT8 ? 2 * TK * 4 : 0));
  // set on the first launch: static + dynamic above 48 KB needs it
  static int configured = 0;
  auto kern = attend_core_kernel<QType, KV, QT>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int lr = p.L * (p.H / p.KVH);
  const dim3 grid(p.B, p.KVH, p.splits * ((lr + QT - 1) / QT));
  kern<<<grid, THREADS, smem, st>>>(p, ld);
  return cudaGetLastError();
}

template <int KV>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  const int ld = KV == KV_INT8 ? ((p.hd / 8) | 1) * 8 : KB_LD * 2;
  const int slot = 2 * TK * ld + (KV == KV_INT8 ? 2 * TK * 4 : 0);
  const int smem = NSTAGE * slot + (KV == KV_INT8 ? 2 * TK * KB_LD * 2 : 0);
  // set on the first launch: static + dynamic above 48 KB needs it
  static int configured = 0;
  auto kern = attend_mma_kernel<KV>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int lr = p.L * (p.H / p.KVH);
  const dim3 grid(p.B, p.KVH, p.splits * ((lr + MMA_ROWS - 1) / MMA_ROWS));
  kern<<<grid, THREADS, smem, st>>>(p, ld);
  return cudaGetLastError();
}

template <typename QType, int KV>
cudaError_t launch_attend(const Params& p, cudaStream_t st) {
  const int lr = p.L * (p.H / p.KVH);
  if constexpr (std::is_same<QType, __nv_bfloat16>::value && KV != KV_F32) {
    if (lr > 16) return launch_mma<KV>(p, st);
  }
  if (lr <= 4) return launch_core<QType, KV, 4>(p, st);
  return launch_core<QType, KV, 16>(p, st);
}

template <typename QType>
cudaError_t run(int kv_mode, const Params& p, cudaStream_t st) {
  cudaError_t e;
  switch (kv_mode) {
    case KV_F32: e = launch_attend<QType, KV_F32>(p, st); break;
    case KV_BF16: e = launch_attend<QType, KV_BF16>(p, st); break;
    case KV_INT8: e = launch_attend<QType, KV_INT8>(p, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || p.splits == 1) return e;
  const int lr = p.L * (p.H / p.KVH);
  const dim3 grid(p.B * p.KVH, (lr + THREADS / 32 - 1) / (THREADS / 32));
  merge_kernel<QType><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  q/out: [B, L, H, hd] (bf16 when
// q_bf16, else f32); k/v pools [num_pages, P, KVH, hd] (kv_mode 0 f32,
// 1 bf16, 2 int8 with k/v scale pools [num_pages, P, KVH, 1] f32);
// page_table [B, maxp] int32; kv_len [B] int32; window < 0 means none;
// splits S >= 1 page ranges of ceil(maxp / S) pages; when S > 1, scratch
// partials acc [B, KVH, S, L*H/KVH, hd] and m, l [B, KVH, S, L*H/KVH]
// fp32.  hd <= 128 and a multiple of 8; pools 16-byte aligned.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* kv_len,
    void* out, void* part_acc, void* part_m, void* part_l, int B, int L,
    int H, int KVH, int hd, int P, int maxp, int window, int splits,
    float scale, int q_bf16, int kv_mode, void* stream) {
  if (B <= 0 || L <= 0 || KVH <= 0 || H % KVH || hd <= 0 || hd > HDP ||
      hd % 8 || P <= 0 || maxp <= 0 || splits <= 0 || splits > maxp)
    return cudaErrorInvalidValue;
  if (splits > 1 && (!part_acc || !part_m || !part_l))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.pt = static_cast<const int*>(page_table);
  p.kvl = static_cast<const int*>(kv_len);
  p.out = out;
  p.pacc = static_cast<float*>(part_acc);
  p.pm = static_cast<float*>(part_m);
  p.pl = static_cast<float*>(part_l);
  p.B = B; p.L = L; p.H = H; p.KVH = KVH; p.hd = hd; p.P = P;
  p.maxp = maxp; p.window = window; p.splits = splits;
  p.pps = (maxp + splits - 1) / splits;
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16) return run<__nv_bfloat16>(kv_mode, p, st);
  return run<float>(kv_mode, p, st);
}
