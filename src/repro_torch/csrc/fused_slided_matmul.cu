// Fused slided matmul for Hopper (sm_90a): the paper's GPU path, the
// per-token quantization and the lift Psi in the prologue of a GEMM on the
// 2:4 sparse tensor cores.
//
// Replaces the TPU kernel repro/kernels/fused_slide_matmul.py::
// fused_slided_matmul_pallas (_kernel).  Computes
//
//   y[R, M] = act((Psi(q(x)) @ Phi(W)^T) * s_x * s_w + bias)
//
// x [R, K] bf16/f32; q int8 or e4m3 per token; Phi(W) the slided weights
// [M, gamma*K], every window of 4 lifted columns 2:4, held as the 2:4
// operand of mma.sp (kernels/fused_slide_matmul.py::sparse_operand): per
// window two int8 (or nibble-packed int4, 'w4') values and two 2-bit
// positions, in the m16n8k64 fragment order, so a lane loads its A
// fragment (16 bytes, 8 for w4) and its metadata (16 bytes for four
// k-steps) straight from device memory.
//
// What bounds it on the H100: the weight stream.  Values plus metadata
// are 0.75 + 0.1875 bytes per original weight at 6:8 (w4: 0.375 +
// 0.1875), against 1.5 for the dense slided matrix the first port read;
// at decode (R <= 8) that stream against 3.35 TB/s is the whole bound,
// and at prefill (R = 128) it still is for the model's shapes
// (2 R / 0.94 int8 operations per byte, far below the card's ~590),
// although there the lift's instructions, not the stream, set the time.
// What the design does about it:
//
// - The sparse weights are mma.sp's A operand (M x gamma*K, 2:4 along
//   gamma*K) and the lifted activations B (gamma*K x R, R padded to 8):
//   mma.sp::ordered_metadata m16n8k64 s8 x s8 -> s32 (w4 sign-extended in
//   registers).  The int32 sums are exact, so any order of summation gives
//   the int8/w4 results bit for bit.
// - A first pass (absmax_kernel, one block per activation row) finds
//   each row's absmax once; a block derives its rows' quantizers from it
//   (quant_lift.cuh's row_quant and quant1, shared with
//   fused_quant_slide.cu) and quantizes and lifts each stage of 256
//   lifted columns once into shared memory, in B-fragment order, where it
//   serves every one of the block's weight rows.  The lifted
//   activations never reach device memory.
// - Decode (R <= 8): four warps of two 16-row tiles, one n8 tile.  The
//   block's first weight fragments are in flight while it lifts its whole
//   share of gamma*K (at most DEC_MAX_STAGES stages of 2 KB), so the
//   weight loop that follows runs with no barrier.  (An absmax pass in
//   every block read the same few KB of x from every SM at once and took
//   most of a decode call.)  Prefill (R > 8): eight warps over 256 weight rows x
//   64 activation rows (two 16-row tiles x eight n8 tiles each), so each
//   lifted stage serves 256 weight rows and each weight byte is read once
//   per 64 activation rows (the lift, not the weight stream, bounds this
//   instance; 128 x 128 tiles ran slower); the stages are lifted into a
//   double buffer, one barrier each, the next stage's weight loads in
//   flight during its lift.  The lift takes
//   one source group of 2N columns at a time, so each x value is loaded
//   and quantized once although gamma = 1.5 lifted columns come from it.
// - 3840 weight rows make only 30 blocks, so the launcher splits gamma*K
//   over blocks (grid.z); reduce_kernel sums the int32 partials in split
//   order (exact, no atomics) and runs the epilogue.
// - e4m3 activations ('fp8', 'fp8w4'): no tensor-core instruction
//   multiplies e4m3 by s8, so these recipes take a CUDA-core fp32 instance
//   (fp8_kernel) over the same 2:4 operand: each lane reads its slots'
//   positions from the lane that holds their metadata (shuffles) and
//   gathers the lifted activations from shared memory.
//
// The epilogue runs in the JAX order: acc -> f32, * s_x, * s_w, + bias,
// activation, cast, with __fmul_rn/__fadd_rn (epilogue.cuh).
#include "epilogue.cuh"
#include "quant_lift.cuh"

#include <algorithm>

namespace {

using quant_lift::RowQuant;
using quant_lift::FULL;

constexpr int KSTEP = 64;             // lifted columns of one mma.sp
constexpr int SKS = 4;                // k-steps per stage (one meta uint4)
constexpr int STAGE = SKS * KSTEP;    // lifted columns per stage
constexpr int FRAG = 512;             // bytes of one A or B fragment
constexpr int DECODE_MAX_R = 8;       // R at or below: the decode instance
constexpr int DEC_MAX_STAGES = 32;    // decode: stages a split lifts at once

__device__ __forceinline__ void mma_sp(int (&c)[4], const uint32_t (&a)[4],
                                       const uint4& b, uint32_t e) {
  asm volatile(
      "mma.sp::ordered_metadata.sync.aligned.m16n8k64.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, "
      "0x0;\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(b.z), "r"(b.w), "r"(e));
}

// four sign-extended int4 values from the low 16 bits of u (element 2i in
// the low nibble of byte i) as four int8 bytes
__device__ __forceinline__ uint32_t nibbles_to_bytes(uint32_t u) {
  uint32_t x = (u & 0xfu) | ((u & 0xf0u) << 4) | ((u & 0xf00u) << 8) |
               ((u & 0xf000u) << 12);
  return x | (((x >> 3) & 0x01010101u) * 0xf0u);
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the A fragment registers of k-step q (0..3) of a stage from the raw
// 16-byte loads: int8 -> load q; w4 -> half (q & 1) of load q / 2
template <bool PACKED>
__device__ __forceinline__ void a_regs(uint32_t (&a)[4], const uint4 (&v)[4],
                                       int q) {
  if constexpr (PACKED) {
    const uint4& p = v[q >> 1];
    const uint32_t w0 = (q & 1) ? p.z : p.x, w1 = (q & 1) ? p.w : p.y;
    a[0] = nibbles_to_bytes(w0);
    a[1] = nibbles_to_bytes(w0 >> 16);
    a[2] = nibbles_to_bytes(w1);
    a[3] = nibbles_to_bytes(w1 >> 16);
  } else {
    a[0] = v[q].x;
    a[1] = v[q].y;
    a[2] = v[q].z;
    a[3] = v[q].w;
  }
}

// one row tile's operand for one stage: the 16-byte value loads (four
// k-steps; two for w4) and the metadata of the four k-steps
struct ATile {
  uint4 v[4];
  uint4 e;
};

template <bool PACKED>
__device__ __forceinline__ void load_tile(ATile& t, const uint4* __restrict__ vals,
                                          const uint4* __restrict__ meta,
                                          int mt, int Mt, int st, int KS,
                                          int KQ, int lane) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (mt >= Mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t.v[i] = zero;
    t.e = make_uint4(0x44444444u, 0x44444444u, 0x44444444u, 0x44444444u);
    return;
  }
  t.e = __ldg(meta + (static_cast<size_t>(mt) * KQ + st) * 32 + lane);
  if constexpr (PACKED) {
    const int KS2 = (KS + 1) / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k2 = 2 * st + h;
      t.v[h] = k2 < KS2 ? __ldg(vals + (static_cast<size_t>(mt) * KS2 + k2)
                                           * 32 + lane)
                        : zero;
    }
    t.v[2] = t.v[3] = zero;
  } else {
#pragma unroll
    for (int q = 0; q < SKS; ++q) {
      const int ks = SKS * st + q;
      t.v[q] = ks < KS ? __ldg(vals + (static_cast<size_t>(mt) * KS + ks)
                                          * 32 + lane)
                       : zero;
    }
  }
}

// Lifted words [64 st, 64 (st + nst)) (stages st .. st + nst - 1) of the
// block's first nr activation rows, quantized, into ``buf`` in B-fragment
// order: stage s at s * SKS*NT*FRAG bytes; in it k-step q, n-tile nt, lane
// (g, t) -> 16 bytes, word j of them lifted word 16 q + 4 j + t of row
// nt * 8 + g.  A thread takes (row, source group) items, four at a time
// with their loads in flight together: it loads a group's 2N values (N
// pair loads), quantizes each once (quant1, the quantizer of
// fused_quant_slide.cu) and writes the N - 1 lifted words (g, j) = pairs
// (j, j + 1) that fall in the range.  Words of rows >= nr
// and past gamma*K are not written: they meet only discarded outputs or
// zero weights, and integer products by 0 are 0.
template <int NT, int THREADS>
__device__ __forceinline__ void lift_range(uint8_t* buf,
                                           const uint8_t* __restrict__ xb,
                                           size_t x_row, int r0, int nr,
                                           int st, int nst, int GK,
                                           int n_fam, int x_bf16,
                                           const RowQuant* rq, int tid) {
  constexpr int U = 4;  // items whose loads a thread has in flight at once
  const int nm1 = n_fam - 1;
  const int W0 = 64 * st, W1 = min(64 * (st + nst), GK / 4);
  if (W0 >= W1) return;
  const int g0 = W0 / nm1, ng = (W1 - 1) / nm1 + 1 - g0;
  const int total = nr * ng;
  for (int base = tid; base < total; base += U * THREADS) {
    // raw pairs: a bf16 pair in .x, an f32 pair in .x/.y
    uint2 raw[U][4];
    int rn[U], rg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      rn[u] = i / ng;
      rg[u] = g0 + (i - rn[u] * ng);
      const uint8_t* row = xb + (r0 + rn[u]) * x_row;
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // guards, not break: keeps the unroll
        const int c = 2 * n_fam * rg[u] + 2 * p;  // even: pair aligned
        raw[u][p] = make_uint2(0, 0);
        if (i < total && p < n_fam) {
          if (x_bf16)
            raw[u][p].x = *reinterpret_cast<const uint32_t*>(row + 2 * c);
          else
            raw[u][p] = *reinterpret_cast<const uint2*>(row + 4 * c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * THREADS >= total) continue;
      const int n = rn[u], grp = rg[u];
      const RowQuant q = rq[n];
      uint32_t qp[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float2 f;
        if (x_bf16)
          f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[u][p].x));
        else
          f = *reinterpret_cast<const float2*>(&raw[u][p]);
        qp[p] = quant_lift::quant_pair<false>(f, q);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int local = grp * nm1 + j - W0;
        if (j >= nm1 || local < 0 || local >= W1 - W0) continue;
        const int w = local & 63;
        *reinterpret_cast<uint32_t*>(
            buf + (local >> 6) * (SKS * NT * FRAG)
            + (((w >> 4) * NT + (n >> 3)) * 32 + 4 * (n & 7) + (w & 3)) * 16
            + 4 * ((w >> 2) & 3)) = quant_lift::lifted_word(qp[j], qp[j + 1]);
      }
    }
  }
}

// the int8/w4 instance: WM x WN warps, each TM 16-row tiles x TN n8 tiles.
// A block walks stages [z * sps, (z + 1) * sps) of gamma*K and takes its
// rows' quantizers from ``amax`` (absmax_kernel).  DECODE: it lifts all
// its stages into shared memory up front (sps stages of 2 KB), so the
// weight loop runs without a barrier; else stage by stage into a double
// buffer.
template <int WM, int WN, int TM, int TN, bool PACKED, bool DECODE>
__global__ void __launch_bounds__(32 * WM * WN) sparse_kernel(
    const void* __restrict__ x, int x_bf16, const uint4* __restrict__ vals,
    const uint4* __restrict__ meta, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out,
    const float* __restrict__ amax, int* __restrict__ part, int R, int M,
    int K,
    int n_fam, int sps, int out_bf16, int act) {
  constexpr int WARPS = WM * WN, THREADS = 32 * WARPS;
  constexpr int BM = WM * TM * 16, NT = WN * TN, BN = NT * 8;
  constexpr int STG = SKS * NT * FRAG;  // one stage's B fragments
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ RowQuant rq[BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int GK = K / (2 * n_fam) * (n_fam - 1) * 4;
  const int KS = (GK + KSTEP - 1) / KSTEP, KQ = (KS + SKS - 1) / SKS;
  const int Mt = (M + 15) / 16;
  const int mt0 = blockIdx.x * (BM / 16) + wm * TM;
  const int r0 = blockIdx.y * BN, nr = min(BN, R - r0);
  const int st0 = blockIdx.z * sps, st1 = min(KQ, st0 + sps);
  const size_t x_row = static_cast<size_t>(K) * (x_bf16 ? 2 : 4);
  const uint8_t* xb = static_cast<const uint8_t*>(x);

  // the first stage's weights are in flight while the block lifts
  ATile cur[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (st0 < st1)
      load_tile<PACKED>(cur[i], vals, meta, mt0 + i, Mt, st0, KS, KQ, lane);

  if (tid < BN)
    rq[tid] = quant_lift::row_quant<false>(tid < nr ? amax[r0 + tid] : 0.f);
  __syncthreads();

  int acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // DECODE lifts the block's whole share now; prefill stage by stage
  if (st0 < st1)
    lift_range<NT, THREADS>(smem, xb, x_row, r0, nr, st0,
                            DECODE ? st1 - st0 : 1, GK, n_fam, x_bf16, rq,
                            tid);
  if constexpr (DECODE) __syncthreads();
  for (int st = st0; st < st1; ++st) {
    const uint8_t* buf;
    ATile nxt[DECODE ? TM : 1];
    if constexpr (DECODE) {
      // the next stage's weights in flight during this stage's products
      buf = smem + (st - st0) * STG;
      if (st + 1 < st1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          load_tile<PACKED>(nxt[i], vals, meta, mt0 + i, Mt, st + 1, KS, KQ,
                            lane);
      }
    } else {
      __syncthreads();  // stage st lifted; stage st - 1's buffer free
      buf = smem + ((st - st0) & 1) * STG;
    }
#pragma unroll
    for (int q = 0; q < SKS; ++q) {
      if (SKS * st + q >= KS) continue;  // not break: keeps the unroll
      uint32_t a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a_regs<PACKED>(a[i], cur[i].v, q);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int nt = wn * TN + j;
        if (nt * 8 >= nr) continue;
        const uint4 b = *reinterpret_cast<const uint4*>(
            buf + ((q * NT + nt) * 32 + lane) * 16);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (mt0 + i < Mt) mma_sp(acc[i][j], a[i], b, comp(cur[i].e, q));
      }
    }
    if (st + 1 < st1) {
      if constexpr (DECODE) {
#pragma unroll
        for (int i = 0; i < TM; ++i) cur[i] = nxt[i];
      } else {
        // the next stage's weights in flight during its lift
#pragma unroll
        for (int i = 0; i < TM; ++i)
          load_tile<PACKED>(cur[i], vals, meta, mt0 + i, Mt, st + 1, KS, KQ,
                            lane);
        lift_range<NT, THREADS>(smem + ((st + 1 - st0) & 1) * STG, xb, x_row,
                                r0, nr, st + 1, 1, GK, n_fam, x_bf16, rq,
                                tid);
      }
    }
  }

  // accumulator c of tile (i, j): weight row g + 8 (c >> 1), activation
  // row 2 t + (c & 1) of the tile
  const size_t total = static_cast<size_t>(R) * M;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = (mt0 + i) * 16 + g + 8 * (c >> 1);
        const int nl = (wn * TN + j) * 8 + 2 * t + (c & 1);
        if (m >= M || nl >= nr) continue;
        const size_t o = static_cast<size_t>(r0 + nl) * M + m;
        if (part != nullptr) {
          part[blockIdx.z * total + o] = acc[i][j][c];
          continue;
        }
        epi::store(__int2float_rn(acc[i][j][c]), rq[nl].scale, sw[m], bias, m,
                   act, out, o, out_bf16);
      }
}

// one block per activation row: amax[r] = max_k |x[r, k]|
__global__ void __launch_bounds__(256) absmax_kernel(
    const void* __restrict__ x, int x_bf16, float* __restrict__ amax, int K) {
  __shared__ float red[8];
  const int r = blockIdx.x, tid = threadIdx.x;
  const uint8_t* row = static_cast<const uint8_t*>(x)
                       + static_cast<size_t>(r) * K * (x_bf16 ? 2 : 4);
  float a = quant_lift::warp_max(
      quant_lift::partial_absmax(row, K, x_bf16, tid, 256));
  if ((tid & 31) == 0) red[tid >> 5] = a;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < 8; ++w) a = fmaxf(a, red[w]);
    amax[r] = a;
  }
}

// sum the split-K int32 partials in split order (exact), then the epilogue
__global__ void __launch_bounds__(256) reduce_kernel(
    const int* __restrict__ part, int splits, const float* __restrict__ amax,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int R, int M, int out_bf16, int act) {
  const size_t total = static_cast<size_t>(R) * M;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    const int r = static_cast<int>(i / M), m = static_cast<int>(i % M);
    epi::store(__int2float_rn(s), quant_lift::row_quant<false>(amax[r]).scale,
               sw[m], bias, m, act, out, i, out_bf16);
  }
}

// ------------------------------------------------------ e4m3 instance
constexpr int F8_WARPS = 4;   // one 16-row tile each
constexpr int F8_RB = 8;      // activation rows per block

template <bool PACKED>
__global__ void __launch_bounds__(32 * F8_WARPS) fp8_kernel(
    const void* __restrict__ x, int x_bf16, const uint4* __restrict__ vals,
    const uint4* __restrict__ meta, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out,
    const float* __restrict__ amax, int R, int M, int K, int n_fam,
    int out_bf16, int act) {
  __shared__ float xs[F8_RB][STAGE];
  __shared__ RowQuant rq[F8_RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int GK = K / (2 * n_fam) * (n_fam - 1) * 4;
  const int KS = (GK + KSTEP - 1) / KSTEP, KQ = (KS + SKS - 1) / SKS;
  const int Mt = (M + 15) / 16;
  const int mt = blockIdx.x * F8_WARPS + warp;
  const int r0 = blockIdx.y * F8_RB, nr = min(F8_RB, R - r0);
  const size_t x_row = static_cast<size_t>(K) * (x_bf16 ? 2 : 4);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  if (tid < F8_RB)
    rq[tid] = quant_lift::row_quant<true>(tid < nr ? amax[r0 + tid] : 0.f);

  float acc[2][F8_RB];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < F8_RB; ++n) acc[h][n] = 0.f;

  for (int st = 0; st < KQ; ++st) {
    __syncthreads();  // rq written; the previous stage consumed
    for (int i = tid; i < F8_RB * (STAGE / 4); i += 32 * F8_WARPS) {
      const int n = i / (STAGE / 4), w = i % (STAGE / 4);
      const int word = st * (STAGE / 4) + w;
      uint32_t v = 0;
      if (n < nr && 4 * word < GK)
        v = quant_lift::quant_lift_word<true>(xb + (r0 + n) * x_row, word,
                                              n_fam, x_bf16, rq[n]);
#pragma unroll
      for (int d = 0; d < 4; ++d)
        xs[n][4 * w + d] = epi::byte_to_f<true>((v >> (8 * d)) & 0xffu);
    }
    __syncthreads();
    ATile tile;
    load_tile<PACKED>(tile, vals, meta, mt, Mt, st, KS, KQ, lane);
    if (mt >= Mt) continue;
#pragma unroll
    for (int q = 0; q < SKS; ++q) {
      if (SKS * st + q >= KS) continue;  // not break: keeps the unroll
      uint32_t a[4];
      a_regs<PACKED>(a, tile.v, q);
      const uint32_t e = comp(tile.e, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // register j: row g + 8 h, kept values 4t + b + 16 qq; their
        // metadata is in lane 4g + 2 qq + h, nibble 2t + b / 2
        const int h = j & 1, qq = j >> 1;
        const uint32_t es = __shfl_sync(FULL, e, 4 * g + 2 * qq + h);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float wv = static_cast<float>(
              static_cast<int8_t>((a[j] >> (8 * b)) & 0xffu));
          if (wv == 0.f) continue;
          const int i = 2 * t + (b >> 1);
          const int p = (es >> (4 * i + 2 * (b & 1))) & 3;
          const int col = q * KSTEP + 4 * (8 * qq + i) + p;
#pragma unroll
          for (int n = 0; n < F8_RB; ++n) acc[h][n] = fmaf(wv, xs[n][col], acc[h][n]);
        }
      }
    }
  }
  if (mt >= Mt) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < F8_RB; ++n) {
      float v = acc[h][n];
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      const int m = mt * 16 + g + 8 * h;
      if (t != 0 || m >= M || n >= nr) continue;
      epi::store(v, rq[n].scale, sw[m], bias, m, act, out,
                 static_cast<size_t>(r0 + n) * M + m, out_bf16);
    }
}

struct Args {
  const void* x;
  int x_bf16;
  const uint4* vals;
  const uint4* meta;
  const float* sw;
  const float* bias;
  void* out;
  float* amax;
  int* part;
  int R, M, K, n_fam, out_bf16, act, splits;
};

template <int WM, int WN, int TM, int TN, bool PACKED, bool DECODE>
cudaError_t launch_sparse(const Args& a, cudaStream_t st) {
  constexpr int BM = WM * TM * 16, BN = WN * TN * 8;
  constexpr int STG = SKS * (BN / 8) * FRAG;
  constexpr int MAX_SMEM = DECODE ? DEC_MAX_STAGES * STG : 2 * STG;
  auto kern = sparse_kernel<WM, WN, TM, TN, PACKED, DECODE>;
  // set on the first launch: dynamic shared memory above 48 KB needs it
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int GK = a.K / (2 * a.n_fam) * (a.n_fam - 1) * 4;
  const int KQ = ((GK + KSTEP - 1) / KSTEP + SKS - 1) / SKS;
  const int sps = (KQ + a.splits - 1) / a.splits;
  if (DECODE && sps > DEC_MAX_STAGES) return cudaErrorInvalidValue;
  const int smem = DECODE ? sps * STG : 2 * STG;
  absmax_kernel<<<a.R, 256, 0, st>>>(a.x, a.x_bf16, a.amax, a.K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((a.M + BM - 1) / BM, (a.R + BN - 1) / BN, a.splits);
  kern<<<grid, 32 * WM * WN, smem, st>>>(
      a.x, a.x_bf16, a.vals, a.meta, a.sw, a.bias, a.out, a.amax,
      a.splits > 1 ? a.part : nullptr, a.R, a.M, a.K, a.n_fam, sps,
      a.out_bf16, a.act);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long total = static_cast<long long>(a.R) * a.M;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  reduce_kernel<<<blocks, 256, 0, st>>>(a.part, a.splits, a.amax, a.sw,
                                        a.bias, a.out, a.R, a.M, a.out_bf16,
                                        a.act);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_int(const Args& a, cudaStream_t st) {
  if (a.R <= DECODE_MAX_R)
    return launch_sparse<4, 1, 2, 1, PACKED, true>(a, st);
  return launch_sparse<8, 1, 2, 8, PACKED, false>(a, st);
}

template <bool PACKED>
cudaError_t launch_fp8(const Args& a, cudaStream_t st) {
  absmax_kernel<<<a.R, 256, 0, st>>>(a.x, a.x_bf16, a.amax, a.K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int Mt = (a.M + 15) / 16;
  const dim3 grid((Mt + F8_WARPS - 1) / F8_WARPS, (a.R + F8_RB - 1) / F8_RB);
  fp8_kernel<PACKED><<<grid, 32 * F8_WARPS, 0, st>>>(
      a.x, a.x_bf16, a.vals, a.meta, a.sw, a.bias, a.out, a.amax, a.R, a.M,
      a.K, a.n_fam, a.out_bf16, a.act);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  x: [R, K] bf16 (x_bf16) or f32;
// vals/meta: the 2:4 operand of sparse_operand for M rows; sw: [M] fp32;
// bias: [M] fp32 or null; out: [R, M] bf16 (out_bf16) or f32; amax: fp32
// scratch [R]; part: int32 scratch [splits, R, M] when splits > 1 (the
// int8/w4 instances; e4m3 takes splits = 1).  Returns the cudaError_t of
// the launches (0 on success).
extern "C" int fused_slided_matmul_launch(
    const void* x, int x_bf16, const void* vals, const void* meta,
    const void* sw, const void* bias, void* out, void* amax, void* part,
    int R, int M, int K, int n_fam, int fp8, int packed, int out_bf16,
    int act, int splits, void* stream) {
  if (n_fam < 2 || n_fam > 4 || R <= 0 || M <= 0 || K <= 0
      || K % (2 * n_fam) || splits < 1 || amax == nullptr
      || (splits > 1 && (part == nullptr || fp8)))
    return cudaErrorInvalidValue;
  const Args a{x, x_bf16, static_cast<const uint4*>(vals),
               static_cast<const uint4*>(meta), static_cast<const float*>(sw),
               static_cast<const float*>(bias), out,
               static_cast<float*>(amax), static_cast<int*>(part), R, M, K,
               n_fam, out_bf16, act, splits};
  auto s = static_cast<cudaStream_t>(stream);
  switch (fp8 * 2 + (packed ? 1 : 0)) {
    case 0: return launch_int<false>(a, s);
    case 1: return launch_int<true>(a, s);
    case 2: return launch_fp8<false>(a, s);
    default: return launch_fp8<true>(a, s);
  }
}
