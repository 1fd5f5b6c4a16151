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
// starts at column 2j of the group (j = slot / 2).  Every source column
// receives at most one non-zero slot (the packer's Algorithm 2), which the
// decompression below relies on.
//
// What bounds it on the H100: at decode (R <= 16) the compressed weight
// stream, 1.5 bytes per original int8 weight at 6:8 (0.75 of values, 0.75
// of positions; 1.125 for 'w4'), against 3.35 TB/s; at prefill (R = 128)
// still that stream for these shapes (2 R / 1.5 int8 operations per byte
// is far below the card's ~590), with the int8 tensor cores' 1979 TOP/s
// behind it.  Three instances, chosen by the launcher:
//
// - decode, int8/w4, R <= DECODE_MAX_R: one warp per weight row, eight
//   rows per block (M / 8 blocks).  The block stages its R activation rows once
//   per K pass, column-major ([K][RB] bytes, so one 4- or 8-byte load
//   gathers a column of every row), in shared memory; no weight tile is
//   built.  Each lane streams whole 48-byte pieces of its row's values and
//   positions (16-byte loads, the next piece in flight during the current
//   one), gathers x at each slot's source column, transposes four gathered
//   words into per-row words and __dp4a's them against four values.  The
//   int32 sum is exact in any order, so int8/w4 stay bit-equal;
// - prefill, int8/w4, R > DECODE_MAX_R: a block owns 64 weight rows and up
//   to 128 activation rows, so each weight tile is decompressed once per
//   call (per 128 rows).  A 3-stage cp.async ring brings each K stage's
//   compressed bytes and x tile; the block decompresses the stage into the
//   original K layout in shared memory and eight warps run
//   mma.sync.m16n8k32 s8 x s8 -> s32 (exact) over it.  Where the (M / 64)
//   blocks leave SMs idle the launcher splits K, and a second kernel sums
//   the int32 partials in split order (exact) before the epilogue;
// - the float recipes (e4m3 x int8/int4, bf16, f32; no mixed-type mma):
//   the first port's tile kernel, a 64-row weight tile decompressed into
//   shared memory per row block, fp32 FMAs.
//
// The epilogue runs in the JAX order: acc -> f32, * s_x, * s_w, + bias,
// activation, cast; the multiplies and the add use the _rn intrinsics so
// nvcc cannot contract them into an FMA, which keeps the integer recipes
// bit-equal to the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int DECODE_MAX_R = 16;  // R at or below: the decode instance
constexpr int DEC_WARPS = 8;      // decode: weight rows (warps) per block
constexpr int DEC_SMEM = 96 * 1024;  // decode: x staging per K pass
constexpr int PF_BM = 64;         // prefill: weight rows per block
constexpr int PF_BR = 128;        // prefill: activation rows per block
constexpr int PF_THREADS = 256;   // prefill: eight warps, 16 x rows each
constexpr int PF_NST = 3;         // prefill: cp.async ring depth
constexpr int BM = 64;            // float path: weight rows per block
constexpr int THREADS = 256;      // float path: 16 x 16 threads
constexpr int BK_MAX = 64;        // float path: dense K per stage

enum XMode { X_INT8 = 0, X_FP8 = 1, X_BF16 = 2, X_F32 = 3 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  if (act == ACT_GELU) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

// the dequant epilogue of one output, in the JAX order
__device__ __forceinline__ void epilogue_store(float o, bool quant, float sx,
                                               float sw, const float* bias,
                                               int m, int act, void* out,
                                               size_t off, int out_bf16) {
  if (quant) o = __fmul_rn(__fmul_rn(o, sx), sw);
  if (bias != nullptr) o = __fadd_rn(o, bias[m]);
  o = activate(o, act);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(o);
  else
    static_cast<float*>(out)[off] = o;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four sign-extended int4 values from the low 16 bits of u (element 2i in
// the low nibble of byte i) as four int8 bytes
__device__ __forceinline__ uint32_t nibbles_to_bytes(uint32_t u) {
  uint32_t x = (u & 0xfu) | ((u & 0xf0u) << 4) | ((u & 0xf00u) << 8) |
               ((u & 0xf000u) << 12);
  return x | (((x >> 3) & 0x01010101u) * 0xf0u);
}

// ----------------------------------------------------- decode instance
// bytes [off, off + 4 * NW) of a row of ``limit`` bytes as NW words, zero
// past the row's end; ``vec``: the row and its pieces are 16-byte aligned
template <int NW>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW],
                                           const uint8_t* __restrict__ row,
                                           int off, int limit, bool vec) {
  if (vec && off + 4 * NW <= limit) {
#pragma unroll
    for (int j = 0; j < NW / 4; ++j) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + off) + j);
      w[4 * j] = t.x;
      w[4 * j + 1] = t.y;
      w[4 * j + 2] = t.z;
      w[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (off + 4 * j + e < limit)
          v |= static_cast<uint32_t>(row[off + 4 * j + e]) << (8 * e);
      w[j] = v;
    }
  }
}

// rows' words from four gathered column words: out[r] byte e = in[e] byte r
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

template <int N, bool PACKED, int RB>
__global__ void __launch_bounds__(32 * DEC_WARPS) decode_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ values,
    const uint8_t* __restrict__ indices, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int R, int M, int K, int spp, int x_vec,
    int w_vec, int out_bf16, int act) {
  constexpr int L = 2 * N, S = 2 * (N - 1);
  constexpr int SPS = PACKED ? 96 : 48;  // slots per piece (48 value bytes)
  constexpr int GPS = SPS / S;           // window groups per piece
  constexpr int CPS = GPS * L;           // source columns per piece
  constexpr int VW = 12;                 // value words per piece
  constexpr int IW = SPS / 4;            // position words per piece
  static_assert(SPS % S == 0 && RB % 4 == 0, "piece layout");
  // piece j of a pass owns [CPS][RB] bytes at j * PIECE_LD: RB bytes of
  // padding per piece puts the lanes' pieces in different banks
  constexpr int PIECE_LD = CPS * RB + RB;
  extern __shared__ __align__(16) uint8_t xs[];  // [spp][PIECE_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m = blockIdx.x * DEC_WARPS + warp;
  const int r0 = blockIdx.y * RB;
  const int nr = min(RB, R - r0);
  const int G = K / L, kc = G * S, kcv = PACKED ? kc / 2 : kc;
  const int npiece = (kc + SPS - 1) / SPS;
  const int mc = min(m, M - 1);  // warps past M stream a real row, store none
  const uint8_t* vrow = values + static_cast<size_t>(mc) * kcv;
  const uint8_t* irow = indices + static_cast<size_t>(mc) * kc;
  const bool wv = w_vec != 0;

  int acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0;

  uint32_t v_cur[VW], i_cur[IW], v_nxt[VW], i_nxt[IW];
  for (int p0 = 0; p0 < npiece; p0 += spp) {
    const int np = min(spp, npiece - p0);
    int sp = p0 + lane;
    if (sp < p0 + np) {  // the first piece's bytes fly while x is staged
      load_words<VW>(v_cur, vrow, sp * 48, kcv, wv);
      load_words<IW>(i_cur, irow, sp * SPS, kc, wv);
    }
    __syncthreads();  // every warp is done with the previous pass
    // stage x[r0 .. r0 + RB)[c0 .. c0 + ncol) column-major: a thread
    // reads four columns of four rows (a word each) and writes the four
    // column words, transposed
    const int c0 = p0 * CPS, ncol = np * CPS;
    const int units = (RB / 4) * (ncol / 4);
#pragma unroll 4
    for (int i = tid; i < units; i += 32 * DEC_WARPS) {
      const int h = i / (ncol / 4), c = 4 * (i % (ncol / 4));
      uint32_t w4[4], cw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * h + j;
        const int8_t* xr = x + static_cast<size_t>(r0 + r) * K + c0 + c;
        uint32_t v = 0;
        if (r < nr) {
          if (x_vec && c0 + c < K) {
            v = *reinterpret_cast<const uint32_t*>(xr);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c0 + c + e < K)
                v |= static_cast<uint32_t>(static_cast<uint8_t>(xr[e]))
                     << (8 * e);
          }
        }
        w4[j] = v;
      }
      transpose4(w4, cw);
      uint8_t* dst = xs + (c / CPS) * PIECE_LD + (c % CPS) * RB + 4 * h;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(dst + e * RB) = cw[e];
    }
    __syncthreads();

    while (sp < p0 + np) {
      const int sn = sp + 32;
      const bool more = sn < p0 + np;
      if (more) {
        load_words<VW>(v_nxt, vrow, sn * 48, kcv, wv);
        load_words<IW>(i_nxt, irow, sn * SPS, kc, wv);
      }
      const uint8_t* xb = xs + (sp - p0) * PIECE_LD;
#pragma unroll
      for (int q4 = 0; q4 < SPS / 4; ++q4) {
        uint32_t g4[RB / 4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q4 + e;
          const int col = (i / S) * L + 2 * ((i % S) / 2) +
                          static_cast<int>((i_cur[i / 4] >> (8 * (i % 4))) &
                                           3u);
          if constexpr (RB == 4) {
            g4[0][e] = *reinterpret_cast<const uint32_t*>(xb + col * 4);
          } else {
            const uint2 t = *reinterpret_cast<const uint2*>(xb + col * 8);
            g4[0][e] = t.x;
            g4[1][e] = t.y;
          }
        }
        uint32_t wq;
        if constexpr (PACKED)
          wq = nibbles_to_bytes(v_cur[q4 / 2] >> (16 * (q4 % 2)));
        else
          wq = v_cur[q4];
#pragma unroll
        for (int h = 0; h < RB / 4; ++h) {
          uint32_t rw[4];
          transpose4(g4[h], rw);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[4 * h + r] = __dp4a(static_cast<int>(rw[r]),
                                    static_cast<int>(wq), acc[4 * h + r]);
        }
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < VW; ++j) v_cur[j] = v_nxt[j];
#pragma unroll
        for (int j = 0; j < IW; ++j) i_cur[j] = i_nxt[j];
      }
      sp = sn;
    }
  }

#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  if (lane == 0 && m < M) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nr)
        epilogue_store(__int2float_rn(acc[r]), true, sx[r0 + r], sw[m], bias,
                       m, act, out, static_cast<size_t>(r0 + r) * M + m,
                       out_bf16);
    }
  }
}

// ---------------------------------------------------- prefill instance
template <int N> struct PfTile {
  static constexpr int L = 2 * N, S = 2 * (N - 1);
  static constexpr int BK = N == 3 ? 96 : 64;  // whole groups, 32 | BK
  static constexpr int GS = BK / L;            // groups per stage
  static constexpr int LD = BK + 16;           // x / W tile row stride
};

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? VB : 0;
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(VB), "r"(n));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy ``n`` bytes from global ``src`` (the bytes at or past ``avail``
// read as 0) to shared ``dst`` in VB-byte cp.async pieces (vec) or bytes.
template <int VB>
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int n, int avail, bool vec,
                                            int i) {
  if (vec) {
    const int c = i * VB;
    if (c < n) cp_async<VB>(dst + c, c < avail ? src + c : src, c < avail);
  } else {
    for (int c = i * VB; c < min(n, (i + 1) * VB); ++c)
      dst[c] = c < avail ? src[c] : 0;
  }
}

template <int N, bool PACKED>
__global__ void __launch_bounds__(PF_THREADS) prefill_kernel(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ values,
    const uint8_t* __restrict__ indices, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int* __restrict__ part, int R, int M, int K,
    int stages_per_split, int vec, int out_bf16, int act) {
  using T = PfTile<N>;
  constexpr int L = T::L, S = T::S, BK = T::BK, GS = T::GS, LD = T::LD;
  constexpr int IROW = GS * S;                       // position bytes / stage
  constexpr int VROW = PACKED ? IROW / 2 : IROW;     // value bytes / stage
  constexpr int VPC = VROW % 16 == 0 ? 16 : 8;       // value cp.async piece
  constexpr int XS = PF_BR * LD;
  constexpr int SLOT = XS + PF_BM * (VROW + IROW);
  static_assert(IROW % 16 == 0 && VROW % 8 == 0 && BK % 32 == 0, "tile");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wd = smem + PF_NST * SLOT;  // the decompressed weight tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * PF_BM;
  const int r0 = blockIdx.y * PF_BR;
  const int G = K / L, kc = G * S, kcv = PACKED ? kc / 2 : kc;
  const int nstage = (G + GS - 1) / GS;
  const int st0 = blockIdx.z * stages_per_split;
  const int st1 = min(nstage, st0 + stages_per_split);
  const int nst = max(0, st1 - st0);
  const bool vv = vec != 0;

  auto issue = [&](int j) {
    uint8_t* base = smem + (j % PF_NST) * SLOT;
    const int st = st0 + j;
    const int k0 = st * BK;
    // x tile [PF_BR][BK], rows past R and columns past K are 0
    for (int i = tid; i < PF_BR * (BK / 16); i += PF_THREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      const int rr = r0 + r;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(x) +
                           static_cast<size_t>(min(rr, R - 1)) * K + k0;
      stage_bytes<16>(base + r * LD, src, BK, rr < R ? K - k0 : 0, vv, c);
    }
    // compressed values and positions of the stage's groups, per row
    uint8_t* vdst = base + XS;
    uint8_t* idst = vdst + PF_BM * VROW;
    for (int i = tid; i < PF_BM * (VROW / VPC); i += PF_THREADS) {
      const int r = i / (VROW / VPC), c = i % (VROW / VPC);
      const int mm = m0 + r;
      const uint8_t* src =
          values + static_cast<size_t>(min(mm, M - 1)) * kcv + st * VROW;
      stage_bytes<VPC>(vdst + r * VROW, src, VROW,
                       mm < M ? kcv - st * VROW : 0, vv, c);
    }
    for (int i = tid; i < PF_BM * (IROW / 16); i += PF_THREADS) {
      const int r = i / (IROW / 16), c = i % (IROW / 16);
      const int mm = m0 + r;
      const uint8_t* src =
          indices + static_cast<size_t>(min(mm, M - 1)) * kc + st * IROW;
      stage_bytes<16>(idst + r * IROW, src, IROW,
                      mm < M ? kc - st * IROW : 0, vv, c);
    }
  };

#pragma unroll
  for (int j = 0; j < PF_NST - 1; ++j) {
    if (j < nst) issue(j);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  int acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;

  for (int c = 0; c < nst; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PF_NST - 2) : "memory");
    __syncthreads();  // stage c landed; every warp is done with c - 1
    if (c + PF_NST - 1 < nst) issue(c + PF_NST - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint8_t* xt = smem + (c % PF_NST) * SLOT;
    const uint8_t* vsrc = xt + XS;
    const uint8_t* isrc = vsrc + PF_BM * VROW;

    // decompress the stage once into the original K layout
    for (int i = tid; i < PF_BM * GS; i += PF_THREADS) {
      const int r = i / GS, gg = i % GS;
      uint64_t dense = 0;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int slot = gg * S + t;
        uint32_t v;
        if constexpr (PACKED) {
          const uint32_t byte = vsrc[r * VROW + slot / 2];
          v = (t & 1) ? (byte >> 4) : (byte & 0xfu);
          v = (v ^ 8u) - 8u;  // sign-extend the nibble
        } else {
          v = vsrc[r * VROW + slot];
        }
        const int pos = 2 * (t / 2) + (isrc[r * IROW + slot] & 3);
        dense |= static_cast<uint64_t>(v & 0xffu) << (8 * pos);
      }
      uint8_t* dst = wd + r * LD + gg * L;
      if constexpr (L == 8) {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(static_cast<uint32_t>(dense),
                       static_cast<uint32_t>(dense >> 32));
      } else if constexpr (L == 4) {
        *reinterpret_cast<uint32_t*>(dst) = static_cast<uint32_t>(dense);
      } else {
#pragma unroll
        for (int e = 0; e < L / 2; ++e)
          reinterpret_cast<uint16_t*>(dst)[e] =
              static_cast<uint16_t>(dense >> (16 * e));
      }
    }
    __syncthreads();

    // warp w: activation rows [16 w, 16 w + 16) x all 64 weight rows
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const uint8_t* xa = xt + (warp * 16 + gid) * LD + ks * 32 + 4 * tig;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xa);
      a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(xa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * LD + 16);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* wb = wd + (n * 8 + gid) * LD + ks * 32 + 4 * tig;
        mma_s8(acc[n], a, *reinterpret_cast<const uint32_t*>(wb),
               *reinterpret_cast<const uint32_t*>(wb + 16));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + warp * 16 + gid + (e >= 2 ? 8 : 0);
      const int m = m0 + n * 8 + 2 * tig + (e & 1);
      if (r >= R || m >= M) continue;
      const size_t off = static_cast<size_t>(r) * M + m;
      if (part != nullptr)
        part[static_cast<size_t>(blockIdx.z) * R * M + off] = acc[n][e];
      else
        epilogue_store(__int2float_rn(acc[n][e]), true, sx[r], sw[m], bias,
                       m, act, out, off, out_bf16);
    }
  }
}

// sum the split-K int32 partials in split order (exact), then the epilogue
__global__ void __launch_bounds__(256) reduce_kernel(
    const int* __restrict__ part, int splits, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int R, int M, int out_bf16, int act) {
  const size_t total = static_cast<size_t>(R) * M;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    const int r = static_cast<int>(i / M), m = static_cast<int>(i % M);
    epilogue_store(__int2float_rn(s), true, sx[r], sw[m], bias, m, act, out,
                   i, out_bf16);
  }
}

// ------------------------------------------------------ float instance
template <int MODE> struct Traits;
template <> struct Traits<X_FP8> {
  using XT = __nv_fp8_e4m3; using WT = int8_t;
  static constexpr bool QUANT = true;
};
template <> struct Traits<X_BF16> {
  using XT = __nv_bfloat16; using WT = __nv_bfloat16;
  static constexpr bool QUANT = false;
};
template <> struct Traits<X_F32> {
  using XT = float; using WT = float;
  static constexpr bool QUANT = false;
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

template <int N, int MODE, bool PACKED>
__global__ void __launch_bounds__(THREADS) float_kernel(
    const typename Traits<MODE>::XT* __restrict__ x,
    const void* __restrict__ values, const int8_t* __restrict__ indices,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out, int R, int M,
    int K, int tr, int out_bf16, int act) {
  using Tr = Traits<MODE>;
  constexpr int L = 2 * N;          // source window-group width
  constexpr int S = 2 * (N - 1);    // compressed slots per group
  constexpr int GT = BK_MAX / L;    // groups per K stage
  constexpr int BK = GT * L;
  constexpr int LDS = BK | 1;       // odd row stride: no bank conflicts

  __shared__ float xs[64][LDS];
  __shared__ float ws[BM][LDS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output-column lane: columns tx + 16 j
  const int ty = tid / 16;  // row lane: rows ty + 16 i, i < tr
  const int br = 16 * tr;
  const int r0 = blockIdx.y * br;
  const int m0 = blockIdx.x * BM;
  const int G = K / L;
  const int kc = G * S;                   // slots per weight row
  const int kcv = PACKED ? kc / 2 : kc;   // stored value width

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int g0 = 0; g0 < G; g0 += GT) {
    // activation tile [br, BK], zero outside the matrix
    for (int i = tid; i < br * BK; i += THREADS) {
      const int rr = i / BK, kk = i % BK;
      const int r = r0 + rr, k = g0 * L + kk;
      float v = 0.0f;
      if (r < R && k < K) v = to_f(x[static_cast<size_t>(r) * K + k]);
      xs[rr][kk] = v;
    }
    // weight tile [BM, BK]: one (row, group) per iteration, decompressed
    // in registers into the original column order of the group
    for (int i = tid; i < BM * GT; i += THREADS) {
      const int mm = i / GT, gg = i % GT;
      const int m = m0 + mm, g = g0 + gg;
      float dense[L];
#pragma unroll
      for (int d = 0; d < L; ++d) dense[d] = 0.0f;
      if (m < M && g < G) {
        const int8_t* ip = indices + static_cast<size_t>(m) * kc
                           + static_cast<size_t>(g) * S;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const float v = to_f(load_w<MODE, PACKED>(values, m, kcv,
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
      epilogue_store(acc[i][j], Tr::QUANT, Tr::QUANT ? sx[r] : 0.0f,
                     Tr::QUANT ? sw[m] : 0.0f, bias, m, act, out,
                     static_cast<size_t>(r) * M + m, out_bf16);
    }
  }
}

// ---------------------------------------------------------------- launch
struct Args {
  const void* x;
  const void* values;
  const void* indices;
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  int* part;
  int R, M, K, splits, out_bf16, act;
};

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

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <int N, bool PACKED, int RB>
cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  constexpr int S = 2 * (N - 1), L = 2 * N;
  constexpr int SPS = PACKED ? 96 : 48, CPS = SPS / S * L;
  const int kc = a.K / L * S, kcv = PACKED ? kc / 2 : kc;
  const int npiece = (kc + SPS - 1) / SPS;
  const int spp =
      std::max(1, std::min(npiece, DEC_SMEM / (CPS * RB + RB)));
  const int smem = spp * (CPS * RB + RB);
  // set on the first launch: static + dynamic above 48 KB needs it
  static int configured = 0;
  auto kern = decode_kernel<N, PACKED, RB>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int x_vec = a.K % 4 == 0 && aligned(a.x, 4);
  const int w_vec = kcv % 16 == 0 && kc % 16 == 0 &&
                    aligned(a.values, 16) && aligned(a.indices, 16);
  const dim3 grid((a.M + DEC_WARPS - 1) / DEC_WARPS, (a.R + RB - 1) / RB);
  kern<<<grid, 32 * DEC_WARPS, smem, st>>>(
      static_cast<const int8_t*>(a.x), static_cast<const uint8_t*>(a.values),
      static_cast<const uint8_t*>(a.indices), a.sx, a.sw, a.bias, a.out, a.R,
      a.M, a.K, spp, x_vec, w_vec, a.out_bf16, a.act);
  return cudaGetLastError();
}

template <int N, bool PACKED>
cudaError_t launch_prefill(const Args& a, cudaStream_t st) {
  using T = PfTile<N>;
  constexpr int IROW = T::GS * T::S;
  constexpr int VROW = PACKED ? IROW / 2 : IROW;
  constexpr int VPC = VROW % 16 == 0 ? 16 : 8;
  const int smem = PF_NST * (PF_BR * T::LD + PF_BM * (VROW + IROW)) +
                   PF_BM * T::LD;
  // set on the first launch: static + dynamic above 48 KB needs it
  static int configured = 0;
  auto kern = prefill_kernel<N, PACKED>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int G = a.K / T::L, kc = G * T::S, kcv = PACKED ? kc / 2 : kc;
  const int nstage = (G + T::GS - 1) / T::GS;
  const int vec = a.K % 16 == 0 && kc % 16 == 0 && kcv % VPC == 0 &&
                  aligned(a.x, 16) && aligned(a.values, 16) &&
                  aligned(a.indices, 16);
  const int sps = (nstage + a.splits - 1) / a.splits;
  const dim3 grid((a.M + PF_BM - 1) / PF_BM, (a.R + PF_BR - 1) / PF_BR,
                  a.splits);
  kern<<<grid, PF_THREADS, smem, st>>>(
      static_cast<const int8_t*>(a.x), static_cast<const uint8_t*>(a.values),
      static_cast<const uint8_t*>(a.indices), a.sx, a.sw, a.bias, a.out,
      a.splits > 1 ? a.part : nullptr, a.R, a.M, a.K, sps, vec, a.out_bf16,
      a.act);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long total = static_cast<long long>(a.R) * a.M;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  reduce_kernel<<<blocks, 256, 0, st>>>(a.part, a.splits, a.sx, a.sw, a.bias,
                                        a.out, a.R, a.M, a.out_bf16, a.act);
  return cudaGetLastError();
}

template <int N, int MODE, bool PACKED>
cudaError_t launch_float(const Args& a, cudaStream_t st) {
  const int tr = a.R > 16 ? 4 : 1;  // 64-row blocks for prefill, 16 for decode
  const dim3 grid((a.M + BM - 1) / BM, (a.R + 16 * tr - 1) / (16 * tr));
  float_kernel<N, MODE, PACKED><<<grid, THREADS, 0, st>>>(
      static_cast<const typename Traits<MODE>::XT*>(a.x), a.values,
      static_cast<const int8_t*>(a.indices), a.sx, a.sw, a.bias, a.out, a.R,
      a.M, a.K, tr, a.out_bf16, a.act);
  return cudaGetLastError();
}

template <int N, bool PACKED>
cudaError_t launch_int(const Args& a, cudaStream_t st) {
  if (a.R > DECODE_MAX_R) return launch_prefill<N, PACKED>(a, st);
  if (a.R <= 4) return launch_decode<N, PACKED, 4>(a, st);
  return launch_decode<N, PACKED, 8>(a, st);
}

template <int N>
cudaError_t dispatch_mode(int xmode, int packed, const Args& a,
                          cudaStream_t s) {
  switch (xmode * 2 + (packed ? 1 : 0)) {
    case X_INT8 * 2: return launch_int<N, false>(a, s);
    case X_INT8 * 2 + 1: return launch_int<N, true>(a, s);
    case X_FP8 * 2: return launch_float<N, X_FP8, false>(a, s);
    case X_FP8 * 2 + 1: return launch_float<N, X_FP8, true>(a, s);
    case X_BF16 * 2: return launch_float<N, X_BF16, false>(a, s);
    case X_F32 * 2: return launch_float<N, X_F32, false>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers; sx/sw
// are ignored by the float modes; bias may be null.  ``splits`` splits K
// at prefill (int8/w4, R > 16); when it is > 1, ``part`` is int32 scratch
// [splits, R, M].  Returns the cudaError_t of the launches (0 on success).
extern "C" int compressed_matmul_launch(
    const void* x, const void* values, const void* indices, const void* sx,
    const void* sw, const void* bias, void* out, void* part, int R, int M,
    int K, int n_fam, int xmode, int packed, int out_bf16, int act,
    int splits, void* stream) {
  if (R <= 0 || M <= 0 || K <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  Args a{x, values, indices, static_cast<const float*>(sx),
         static_cast<const float*>(sw), static_cast<const float*>(bias), out,
         static_cast<int*>(part), R, M, K, splits, out_bf16, act};
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_fam) {
    case 2: return dispatch_mode<2>(xmode, packed, a, s);
    case 3: return dispatch_mode<3>(xmode, packed, a, s);
    case 4: return dispatch_mode<4>(xmode, packed, a, s);
    default: return cudaErrorInvalidValue;
  }
}
