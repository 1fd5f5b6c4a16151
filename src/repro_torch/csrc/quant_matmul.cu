// Dense quantized matmul for Hopper (sm_90a): the w8a8 / fp8 baseline GEMM
// (the paper's cuBLASLt INT8 yardstick), and the second half of the
// two-kernel slided pipeline (fused_quant_slide.cu -> this kernel over
// the gamma*K contraction).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::
// quant_matmul_pallas (_kernel).  Computes
//
//   y[R, M] = act((q_x[R, K] @ q_w[M, K]^T) * s_x * s_w + bias)
//
// q_x and q_w int8 or e4m3 (int32-exact sums when both are int8, fp32
// with any e4m3 operand); s_x [R, 1], s_w [M, 1] fp32.
//
// What bounds it on the H100: at decode the weight stream (1 byte per
// weight against 3.35 TB/s) plus a fixed latency per call (launch, two
// DRAM round trips) that outweighs the stream on the narrow shapes; at
// prefill the same stream up to a few hundred rows, then the int8 tensor
// cores (1979 TOP/s).  Three instances, chosen by the launcher:
//
// - decode, R <= DECODE_MAX_R: one warp per weight row, eight rows per
//   block.  The block copies its rows' share of the contraction into
//   shared memory once (cp.async) while each lane's first weight loads
//   are in flight; each lane then streams 16-byte pieces of its warp's
//   weight row, DEC_UNROLL loads issued together a round, with no barrier
//   in the loop: __dp4a for int8 x int8, fp32 FMAs with any e4m3 operand.
//   A split (grid.z) only where x would not fit shared memory or SMs
//   would idle over a long row; reduce_kernel then sums the partials in
//   split order.
// - prefill, int8 x int8: wgmma.mma_async m64n128k32 s8 on 128 x 128
//   output tiles, both operands K-major as they lie in memory, fed by TMA
//   (tensor maps from cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so no -lcuda) into a 3- or 4-stage ring of
//   128-byte-swizzled tiles guarded by mbarriers: one producer warp, two
//   consumer warpgroups of 64 rows each.  Splits of the contraction form
//   a thread block cluster and sum through distributed shared memory.
// - prefill with an e4m3 operand: no tensor-core instruction multiplies
//   e4m3 by s8, but both are exact in f16, so a cp.async ring brings the
//   bytes and mma.sync.m16n8k16 f16 -> f32 runs on fragments converted in
//   registers (exact products, fp32 sums); reduce_kernel sums its splits.
//
// The split counts are kernels/quant_matmul.py::splits_for's; partials
// are summed in split order without atomics, so int8 stays exact and a
// result is bit-identical launch to launch.  The epilogue runs in the JAX
// order (epilogue.cuh): acc -> f32, * s_x, * s_w, + bias, activation,
// cast.
#include "epilogue.cuh"

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its encoder's types (no driver calls)
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int DECODE_MAX_R = 16;        // R at or below: the decode instance
constexpr int DEC_WARPS = 8;            // decode: weight rows per block
constexpr int DEC_UNROLL = 4;           // decode: loads in flight per lane
constexpr int DEC_SMEM = 64 * 1024;     // decode: most bytes of x a block stages
constexpr int WG_BR = 128;              // wgmma: activation rows per block
constexpr int WG_BN = 128;              // wgmma: weight rows per block
constexpr int WG_BK = 128;              // wgmma: contraction bytes per stage
constexpr int WG_TILE = WG_BR * WG_BK;  // bytes of one operand tile (both)
constexpr int WG_THREADS = 288;         // two consumer warpgroups + a producer warp
constexpr int WG_LD = WG_BN + 8;        // int32 row stride of the staged tile
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int HM_BR = 128;              // f16 mma: activation rows per block
constexpr int HM_BN = 64;               // f16 mma: weight rows per block
constexpr int HM_BK = 64;               // f16 mma: contraction bytes per stage
constexpr int HM_LD = HM_BK + 16;       // f16 mma: tile row stride
constexpr int HM_ST = 3;                // f16 mma: ring stages
constexpr int HM_THREADS = 256;         // f16 mma: eight warps, 16 x rows each

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float acc_to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_f(float v) { return v; }

// the output (r, m) of a sum: its epilogue, or with split-K the partial
// (``part`` points at this split's [R, M] slice)
template <typename AT>
__device__ __forceinline__ void emit(AT acc, AT* part, const float* sx,
                                     const float* sw, const float* bias,
                                     int r, int m, int M, int act, void* out,
                                     int out_bf16) {
  const size_t off = static_cast<size_t>(r) * M + m;
  if (part != nullptr)
    part[off] = acc;
  else
    epi::store(acc_to_f(acc), sx[r], sw[m], bias, m, act, out, off, out_bf16);
}

// the outputs (r, m) and (r, m + 1), m even: one paired store where both
// exist and M is even (so the pair is aligned), else one by one
template <typename AT>
__device__ __forceinline__ void emit2(AT a0, AT a1, AT* part,
                                      const float* sx, const float* sw,
                                      const float* bias, int r, int m, int M,
                                      int act, void* out, int out_bf16) {
  if (m + 1 < M && M % 2 == 0) {
    const size_t off = static_cast<size_t>(r) * M + m;
    if (part == nullptr) {
      epi::store2(acc_to_f(a0), acc_to_f(a1), sx[r], sw[m], sw[m + 1], bias,
                  m, act, out, off, out_bf16);
    } else if constexpr (std::is_same_v<AT, int>) {
      *reinterpret_cast<int2*>(part + off) = make_int2(a0, a1);
    } else {
      *reinterpret_cast<float2*>(part + off) = make_float2(a0, a1);
    }
    return;
  }
  if (m < M) emit(a0, part, sx, sw, bias, r, m, M, act, out, out_bf16);
  if (m + 1 < M) emit(a1, part, sx, sw, bias, r, m + 1, M, act, out, out_bf16);
}

// 16 bytes at src to shared dst, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ----------------------------------------------------- decode instance
// the 16 bytes of a row from column kc, 0 at and past ``limit``; ``vec``:
// the row is 16-byte aligned and limit a multiple of 16
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                        int kc, int limit, bool vec) {
  if (vec) {
    if (kc < limit) return __ldg(reinterpret_cast<const uint4*>(row + kc));
    return make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (kc + e < limit) w[e / 4] |= static_cast<uint32_t>(row[kc + e]) << (8 * (e % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (M / DEC_WARPS, 1, splits): warp w of block (b, z) sums weight row
// b * DEC_WARPS + w against the RB activation rows over the split's
// columns [z * share, (z + 1) * share).  Blocks an SM as registers allow
// without spills (the 16-row fp32 instances keep 16 products of 16 rows
// in flight).
template <int RB, bool XF8, bool WF8>
__global__ void __launch_bounds__(
    32 * DEC_WARPS,
    !XF8 && !WF8 ? (RB == 4 ? 4 : RB == 8 ? 3 : 2) : (RB == 16 ? 1 : 2))
    decode_kernel(
    const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out,
    void* __restrict__ part, int R, int M, int K, int share, int vec,
    int out_bf16, int act) {
  constexpr bool INT = !XF8 && !WF8;
  // the fp32 path's work a piece is 16x larger: fewer pieces a round
  constexpr int U = INT ? DEC_UNROLL : RB == 16 ? 1 : DEC_UNROLL / 2;
  using AT = std::conditional_t<INT, int, float>;
  extern __shared__ __align__(16) uint8_t xs[];  // [RB][share]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = blockIdx.x * DEC_WARPS + warp;
  const int k0 = blockIdx.z * share, k1 = min(K, k0 + share);
  const int np = (max(0, k1 - k0) + 15) / 16;  // 16-byte pieces of the split
  // warps past M stream a real row and store nothing
  const uint8_t* wrow = w + static_cast<size_t>(min(m, M - 1)) * K;
  const bool vv = vec != 0;

  // round 0's weight pieces are in flight while x is staged
  uint4 wv[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    wv[u] = load16(wrow, k0 + 16 * (lane + 32 * u), k1, vv);
  for (int i = tid; i < RB * np; i += 32 * DEC_WARPS) {
    const int rr = i / np, c = 16 * (i % np);
    uint8_t* dst = xs + rr * share + c;
    const uint8_t* src = x + static_cast<size_t>(min(rr, R - 1)) * K + k0 + c;
    if (vv)
      cp_async16(dst, src, rr < R);
    else
      *reinterpret_cast<uint4*>(dst) =
          rr < R ? load16(src - c - k0, k0 + c, k1, false)
                 : make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  AT acc[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) acc[j] = AT(0);
  // U pieces a lane per round, their loads issued together; the other
  // warps of the SM cover a round's latency
  for (int base = 0; base < np; base += 32 * U) {
    if (base > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        wv[u] = load16(wrow, k0 + 16 * (base + lane + 32 * u), k1, vv);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + lane + 32 * u;
      if (p >= np) continue;
      if constexpr (INT) {
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const uint4 xv =
              *reinterpret_cast<const uint4*>(xs + j * share + 16 * p);
          acc[j] = __dp4a(static_cast<int>(xv.x), static_cast<int>(wv[u].x),
                          acc[j]);
          acc[j] = __dp4a(static_cast<int>(xv.y), static_cast<int>(wv[u].y),
                          acc[j]);
          acc[j] = __dp4a(static_cast<int>(xv.z), static_cast<int>(wv[u].z),
                          acc[j]);
          acc[j] = __dp4a(static_cast<int>(xv.w), static_cast<int>(wv[u].w),
                          acc[j]);
        }
      } else {
        const uint32_t* ww = reinterpret_cast<const uint32_t*>(&wv[u]);
        float wf[16];
#pragma unroll
        for (int q = 0; q < 16; ++q)
          wf[q] = epi::byte_to_f<WF8>((ww[q / 4] >> (8 * (q % 4))) & 0xffu);
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const uint4 xv =
              *reinterpret_cast<const uint4*>(xs + j * share + 16 * p);
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
#pragma unroll
          for (int q = 0; q < 16; ++q)
            acc[j] = fmaf(
                epi::byte_to_f<XF8>((xw[q / 4] >> (8 * (q % 4))) & 0xffu),
                wf[q], acc[j]);
        }
      }
    }
  }

  // sum the lanes; lane j emits activation row j
  AT* pz = part != nullptr ? static_cast<AT*>(part) +
                                 static_cast<size_t>(blockIdx.z) * R * M
                           : nullptr;
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    AT v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == j && j < R && m < M)
      emit(v, pz, sx, sw, bias, j, m, M, act, out, out_bf16);
  }
}

// ---------------------------------------------- prefill instance, int8
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait for the phase of ``parity`` to complete (try_wait may suspend the
// thread until it does)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// the box of ``map`` at (column c0, row c1) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled as TMA wrote it: 8-row atoms 1024 bytes apart (SBO), the
// leading offset unused for this layout (1)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// d[64 x 128] += a[64 x 32] * b[128 x 32]^T, s8 x s8 -> s32, both from
// shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// grid (M / WG_BN, R / WG_BR, splits), clusters of the ``splits`` blocks
// of one output tile.  Warps 0-7 are two consumer warpgroups (activation
// rows [64 g, 64 g + 64) of the tile each), warp 8 the producer: one
// thread keeps ST stages of TMA loads in flight.  Stage j of a split lands
// in slot j % ST; its full barrier completes once per fill (parity
// (j / ST) & 1), its empty barrier once the 8 consumer warps are done
// with it (one arrival each).  A consumer keeps one stage's wgmma group in
// flight while it issues the next.  ST = 3 fits two blocks on an SM, so
// one block's prologue and epilogue overlap the other's main loop.
//
// The epilogue stages the tile's int32 sums in shared memory (the ring is
// free by then).  With split-K, rank z of the cluster then takes a slice
// of the tile's rows and sums every rank's partials, read through
// distributed shared memory in rank order (exact, and the same every
// launch), before the dequant epilogue: no second kernel and no partials
// in device memory.  Stores go out coalesced, two outputs a thread.
template <int ST>
__global__ void __launch_bounds__(WG_THREADS, ST == 3 ? 2 : 1) wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int R, int M, int K, int share, int out_bf16,
    int act) {
  static_assert(WG_BR * WG_LD * 4 <= 2 * ST * WG_TILE, "tile fits the ring");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;                  // [ST][WG_BR][WG_BK]
  uint8_t* sb = smem + ST * WG_TILE;   // [ST][WG_BN][WG_BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ST * WG_TILE);
  uint64_t* empty = full + ST;
  int* tile = reinterpret_cast<int*>(smem);  // [WG_BR][WG_LD], after the loop
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.z * share, k1 = min(K, k0 + share);
  const int nst = (max(0, k1 - k0) + WG_BK - 1) / WG_BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int j = 0; j < nst; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * WG_TILE);
        const int kc = k0 + j * WG_BK;
        tma_load(sa + s * WG_TILE, &tmx, kc, blockIdx.y * WG_BR, &full[s]);
        tma_load(sb + s * WG_TILE, &tmw, kc, blockIdx.x * WG_BN, &full[s]);
      }
    }
  } else {  // consumers
    const int wg = warp >> 2;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int j = 0; j < nst; ++j) {
      const int s = j % ST;
      mbar_wait(&full[s], (j / ST) & 1);
      const uint64_t da = sw128_desc(sa + s * WG_TILE + wg * 64 * WG_BK);
      const uint64_t db = sw128_desc(sb + s * WG_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)  // 32 bytes: +2 in the address
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // stage j - 1's group is done: free its slot
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % ST]);
    }
    wgmma_wait<0>();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every wgmma has read
    // accumulator 4 i + e of thread (warp w of the group, lane): row
    // 16 w + lane / 4 (+ 8 for e >= 2), column 8 i + 2 (lane % 4) (+ 1 for
    // odd e)
    const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (rl + 8 * h) * WG_LD + 8 * i +
                                 2 * (lane & 3)) =
            make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  cluster.sync();  // every rank's tile is staged

  const int splits = static_cast<int>(cluster.num_blocks());
  const int rps = (WG_BR + splits - 1) / splits;  // rows of each rank's slice
  const int row0 = static_cast<int>(cluster.block_rank()) * rps;
  const int r0 = blockIdx.y * WG_BR, m0 = blockIdx.x * WG_BN;
#pragma unroll 1
  for (int p = tid; p < rps * (WG_BN / 2); p += WG_THREADS) {
    const int row = row0 + p / (WG_BN / 2), c = 2 * (p % (WG_BN / 2));
    if (row >= WG_BR || r0 + row >= R) break;  // rows ascend with p
    const int off = row * WG_LD + c;
    int2 v = *reinterpret_cast<const int2*>(cluster.map_shared_rank(tile, 0) + off);
    for (int q = 1; q < splits; ++q) {
      const int2 u =
          *reinterpret_cast<const int2*>(cluster.map_shared_rank(tile, q) + off);
      v.x += u.x;
      v.y += u.y;
    }
    emit2(v.x, v.y, static_cast<int*>(nullptr), sx, sw, bias, r0 + row, m0 + c,
          M, act, out, out_bf16);
  }
  cluster.sync();  // no rank exits while another reads its tile
}

// -------------------------------------- prefill instance, e4m3 operands
// two neighbouring bytes (int8 or e4m3; the first in the low 8 bits of
// v) as an f16 pair, the first in the low half: exact for both.  An int8
// b becomes the f16 1024 + (b + 128) by placing b ^ 0x80 under the
// exponent of 1024, then 1152 is subtracted.
template <bool F8>
__device__ __forceinline__ uint32_t pair_f16(uint32_t v) {
  if constexpr (F8) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(v & 0xffffu), __NV_E4M3);
    return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
  } else {
    const uint32_t t = __byte_perm(v, 0x64646464u, 0x5140) ^ 0x00800080u;
    const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&t),
                              __half2half2(__ushort_as_half(0x6480)));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}
template <bool F8>
__device__ __forceinline__ uint32_t pair_f16(const uint8_t* p) {
  return pair_f16<F8>(*reinterpret_cast<const uint16_t*>(p));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (M / HM_BN, R / HM_BR, splits); warp w: activation rows
// [16 w, 16 w + 16) of the tile x its 64 weight rows.  Every warp reads
// every weight row, so each stage's weight tile is converted to f16 once,
// into shared memory, and each warp converts only its own activation
// rows.  K % 16 == 0 and 16-byte aligned rows (the wrapper pads
// otherwise).
template <bool XF8, bool WF8>
__global__ void __launch_bounds__(HM_THREADS) hmma_kernel(
    const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, void* __restrict__ out,
    float* __restrict__ part, int R, int M, int K, int share, int out_bf16,
    int act) {
  constexpr int XT = HM_BR * HM_LD, SLOT = (HM_BR + HM_BN) * HM_LD;
  constexpr int PIECES = HM_BK / 16;
  constexpr int WLD = HM_BK + 8;  // f16 weight tile row stride: rows miss banks
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) __half wh[HM_BN][WLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * HM_BN, r0 = blockIdx.y * HM_BR;
  const int k0 = blockIdx.z * share, k1 = min(K, k0 + share);
  const int nst = (max(0, k1 - k0) + HM_BK - 1) / HM_BK;

  auto issue = [&](int j) {
    uint8_t* base = smem + (j % HM_ST) * SLOT;
    const int kc = k0 + j * HM_BK;
    for (int i = tid; i < (HM_BR + HM_BN) * PIECES; i += HM_THREADS) {
      const int row = i / PIECES, c = 16 * (i % PIECES);
      const bool isx = row < HM_BR;
      const int rr = isx ? r0 + row : m0 + row - HM_BR;
      const int lim = isx ? R : M;
      const bool valid = rr < lim && kc + c < k1;
      const uint8_t* src = (isx ? x : w) +
                           static_cast<size_t>(min(rr, lim - 1)) * K +
                           (valid ? kc + c : 0);
      cp_async16(base + row * HM_LD + c, src, valid);
    }
  };

#pragma unroll
  for (int j = 0; j < HM_ST - 1; ++j) {
    if (j < nst) issue(j);
    cp_async_commit();
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int c = 0; c < nst; ++c) {
    cp_async_wait<HM_ST - 2>();
    __syncthreads();  // stage c landed; every warp is done with c - 1
    if (c + HM_ST - 1 < nst) issue(c + HM_ST - 1);
    cp_async_commit();
    const uint8_t* xt = smem + (c % HM_ST) * SLOT;
    {  // the weight tile to f16: 16 bytes a thread
      static_assert(HM_BN * HM_BK == 16 * HM_THREADS, "one piece a thread");
      const int row = tid / PIECES, c16 = 16 * (tid % PIECES);
      const uint4 v =
          *reinterpret_cast<const uint4*>(xt + XT + row * HM_LD + c16);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = pair_f16<WF8>(in[i]);
        o[2 * i + 1] = pair_f16<WF8>(in[i] >> 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(&wh[row][c16]);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < HM_BK / 16; ++ks) {
      const uint8_t* xa = xt + (warp * 16 + g) * HM_LD + ks * 16 + 2 * t;
      const uint32_t a[4] = {pair_f16<XF8>(xa), pair_f16<XF8>(xa + 8 * HM_LD),
                             pair_f16<XF8>(xa + 8),
                             pair_f16<XF8>(xa + 8 * HM_LD + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __half* wb = &wh[n * 8 + g][ks * 16 + 2 * t];
        mma_f16(acc[n], a, *reinterpret_cast<const uint32_t*>(wb),
                *reinterpret_cast<const uint32_t*>(wb + 8));
      }
    }
  }
  cp_async_wait<0>();

  float* pz = part != nullptr ? part + static_cast<size_t>(blockIdx.z) * R * M
                              : nullptr;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 16 + g + 8 * h;
      if (r < R)
        emit2(acc[n][2 * h], acc[n][2 * h + 1], pz, sx, sw, bias, r,
              m0 + n * 8 + 2 * t, M, act, out, out_bf16);
    }
}

// sum the split-K partials in split order (int32 exact; fp32 in a fixed
// order), then the epilogue
template <typename AT>
__global__ void __launch_bounds__(256) reduce_kernel(
    const AT* __restrict__ part, int splits, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    void* __restrict__ out, int R, int M, int out_bf16, int act) {
  const size_t total = static_cast<size_t>(R) * M;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    AT s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * total + i];
    const int r = static_cast<int>(i / M), m = static_cast<int>(i % M);
    epi::store(acc_to_f(s), sx[r], sw[m], bias, m, act, out, i, out_bf16);
  }
}

// ---------------------------------------------------------------- launch
struct Args {
  const uint8_t* x;
  const uint8_t* w;
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  void* part;
  int R, M, K, splits, share, stages, out_bf16, act;
};

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// dynamic shared memory above 48 KB needs the opt-in, set once per
// kernel (on its first launch, for the most it has been asked for)
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

template <typename AT>
cudaError_t reduce_splits(const Args& a, cudaStream_t st) {
  const long long total = static_cast<long long>(a.R) * a.M;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  reduce_kernel<AT><<<blocks, 256, 0, st>>>(
      static_cast<const AT*>(a.part), a.splits, a.sx, a.sw, a.bias, a.out,
      a.R, a.M, a.out_bf16, a.act);
  return cudaGetLastError();
}

template <int RB, bool XF8, bool WF8>
cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  const int smem = RB * a.share;
  if (a.share % 16 || smem > DEC_SMEM) return cudaErrorInvalidValue;
  static int configured = 0;
  auto kern = decode_kernel<RB, XF8, WF8>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int vec = a.K % 16 == 0 && aligned(a.x, 16) && aligned(a.w, 16);
  const dim3 grid((a.M + DEC_WARPS - 1) / DEC_WARPS, 1, a.splits);
  kern<<<grid, 32 * DEC_WARPS, smem, st>>>(
      a.x, a.w, a.sx, a.sw, a.bias, a.out, a.splits > 1 ? a.part : nullptr,
      a.R, a.M, a.K, a.share, vec, a.out_bf16, a.act);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime's entry-point query (the library is built without -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, K] byte matrix read in boxes of 128 rows x WG_BK bytes,
// 128-byte swizzled; rows and columns past the matrix read as 0
bool tile_map(CUtensorMap* map, const void* base, int rows, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {WG_BK, WG_BR};
  const cuuint32_t estr[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                   const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ST>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  if (a.K % 16 || !aligned(a.x, 16) || !aligned(a.w, 16) ||
      a.share % WG_BK || a.splits > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tmx, tmw;
  if (!tile_map(&tmx, a.x, a.R, a.K) || !tile_map(&tmw, a.w, a.M, a.K))
    return cudaErrorInvalidValue;
  const int smem = 2 * ST * WG_TILE + 2 * ST * 8 + 1024;
  static int configured = 0;
  const cudaError_t e = set_smem(wgmma_kernel<ST>, smem, configured);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.M + WG_BN - 1) / WG_BN, (a.R + WG_BR - 1) / WG_BR,
                     a.splits);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wgmma_kernel<ST>, tmx, tmw, a.sx, a.sw,
                            a.bias, a.out, a.R, a.M, a.K, a.share,
                            a.out_bf16, a.act);
}

template <bool XF8, bool WF8>
cudaError_t launch_hmma(const Args& a, cudaStream_t st) {
  if (a.K % 16 || !aligned(a.x, 16) || !aligned(a.w, 16) || a.share % HM_BK)
    return cudaErrorInvalidValue;
  const int smem = HM_ST * (HM_BR + HM_BN) * HM_LD;
  static int configured = 0;
  auto kern = hmma_kernel<XF8, WF8>;
  cudaError_t e = set_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.M + HM_BN - 1) / HM_BN, (a.R + HM_BR - 1) / HM_BR,
                  a.splits);
  kern<<<grid, HM_THREADS, smem, st>>>(
      a.x, a.w, a.sx, a.sw, a.bias, a.out,
      a.splits > 1 ? static_cast<float*>(a.part) : nullptr, a.R, a.M, a.K,
      a.share, a.out_bf16, a.act);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  return reduce_splits<float>(a, st);
}

template <bool XF8, bool WF8>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using AT = std::conditional_t<!XF8 && !WF8, int, float>;
  cudaError_t e;
  if (a.R > DECODE_MAX_R) {
    if constexpr (!XF8 && !WF8)
      return a.stages == 3 ? launch_wgmma<3>(a, st) : launch_wgmma<4>(a, st);
    else return launch_hmma<XF8, WF8>(a, st);
  }
  if (a.R <= 4)
    e = launch_decode<4, XF8, WF8>(a, st);
  else if (a.R <= 8)
    e = launch_decode<8, XF8, WF8>(a, st);
  else
    e = launch_decode<16, XF8, WF8>(a, st);
  if (e != cudaSuccess || a.splits == 1) return e;
  return reduce_splits<AT>(a, st);
}

}  // namespace

// C entry point (bound with ctypes).  qx: [R, K] bytes (int8, or e4m3 when
// x_fp8); sx: [R] fp32; qw: [M, K] bytes (e4m3 when w_fp8); sw: [M] fp32;
// bias: [M] fp32 or null; out: [R, M] bf16 (out_bf16) or f32.  The
// contraction splits into ``splits`` shares of ``share`` bytes; when
// splits > 1, ``part`` is scratch [splits, R, M] of int32 (int8 x int8)
// or fp32 (the int8 prefill instance reduces its splits in a cluster and
// takes none).  ``stages`` (3 or 4): the int8 prefill instance's ring
// depth.  Returns the cudaError_t of the launches (0 on success).
extern "C" int quant_matmul_launch(const void* qx, const void* sx,
                                   const void* qw, const void* sw,
                                   const void* bias, void* out, void* part,
                                   int R, int M, int K, int x_fp8, int w_fp8,
                                   int out_bf16, int act, int splits,
                                   int share, int stages, void* stream) {
  // the int8 prefill instance sums its splits in a cluster, the others
  // through ``part``
  const bool in_cluster = R > DECODE_MAX_R && !x_fp8 && !w_fp8;
  if (R <= 0 || M <= 0 || K <= 0 || splits < 1 || share <= 0 ||
      static_cast<long long>(splits - 1) * share >= K ||
      static_cast<long long>(splits) * share < K ||
      (splits > 1 && part == nullptr && !in_cluster) ||
      (stages != 3 && stages != 4))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(qx), static_cast<const uint8_t*>(qw),
               static_cast<const float*>(sx), static_cast<const float*>(sw),
               static_cast<const float*>(bias), out, part, R, M, K, splits,
               share, stages, out_bf16, act};
  auto s = static_cast<cudaStream_t>(stream);
  switch ((x_fp8 ? 2 : 0) + (w_fp8 ? 1 : 0)) {
    case 0: return launch<false, false>(a, s);
    case 1: return launch<false, true>(a, s);
    case 2: return launch<true, false>(a, s);
    default: return launch<true, true>(a, s);
  }
}
