// Fused per-token quantization + activation lifting for Hopper (sm_90a):
// paper Algorithm 1, one read of x and one write of the lifted rows.
//
// Replaces the TPU kernel repro/kernels/fused_quant_slide.py::
// fused_quant_slide_pallas (_kernel).  Computes
//
//   q[R, gamma*K] = Psi(quantize(x)),  scale[R, 1]
//
// x [R, K] bf16/f32; q int8 or e4m3.  The quantizer is quant_lift.cuh's
// row_quant/quant1, the code the fused slided matmul (B3) runs in its
// prologue, so this kernel followed by quant_matmul.cu gives B3's result
// bit for bit (int8).
//
// What bounds it on the H100: bytes (R*K*2 in, R*gamma*K + 4R out against
// 3.35 TB/s) at many rows; at decode (a few rows of a few KB) the latency
// of one launch, one load and one store, which no byte count reaches.
// The design spreads a row over the card and touches each byte once:
//
// - A row is split over a thread block cluster of up to 8 blocks (the
//   portable cluster size; the wrapper's launch_plan picks it: enough
//   blocks for the 132 SMs when rows are few, one block per row, or as
//   many as the row needs, when they are many).  Each thread owns one
//   unit of whole source groups of 2N columns, U groups whose lifted
//   bytes U * 4(N-1) are a multiple of 16 (N = 4: 4 groups, 32 columns
//   in, 48 bytes out), and loads it once with 16-byte loads (8-byte for
//   N = 3 in bf16) into registers.
// - Each block takes its span's max|x| (shuffles, then shared memory);
//   the cluster takes the row's max through distributed shared memory
//   (cluster.sync, map_shared_rank).  A max is order-free, so the scale
//   is bit-equal to the plain version's.  Block 0 writes the scale.
// - Each thread then quantizes each value of its unit once (quant_pair)
//   and builds the N - 1 lifted words of each group from neighbouring
//   pairs (lifted_word), then writes the unit's lifted bytes with 16-byte
//   stores.  x is read from device memory once.
#include "quant_lift.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using quant_lift::RowQuant;

constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int MAX_THREADS = 512;  // threads (units) per block

// A thread's unit: U whole source groups of 2N columns, whose U * 4(N-1)
// lifted bytes are a multiple of 16.
template <int N> struct Unit {
  static constexpr int U = N == 3 ? 2 : 4;
  static constexpr int S = U * 2 * N;    // source columns
  static constexpr int W = U * (N - 1);  // lifted words
};

// the bytes of a unit's loads: 16, or 8 where the unit's bytes are not a
// multiple of 16 (N = 3 in bf16)
template <int S, typename T> __host__ __device__ constexpr int load_bytes() {
  return (S * static_cast<int>(sizeof(T))) % 16 == 0 ? 16 : 8;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// source columns [c0, c0 + S) of a row as fp32, 0 at and past ``valid``;
// ``vec``: the row admits load_bytes()-byte loads at unit boundaries
template <int S, typename T>
__device__ __forceinline__ void load_unit(const T* __restrict__ row, int c0,
                                          int valid, bool vec, float (&v)[S]) {
  constexpr int LB = load_bytes<S, T>();
  constexpr int PER = LB / static_cast<int>(sizeof(T));  // elements a load
  if (vec && c0 + S <= valid) {
#pragma unroll
    for (int i = 0; i < S / PER; ++i) {
      uint32_t w[LB / 4];
      if constexpr (LB == 16) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + c0) + i);
        w[0] = t.x;
        w[1] = t.y;
        w[2] = t.z;
        w[3] = t.w;
      } else {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(row + c0) + i);
        w[0] = t.x;
        w[1] = t.y;
      }
#pragma unroll
      for (int e = 0; e < LB / 4; ++e) {
        if constexpr (sizeof(T) == 2) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          v[i * PER + 2 * e] = f.x;
          v[i * PER + 2 * e + 1] = f.y;
        } else {
          v[i * PER + e] = __uint_as_float(w[e]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i)
      v[i] = c0 + i < valid ? to_f(row[c0 + i]) : 0.f;
  }
}

// grid (cluster, R), cluster (cluster, 1, 1): block b of row r's cluster
// owns units [b * upb, (b + 1) * upb), thread t unit b * upb + t
template <int N, bool FP8, typename T>
__global__ void __launch_bounds__(MAX_THREADS) quant_slide_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ q,
    float* __restrict__ scale, int K, int upb, int xvec, int qvec) {
  using Un = Unit<N>;
  __shared__ float wmax[MAX_THREADS / 32];
  __shared__ float bmax, rmax;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.y;
  const int u = static_cast<int>(cluster.block_rank()) * upb + tid;
  const int c0 = u * Un::S;
  const bool mine = tid < upb && c0 < K;
  const T* row = x + static_cast<size_t>(r) * K;

  float v[Un::S];
  float a = 0.f;
  if (mine) {
    load_unit<Un::S>(row, c0, K, xvec != 0, v);
#pragma unroll
    for (int i = 0; i < Un::S; ++i) a = fmaxf(a, fabsf(v[i]));
  }
  a = quant_lift::warp_max(a);
  if (lane == 0) wmax[warp] = a;
  __syncthreads();
  if (tid == 0) {
    float m = wmax[0];
    for (int i = 1; i < static_cast<int>(blockDim.x) / 32; ++i)
      m = fmaxf(m, wmax[i]);
    bmax = m;
  }
  cluster.sync();  // every block's span max written and visible
  if (warp == 0) {
    float m = lane < static_cast<int>(cluster.num_blocks())
                  ? *cluster.map_shared_rank(&bmax, lane)
                  : 0.f;
    m = quant_lift::warp_max(m);
    if (lane == 0) rmax = m;
  }
  __syncthreads();
  // this block is done reading the others' span maxima; a block waits for
  // the cluster's arrivals only when it exits, so no block's shared
  // memory goes while another may read it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const RowQuant rq = quant_lift::row_quant<FP8>(rmax);
  if (tid == 0 && cluster.block_rank() == 0) scale[r] = rq.scale;

  if (mine) {
    uint32_t w[Un::W];
#pragma unroll
    for (int g = 0; g < Un::U; ++g) {
      uint32_t qp[N];
#pragma unroll
      for (int p = 0; p < N; ++p)
        qp[p] = quant_lift::quant_pair<FP8>(
            make_float2(v[2 * N * g + 2 * p], v[2 * N * g + 2 * p + 1]), rq);
#pragma unroll
      for (int j = 0; j < N - 1; ++j)
        w[g * (N - 1) + j] = quant_lift::lifted_word(qp[j], qp[j + 1]);
    }
    const int kc = K / (2 * N) * (N - 1) * 4;
    uint32_t* out = reinterpret_cast<uint32_t*>(
        q + static_cast<size_t>(r) * kc + static_cast<size_t>(u) * Un::W * 4);
    if (qvec && c0 + Un::S <= K) {
#pragma unroll
      for (int i = 0; i < Un::W / 4; ++i)
        reinterpret_cast<uint4*>(out)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else {
      const int words = min(K - c0, Un::S) / (2 * N) * (N - 1);
#pragma unroll
      for (int i = 0; i < Un::W; ++i)
        if (i < words) out[i] = w[i];
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <int N, bool FP8, typename T>
cudaError_t launch(const void* x, uint8_t* q, float* scale, int R, int K,
                   int cluster, int upb, cudaStream_t s) {
  using Un = Unit<N>;
  const int threads = (upb + 31) / 32 * 32;
  const int units = (K + Un::S - 1) / Un::S;
  if (cluster < 1 || cluster > MAX_CLUSTER || upb < 1 ||
      threads > MAX_THREADS || cluster * upb < units || R > 65535)
    return cudaErrorInvalidValue;
  constexpr int LB = load_bytes<Un::S, T>();
  const int kc = K / (2 * N) * (N - 1) * 4;
  const int xvec = (static_cast<size_t>(K) * sizeof(T)) % LB == 0 &&
                   aligned(x, LB);
  const int qvec = kc % 16 == 0 && aligned(q, 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, R, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quant_slide_kernel<N, FP8, T>,
                            static_cast<const T*>(x), q, scale, K, upb, xvec,
                            qvec);
}

template <int N>
cudaError_t dispatch(const void* x, int x_bf16, uint8_t* q, float* scale,
                     int R, int K, int fp8, int cluster, int upb,
                     cudaStream_t s) {
  switch (fp8 * 2 + (x_bf16 ? 1 : 0)) {
    case 0: return launch<N, false, float>(x, q, scale, R, K, cluster, upb, s);
    case 1:
      return launch<N, false, __nv_bfloat16>(x, q, scale, R, K, cluster, upb,
                                             s);
    case 2: return launch<N, true, float>(x, q, scale, R, K, cluster, upb, s);
    default:
      return launch<N, true, __nv_bfloat16>(x, q, scale, R, K, cluster, upb,
                                            s);
  }
}

__global__ void noop_kernel() {}

}  // namespace

// C entry point (bound with ctypes).  x: [R, K] bf16 (x_bf16) or f32;
// q: [R, gamma*K] bytes (int8, or e4m3 when fp8); scale: [R] fp32.
// ``cluster`` blocks per row, ``upb`` units per block
// (kernels/fused_quant_slide.py::launch_plan).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fused_quant_slide_launch(const void* x, int x_bf16, void* q,
                                        void* scale, int R, int K, int n_fam,
                                        int fp8, int cluster, int upb,
                                        void* stream) {
  if (R <= 0 || K <= 0 || n_fam < 2 || n_fam > 4 || K % (2 * n_fam))
    return cudaErrorInvalidValue;
  auto* qb = static_cast<uint8_t*>(q);
  auto* fs = static_cast<float*>(scale);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (n_fam) {
    case 2: e = dispatch<2>(x, x_bf16, qb, fs, R, K, fp8, cluster, upb, s); break;
    case 3: e = dispatch<3>(x, x_bf16, qb, fs, R, K, fp8, cluster, upb, s); break;
    default: e = dispatch<4>(x, x_bf16, qb, fs, R, K, fp8, cluster, upb, s);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One block of 32 threads that does nothing: the launch floor that B4's
// decode time is read against (chip_smoke.py times it with the same
// timer).
extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
