// Hopper (sm_90a) kernel for the coefficient-gradient projection C = A^T B.
//
// It replaces the Pallas TPU kernel of the JAX package
//   atb  <- src/repro/kernels/coeff_grad.py::atb / _atb_kernel (line 22)
// and computes what that computes: C = A^T B with A (M, Ka) and B (M, Kb),
// reduced over all of M in an f32 accumulator and rounded once to the
// working type (A's). A and B are both float32 or both bfloat16.
//
// Where the port calls it (backward of lowrank_apply, kernels/ops.py):
//   dS = (x U)^T (dy V)   Ka = Kb = rank: the FeDLRT client loop's hot op
//   dU = x^T (dy V S^T)   Ka = n_in, Kb = rank (basis-gradient pass)
//   dV = dy^T (x U S)     Ka = n_out, Kb = rank (basis-gradient pass)
//
// What bounds it on an H100. The work is 2 M Ka Kb FLOPs over
// (M Ka + M Kb + Ka Kb) elements. At the training path's sizes (M = 512,
// rank 160-320) f32 dS moves ~1.7 MB for ~0.1 GFLOP: at 67 TFLOP/s f32 it
// is bound by operations (1.6 us vs 0.5 us for the bytes); in bf16 the
// tensor-core rate makes the bytes the bound. dU / dV are shaped like dS
// with one long side, so the same holds. This first kernel does scalar f32
// FMAs from shared memory (no tensor cores; wgmma/TMA are later work), so it
// is far from either bound; PERF.md has its times.
//
// The TPU grid carried its (bka, Kb) accumulator across a sequential M axis.
// On Hopper the blocks run in parallel and in no order, and the dS shapes are
// small (320 x 320 is 25 tiles of 64 x 64 for 132 SMs), so:
//   1. atb_tile: grid (Kb tiles, Ka tiles, M splits x G). Each block owns a
//      64 x 64 tile of C and one contiguous range of M. It stages 16 rows of
//      A's and B's tile columns at a time in shared memory (coalesced loads:
//      both matrices are row-major along Ka / Kb) and each of its 256 threads
//      accumulates a 4 x 4 micro-tile in registers. The M split is chosen
//      from the shapes so that the grid holds about two blocks per SM. With
//      one split the block rounds and writes C itself; otherwise it writes
//      its f32 partial tile to a workspace.
//   2. atb_reduce: one thread per element of C adds the splits' partials in
//      split order and rounds once. No atomics: the sum is the same bits on
//      every run, which the port's determinism pins rely on.
// Ragged M, Ka and Kb (ranks 160 / 320, n = 2560, vocab 152064) are masked
// in the loads and stores; no operand is padded.
//
// Entry points take a leading batch count G (stacked factors), return
// cudaGetLastError(), and launch on the caller's stream without
// synchronising. Buffers (C and the workspace) are allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int ATB_TILE = 64;              // C tile: ATB_TILE x ATB_TILE
constexpr int ATB_TPD = 16;               // threads per tile dim
constexpr int ATB_MICRO = ATB_TILE / ATB_TPD;  // 4 x 4 outputs per thread
constexpr int ATB_THREADS = ATB_TPD * ATB_TPD;  // 256
constexpr int ATB_BK = 16;                // rows of M staged per step
constexpr int ATB_MC_MIN = 64;            // rows of M per split: at least
constexpr int ATB_TARGET_BLOCKS = 264;    // two blocks per SM of an H100
constexpr int RED_THREADS = 256;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows of M per split: enough splits for ~2 blocks per SM, each split a
// multiple of ATB_BK and at least ATB_MC_MIN rows (or all of M).
int atb_mc(int G, int M, int Ka, int Kb) {
  const long long tiles = (long long)G * cdiv(Ka, ATB_TILE) * cdiv(Kb, ATB_TILE);
  const long long want = (ATB_TARGET_BLOCKS + tiles - 1) / tiles;
  int mc = cdiv(M, (int)(want < M ? want : M));
  mc = cdiv(mc, ATB_BK) * ATB_BK;
  if (mc < ATB_MC_MIN) mc = ATB_MC_MIN;
  return mc < M ? mc : M;
}

template <typename T, bool DIRECT>
__global__ void __launch_bounds__(ATB_THREADS)
atb_tile_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                float* __restrict__ work, int M, int Ka, int Kb, int mc, int nsplit) {
  __shared__ float As[ATB_BK][ATB_TILE];
  __shared__ float Bs[ATB_BK][ATB_TILE];
  const int tid = threadIdx.x;
  const int tx = tid % ATB_TPD;  // along Kb
  const int ty = tid / ATB_TPD;  // along Ka
  const int kb0 = blockIdx.x * ATB_TILE;
  const int ka0 = blockIdx.y * ATB_TILE;
  const int split = blockIdx.z % nsplit;
  const int g = blockIdx.z / nsplit;
  const int m_begin = split * mc;
  const int m_end = min(M, m_begin + mc);
  A += (size_t)g * M * Ka;
  B += (size_t)g * M * Kb;

  float acc[ATB_MICRO][ATB_MICRO];
#pragma unroll
  for (int i = 0; i < ATB_MICRO; ++i) {
#pragma unroll
    for (int j = 0; j < ATB_MICRO; ++j) acc[i][j] = 0.f;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += ATB_BK) {
    for (int i = tid; i < ATB_BK * ATB_TILE; i += ATB_THREADS) {
      const int r = i / ATB_TILE, c = i % ATB_TILE;
      const int m = m0 + r;
      const bool row = m < m_end;
      As[r][c] = (row && ka0 + c < Ka) ? to_f32(A[(size_t)m * Ka + ka0 + c]) : 0.f;
      Bs[r][c] = (row && kb0 + c < Kb) ? to_f32(B[(size_t)m * Kb + kb0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ATB_BK; ++r) {
      float a[ATB_MICRO], b[ATB_MICRO];
#pragma unroll
      for (int i = 0; i < ATB_MICRO; ++i) a[i] = As[r][ty + ATB_TPD * i];
#pragma unroll
      for (int j = 0; j < ATB_MICRO; ++j) b[j] = Bs[r][tx + ATB_TPD * j];
#pragma unroll
      for (int i = 0; i < ATB_MICRO; ++i) {
#pragma unroll
        for (int j = 0; j < ATB_MICRO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ATB_MICRO; ++i) {
    const int ka = ka0 + ty + ATB_TPD * i;
    if (ka >= Ka) continue;
#pragma unroll
    for (int j = 0; j < ATB_MICRO; ++j) {
      const int kb = kb0 + tx + ATB_TPD * j;
      if (kb >= Kb) continue;
      if (DIRECT) {
        C[((size_t)g * Ka + ka) * Kb + kb] = from_f32<T>(acc[i][j]);
      } else {
        work[(((size_t)g * nsplit + split) * Ka + ka) * Kb + kb] = acc[i][j];
      }
    }
  }
}

// C = the splits' partial tiles, added in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
atb_reduce_kernel(const float* __restrict__ work, T* __restrict__ C, int G, int Ka, int Kb,
                  int nsplit) {
  const long long e = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long long per_g = (long long)Ka * Kb;
  if (e >= (long long)G * per_g) return;
  const float* w = work + (e / per_g) * nsplit * per_g + e % per_g;
  float s = 0.f;
#pragma unroll 4
  for (int p = 0; p < nsplit; ++p) s += w[(size_t)p * per_g];
  C[e] = from_f32<T>(s);
}

template <typename T>
int launch_atb(const void* A, const void* B, void* C, void* work, int G, int M, int Ka,
               int Kb, cudaStream_t stream) {
  const int mc = atb_mc(G, M, Ka, Kb);
  const int nsplit = cdiv(M, mc);
  const long long elems = (long long)G * Ka * Kb;
  if ((long long)G * nsplit > 65535 || cdiv(Ka, ATB_TILE) > 65535 ||
      (elems + RED_THREADS - 1) / RED_THREADS > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(cdiv(Kb, ATB_TILE), cdiv(Ka, ATB_TILE), G * nsplit);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* c = static_cast<T*>(C);
  if (nsplit == 1) {
    atb_tile_kernel<T, true><<<grid, ATB_THREADS, 0, stream>>>(a, b, c, nullptr, M, Ka, Kb,
                                                               mc, 1);
  } else {
    float* w = static_cast<float*>(work);
    atb_tile_kernel<T, false><<<grid, ATB_THREADS, 0, stream>>>(a, b, c, w, M, Ka, Kb, mc,
                                                                nsplit);
    const unsigned blocks = (unsigned)((elems + RED_THREADS - 1) / RED_THREADS);
    atb_reduce_kernel<T><<<blocks, RED_THREADS, 0, stream>>>(w, c, G, Ka, Kb, nsplit);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// f32 elements of the workspace lr_atb needs for these sizes (0 when the
// M reduction fits in one split and the tile kernel writes C directly).
long long lr_atb_workspace(int G, int M, int Ka, int Kb) {
  if (G < 1 || M < 1 || Ka < 1 || Kb < 1) return 0;
  const int nsplit = cdiv(M, atb_mc(G, M, Ka, Kb));
  return nsplit > 1 ? (long long)G * nsplit * Ka * Kb : 0;
}

// C = A^T B.  A (G, M, Ka), B (G, M, Kb), C (G, Ka, Kb), all in dtype dt;
// work holds lr_atb_workspace(G, M, Ka, Kb) floats.
int lr_atb(int dt, const void* A, const void* B, void* C, void* work, int G, int M, int Ka,
           int Kb, void* stream) {
  if (G < 1 || M < 1 || Ka < 1 || Kb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return launch_atb<float>(A, B, C, work, G, M, Ka, Kb, s);
  if (dt == 1) return launch_atb<__nv_bfloat16>(A, B, C, work, G, M, Ka, Kb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
