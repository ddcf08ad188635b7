// Hopper (sm_90a) kernels for the low-rank bottleneck chain y = ((x U) S) V^T.
//
// They replace the two Pallas TPU kernels of the JAX package:
//   xus  <- src/repro/kernels/lowrank_matmul.py::xus / _xus_kernel (line 58)
//   avt  <- src/repro/kernels/lowrank_matmul.py::avt / _avt_kernel (line 103)
// and compute what those compute: x.U accumulated in f32, S applied in f32 to
// the f32 accumulator, one rounding to the working type at A; A V^T
// accumulated in f32 with one rounding at y.
//
// What bounds them on an H100. Serving decodes at M = max_batch (a handful
// of rows), so every call streams a whole factor (U: K x R, V: N x R) from
// device memory for a few FLOPs per byte: both kernels are bound by the
// bytes of U or V, never by arithmetic. The design therefore spends its
// effort on keeping the card's SMs busy reading, and does the arithmetic
// with plain f32 FMAs (no tensor cores; wgmma/TMA come in a later change).
//
// xus. The TPU kept a (bm, R) f32 accumulator and the whole (R, R) f32 S in
// VMEM and ran one sequential K loop. On this card S alone (256 KB at
// R = 256) exceeds a block's 227 KB of shared memory, and one block per M
// tile would put all of K = 18944 on a single SM at M = 4. So xus is three
// launches:
//   1. xus_partial: grid (R / 64 column tiles, K splits, M tiles x G). The
//      split count is chosen from the shapes so the grid holds about two
//      blocks per SM (32 <= K per split <= 512). Each block multiplies its
//      (<= 8 rows) x (K split) slice of x, staged in shared memory, by the
//      matching (K split, 64) slice of U read once from device memory, and
//      writes an f32 partial sum to a workspace.
//   2. xus_reduce: one thread per element of x.U adds its partials over
//      the splits in a fixed order (no atomics, so greedy decode is
//      deterministic run to run). Skipped when there is one split.
//   3. xus_epilogue: multiplies the f32 x.U rows by S, the R terms of each
//      column split over 16 threads and added back in a fixed order, and
//      rounds once to the output type.
//   (A first version summed the splits inside the epilogue: every block
//   re-read all partials with one thread walking all splits in sequence,
//   and that dependent chain of L2 loads made xus 2.5-5.5x slower than
//   the cuBLAS chain at M = 4 on the H100.)
// Ragged M, K and R are masked inside the kernels; no operand is padded.
//
// avt. One warp computes a few outputs y[m, n] for up to 8 rows m: its 32
// lanes walk the rank dimension of a row of V (coalesced), the rows of A sit
// in shared memory, and a shuffle reduction finishes each dot product. The
// grid covers N (152064 for the LM head), so the card fills even at M = 1.
//
// Every entry point takes a leading batch count G (stacked factors, one
// grid axis), returns cudaGetLastError(), and launches on the caller's
// stream without synchronising. Buffers are allocated by the caller.

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

// ---------------------------------------------------------------- xus
constexpr int XUS_COLS = 64;                       // rank columns per block
constexpr int XUS_KLANES = 4;                      // threads sharing a column
constexpr int XUS_THREADS = XUS_COLS * XUS_KLANES;  // 256
constexpr int XUS_KC_MIN = 32;                     // K per split: at least ...
constexpr int XUS_KC_MAX = 512;                    // ... and at most
constexpr int XUS_BM = 8;                          // rows of x per block
constexpr int XUS_TARGET_BLOCKS = 264;             // two blocks per SM of an H100
constexpr int EPI_COLS = 16;                       // epilogue: columns per block
constexpr int EPI_ILANES = 16;                     // epilogue: threads sharing a column
constexpr int EPI_BM = 8;                          // epilogue: rows per block
constexpr int RED_THREADS = 256;                   // reduce: threads per block
constexpr int MAX_SMEM = 48 * 1024;                // dynamic shared memory without opt-in

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// K per split: enough splits to give the card ~2 blocks per SM, each split
// a multiple of 32 between XUS_KC_MIN and XUS_KC_MAX.
int xus_kc(int G, int M, int K, int R) {
  const long long tiles = (long long)G * cdiv(M, XUS_BM) * cdiv(R, XUS_COLS);
  const long long want = (XUS_TARGET_BLOCKS + tiles - 1) / tiles;
  int kc = cdiv(K, (int)(want < K ? want : K));
  kc = cdiv(kc, 32) * 32;
  return kc < XUS_KC_MIN ? XUS_KC_MIN : (kc > XUS_KC_MAX ? XUS_KC_MAX : kc);
}

template <typename T>
__global__ void __launch_bounds__(XUS_THREADS)
xus_partial_kernel(const T* __restrict__ x, const T* __restrict__ U,
                   float* __restrict__ work, int M, int K, int R, int kc, int nsplit) {
  __shared__ float xs[XUS_BM][XUS_KC_MAX];
  __shared__ float red[XUS_KLANES - 1][XUS_BM][XUS_COLS];
  const int tid = threadIdx.x;
  const int c = tid % XUS_COLS;
  const int kl = tid / XUS_COLS;
  const int col = blockIdx.x * XUS_COLS + c;
  const int split = blockIdx.y;
  const int mtiles = cdiv(M, XUS_BM);
  const int g = blockIdx.z / mtiles;
  const int m0 = (blockIdx.z % mtiles) * XUS_BM;
  const int k0 = split * kc;
  const int kn = min(kc, K - k0);
  x += (size_t)g * M * K;
  U += (size_t)g * K * R;
  work += (size_t)g * nsplit * M * R;

  for (int i = tid; i < XUS_BM * kc; i += XUS_THREADS) {
    const int m = i / kc, k = i % kc;
    xs[m][k] = (m0 + m < M && k < kn) ? to_f32(x[(size_t)(m0 + m) * K + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[XUS_BM];
#pragma unroll
  for (int m = 0; m < XUS_BM; ++m) acc[m] = 0.f;
  if (col < R) {
#pragma unroll 8
    for (int k = kl; k < kn; k += XUS_KLANES) {
      const float u = to_f32(U[(size_t)(k0 + k) * R + col]);
#pragma unroll
      for (int m = 0; m < XUS_BM; ++m) acc[m] = fmaf(xs[m][k], u, acc[m]);
    }
  }
  if (kl > 0) {
#pragma unroll
    for (int m = 0; m < XUS_BM; ++m) red[kl - 1][m][c] = acc[m];
  }
  __syncthreads();
  if (kl == 0 && col < R) {
#pragma unroll
    for (int m = 0; m < XUS_BM; ++m) {
      float s = acc[m];
#pragma unroll
      for (int j = 0; j < XUS_KLANES - 1; ++j) s += red[j][m][c];
      if (m0 + m < M) work[((size_t)split * M + m0 + m) * R + col] = s;
    }
  }
}

// x.U = the splits' partial sums, added in split order (no atomics: the
// sum is the same bits on every run), written over split 0 of the
// workspace. One thread per element of x.U, so the whole card takes part.
__global__ void __launch_bounds__(RED_THREADS)
xus_reduce_kernel(float* __restrict__ work, int G, int M, int R, int nsplit) {
  const long long e = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long long per_g = (long long)M * R;
  if (e >= (long long)G * per_g) return;
  float* w = work + (e / per_g) * nsplit * per_g + e % per_g;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < nsplit; ++p) s += w[(size_t)p * per_g];
  w[0] = s;
}

// A = (x.U) S for this block's columns and rows. The R terms of each
// column are split over EPI_ILANES threads and added back in a fixed order.
template <typename T, typename TS>
__global__ void __launch_bounds__(EPI_COLS * EPI_ILANES)
xus_epilogue_kernel(const float* __restrict__ work, const TS* __restrict__ S,
                    T* __restrict__ out, int M, int R, int nsplit) {
  extern __shared__ float acc[];  // [EPI_BM][R]: the f32 x.U rows of this block
  __shared__ float red[EPI_ILANES - 1][EPI_BM][EPI_COLS];
  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * EPI_BM;
  const int rows = min(EPI_BM, M - m0);
  work += (size_t)g * nsplit * M * R;  // split 0 holds x.U after the reduce
  S += (size_t)g * R * R;
  out += (size_t)g * M * R;

  for (int i = tid; i < EPI_BM * R; i += EPI_COLS * EPI_ILANES) {
    acc[i] = (i / R < rows) ? work[(size_t)m0 * R + i] : 0.f;
  }
  __syncthreads();

  const int c = tid % EPI_COLS;
  const int il = tid / EPI_COLS;
  const int j = blockIdx.x * EPI_COLS + c;
  float o[EPI_BM];
#pragma unroll
  for (int m = 0; m < EPI_BM; ++m) o[m] = 0.f;
  if (j < R) {
#pragma unroll 8
    for (int i = il; i < R; i += EPI_ILANES) {
      const float s = to_f32(S[(size_t)i * R + j]);
#pragma unroll
      for (int m = 0; m < EPI_BM; ++m) o[m] = fmaf(acc[m * R + i], s, o[m]);
    }
  }
  if (il > 0) {
#pragma unroll
    for (int m = 0; m < EPI_BM; ++m) red[il - 1][m][c] = o[m];
  }
  __syncthreads();
  if (il == 0 && j < R) {
#pragma unroll
    for (int m = 0; m < EPI_BM; ++m) {
      float s = o[m];
#pragma unroll
      for (int q = 0; q < EPI_ILANES - 1; ++q) s += red[q][m][c];
      if (m < rows) out[(size_t)(m0 + m) * R + j] = from_f32<T>(s);
    }
  }
}

template <typename T, typename TS>
int launch_xus(const void* x, const void* U, const void* S, void* out, void* work,
               int G, int M, int K, int R, cudaStream_t stream) {
  const int kc = xus_kc(G, M, K, R);
  const int nsplit = cdiv(K, kc);
  const int mtiles = cdiv(M, XUS_BM);
  const long long elems = (long long)G * M * R;
  if ((long long)G * mtiles > 65535 || nsplit > 65535 || G > 65535 ||
      cdiv(M, EPI_BM) > 65535 || (elems + RED_THREADS - 1) / RED_THREADS > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t epi_smem = (size_t)EPI_BM * R * sizeof(float);
  if (epi_smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(work);
  dim3 grid1(cdiv(R, XUS_COLS), nsplit, G * mtiles);
  xus_partial_kernel<T><<<grid1, XUS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(U), w, M, K, R, kc, nsplit);
  if (nsplit > 1) {
    const unsigned blocks = (unsigned)((elems + RED_THREADS - 1) / RED_THREADS);
    xus_reduce_kernel<<<blocks, RED_THREADS, 0, stream>>>(w, G, M, R, nsplit);
  }
  dim3 grid3(cdiv(R, EPI_COLS), cdiv(M, EPI_BM), G);
  xus_epilogue_kernel<T, TS><<<grid3, EPI_COLS * EPI_ILANES, epi_smem, stream>>>(
      w, static_cast<const TS*>(S), static_cast<T*>(out), M, R, nsplit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- avt
constexpr int AVT_WARPS = 8;
constexpr int AVT_NPW = 4;  // outputs (rows of V) per warp

template <typename T, int BM>
__global__ void __launch_bounds__(AVT_WARPS * 32)
avt_kernel(const T* __restrict__ A, const T* __restrict__ V, T* __restrict__ y,
           int M, int N, int R) {
  extern __shared__ float As[];  // [BM][R]
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  A += (size_t)g * M * R;
  V += (size_t)g * N * R;
  y += (size_t)g * M * N;
  for (int i = threadIdx.x; i < BM * R; i += AVT_WARPS * 32) {
    const int m = i / R, r = i % R;
    As[i] = (m0 + m < M) ? to_f32(A[(size_t)(m0 + m) * R + r]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * AVT_WARPS + warp) * AVT_NPW;
  if (n0 >= N) return;
  float acc[BM][AVT_NPW];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int j = 0; j < AVT_NPW; ++j) acc[m][j] = 0.f;
  }
#pragma unroll 2
  for (int r = lane; r < R; r += 32) {
    float v[AVT_NPW];
#pragma unroll
    for (int j = 0; j < AVT_NPW; ++j) {
      v[j] = (n0 + j < N) ? to_f32(V[(size_t)(n0 + j) * R + r]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float a = As[m * R + r];
#pragma unroll
      for (int j = 0; j < AVT_NPW; ++j) acc[m][j] = fmaf(a, v[j], acc[m][j]);
    }
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int j = 0; j < AVT_NPW; ++j) {
      float s = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == (m * AVT_NPW + j) % 32 && m0 + m < M && n0 + j < N) {
        y[(size_t)(m0 + m) * N + n0 + j] = from_f32<T>(s);
      }
    }
  }
}

template <typename T, int BM>
int launch_avt_bm(const void* A, const void* V, void* y, int G, int M, int N, int R,
                  cudaStream_t stream) {
  const size_t smem = (size_t)BM * R * sizeof(float);
  if (smem > (size_t)MAX_SMEM || G > 65535 || cdiv(M, BM) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(cdiv(N, AVT_WARPS * AVT_NPW), cdiv(M, BM), G);
  avt_kernel<T, BM><<<grid, AVT_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(V), static_cast<T*>(y), M, N, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_avt(const void* A, const void* V, void* y, int G, int M, int N, int R,
               cudaStream_t stream) {
  if (M == 1) return launch_avt_bm<T, 1>(A, V, y, G, M, N, R, stream);
  if (M <= 4) return launch_avt_bm<T, 4>(A, V, y, G, M, N, R, stream);
  return launch_avt_bm<T, 8>(A, V, y, G, M, N, R, stream);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// f32 elements of the workspace lr_xus needs for these sizes.
long long lr_xus_workspace(int G, int M, int K, int R) {
  if (G < 1 || M < 1 || K < 1 || R < 1) return 0;
  return (long long)G * cdiv(K, xus_kc(G, M, K, R)) * M * R;
}

// A = (x U) S.  x (G, M, K), U (G, K, R) in dtype dt; S (G, R, R) in dt_s;
// A (G, M, R) in dt; work holds lr_xus_workspace(G, M, K, R) floats.
int lr_xus(int dt, int dt_s, const void* x, const void* U, const void* S, void* out,
           void* work, int G, int M, int K, int R, void* stream) {
  if (G < 1 || M < 1 || K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0 && dt_s == 0) return launch_xus<float, float>(x, U, S, out, work, G, M, K, R, s);
  if (dt == 1 && dt_s == 1) {
    return launch_xus<__nv_bfloat16, __nv_bfloat16>(x, U, S, out, work, G, M, K, R, s);
  }
  if (dt == 1 && dt_s == 0) {
    return launch_xus<__nv_bfloat16, float>(x, U, S, out, work, G, M, K, R, s);
  }
  return (int)cudaErrorInvalidValue;
}

// y = A V^T.  A (G, M, R), V (G, N, R), y (G, M, N), all in dtype dt.
int lr_avt(int dt, const void* A, const void* V, void* y, int G, int M, int N, int R,
           void* stream) {
  if (G < 1 || M < 1 || N < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return launch_avt<float>(A, V, y, G, M, N, R, s);
  if (dt == 1) return launch_avt<__nv_bfloat16>(A, V, y, G, M, N, R, s);
  return (int)cudaErrorInvalidValue;
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
