// Hopper (sm_90a) kernel for online-softmax (flash) attention.
//
// It replaces the Pallas TPU kernel of the JAX package
//   flash_attention <- src/repro/kernels/flash_attention.py::flash_attention
//                      / _flash_kernel (line 34)
// and computes what that computes, for q (B, Tq, H, d) and k, v
// (B, Tk, Hkv, d), all float32 or all bfloat16, with int32 absolute positions
// qpos (Tq,) and kpos (Tk,):
//   s   = (q . k) * scale in f32                    (scale = 1 / sqrt(d))
//   vis = kp >= 0 & qp >= 0 [& kp <= qp if causal] [& kp > qp - window]
//   s   = vis ? s : -1e30
//   a running max m, sum l and f32 accumulator over the key tiles, with the
//   TPU kernel's guards for rows that have seen no visible key yet
//   (m_safe = 0, alpha = 0), p = exp(s - m_safe) zeroed where masked, p
//   rounded to V's type before p . V, l summed from the unrounded p;
//   out = acc / max(l, 1e-20), rounded once to q's type.
// A row whose keys are all masked comes out as exactly 0. GQA: query head h
// reads KV head h / (H / Hkv), indexed directly (K and V are not repeated
// in memory as the TPU wrapper does).
//
// What bounds it on an H100. Prefill at 4096 tokens does 4 B H d FLOPs per
// visible query-key pair (1.2e11 for Qwen2-7B's causal prefill): it is bound
// by operations, 0.12 ms at the bf16 tensor-core rate. Decode (Tq = 1) reads
// the whole K/V cache once for a few FLOPs per byte: bound by bytes. This
// first kernel does its products with f32 FMAs from shared memory (no tensor
// cores: mma.sync / wgmma are later work), so it is far from the operations
// bound; PERF.md has its times.
//
// Design. The TPU grid carried (acc, m, l) in VMEM scratch across a
// sequential KV grid axis. Hopper blocks run in parallel and in no order, so
// one block owns one (batch, query head, 32-row query tile) and loops over
// the key tiles itself:
//   - 128 threads = 4 warps; warp w owns query rows 8w .. 8w+7 of the tile.
//   - The query tile is staged once in shared memory as f32; each key tile
//     (32 keys) of K and V is staged as f32, rows padded by 4 floats so that
//     the float4 reads of the score loop hit distinct banks. Staging reads
//     16 bytes a load where d and the pointers allow it, every load of a
//     thread issued before its stores (Run 13.2 staged one element a load,
//     and the loop's serialized latency dominated the decode shape).
//   - Scores: lane j computes key j of the tile against the warp's 8 rows
//     (8 accumulators, float4 reads of its K row and broadcast Q rows).
//   - Softmax state per row (m, l) is kept in registers, the same in every
//     lane of the warp (max and sum by xor shuffles, which give identical
//     bits in every lane). p goes through a per-warp shared buffer.
//   - P.V: lane j owns output dims j, j + 32, ...; for each key it reads one
//     p per row (broadcast) and its V elements (consecutive lanes, no bank
//     conflicts).
//   - A key tile with no visible (row, key) pair for the block's rows is
//     skipped (__syncthreads_or). Skipping is exact: such a tile leaves m, l
//     and acc as they were (alpha is 1, or 0 on state that is already 0).
//     Causal prefill skips about half the tiles.
//   - Ragged Tq and Tk are masked, nothing is padded: rows past Tq get an
//     invalid position and are not written; keys past Tk, and slots with a
//     negative position, are staged as zeros, so poisoned cache slots (a
//     ring cache's invalid entries) never reach l or acc, not even as 0 * inf.
// Head dims up to 256 are taken, staged at the next of 32, 64, 128, 256.
//
// The entry point returns cudaGetLastError() and launches on the caller's
// stream without synchronising; the caller allocates the output.

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

// p rounded to V's type (the TPU kernel's p.astype(v.dtype)), back in f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16-byte chunks: 4 float32 or 8 bfloat16 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__device__ __forceinline__ void unpack16(uint4 x, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 x, float* f) {
  f[0] = __uint_as_float(x.x), f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z), f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 x, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = 32 * FA_WARPS;
constexpr int FA_ROWS_PER_WARP = 8;
constexpr int FA_BQ = FA_WARPS * FA_ROWS_PER_WARP;  // 32 query rows per block
constexpr int FA_BK = 32;                           // keys per tile: one per lane
constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;  // NEG_INF / 2: "no visible key yet"

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  if (qp < 0 || kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window && (long long)kp <= (long long)qp - window) return false;
  return true;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage ROWS rows of an operand (row r at src + r * stride) into shared f32
// rows of length DP + 4: row r is read where valid(r), columns past d and
// rows that are not valid are zero. VEC (d a multiple of the 16-byte chunk,
// 16-byte aligned rows): a thread issues all its 16-byte loads, then
// converts and stores them; otherwise one element per load.
template <typename T, int DP, int ROWS, bool VEC, typename Valid>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, size_t stride,
                                      int d, int tid, Valid valid) {
  constexpr int LD = DP + 4;
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N, CPR = DP / N, CHUNKS = ROWS * CPR;
    constexpr int ITERS = (CHUNKS + FA_THREADS - 1) / FA_THREADS;
    uint4 raw[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = it * FA_THREADS + tid;
      const int r = i / CPR, c0 = (i % CPR) * N;
      raw[it] = (i < CHUNKS && c0 < d && valid(r))
                    ? *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c0)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = it * FA_THREADS + tid;
      if (i < CHUNKS) {
        const int r = i / CPR, c0 = (i % CPR) * N;
        float f[N];
        unpack16<T>(raw[it], f);
        float4* o = reinterpret_cast<float4*>(dst + r * LD + c0);
#pragma unroll
        for (int e = 0; e < N / 4; ++e)
          o[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
      }
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += FA_THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (c < d && valid(r)) ? to_f32(src[(size_t)r * stride + c]) : 0.f;
    }
  }
}

template <int DP>
constexpr int smem_bytes() {
  // Q tile, K tile, V tile (f32, rows padded by 4), p per warp, positions
  return (FA_BQ + 2 * FA_BK) * (DP + 4) * 4 + FA_WARPS * FA_ROWS_PER_WARP * FA_BK * 4 +
         (FA_BQ + FA_BK) * 4;
}

template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ qpos, const int* __restrict__ kpos, T* __restrict__ out,
             int Tq, int Tk, int H, int Hkv, int d, int causal, int window, float scale) {
  constexpr int LD = DP + 4;            // padded row length (floats)
  constexpr int NT = DP / 32;           // output dims per lane
  extern __shared__ float4 smem_f4[];   // float4: 16-byte alignment for the reads
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + FA_BQ * LD;
  float* Vs = Ks + FA_BK * LD;
  float* Ps = Vs + FA_BK * LD;          // [warp][row][key]
  int* qp_s = reinterpret_cast<int*>(Ps + FA_WARPS * FA_ROWS_PER_WARP * FA_BK);
  int* kp_s = qp_s + FA_BQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * FA_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_row = (size_t)H * d;      // elements between query rows
  const size_t kv_row = (size_t)Hkv * d;   // elements between key rows
  const T* qb = q + (size_t)b * Tq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)b * Tk * kv_row + (size_t)kvh * d;
  const T* vb = v + (size_t)b * Tk * kv_row + (size_t)kvh * d;

  // the query tile (rows past Tq: zeros and an invalid position)
  stage<T, DP, FA_BQ, VEC>(Qs, qb + (size_t)q0 * q_row, q_row, d, tid,
                           [&](int r) { return q0 + r < Tq; });
  if (tid < FA_BQ) qp_s[tid] = (q0 + tid < Tq) ? qpos[q0 + tid] : -1;

  float m[FA_ROWS_PER_WARP], l[FA_ROWS_PER_WARP], acc[FA_ROWS_PER_WARP][NT];
#pragma unroll
  for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }
  const int row0 = warp * FA_ROWS_PER_WARP;
  float* Pw = Ps + warp * FA_ROWS_PER_WARP * FA_BK;

  for (int k0 = 0; k0 < Tk; k0 += FA_BK) {
    if (tid < FA_BK) kp_s[tid] = (k0 + tid < Tk) ? kpos[k0 + tid] : -1;
    __syncthreads();  // kp_s written (and, on the first tile, Qs and qp_s)
    const int kp = kp_s[lane];
    bool any = false;
#pragma unroll
    for (int r = 0; r < FA_ROWS_PER_WARP; ++r) any |= visible(qp_s[row0 + r], kp, causal, window);
    if (!__syncthreads_or(any)) continue;  // no visible pair in this tile: exact skip

    // the key tile: slots past Tk or with a negative position stay zero
    const auto key_ok = [&](int j) { return k0 + j < Tk && kp_s[j] >= 0; };
    stage<T, DP, FA_BK, VEC>(Ks, kb + (size_t)k0 * kv_row, kv_row, d, tid, key_ok);
    stage<T, DP, FA_BK, VEC>(Vs, vb + (size_t)k0 * kv_row, kv_row, d, tid, key_ok);
    __syncthreads();

    // scores of key `lane` against the warp's rows
    float s[FA_ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < FA_ROWS_PER_WARP; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * LD);
#pragma unroll 4
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      const float4 kv4 = krow[c4];
#pragma unroll
      for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
        const float4 qv4 = reinterpret_cast<const float4*>(Qs + (row0 + r) * LD)[c4];
        s[r] = fmaf(qv4.x, kv4.x, s[r]);
        s[r] = fmaf(qv4.y, kv4.y, s[r]);
        s[r] = fmaf(qv4.z, kv4.z, s[r]);
        s[r] = fmaf(qv4.w, kv4.w, s[r]);
      }
    }

    // online softmax, per row; m and l are the same in every lane
    float alpha[FA_ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
      const bool vis = visible(qp_s[row0 + r], kp, causal, window);
      const float sr = vis ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float m_safe = m_new <= NEG_HALF ? 0.f : m_new;
      const float p = vis ? expf(sr - m_safe) : 0.f;
      alpha[r] = m[r] <= NEG_HALF ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * alpha[r] + warp_sum(p);
      m[r] = m_new;
      Pw[r * FA_BK + lane] = round_to<T>(p);
    }
    __syncwarp();

    // acc = acc * alpha + p . V
#pragma unroll
    for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= alpha[r];
    }
#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float vj[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) vj[t] = Vs[j * LD + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
        const float p = Pw[r * FA_BK + j];
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[r][t] = fmaf(p, vj[t], acc[r][t]);
      }
    }
    __syncthreads();  // Ks, Vs, Pw and kp_s are rewritten by the next tile
  }

  T* ob = out + (size_t)b * Tq * q_row + (size_t)h * d;
#pragma unroll
  for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
    const int t = q0 + row0 + r;
    if (t >= Tq) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      const int c = lane + 32 * tt;
      if (c < d) ob[(size_t)t * q_row + c] = from_f32<T>(acc[r][tt] / den);
    }
  }
}

template <typename T, int DP, bool VEC>
int launch_flash(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                 void* out, int B, int Tq, int Tk, int H, int Hkv, int d, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();  // above 48 KB from DP = 128 on
  // the opt-in to that much shared memory, once per device (so that no
  // attribute call falls inside a CUDA-graph capture after a warm-up)
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices || !opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_kernel<T, DP, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < kMaxDevices) opted_in[dev] = true;
  }
  const dim3 grid(cdiv(Tq, FA_BQ), B * H);
  flash_kernel<T, DP, VEC><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos, kpos,
      static_cast<T*>(out), Tq, Tk, H, Hkv, d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch_dp(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                void* out, int B, int Tq, int Tk, int H, int Hkv, int d, int causal, int window,
                float scale, cudaStream_t s) {
  if (d <= 32)
    return launch_flash<T, 32, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                    window, scale, s);
  if (d <= 64)
    return launch_flash<T, 64, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                    window, scale, s);
  if (d <= 128)
    return launch_flash<T, 128, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                     window, scale, s);
  return launch_flash<T, 256, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                   window, scale, s);
}

template <typename T>
int dispatch_flash(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                   void* out, int B, int Tq, int Tk, int H, int Hkv, int d, int causal,
                   int window, float scale, cudaStream_t s) {
  // 16-byte staging loads need whole chunks per row and 16-byte aligned rows
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (d % Vec<T>::N == 0 && align % 16 == 0)
    return dispatch_dp<T, true>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal, window,
                                scale, s);
  return dispatch_dp<T, false>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal, window,
                               scale, s);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.
// q (B, Tq, H, d), k / v (B, Tk, Hkv, d), out (B, Tq, H, d), all contiguous in
// dtype dt; qpos (Tq,), kpos (Tk,) int32. H % Hkv == 0, 1 <= d <= 256.
int lr_flash_attention(int dt, const void* q, const void* k, const void* v, const void* qpos,
                       const void* kpos, void* out, int B, int Tq, int Tk, int H, int Hkv, int d,
                       int causal, int window, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || Hkv < 1 || H % Hkv || d < 1 || d > 256 ||
      window < 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  if (dt == 0)
    return dispatch_flash<float>(q, k, v, qp, kp, out, B, Tq, Tk, H, Hkv, d, causal, window,
                                 scale, s);
  if (dt == 1)
    return dispatch_flash<__nv_bfloat16>(q, k, v, qp, kp, out, B, Tq, Tk, H, Hkv, d, causal,
                                         window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
