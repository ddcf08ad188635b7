// Hopper (sm_90a) kernels for online-softmax (flash) attention.
//
// They replace the Pallas TPU kernel of the JAX package
//   flash_attention <- src/repro/kernels/flash_attention.py::flash_attention
//                      / _flash_kernel (line 34)
// and compute what that computes, for q (B, Tq, H, d) and k, v
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
// What bounds it on an H100. Prefill does 4 B H d FLOPs per visible
// query-key pair (1.2e11 for Qwen2-7B's causal prefill at 4096 tokens): it
// is bound by operations, 0.12 ms at the bf16 tensor-core rate. Decode
// (Tq = 1) reads the whole K/V cache once for a few FLOPs per byte: it is
// bound by bytes (29 MB, 9 us for Qwen2-7B at B 4 and 4096 slots).
//
// bfloat16: flash_tc_kernel, tensor cores (the FA2 shape: mma.sync,
// ldmatrix, cp.async; the FA3 shape of wgmma, TMA and warp specialisation
// is later work). What it does about each bound:
//   - Products on tensor cores: S = Q K^T and O += P V are
//     mma.sync.m16n8k16 bf16 -> f32. 4 warps, each owns 16 rows of the
//     block's 64; its Q fragments stay in registers for the whole key loop,
//     K is read with ldmatrix and V with ldmatrix.trans, and P goes from the
//     S accumulators straight into the A fragments of P V (rounded to bf16
//     there), never through shared memory. Row max and sum: a quad shuffle.
//   - Tiles of 64 keys (32 at d = 256, where registers are tight) arrive by
//     16-byte cp.async.cg into a two-stage ring: the next tile loads while
//     this one is computed, one barrier per tile. Rows are padded by 16
//     bytes, so the 8 row addresses of an ldmatrix fall in 8 distinct bank
//     groups. Head dims are padded with zeros in shared memory to 64, 128
//     or 256. The query tile is staged in the second stage, which it leaves
//     for registers before the first prefetch: 70 KB a block at d = 128,
//     three blocks an SM (168 registers a thread).
//   - Exact masks at tile edges: keys past Tk and slots with a negative
//     position are zero-filled (cp.async with src-size 0), so a poisoned
//     slot never enters a sum, not even as 0 * x. At the start a block
//     reads the positions of its key range once and marks, per tile,
//     whether any (row, key) pair may be visible (tiles without one are
//     skipped: exact, as such a tile leaves m, l and acc unchanged) and
//     whether every pair is (those skip the per-element masks and the
//     position loads, and take p = 2^(s c - m) in one fma): only tiles
//     across the diagonal or the window edge pay for masks.
//   - GQA row packing: row r of a block is query r / g of head
//     kvh g + r % g (g = H / Hkv), so one K/V tile serves all g heads of its
//     KV head (7x fewer K/V bytes for Qwen2-7B). Grid
//     (cdiv(Tq g, 64), B Hkv, splits); the latest query rows (the longest
//     causal key ranges) start first.
//   - Split-KV decode: when the grid has too few blocks for 132 SMs, the
//     wrapper splits the key range into `splits` contiguous chunks of
//     `split_keys` keys (a multiple of 64); each block writes its partial
//     (m, l, acc) in f32 to scratch and flash_combine merges the splits in
//     the fixed order 0 .. splits - 1 (deterministic), with the guards: a
//     split with m <= -5e29 weighs 0, a row with l = 0 everywhere gives 0.
// The scores are kept in the base-2 domain (s * scale * log2 e, exp2), the
// same function as exp(s - m) with one multiply folded into the scale.
//
// float32: flash_kernel, CUDA cores (f32 FMAs from shared memory). TF32
// tensor cores would keep ~3 digits and break the 1e-4 f32 rule, and this
// kernel already beats the library's f32 attention (PERF.md). One block
// owns one (batch, query head, 32-row query tile) and loops over the key
// tiles itself:
//   - 128 threads = 4 warps; warp w owns query rows 8w .. 8w+7 of the tile.
//   - The query tile is staged once in shared memory; each key tile
//     (32 keys) of K and V is staged, rows padded by 4 floats so that the
//     float4 reads of the score loop hit distinct banks. Staging reads 16
//     bytes a load where d and the pointers allow it, every load of a thread
//     started before its stores.
//   - Scores: lane j computes key j of the tile against the warp's 8 rows.
//   - Softmax state per row (m, l) is kept in registers, the same in every
//     lane of the warp (max and sum by xor shuffles). p goes through a
//     per-warp shared buffer.
//   - P.V: lane j owns output dims j, j + 32, ...
//   - A key tile with no visible (row, key) pair is skipped
//     (__syncthreads_or); keys past Tk and invalid slots are staged as zeros.
// Head dims up to 256 are taken, staged at the next of 32, 64, 128, 256.
//
// Both take the same staging choice: 16-byte loads where d and the
// pointers allow it, element loads into the same shared layout where they do
// not; the arithmetic, and so the bits, are the same either way. The entry
// point returns cudaGetLastError() and launches on the caller's stream
// without synchronising; the caller allocates the output and the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

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

// Stage ROWS rows of an f32 operand (row r at src + r * stride) into shared
// rows of length DP + 4: row r is read where valid(r), columns past d and
// rows that are not valid are zero. VEC (d a multiple of 4, 16-byte aligned
// rows): a thread starts all its 16-byte loads, then stores them; otherwise
// one element per load.
template <int DP, int ROWS, bool VEC, typename Valid>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, size_t stride,
                                      int d, int tid, Valid valid) {
  constexpr int LD = DP + 4;
  if constexpr (VEC) {
    constexpr int N = 4, CPR = DP / N, CHUNKS = ROWS * CPR;
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
        const uint4 x = raw[it];
        *reinterpret_cast<float4*>(dst + r * LD + c0) =
            make_float4(__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                        __uint_as_float(x.w));
      }
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += FA_THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (c < d && valid(r)) ? src[(size_t)r * stride + c] : 0.f;
    }
  }
}

template <int DP>
constexpr int smem_bytes() {
  // Q tile, K tile, V tile (f32, rows padded by 4), p per warp, positions
  return (FA_BQ + 2 * FA_BK) * (DP + 4) * 4 + FA_WARPS * FA_ROWS_PER_WARP * FA_BK * 4 +
         (FA_BQ + FA_BK) * 4;
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const int* __restrict__ qpos, const int* __restrict__ kpos, float* __restrict__ out,
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
  const float* qb = q + (size_t)b * Tq * q_row + (size_t)h * d;
  const float* kb = k + (size_t)b * Tk * kv_row + (size_t)kvh * d;
  const float* vb = v + (size_t)b * Tk * kv_row + (size_t)kvh * d;

  // the query tile (rows past Tq: zeros and an invalid position)
  stage<DP, FA_BQ, VEC>(Qs, qb + (size_t)q0 * q_row, q_row, d, tid,
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
    stage<DP, FA_BK, VEC>(Ks, kb + (size_t)k0 * kv_row, kv_row, d, tid, key_ok);
    stage<DP, FA_BK, VEC>(Vs, vb + (size_t)k0 * kv_row, kv_row, d, tid, key_ok);
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
      Pw[r * FA_BK + lane] = p;
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

  float* ob = out + (size_t)b * Tq * q_row + (size_t)h * d;
#pragma unroll
  for (int r = 0; r < FA_ROWS_PER_WARP; ++r) {
    const int t = q0 + row0 + r;
    if (t >= Tq) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      const int c = lane + 32 * tt;
      if (c < d) ob[(size_t)t * q_row + c] = acc[r][tt] / den;
    }
  }
}

// The opt-in to more than 48 KB of dynamic shared memory, up to the device's
// maximum, once per kernel (`done`, one slot per device: no attribute call
// falls inside a CUDA-graph capture after a warm-up); *max_bytes = that
// maximum.
int smem_opt_in(const void* kernel, int* done, int* max_bytes) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool slot = dev >= 0 && dev < kMaxDevices;
  if (slot && done[dev]) {
    *max_bytes = done[dev];
    return 0;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  if (slot) done[dev] = optin;
  *max_bytes = optin;
  return 0;
}

template <int DP, bool VEC>
int launch_flash(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                 void* out, int B, int Tq, int Tk, int H, int Hkv, int d, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();  // above 48 KB from DP = 128 on
  static int done[64] = {};
  int max_bytes = 0;
  const int e = smem_opt_in((const void*)flash_kernel<DP, VEC>, done, &max_bytes);
  if (e) return e;
  const dim3 grid(cdiv(Tq, FA_BQ), B * H);
  flash_kernel<DP, VEC><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, static_cast<float*>(out), Tq, Tk, H, Hkv, d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch_dp(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                void* out, int B, int Tq, int Tk, int H, int Hkv, int d, int causal, int window,
                float scale, cudaStream_t s) {
  if (d <= 32)
    return launch_flash<32, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                    window, scale, s);
  if (d <= 64)
    return launch_flash<64, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                    window, scale, s);
  if (d <= 128)
    return launch_flash<128, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                     window, scale, s);
  return launch_flash<256, VEC>(q, k, v, qpos, kpos, out, B, Tq, Tk, H, Hkv, d, causal,
                                   window, scale, s);
}

// 16-byte staging needs whole chunks per row (n elements) and 16-byte
// aligned rows
bool vec_ok(const void* q, const void* k, const void* v, int d, int n) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  return d % n == 0 && align % 16 == 0;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;  // packed (query, head) rows per block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (src-size 0: no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DP, int BK>
struct TcSmem {
  static constexpr int LD = DP + 8;  // bf16 per row: 16 bytes of padding
  // two stages, each BK rows of K then BK rows of V (bf16). The query tile
  // (TC_BQ rows) is staged in stage 1, which it leaves (into registers)
  // before the key loop's first prefetch lands there.
  static constexpr int STAGE = 2 * BK * LD;  // bf16 per stage
  static_assert(2 * BK >= TC_BQ, "the query tile fits one stage");
  static constexpr int QP = 2 * STAGE * 2;        // [TC_BQ] int: row positions
  static constexpr int KP = QP + TC_BQ * 4;       // [2][BK] int: key positions
  static constexpr int QR = KP + 2 * BK * 4;      // qmin, qmax
  static constexpr int MAP = QR + 2 * 4;          // tile maps, 2 * words uint32
  static constexpr int bytes(int words) { return MAP + 2 * words * 4; }
};

// One block: 64 packed rows of one (batch, KV head) against the keys of one
// split. part_ml == nullptr: write out; else write the split's partial
// (m, l) and acc rows (f32, m in the base-2 domain) for flash_combine.
// Three blocks per SM where registers allow (d <= 128: 70 KB of shared
// memory each), two at d = 256.
template <int DP, int BK, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, DP <= 128 ? 3 : 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kpos, bf16* __restrict__ out, float2* __restrict__ part_ml,
                float* __restrict__ part_acc, int Tq, int Tk, int H, int Hkv, int d, int causal,
                int window, float scale_log2, int split_keys) {
  using L = TcSmem<DP, BK>;
  constexpr int LD = L::LD;
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  extern __shared__ float4 smem_tc[];
  char* base = reinterpret_cast<char*>(smem_tc);
  bf16* KVs = reinterpret_cast<bf16*>(base);  // stage st: K at st STAGE, V BK rows on
  bf16* Qs = KVs + L::STAGE;
  int* qp_s = reinterpret_cast<int*>(base + L::QP);
  int* kp_s = reinterpret_cast<int*>(base + L::KP);
  int* qr_s = reinterpret_cast<int*>(base + L::QR);
  uint32_t* any_map = reinterpret_cast<uint32_t*>(base + L::MAP);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = H / Hkv;
  const int R = Tq * g;                                 // packed rows of one (b, kvh)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;  // latest rows first
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int kbeg = blockIdx.z * split_keys;
  const int kend = min(Tk, kbeg + split_keys);
  const int ntiles = cdiv(kend - kbeg, BK);
  const int words = cdiv(ntiles, 32);
  uint32_t* nf_map = any_map + words;  // bit set: some pair of the tile is masked
  const size_t q_row = (size_t)H * d, kv_row = (size_t)Hkv * d;
  const bf16* kb = k + (size_t)b * Tk * kv_row + (size_t)kvh * d;
  const bf16* vb = v + (size_t)b * Tk * kv_row + (size_t)kvh * d;
  const bf16 zero = __float2bfloat16_rn(0.f);
  // packed row r: query t = r / g, head kvh g + r % g
  const auto q_src = [&](int pr) {
    return q + ((size_t)b * Tq + pr / g) * q_row + (size_t)(kvh * g + pr % g) * d;
  };

  // the query tile (rows past R: zeros)
  if constexpr (VEC) {
    for (int i = tid; i < TC_BQ * CPR; i += TC_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, pr = q0 + r;
      const bool ok = pr < R && c < d;
      cp_async16(smem_u32(Qs + r * LD + c), ok ? q_src(pr) + c : q, ok);
    }
  } else {
    for (int i = tid; i < TC_BQ * DP; i += TC_THREADS) {
      const int r = i / DP, c = i % DP, pr = q0 + r;
      Qs[r * LD + c] = (pr < R && c < d) ? q_src(pr)[c] : zero;
    }
  }
  cp_async_commit();

  // row positions (-1 past R), their range over the rows that see anything
  if (tid < TC_BQ) qp_s[tid] = q0 + tid < R ? qpos[(q0 + tid) / g] : -1;
  if (tid == 0) qr_s[0] = INT_MAX, qr_s[1] = INT_MIN;
  for (int i = tid; i < 2 * words; i += TC_THREADS) any_map[i] = 0u;
  __syncthreads();
  bool row_bad = false;
  if (tid < TC_BQ) {
    const int qp = qp_s[tid];
    if (qp >= 0) atomicMin(&qr_s[0], qp), atomicMax(&qr_s[1], qp);
    row_bad = q0 + tid < R && qp < 0;
  }
  const bool rows_all_valid = !__syncthreads_or(row_bad);
  const long long qmin = qr_s[0], qmax = qr_s[1];
  const bool any_rows = qmax >= 0;

  // tile maps from one pass over this split's key positions: a warp's 32
  // keys lie in one tile (BK is a multiple of 32)
  {
    constexpr int U = 8;  // loads in flight per thread
    const int span = ntiles * BK;
    for (int base0 = warp * 32; base0 < span; base0 += TC_THREADS * U) {
      int kpv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base0 + u * TC_THREADS + lane;
        kpv[u] = (i < span && kbeg + i < kend) ? __ldg(kpos + kbeg + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i0 = base0 + u * TC_THREADS;  // the same in the whole warp
        if (i0 >= span) break;
        const long long kp = kpv[u];
        const bool possible = kp >= 0 && any_rows && (!causal || kp <= qmax) &&
                              (!window || kp + window > qmin);
        const bool all = kp >= 0 && any_rows && rows_all_valid && (!causal || kp <= qmin) &&
                         (!window || kp + window > qmax);
        const unsigned any_b = __any_sync(0xffffffffu, possible);
        const unsigned nf_b = __any_sync(0xffffffffu, !all);
        const int tile = i0 / BK;
        if (lane == 0) {
          if (any_b) atomicOr(&any_map[tile / 32], 1u << (tile % 32));
          if (nf_b) atomicOr(&nf_map[tile / 32], 1u << (tile % 32));
        }
      }
    }
  }
  __syncthreads();

  // the first tile at or after tile i that may see a pair (ntiles: none)
  const auto next_tile = [&](int i) {
    while (i < ntiles) {
      const uint32_t w = any_map[i / 32] >> (i % 32);
      if (w) return i + __ffs(w) - 1;
      i = (i | 31) + 1;
    }
    return ntiles;
  };
  const auto masked = [&](int i) { return (nf_map[i / 32] >> (i % 32) & 1u) != 0u; };
  // K and V of tile i into stage st; invalid key slots are zero-filled. A
  // tile whose pairs are all visible has only valid keys: neither its
  // positions nor its zero-fill need a load of kpos.
  const auto load_tile = [&](int i, int st) {
    const int k0 = kbeg + i * BK;
    bf16* Kd = KVs + st * L::STAGE;
    bf16* Vd = Kd + BK * LD;
    const bool mask = masked(i);
    if (mask && tid < BK) kp_s[st * BK + tid] = k0 + tid < kend ? kpos[k0 + tid] : -1;
    const auto key_ok = [&](int r) {
      return !mask || (k0 + r < kend && __ldg(kpos + k0 + r) >= 0);
    };
    if constexpr (VEC) {
      // a thread copies chunk tid % CPR of rows tid / CPR + it * RSTEP
      constexpr int RSTEP = TC_THREADS / CPR;
      static_assert(TC_THREADS % CPR == 0 && BK % RSTEP == 0, "whole chunk rows per pass");
      const int c = (tid % CPR) * 8;
      const bf16* ksrc = kb + (size_t)(k0 + tid / CPR) * kv_row + c;
      const bf16* vsrc = vb + (size_t)(k0 + tid / CPR) * kv_row + c;
      const uint32_t kdst = smem_u32(Kd + (tid / CPR) * LD + c);
      const uint32_t vdst = smem_u32(Vd + (tid / CPR) * LD + c);
#pragma unroll
      for (int it = 0; it < BK / RSTEP; ++it) {
        const bool ok = c < d && key_ok(tid / CPR + it * RSTEP);
        const size_t off = (size_t)it * RSTEP * kv_row;
        cp_async16(kdst + it * RSTEP * LD * 2, ok ? ksrc + off : kb, ok);
        cp_async16(vdst + it * RSTEP * LD * 2, ok ? vsrc + off : vb, ok);
      }
    } else {
      for (int e = tid; e < BK * DP; e += TC_THREADS) {
        const int r = e / DP, c = e % DP;
        const bool ok = c < d && key_ok(r);
        const size_t off = (size_t)(k0 + r) * kv_row + c;
        Kd[r * LD + c] = ok ? kb[off] : zero;
        Vd[r * LD + c] = ok ? vb[off] : zero;
      }
    }
  };

  int j = next_tile(0);
  if (j < ntiles) load_tile(j, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the whole key loop
  const int wr0 = warp * 16;
  const int g4 = lane / 4, t4 = lane % 4;  // fragment row group, column pair
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(smem_u32(Qs + (wr0 + lane % 16) * LD + kk * 16 + (lane / 16) * 8), qf[kk]);
  const int qp0 = qp_s[wr0 + g4], qp1 = qp_s[wr0 + g4 + 8];
  const bool warp_active = q0 + wr0 < R;

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f};  // rows g4, g4 + 8

  // one barrier per tile: past it, tile j (stage st) has landed from every
  // thread, and every warp is done with stage st ^ 1, which then takes the
  // next tile while this one is computed
  int st = 0;
  while (j < ntiles) {
    cp_async_wait<0>();
    __syncthreads();
    const int jn = next_tile(j + 1);
    if (jn < ntiles) load_tile(jn, st ^ 1);
    cp_async_commit();
    if (warp_active) {
      const bf16* Kt = KVs + st * L::STAGE;
      const bf16* Vt = Kt + BK * LD;
      const int* kps = kp_s + st * BK;
      // S = Q K^T: 16 rows x BK keys
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          uint32_t kf[4];
          ldsm_x4(smem_u32(Kt + (nb * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8),
                  kf);
          mma_bf16(s[2 * nb], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * nb + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // element (n, e): row g4 + 8 (e / 2), key 8 n + 2 t4 + e % 2. A tile
      // whose pairs are all visible takes the row max of the raw scores
      // (the scale is positive) and p = 2^(s c - m) in one fma; a masked
      // tile scales, masks to -1e30, and zeroes p where masked.
      const bool mtile = masked(j);
      uint32_t vis = 0u;
      float mx[2] = {NEG_INF, NEG_INF};
      if (mtile) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = visible(e < 2 ? qp0 : qp1, kps[8 * n + 2 * t4 + e % 2], causal, window);
            vis |= (ok ? 1u : 0u) << (4 * n + e);
            s[n][e] = ok ? s[n][e] * scale_log2 : NEG_INF;
            mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        mx[0] *= scale_log2, mx[1] *= scale_log2;
      }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_safe[r] = m_new <= NEG_HALF ? 0.f : m_new;
        alpha[r] = m[r] <= NEG_HALF ? 0.f : exp2_approx(m[r] - m_safe[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p;
          if (mtile)
            p = (vis >> (4 * n + e) & 1u) ? exp2_approx(s[n][e] - m_safe[e / 2]) : 0.f;
          else
            p = exp2_approx(fmaf(s[n][e], scale_log2, -m_safe[e / 2]));
          rs[e / 2] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) lsum[r] = lsum[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][0] *= alpha[0], o[n][1] *= alpha[0];
        o[n][2] *= alpha[1], o[n][3] *= alpha[1];
      }
      // O += P V, P rounded to bf16 in the A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd) {
          uint32_t vf[4];
          ldsm_x4_trans(smem_u32(Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                 nd * 16 + (lane / 16) * 8),
                        vf);
          mma_bf16(o[2 * nd], pa, vf[0], vf[1]);
          mma_bf16(o[2 * nd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    j = jn;
    st ^= 1;
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = q0 + wr0 + g4 + 8 * r;
    if (pr >= R) continue;
    if (part_ml == nullptr) {
      const int t = pr / g;
      bf16* orow = out + ((size_t)b * Tq + t) * q_row + (size_t)(kvh * g + pr % g) * d;
      const float den = fmaxf(lsum[r], 1e-20f);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * t4;
        const float x0 = o[n][2 * r] / den, x1 = o[n][2 * r + 1] / den;
        if (d % 2 == 0) {
          if (c < d) *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < d) orow[c] = __float2bfloat16_rn(x0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(x1);
        }
      }
    } else {
      const size_t prow = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * R + pr;
      if (t4 == 0) part_ml[prow] = make_float2(m[r], lsum[r]);
      float* arow = part_acc + prow * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * t4;
        if (c < d) arow[c] = o[n][2 * r];
        if (c + 1 < d) arow[c + 1] = o[n][2 * r + 1];
      }
    }
  }
}

// Merges the splits of flash_tc_kernel, one warp per packed row: weights
// 2^(m_s - M), 0 for a split that saw no key, summed in the fixed order
// s = 0 .. splits - 1 (lane s0 + u loads split s0 + u's (m, l), and the
// warp walks u in order); out = sum w acc / max(sum w l, 1e-20).
__global__ void __launch_bounds__(128)
flash_combine(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
              bf16* __restrict__ out, int splits, int rows, int R, int Tq, int H, int Hkv, int d) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int g = H / Hkv, bk = row / R, pr = row % R;
  const int b = bk / Hkv, kvh = bk % Hkv;
  float M = NEG_INF;
  for (int s = lane; s < splits; s += 32) M = fmaxf(M, part_ml[(size_t)s * rows + row].x);
  M = warp_max(M);
  const float m_safe = M <= NEG_HALF ? 0.f : M;
  constexpr int NC = 256 / 32;  // columns per lane, up to d = 256
  float acc[NC] = {}, l = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const float2 mine = s0 + lane < splits ? part_ml[(size_t)(s0 + lane) * rows + row]
                                           : make_float2(NEG_INF, 0.f);
    const float w_mine = mine.x <= NEG_HALF ? 0.f : exp2_approx(mine.x - m_safe);
    const int n = min(32, splits - s0);
#pragma unroll 4
    for (int u = 0; u < n; ++u) {
      const float w = __shfl_sync(0xffffffffu, w_mine, u);
      l += w * __shfl_sync(0xffffffffu, mine.y, u);
      const float* src = part_acc + ((size_t)(s0 + u) * rows + row) * d;
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (lane + 32 * i < d) acc[i] += w * src[lane + 32 * i];
    }
  }
  const float den = fmaxf(l, 1e-20f);
  bf16* orow = out + ((size_t)b * Tq + pr / g) * H * d + (size_t)(kvh * g + pr % g) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (lane + 32 * i < d) orow[lane + 32 * i] = __float2bfloat16_rn(acc[i] / den);
}

template <int DP, int BK, bool VEC>
int launch_tc(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
              void* out, void* part_ml, void* part_acc, int B, int Tq, int Tk, int H, int Hkv,
              int d, int causal, int window, float scale, int splits, int split_keys,
              cudaStream_t stream) {
  const int words = cdiv(cdiv(min(Tk, split_keys), BK), 32);
  const int bytes = TcSmem<DP, BK>::bytes(words);
  static int done[64] = {};
  int max_bytes = 0;
  int e = smem_opt_in((const void*)flash_tc_kernel<DP, BK, VEC>, done, &max_bytes);
  if (e) return e;
  if (bytes > max_bytes) return (int)cudaErrorInvalidValue;
  const int R = Tq * (H / Hkv);
  const dim3 grid(cdiv(R, TC_BQ), B * Hkv, splits);
  float2* ml = splits > 1 ? static_cast<float2*>(part_ml) : nullptr;
  float* acc = static_cast<float*>(part_acc);
  flash_tc_kernel<DP, BK, VEC><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qpos,
      kpos, static_cast<bf16*>(out), ml, acc, Tq, Tk, H, Hkv, d, causal, window, scale * LOG2E,
      split_keys);
  e = (int)cudaGetLastError();
  if (e || splits == 1) return e;
  const int rows = B * Hkv * R;
  flash_combine<<<cdiv(rows, 4), 128, 0, stream>>>(ml, acc, static_cast<bf16*>(out), splits,
                                                   rows, R, Tq, H, Hkv, d);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch_tc(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                void* out, void* ml, void* acc, int B, int Tq, int Tk, int H, int Hkv, int d,
                int causal, int window, float scale, int splits, int split_keys,
                cudaStream_t s) {
  if (d <= 64)
    return launch_tc<64, 64, VEC>(q, k, v, qpos, kpos, out, ml, acc, B, Tq, Tk, H, Hkv, d,
                                  causal, window, scale, splits, split_keys, s);
  if (d <= 128)
    return launch_tc<128, 64, VEC>(q, k, v, qpos, kpos, out, ml, acc, B, Tq, Tk, H, Hkv, d,
                                   causal, window, scale, splits, split_keys, s);
  return launch_tc<256, 32, VEC>(q, k, v, qpos, kpos, out, ml, acc, B, Tq, Tk, H, Hkv, d,
                                 causal, window, scale, splits, split_keys, s);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// q (B, Tq, H, d), k / v (B, Tk, Hkv, d), out (B, Tq, H, d), all contiguous in
// dtype dt; qpos (Tq,), kpos (Tk,) int32. H % Hkv == 0, 1 <= d <= 256.
// splits > 1 (bfloat16 only): the key range in chunks of split_keys keys (a
// multiple of 64, every chunk non-empty), merged by a second launch;
// part_ml holds splits * B * Hkv * Tq * (H / Hkv) float2 and part_acc that
// many rows of d floats. splits == 1: one launch, part_ml / part_acc unused.
int lr_flash_attention(int dt, const void* q, const void* k, const void* v, const void* qpos,
                       const void* kpos, void* out, void* part_ml, void* part_acc, int B, int Tq,
                       int Tk, int H, int Hkv, int d, int causal, int window, float scale,
                       int splits, int split_keys, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || Hkv < 1 || H % Hkv || d < 1 || d > 256 ||
      window < 0 || (long long)B * H > 65535 || (long long)Tq * (H / Hkv) > INT_MAX - 64 ||
      splits < 1 || splits > 65535 || split_keys < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (dt != 1 || split_keys % 64 || !part_ml || !part_acc ||
                     (long long)(splits - 1) * split_keys >= Tk ||
                     (long long)splits * split_keys < Tk))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) split_keys = Tk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  if (dt == 0) {
    if (vec_ok(q, k, v, d, 4))
      return dispatch_dp<true>(q, k, v, qp, kp, out, B, Tq, Tk, H, Hkv, d, causal, window,
                                      scale, s);
    return dispatch_dp<false>(q, k, v, qp, kp, out, B, Tq, Tk, H, Hkv, d, causal, window,
                                     scale, s);
  }
  if (dt == 1) {
    if (vec_ok(q, k, v, d, 8))
      return dispatch_tc<true>(q, k, v, qp, kp, out, part_ml, part_acc, B, Tq, Tk, H, Hkv, d,
                               causal, window, scale, splits, split_keys, s);
    return dispatch_tc<false>(q, k, v, qp, kp, out, part_ml, part_acc, B, Tq, Tk, H, Hkv, d,
                              causal, window, scale, splits, split_keys, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
