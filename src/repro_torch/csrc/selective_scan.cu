// Hopper (sm_90a) kernels for Mamba's state recurrence and its gradient:
// the selective scan of the serving prefill, of every decode step and of
// training's mixer (from a zero state), and the scan's backward.
//
// The forward replaces no Pallas kernel: the JAX package computes this
// recurrence in XLA, as the sequential lax.scan of mamba_mix's state branch
//   src/repro/models/ssm.py::mamba_mix (the scan at line 185)
// and, in training, as associative_scan with the custom VJP
//   src/repro/models/ssm.py::_linrec_bwd (line 63)
// whose docstring names what both re-express for the TPU: the CUDA
// selective scan of Mamba. These are that kernel and its backward, in the
// reference's order:
//
//   a_t = exp(delta_t A)          rounded to the state's type S
//   b_t = (delta_t x_t) B_t       rounded to S
//   h_t = b_t + a_t h_{t-1}       in f32, rounded to S (h_{-1} = h0 in S)
//   y_t = sum_n h_t,n C_t,n       in f32
//
// delta, x (B, T, D) f32; Bp, Cp (B, T, N) f32; A (D, N) f32; h0 (B, D, N)
// f32. Out: y (B, T, D) f32, h_T (B, D, N) f32 and, when asked for, the
// checkpoints ck (B, ceil(T/K), D, N) f32: ck[:, k] is the state entering
// step kK (ck[:, 0] = h0 in S). S is float32 or bfloat16 (the model's
// compute dtype). Every product and sum of the state is rounded where the
// plain version (kernels/ref.py::selective_scan_ref) rounds it: __fmul_rn
// keeps nvcc from contracting a product into an fma, expf is the precise
// one (no fast math), and h = b + a h is one fmaf, one rounding of the exact
// b + a h, as PyTorch's addcmul computes it on the card. So the states are
// the plain version's bits. Only y's sum over n is taken in another order.
//
// The backward, from dy (B, T, D) and dh_T (B, D, N) or none, with
// lambda_t = dL/dh_t:
//
//   lambda_t = dy_t C_t + a_{t+1} lambda_{t+1}   (lambda_T-1 adds dh_T)
//   g_t      = lambda_t h_{t-1} exp(delta_t A)   (d/d(delta_t A))
//   ddelta_t = sum_n g_t A + x_t sum_n lambda_t B_t
//   dx_t     = delta_t sum_n lambda_t B_t
//   dB_t     = sum_channels lambda_t delta_t x_t
//   dC_t     = sum_channels dy_t h_t
//   dA       = sum_(b, t) g_t delta_t
//   dh0      = a_0 lambda_0
//
// the reference's reverse recurrence chained through a and b as jax.grad
// chains it (a rounding's gradient passes it unchanged), all in f32.
//
// What bounds them on an H100. The forward's bytes are delta, x and y, 12
// bytes a (b, t, channel); at Jamba's width (D = 16384, N = 16) over 2 x
// 1,100 tokens 438 MB, 0.13 ms at 3.35 TB/s. Its largest bound is issue:
// a (b, t, channel, n) costs the precise expf (about 8 instructions, one
// MUFU.EX2), the two products, the fma, three roundings to S (two
// instructions each in bf16) and y's fma, about 18 instructions; at that
// shape ~0.3 ms of the SMs' issue slots, and ~0.14 ms of the SFUs' 16
// MUFU.EX2 a clock an SM. The backward recomputes each segment's states
// (a second expf and the state update) and walks it back (a third expf,
// about twice the forward's arithmetic, and the channel sums of dB and dC),
// so its largest bound is issue too, about three times the forward's.
// Neither kernel reaches it: on an H100 80GB HBM3 at 700 W the SASS gives
// the forward 170 instructions a thread-step in bf16, a 0.37 ms bound
// against 0.83 ms taken, and the backward 479, 0.24 ms against 0.53 ms at
// 4 x 128 (tools/scan_sass_bounds.py); a thread's chain of dependent
// steps holds them.
//
// What the design does about it. Forward: one thread holds 8 of a
// channel's states in registers (a channel takes L = ceil(N / 8) lanes of a
// warp, at most 4), so delta_t x_t is formed once a lane, y_t is summed in
// the thread and across its L lanes by log2(L) shuffles, and nothing is
// recomputed per state. A block of 64 threads stages 32 steps of delta and x
// (its channels) and of B and C into shared memory with cp.async, double
// buffered: the next 32 steps land while the current ones are walked.
// B_t and C_t are read as 16-byte broadcast loads (the rows padded to 8 L
// states). With ck it writes the state every K steps. Backward: the same
// lanes, one warp a block; it walks the checkpoint segments from the last,
// staging the segment before it with cp.async, recomputes the segment's
// states into shared memory (in S: lossless, as they are S values), then
// walks it back with lambda, a_{t+1} and dA in registers. ddelta and dx are
// summed over the L lanes by shuffles. dB_t and dC_t, sums over every
// channel, are summed over the warp's channels by a butterfly that halves
// the values a thread holds at each level (15 shuffles for 16 values), and
// each block writes its partial for every step; a second kernel sums the
// blocks' partials, and dA's over the batch, in one fixed order. No float
// atomics anywhere: a call gives the same bits every time. No (B, T, D, N)
// tensor is written by either kernel. Ragged D and N are masked (zeros
// flow through the masked lanes); nothing is padded in memory.
//
// The entry points return cudaGetLastError() and launch on the caller's
// stream without synchronising; every output and the scratch are the
// caller's.

#include "common.cuh"

namespace {

constexpr int SS_THREADS = 64;  // forward: threads a block
constexpr int SS_TS = 32;       // forward: time steps a stage
constexpr int SF_NS = 8;        // forward: states a thread
constexpr int SS_NS = 8;        // backward: states a thread
constexpr int SS_NMAX = 32;     // state size at most: 4 lanes of 8
constexpr int SB_THREADS = 32;  // backward: one warp a block
constexpr int SB_KMAX = 16;     // backward: the longest segment (checkpoint interval)
constexpr unsigned FULL = 0xffffffffu;

template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<S>(v));
}

// 4 bytes global -> shared, or a zero when !ok (src-size 0: no read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// rows t0 .. t0 + ROWS - 1 of a (B, T, W) tensor's columns c0 .. c0 + COLS - 1, for
// batch row b, into dst[ROWS][COLS]; zeros at rows from tend on and past W
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_rows(float (*dst)[COLS], const float* __restrict__ src,
                                           int b, int t0, int tend, int T, int c0, int W,
                                           int tid) {
#pragma unroll 4
  for (int i = tid; i < ROWS * COLS; i += THREADS) {
    const int tt = i / COLS, cc = i - tt * COLS;
    const bool ok = t0 + tt < tend && c0 + cc < W;
    const long long g = ((long long)b * T + t0 + tt) * W + c0 + cc;
    cp_async4(&dst[tt][cc], ok ? src + g : src, ok);
  }
}

// The backward keeps a segment's states in shared memory as S values: f32, or
// a bf16 value's upper 16 bits (exact: the state is a bf16 value)
template <typename S>
struct Held {
  using type = float;
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float get(float v) { return v; }
};
template <>
struct Held<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ unsigned short put(float v) {
    return (unsigned short)(__float_as_uint(v) >> 16);
  }
  static __device__ __forceinline__ float get(unsigned short v) {
    return __uint_as_float((unsigned)v << 16);
  }
};

// NS consecutive floats of shared memory (16-byte aligned), as 16-byte loads
template <int NS>
__device__ __forceinline__ void load_states(float (&v)[NS], const float* p) {
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename S, int L>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_kernel(const float* __restrict__ delta, const float* __restrict__ x,
                          const float* __restrict__ Bp, const float* __restrict__ Cp,
                          const float* __restrict__ A, const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT, float* __restrict__ ck,
                          int T, int D, int N, int K) {
  constexpr int CH = SS_THREADS / L;  // channels a block
  constexpr int NP = SF_NS * L;       // a staged row of B or C
  __shared__ float s_d[2][SS_TS][CH];
  __shared__ float s_x[2][SS_TS][CH];
  __shared__ __align__(16) float s_B[2][SS_TS][NP];
  __shared__ __align__(16) float s_C[2][SS_TS][NP];

  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int cl = tid / L;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < D;
  const int n0 = lane * SF_NS;

  float a_c[SF_NS], h[SF_NS];
#pragma unroll
  for (int j = 0; j < SF_NS; ++j) {
    const bool ok = live && n0 + j < N;
    a_c[j] = ok ? A[(long long)c * N + n0 + j] : 0.f;
    h[j] = ok ? round_to<S>(h0[((long long)b * D + c) * N + n0 + j]) : 0.f;
  }

  const int nstage = cdiv(T, SS_TS);
  const int nK = ck != nullptr ? cdiv(T, K) : 0;
  int until_ck = 0, k = 0;  // steps to the next checkpoint, and its index
  for (int s = -1; s < nstage; ++s) {
    if (s + 1 < nstage) {  // stage s + 1; the one walked before s is free
      const int nx = (s + 1) & 1, t1 = (s + 1) * SS_TS;
      stage_rows<SS_TS, CH, SS_THREADS>(s_d[nx], delta, b, t1, T, T, c0, D, tid);
      stage_rows<SS_TS, CH, SS_THREADS>(s_x[nx], x, b, t1, T, T, c0, D, tid);
      stage_rows<SS_TS, NP, SS_THREADS>(s_B[nx], Bp, b, t1, T, T, 0, N, tid);
      stage_rows<SS_TS, NP, SS_THREADS>(s_C[nx], Cp, b, t1, T, T, 0, N, tid);
      cp_async_commit();
    }
    if (s < 0) continue;
    const int st = s & 1, t0 = s * SS_TS;
    if (s + 1 < nstage) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nt = min(SS_TS, T - t0);
#pragma unroll 1  // one step an iteration (tools/scan_sass_bounds.py counts its instructions)
    for (int tt = 0; tt < nt; ++tt) {
      if (nK && until_ck == 0) {
        if (live) {
          float* dst = ck + (((long long)b * nK + k) * D + c) * N + n0;
#pragma unroll
          for (int j = 0; j < SF_NS; ++j) {
            if (n0 + j < N) dst[j] = h[j];
          }
        }
        until_ck = K;
        ++k;
      }
      --until_ck;
      const float dl = s_d[st][tt][cl];
      const float dx = __fmul_rn(dl, s_x[st][tt][cl]);
      float Bv[SF_NS], Cv[SF_NS];
      load_states<SF_NS>(Bv, &s_B[st][tt][n0]);
      load_states<SF_NS>(Cv, &s_C[st][tt][n0]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SF_NS; ++j) {
        const float a = round_to<S>(expf(__fmul_rn(dl, a_c[j])));
        const float bb = round_to<S>(__fmul_rn(dx, Bv[j]));
        h[j] = round_to<S>(fmaf(a, h[j], bb));
        acc = fmaf(h[j], Cv[j], acc);
      }
#pragma unroll
      for (int off = L >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (lane == 0 && live) y[((long long)b * T + t0 + tt) * D + c] = acc;
    }
    __syncthreads();  // this stage is walked: the next iteration refills it
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SF_NS; ++j) {
      if (n0 + j < N) hT[((long long)b * D + c) * N + n0 + j] = h[j];
    }
  }
}

template <typename S, int L>
int launch_forward(const void* delta, const void* x, const void* Bp, const void* Cp,
                   const void* A, const void* h0, void* y, void* hT, void* ck, int B, int T,
                   int D, int N, int K, cudaStream_t stream) {
  constexpr int CH = SS_THREADS / L;
  dim3 grid(cdiv(D, CH), B);
  selective_scan_kernel<S, L><<<grid, SS_THREADS, 0, stream>>>(
      static_cast<const float*>(delta), static_cast<const float*>(x),
      static_cast<const float*>(Bp), static_cast<const float*>(Cp), static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT),
      static_cast<float*>(ck), T, D, N, K);
  return (int)cudaGetLastError();
}

template <typename S>
int forward_lanes(const void* delta, const void* x, const void* Bp, const void* Cp,
                  const void* A, const void* h0, void* y, void* hT, void* ck, int B, int T, int D,
                  int N, int K, cudaStream_t s) {
  if (N <= SF_NS) return launch_forward<S, 1>(delta, x, Bp, Cp, A, h0, y, hT, ck, B, T, D, N, K, s);
  if (N <= 2 * SF_NS) {
    return launch_forward<S, 2>(delta, x, Bp, Cp, A, h0, y, hT, ck, B, T, D, N, K, s);
  }
  return launch_forward<S, 4>(delta, x, Bp, Cp, A, h0, y, hT, ck, B, T, D, N, K, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// the lower or upper half of v[0 .. V) summed with the partner's (lane ^ off):
// the thread with `off` set keeps the upper half; the sums land in v[0 .. V/2)
template <int V>
__device__ __forceinline__ void halve(float (&v)[2 * SS_NS], int off, bool upper) {
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float send = upper ? v[i] : v[i + V / 2];
    const float keep = upper ? v[i + V / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// v[0 .. 16) (a thread's 8 dB and 8 dC terms) summed over the warp's channels
// (the lanes that share tid % L); returns how many sums this thread holds at
// v[0 ..) and the index of the first among the 16: sum i is value
// first + i
template <int L>
__device__ __forceinline__ int channel_sums(float (&v)[2 * SS_NS], int tid, int& first) {
  halve<16>(v, 16, tid & 16);
  halve<8>(v, 8, tid & 8);
  halve<4>(v, 4, tid & 4);
  if constexpr (L == 4) {
    first = ((tid >> 2) & 7) * 2;
    return 2;
  } else {
    halve<2>(v, 2, tid & 2);
    first = (tid >> 1) & 15;
    if constexpr (L == 1) {
      v[0] += __shfl_xor_sync(FULL, v[0], 1);
      return (tid & 1) ? 0 : 1;  // the two partners hold the same sum
    }
    return 1;
  }
}

template <typename S, int L>
__global__ void __launch_bounds__(SB_THREADS)
    selective_scan_bwd_kernel(const float* __restrict__ delta, const float* __restrict__ x,
                              const float* __restrict__ Bp, const float* __restrict__ Cp,
                              const float* __restrict__ A, const float* __restrict__ ck,
                              const float* __restrict__ dy, const float* __restrict__ dhT,
                              float* __restrict__ ddelta, float* __restrict__ dx,
                              float* __restrict__ part, float* __restrict__ dA_part,
                              float* __restrict__ dh0, int T, int D, int N, int K) {
  constexpr int CH = SB_THREADS / L;  // channels a block
  constexpr int NP = SS_NS * L;
  __shared__ float s_d[2][SB_KMAX][CH];
  __shared__ float s_x[2][SB_KMAX][CH];
  __shared__ float s_dy[2][SB_KMAX][CH];
  __shared__ __align__(16) float s_B[2][SB_KMAX][NP];
  __shared__ __align__(16) float s_C[2][SB_KMAX][NP];
  __shared__ typename Held<S>::type s_h[SB_KMAX][SS_NS][SB_THREADS];  // the segment's h_t

  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int cl = tid / L;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < D;
  const int n0 = lane * SS_NS;
  const int nK = cdiv(T, K);
  const long long ND = (long long)D * N;

  float a_c[SS_NS], lam[SS_NS], a_next[SS_NS], dA[SS_NS];
#pragma unroll
  for (int j = 0; j < SS_NS; ++j) {
    const bool ok = live && n0 + j < N;
    a_c[j] = ok ? A[(long long)c * N + n0 + j] : 0.f;
    lam[j] = ok && dhT != nullptr ? dhT[((long long)b * D + c) * N + n0 + j] : 0.f;
    a_next[j] = 1.f;
    dA[j] = 0.f;
  }

  for (int i = -1; i < nK; ++i) {
    if (i + 1 < nK) {  // stage segment nK - 2 - i; the one walked before i is free
      const int nx = (i + 1) & 1, t1 = (nK - 2 - i) * K;
      const int tend = min(t1 + K, T);  // rows past the segment are zeros
      stage_rows<SB_KMAX, CH, SB_THREADS>(s_d[nx], delta, b, t1, tend, T, c0, D, tid);
      stage_rows<SB_KMAX, CH, SB_THREADS>(s_x[nx], x, b, t1, tend, T, c0, D, tid);
      stage_rows<SB_KMAX, CH, SB_THREADS>(s_dy[nx], dy, b, t1, tend, T, c0, D, tid);
      stage_rows<SB_KMAX, NP, SB_THREADS>(s_B[nx], Bp, b, t1, tend, T, 0, N, tid);
      stage_rows<SB_KMAX, NP, SB_THREADS>(s_C[nx], Cp, b, t1, tend, T, 0, N, tid);
      cp_async_commit();
    }
    if (i < 0) continue;
    const int k = nK - 1 - i, st = i & 1, t0 = k * K;
    const int nt = min(K, T - t0);
    float hs[SS_NS];  // the state entering the segment
#pragma unroll
    for (int j = 0; j < SS_NS; ++j) {
      hs[j] = live && n0 + j < N ? ck[((long long)b * nK + k) * ND + (long long)c * N + n0 + j]
                                 : 0.f;
    }
    if (k > 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the segment's states, as the forward made them
    {
      float h[SS_NS];
#pragma unroll
      for (int j = 0; j < SS_NS; ++j) h[j] = hs[j];
#pragma unroll 1
      for (int tt = 0; tt < nt; ++tt) {
        const float dl = s_d[st][tt][cl];
        const float dxv = __fmul_rn(dl, s_x[st][tt][cl]);
        float Bv[SS_NS];
        load_states<SS_NS>(Bv, &s_B[st][tt][n0]);
#pragma unroll
        for (int j = 0; j < SS_NS; ++j) {
          const float a = round_to<S>(expf(__fmul_rn(dl, a_c[j])));
          const float bb = round_to<S>(__fmul_rn(dxv, Bv[j]));
          h[j] = round_to<S>(fmaf(a, h[j], bb));
          s_h[tt][j][tid] = Held<S>::put(h[j]);
        }
      }
    }

    // walked back
#pragma unroll 1
    for (int tt = nt - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float dl = s_d[st][tt][cl];
      const float xv = s_x[st][tt][cl];
      const float dyv = s_dy[st][tt][cl];
      const float dxv = __fmul_rn(dl, xv);
      float Bv[SS_NS], Cv[SS_NS], v[2 * SS_NS];
      load_states<SS_NS>(Bv, &s_B[st][tt][n0]);
      load_states<SS_NS>(Cv, &s_C[st][tt][n0]);
      float sA = 0.f, sB = 0.f;
#pragma unroll
      for (int j = 0; j < SS_NS; ++j) {
        const float hp = tt > 0 ? Held<S>::get(s_h[tt - 1][j][tid]) : hs[j];
        const float ht = Held<S>::get(s_h[tt][j][tid]);
        const float ar = expf(__fmul_rn(dl, a_c[j]));
        lam[j] = fmaf(a_next[j], lam[j], __fmul_rn(dyv, Cv[j]));
        const float g = __fmul_rn(__fmul_rn(lam[j], hp), ar);
        sA = fmaf(g, a_c[j], sA);
        sB = fmaf(lam[j], Bv[j], sB);
        dA[j] = fmaf(g, dl, dA[j]);
        v[j] = __fmul_rn(lam[j], dxv);
        v[SS_NS + j] = __fmul_rn(dyv, ht);
        a_next[j] = round_to<S>(ar);
      }
#pragma unroll
      for (int off = L >> 1; off > 0; off >>= 1) {
        sA += __shfl_xor_sync(FULL, sA, off);
        sB += __shfl_xor_sync(FULL, sB, off);
      }
      if (lane == 0 && live) {
        const long long o = ((long long)b * T + t) * D + c;
        ddelta[o] = fmaf(xv, sB, sA);
        dx[o] = __fmul_rn(dl, sB);
      }
      int first;
      const int held = channel_sums<L>(v, tid, first);
      // part (B, blocks, T, 2, N): this block's sums over its channels
      float* row = part + (((long long)b * gridDim.x + blockIdx.x) * T + t) * 2 * N;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < held) {
          const int idx = first + q;  // < 8: dB of state n0 + idx, else dC of n0 + idx - 8
          const int n = n0 + (idx & (SS_NS - 1));
          if (n < N) row[(idx >> 3) * N + n] = v[q];
        }
      }
    }
    __syncthreads();  // this segment is walked: the next iteration refills its buffers
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SS_NS; ++j) {
      if (n0 + j < N) {
        const long long o = ((long long)b * D + c) * N + n0 + j;
        dh0[o] = __fmul_rn(a_next[j], lam[j]);
        dA_part[o] = dA[j];
      }
    }
  }
}

// dB, dC (B, T, N): the blocks' partials summed in block order; dA (D, N): the
// batch rows' summed in row order
__global__ void selective_scan_bwd_sums(const float* __restrict__ part,
                                        const float* __restrict__ dA_part,
                                        float* __restrict__ dB, float* __restrict__ dC,
                                        float* __restrict__ dA, int B, int T, int D, int N,
                                        int blocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_b = (long long)T * 2 * N;
  const long long n_bc = (long long)B * per_b;
  if (i < n_bc) {
    const long long bb = i / per_b, r = i - bb * per_b;
    const float* p = part + bb * blocks * per_b + r;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < blocks; ++k) s += p[(long long)k * per_b];
    const long long t = r / (2 * N);
    const int q = (int)(r - t * 2 * N) / N, n = (int)(r - t * 2 * N) % N;
    (q == 0 ? dB : dC)[(bb * T + t) * N + n] = s;
  } else if (i < n_bc + (long long)D * N) {
    const long long e = i - n_bc;
    float s = 0.f;
    for (int bb = 0; bb < B; ++bb) s += dA_part[(long long)bb * D * N + e];
    dA[e] = s;
  }
}

template <typename S, int L>
int launch_backward(const void* delta, const void* x, const void* Bp, const void* Cp,
                    const void* A, const void* ck, const void* dy, const void* dhT, void* ddelta,
                    void* dx, void* dB, void* dC, void* dA, void* dh0, void* part, void* dA_part,
                    int B, int T, int D, int N, int K, cudaStream_t stream) {
  constexpr int CH = SB_THREADS / L;
  const int blocks = cdiv(D, CH);
  dim3 grid(blocks, B);
  selective_scan_bwd_kernel<S, L><<<grid, SB_THREADS, 0, stream>>>(
      static_cast<const float*>(delta), static_cast<const float*>(x),
      static_cast<const float*>(Bp), static_cast<const float*>(Cp), static_cast<const float*>(A),
      static_cast<const float*>(ck), static_cast<const float*>(dy),
      static_cast<const float*>(dhT), static_cast<float*>(ddelta), static_cast<float*>(dx),
      static_cast<float*>(part), static_cast<float*>(dA_part), static_cast<float*>(dh0), T, D, N,
      K);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long outs = (long long)B * T * 2 * N + (long long)D * N;
  selective_scan_bwd_sums<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(dA_part),
      static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dA), B, T, D, N,
      blocks);
  return (int)cudaGetLastError();
}

template <typename S>
int backward_lanes(const void* delta, const void* x, const void* Bp, const void* Cp,
                   const void* A, const void* ck, const void* dy, const void* dhT, void* ddelta,
                   void* dx, void* dB, void* dC, void* dA, void* dh0, void* part, void* dA_part,
                   int B, int T, int D, int N, int K, cudaStream_t s) {
  if (N <= SS_NS) {
    return launch_backward<S, 1>(delta, x, Bp, Cp, A, ck, dy, dhT, ddelta, dx, dB, dC, dA, dh0,
                                 part, dA_part, B, T, D, N, K, s);
  }
  if (N <= 2 * SS_NS) {
    return launch_backward<S, 2>(delta, x, Bp, Cp, A, ck, dy, dhT, ddelta, dx, dB, dC, dA, dh0,
                                 part, dA_part, B, T, D, N, K, s);
  }
  return launch_backward<S, 4>(delta, x, Bp, Cp, A, ck, dy, dhT, ddelta, dx, dB, dC, dA, dh0,
                               part, dA_part, B, T, D, N, K, s);
}

bool scan_dims_ok(int B, int T, int D, int N) {
  return B >= 1 && T >= 1 && D >= 1 && N >= 1 && N <= SS_NMAX && B <= 65535;
}

}  // namespace

extern "C" {

// dtype codes (of the state's type S): 0 = float32, 1 = bfloat16.

// y, h_T = the selective scan of delta, x (B, T, D), Bp, Cp (B, T, N), A (D, N)
// from h0 (B, D, N), and, when ck is not null, the state entering every K-th
// step into ck (B, ceil(T/K), D, N); every operand and output float32 and
// contiguous.
int lr_selective_scan(int dt, const void* delta, const void* x, const void* Bp, const void* Cp,
                      const void* A, const void* h0, void* y, void* hT, void* ck, int B, int T,
                      int D, int N, int K, void* stream) {
  if (!scan_dims_ok(B, T, D, N) || (ck != nullptr && K < 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return forward_lanes<float>(delta, x, Bp, Cp, A, h0, y, hT, ck, B, T, D, N, K, s);
  if (dt == 1) {
    return forward_lanes<__nv_bfloat16>(delta, x, Bp, Cp, A, h0, y, hT, ck, B, T, D, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Scratch the backward needs, in floats: the blocks' partial sums of dB and
// dC (B, blocks, T, 2, N) and the batch rows' of dA (B, D, N).
long long lr_selective_scan_bwd_scratch(int B, int T, int D, int N) {
  const int L = N <= SS_NS ? 1 : (N <= 2 * SS_NS ? 2 : 4);
  const long long blocks = cdiv(D, SB_THREADS / L);
  return (long long)B * blocks * T * 2 * N + (long long)B * D * N;
}

// ddelta, dx (B, T, D), dB, dC (B, T, N), dA (D, N), dh0 (B, D, N): the
// gradient of the scan from the checkpoints ck (B, ceil(T/K), D, N) its forward
// kept, given dy (B, T, D) and dh_T (B, D, N, or null for none); scratch
// holds lr_selective_scan_bwd_scratch floats. 1 <= K <= 16.
int lr_selective_scan_bwd(int dt, const void* delta, const void* x, const void* Bp,
                          const void* Cp, const void* A, const void* ck, const void* dy,
                          const void* dhT, void* ddelta, void* dx, void* dB, void* dC, void* dA,
                          void* dh0, void* scratch, int B, int T, int D, int N, int K,
                          void* stream) {
  if (!scan_dims_ok(B, T, D, N) || K < 1 || K > SB_KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  float* dA_part = part + (lr_selective_scan_bwd_scratch(B, T, D, N) - (long long)B * D * N);
  if (dt == 0) {
    return backward_lanes<float>(delta, x, Bp, Cp, A, ck, dy, dhT, ddelta, dx, dB, dC, dA, dh0,
                                 part, dA_part, B, T, D, N, K, s);
  }
  if (dt == 1) {
    return backward_lanes<__nv_bfloat16>(delta, x, Bp, Cp, A, ck, dy, dhT, ddelta, dx, dB, dC,
                                         dA, dh0, part, dA_part, B, T, D, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
