// Hopper (sm_90a) kernel for Mamba's state recurrence from a given state:
// the selective scan of the serving prefill and of every decode step.
//
// It replaces no Pallas kernel: the JAX package computes this recurrence in
// XLA, as the sequential lax.scan of mamba_mix's state branch
//   src/repro/models/ssm.py::mamba_mix (the scan at line 185)
// whose docstring names what it re-expresses for the TPU: the CUDA
// selective scan of Mamba. This is that kernel, in the reference's order:
//
//   a_t = exp(delta_t A)          rounded to the state's type S
//   b_t = (delta_t x_t) B_t       rounded to S
//   h_t = b_t + a_t h_{t-1}       in f32, rounded to S (h_{-1} = h0 in S)
//   y_t = sum_n h_t,n C_t,n       in f32
//
// delta, x (B, T, D) f32; Bp, Cp (B, T, N) f32; A (D, N) f32; h0 (B, D, N)
// f32. Out: y (B, T, D) f32 and h_T (B, D, N) f32. S is float32 or
// bfloat16 (the model's compute dtype). Every product and sum is rounded
// where the plain version (kernels/ref.py::selective_scan_ref) rounds it:
// __fmul_rn / __fadd_rn keep nvcc from contracting them into an fma, expf
// is the precise one (no fast math), and h = b + a h is one fmaf, one
// rounding of the exact b + a h, as PyTorch's addcmul computes it on the
// card (with S = bfloat16 the product of two bf16 values is exact in f32,
// so there any order of the two gives the same bits). Only y's sum over n
// is taken in another order (a butterfly over the N lanes).
//
// What bounds it on an H100. The bytes: delta, x and y are 12 bytes a
// (b, t, channel), the rest is small; at Jamba's width (D = 16384, N = 16)
// over 2 x 1,100 tokens that is 438 MB, 0.13 ms at 3.35 TB/s. The work,
// about 7 operations a (b, t, channel, n), is 0.06 ms at the CUDA cores'
// 67 TF. What it meets first is instruction throughput: a thread spends
// about 40 instructions a step (the precise expf, three roundings to S, the
// shuffle sum of y, the shared-memory reads), about 0.9 ms of the SMs'
// instruction slots at that shape. The recurrence itself is sequential in T, but
// its dependent chain a step (one fma and a rounding) is short beside that.
//
// What the design does about it: one thread a (b, channel, n), so the card
// runs B x D x N independent chains (524,288 at the shape above), the state
// in a register for all of T. N lanes of a warp hold one channel's states
// (N rounded up to a power of two, at most 32) and reduce y_t by shuffles;
// a block holds up to 32 channels. The block stages 32 time steps of
// delta, x (its channels), B and C into shared memory with coalesced loads
// before it walks them, so the chain waits on no global load, and writes
// the chunk's y back as whole rows. The (B, T, D, N) decay and input terms
// are never written to memory. Ragged D and N are masked; nothing is
// padded.
//
// The entry point returns cudaGetLastError() and launches on the caller's
// stream without synchronising; y and h_T are the caller's.

#include "common.cuh"

namespace {

constexpr int SS_THREADS = 256;  // threads a block at most
constexpr int SS_CH = 32;        // channels a block at most
constexpr int SS_TS = 32;        // time steps staged a chunk
constexpr int SS_NMAX = 32;      // state size at most: one warp a channel

template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<S>(v));
}

template <typename S>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_kernel(const float* __restrict__ delta, const float* __restrict__ x,
                          const float* __restrict__ Bp, const float* __restrict__ Cp,
                          const float* __restrict__ A, const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT, int T, int D, int N,
                          int np_log2) {
  __shared__ float s_delta[SS_TS][SS_CH];
  __shared__ float s_x[SS_TS][SS_CH];
  __shared__ float s_y[SS_TS][SS_CH];
  __shared__ float s_B[SS_TS][SS_NMAX];
  __shared__ float s_C[SS_TS][SS_NMAX];

  const int NP = 1 << np_log2;           // lanes a channel
  const int CH = blockDim.x >> np_log2;  // channels a block
  const int tid = threadIdx.x;
  const int n = tid & (NP - 1);
  const int cl = tid >> np_log2;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const bool live = c < D && n < N;
  const long long row0 = (long long)blockIdx.y * T;  // row (b, 0) of delta, x, y, Bp, Cp

  const float a_cn = live ? A[(long long)c * N + n] : 0.f;
  const long long hi = ((long long)blockIdx.y * D + c) * N + n;
  float h = live ? round_to<S>(h0[hi]) : 0.f;

  for (int t0 = 0; t0 < T; t0 += SS_TS) {
    const int nt = min(SS_TS, T - t0);
    __syncthreads();  // the previous chunk's y is written out
    for (int i = tid; i < nt * CH; i += blockDim.x) {
      const int tt = i / CH, cc = i - tt * CH;
      const bool ok = c0 + cc < D;
      const long long g = (row0 + t0 + tt) * D + c0 + cc;
      s_delta[tt][cc] = ok ? delta[g] : 0.f;
      s_x[tt][cc] = ok ? x[g] : 0.f;
    }
    for (int i = tid; i < nt * NP; i += blockDim.x) {
      const int tt = i >> np_log2, nn = i & (NP - 1);
      const bool ok = nn < N;
      const long long g = (row0 + t0 + tt) * N + nn;
      s_B[tt][nn] = ok ? Bp[g] : 0.f;
      s_C[tt][nn] = ok ? Cp[g] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float dl = s_delta[tt][cl];
      const float a = round_to<S>(expf(__fmul_rn(dl, a_cn)));
      const float b = round_to<S>(__fmul_rn(__fmul_rn(dl, s_x[tt][cl]), s_B[tt][n]));
      h = round_to<S>(fmaf(a, h, b));
      float p = live ? __fmul_rn(h, s_C[tt][n]) : 0.f;
      for (int off = NP >> 1; off > 0; off >>= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      }
      if (n == 0) s_y[tt][cl] = p;
    }
    __syncthreads();
    for (int i = tid; i < nt * CH; i += blockDim.x) {
      const int tt = i / CH, cc = i - tt * CH;
      if (c0 + cc < D) y[(row0 + t0 + tt) * D + c0 + cc] = s_y[tt][cc];
    }
  }
  if (live) hT[hi] = h;
}

template <typename S>
int launch_selective_scan(const void* delta, const void* x, const void* Bp, const void* Cp,
                          const void* A, const void* h0, void* y, void* hT, int B, int T, int D,
                          int N, cudaStream_t stream) {
  int np_log2 = 0;
  while ((1 << np_log2) < N) ++np_log2;
  const int NP = 1 << np_log2;
  const int CH = SS_THREADS / NP < SS_CH ? SS_THREADS / NP : SS_CH;
  dim3 grid(cdiv(D, CH), B);
  selective_scan_kernel<S><<<grid, CH * NP, 0, stream>>>(
      static_cast<const float*>(delta), static_cast<const float*>(x),
      static_cast<const float*>(Bp), static_cast<const float*>(Cp), static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT), T, D, N,
      np_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes (of the state's type S): 0 = float32, 1 = bfloat16.

// y, h_T = the selective scan of delta, x (B, T, D), Bp, Cp (B, T, N), A (D, N)
// from h0 (B, D, N); every operand and output float32 and contiguous.
int lr_selective_scan(int dt, const void* delta, const void* x, const void* Bp, const void* Cp,
                      const void* A, const void* h0, void* y, void* hT, int B, int T, int D,
                      int N, void* stream) {
  if (B < 1 || T < 1 || D < 1 || N < 1 || N > SS_NMAX || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return launch_selective_scan<float>(delta, x, Bp, Cp, A, h0, y, hT, B, T, D, N, s);
  if (dt == 1) {
    return launch_selective_scan<__nv_bfloat16>(delta, x, Bp, Cp, A, h0, y, hT, B, T, D, N, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
