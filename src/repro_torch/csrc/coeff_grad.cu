// Hopper (sm_90a) kernel for the coefficient-gradient projection C = A^T B.
//
// It replaces the Pallas TPU kernel of the JAX package
//   atb  <- src/repro/kernels/coeff_grad.py::atb (line 42) / _atb_kernel (line 22)
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
// (M Ka + M Kb + Ka Kb) elements. In f32, at every shape of an llm-100m
// round (M = 512; (Ka, Kb) = (320, 320), (640, 160), (160, 160),
// (2560, 160), (8192, 160)), it is bound by operations at the CUDA cores'
// 67 TF: 0.39-20 us a call against 0.23-6.7 us for the bytes. In bf16 the
// tensor-core rate makes the bytes the bound. At those sizes one call is a
// few microseconds of work, so what a call costs beyond that (the launch,
// the latency of the first loads, the split partials' round trip through
// memory) decides its time; at the large shapes, the rate at which mma.sync
// takes tf32 products and the splitting of f32 operands into them.
//
// What the design does about it: ONE launch a call, grid (Ka tiles, Kb
// tiles, M splits x G), and the products on the tensor cores.
// - Each block owns a 64 x 32 tile of C and one range of M. It stages
//   32-row steps of A's tile columns and B's tile columns (both row-major
//   along Ka / Kb, so the copies coalesce) through a four-stage cp.async
//   ring, three steps in flight. 16-byte copies where the rows are whole
//   16-byte vectors and the operands are 16-byte aligned; an element-load
//   variant otherwise (the wrapper picks, the launcher checks it).
// - The products are mma.sync m16n8k8 in split precision (3xTF32: each f32
//   operand is a tf32 "big" part plus a "small" remainder, and big*big +
//   big*small + small*big keeps about 21 bits; plain TF32 would miss the
//   1e-4 tolerance of an f32 sum). A bf16 operand is exact in tf32 and needs
//   only the big pass. Four warps of 32 x 16 each.
// - A^T is the MMA's A operand: its fragment element (ka, m) is A[m][ka],
//   so the fragment reads are column reads of the staged [m][ka] tile, and
//   B's "col" fragment (m, kb) is B[m][kb]. In one read a warp's lanes take
//   rows m = m0 + lt (lt = lane % 4) and columns c0 + lg (lg = lane / 4).
//   Rows are padded by 8 elements: in f32 a row is then 8 banks on from the
//   one before (72 and 40 floats), so the four rows' eight columns fall in
//   32 different banks; in bf16 4 banks on for A (72 halves = 36 words:
//   four rows of four words each) and 20 for B (40 halves), again distinct
//   words. The padded rows stay whole 16-byte vectors for cp.async.
// - The tensor cores round their f32 sums toward zero: each 32-row step is
//   summed from zero and added to the accumulator with a rounded f32 add, so
//   the bias does not grow with M (checked at M = 8192).
// - M is split only while the tile grid is under about 1.5 waves, and only
//   so far that the splits' partials (splits x Ka x Kb floats) stay within
//   twice the operands' elements (kernels/coeff_grad.py::atb_plan, from the
//   shapes alone). A block of a split call writes its f32 partial tile to
//   the workspace and takes a ticket on its tile's counter (a slot of the
//   wrappers' counter pool); the block that takes the last ticket adds the
//   partials in split order, rounds once, writes C and puts the counter back
//   to 0. No atomics on data and no second kernel: the sum does not depend
//   on which block came last, so two calls give the same bits.
// Ragged M, Ka and Kb (ranks 160 / 320, Ka 8192 or 152064) are masked in the
// loads and stores; no operand is padded.
//
// The entry point takes a leading batch count G (stacked factors), returns
// cudaGetLastError(), and launches on the caller's stream without
// synchronising. Buffers (C, the workspace, the counters) are the caller's.

#include "common.cuh"

namespace {

constexpr int AT_KA = 64, AT_KB = 32;            // C tile (Ka x Kb) of a block
constexpr int AT_M = 32;                         // rows of M a step
constexpr int AT_WKA = 32, AT_WKB = 16;          // warp tile
constexpr int AT_MT = AT_WKA / 16, AT_NT = AT_WKB / 8;  // m16n8k8 tiles a warp
constexpr int AT_WB = AT_KB / AT_WKB;            // warps across Kb
constexpr int AT_THREADS = 32 * (AT_KA / AT_WKA) * AT_WB;
constexpr int AT_STAGES = 4;                     // cp.async ring (dynamic shared memory)
constexpr int AT_PAD = 8;                        // elements a staged row is padded by
constexpr int AT_AP = AT_KA + AT_PAD, AT_BP = AT_KB + AT_PAD;  // row pitches

// shared memory of a block: the ring's A and B tiles
template <typename T>
__host__ __device__ constexpr int at_smem_bytes() {
  return AT_STAGES * AT_M * (AT_AP + AT_BP) * (int)sizeof(T);
}

// C's tile for the block's range of M: with one split, rounded into C;
// otherwise the f32 partial into `part`, and the last block of the tile
// adds the partials.
template <typename T, bool VEC>
__global__ void __launch_bounds__(AT_THREADS)
atb_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
           float* __restrict__ part, unsigned* __restrict__ counters, int M, int Ka, int Kb,
           int mc, int nsplit) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
  static_assert(AT_AP * sizeof(T) % 16 == 0 && AT_BP * sizeof(T) % 16 == 0, "16-byte rows");
  extern __shared__ __align__(16) unsigned char at_smem[];
  T (*As)[AT_M * AT_AP] = reinterpret_cast<T (*)[AT_M * AT_AP]>(at_smem);  // [stage][m][ka]
  T (*Bs)[AT_M * AT_BP] = reinterpret_cast<T (*)[AT_M * AT_BP]>(         // [stage][m][kb]
      at_smem + AT_STAGES * AT_M * AT_AP * sizeof(T));
  __shared__ unsigned ticket;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lg = lane / 4, lt = lane % 4;  // the mma fragments' group and thread
  const int wa = (warp / AT_WB) * AT_WKA, wb = (warp % AT_WB) * AT_WKB;
  const int a0 = blockIdx.x * AT_KA, b0 = blockIdx.y * AT_KB;
  const int g = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int m0 = split * mc, mend = min(M, m0 + mc);
  A += (size_t)g * M * Ka;
  B += (size_t)g * M * Kb;

  // rows [mt, mt + AT_M) of this split into stage `st`; past the split, Ka
  // or Kb: zeros. With VEC a 16-byte chunk is wholly inside or outside,
  // since Ka and Kb are whole vectors.
  auto stage = [&](int st, int t) {
    const int mt = m0 + t * AT_M;
    if constexpr (VEC) {
      for (int c = tid; c < AT_M * AT_KA / V; c += AT_THREADS) {
        const int m = c / (AT_KA / V), q = (c % (AT_KA / V)) * V;
        const bool ok = mt + m < mend && a0 + q < Ka;
        cp_async16(&As[st][m * AT_AP + q], ok ? A + (size_t)(mt + m) * Ka + a0 + q : A, ok);
      }
      for (int c = tid; c < AT_M * AT_KB / V; c += AT_THREADS) {
        const int m = c / (AT_KB / V), q = (c % (AT_KB / V)) * V;
        const bool ok = mt + m < mend && b0 + q < Kb;
        cp_async16(&Bs[st][m * AT_BP + q], ok ? B + (size_t)(mt + m) * Kb + b0 + q : B, ok);
      }
    } else {
      for (int i = tid; i < AT_M * AT_KA; i += AT_THREADS) {
        const int m = i / AT_KA, k = i % AT_KA;
        As[st][m * AT_AP + k] = (mt + m < mend && a0 + k < Ka)
                                    ? A[(size_t)(mt + m) * Ka + a0 + k] : from_f32<T>(0.f);
      }
      for (int i = tid; i < AT_M * AT_KB; i += AT_THREADS) {
        const int m = i / AT_KB, k = i % AT_KB;
        Bs[st][m * AT_BP + k] = (mt + m < mend && b0 + k < Kb)
                                    ? B[(size_t)(mt + m) * Kb + b0 + k] : from_f32<T>(0.f);
      }
    }
  };

  float acc[AT_MT][AT_NT][4];
#pragma unroll
  for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
    for (int j = 0; j < AT_NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  const int nsteps = cdiv(mend - m0, AT_M);
#pragma unroll
  for (int t = 0; t < AT_STAGES - 1; ++t) {
    if (t < nsteps) stage(t, t);
    cp_async_commit();
  }
  constexpr bool EXACT = sizeof(T) == 2;  // bf16: exact in tf32
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<AT_STAGES - 2>();  // step t has landed
    __syncthreads();                 // ... for every thread, and step t - 1 is done
    if (t + AT_STAGES - 1 < nsteps) stage((t + AT_STAGES - 1) % AT_STAGES, t + AT_STAGES - 1);
    cp_async_commit();
    // fragment bases: row m = lt of the step, column ka (kb) = lg of the warp tile
    const T* as = As[t % AT_STAGES] + lt * AT_AP + wa + lg;
    const T* bs = Bs[t % AT_STAGES] + lt * AT_BP + wb + lg;
    // the step summed from zero, then added to acc with a rounded f32 add
    float step[AT_MT][AT_NT][4];
#pragma unroll
    for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
      for (int j = 0; j < AT_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) step[i][j][r] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < AT_M; kk += 8) {
      uint32_t ab[AT_MT][4], as_[AT_MT][4], bb[AT_NT][2], bs_[AT_NT][2];
#pragma unroll
      for (int i = 0; i < AT_MT; ++i) {
        // the A fragment of A^T: (ka lg, m lt), (ka lg + 8, m lt), (lg, lt + 4), (lg + 8, lt + 4)
        const T* a = as + kk * AT_AP + 16 * i;
        split_tf32_rhu<EXACT>(to_f32(a[0]), ab[i][0], as_[i][0]);
        split_tf32_rhu<EXACT>(to_f32(a[8]), ab[i][1], as_[i][1]);
        split_tf32_rhu<EXACT>(to_f32(a[4 * AT_AP]), ab[i][2], as_[i][2]);
        split_tf32_rhu<EXACT>(to_f32(a[4 * AT_AP + 8]), ab[i][3], as_[i][3]);
      }
#pragma unroll
      for (int j = 0; j < AT_NT; ++j) {
        // the B fragment: (m lt, kb lg), (m lt + 4, kb lg)
        const T* b = bs + kk * AT_BP + 8 * j;
        split_tf32_rhu<EXACT>(to_f32(b[0]), bb[j][0], bs_[j][0]);
        split_tf32_rhu<EXACT>(to_f32(b[4 * AT_BP]), bb[j][1], bs_[j][1]);
      }
#pragma unroll
      for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
        for (int j = 0; j < AT_NT; ++j) {
          // the small terms first, then big * big
          if constexpr (!EXACT) {
            mma_tf32(step[i][j], as_[i], bb[j]);
            mma_tf32(step[i][j], ab[i], bs_[j]);
          }
          mma_tf32(step[i][j], ab[i], bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
      for (int j = 0; j < AT_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += step[i][j][r];
      }
    }
  }
  cp_async_wait<0>();
  // this thread's outputs: rows ka = a0 + wa + 16 i + lg (+ 8), columns
  // kb = b0 + wb + 8 j + 2 lt (+ 1)
  const size_t per_g = (size_t)Ka * Kb;
  T* cg = C + g * per_g;
  float* pg = part + (size_t)g * nsplit * per_g;  // [split][Ka][Kb]
  const int ar = a0 + wa + lg, bc = b0 + wb + 2 * lt;
#pragma unroll
  for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ka = ar + 16 * i + 8 * h;
      if (ka >= Ka) continue;
#pragma unroll
      for (int j = 0; j < AT_NT; ++j) {
        const int kb = bc + 8 * j;
        if (kb >= Kb) continue;
        const float c0 = acc[i][j][2 * h], c1 = acc[i][j][2 * h + 1];
        if (nsplit == 1) {
          store2(cg + (size_t)ka * Kb + kb, c0, c1, Kb - kb, VEC);
        } else {
          store2(pg + split * per_g + (size_t)ka * Kb + kb, c0, c1, Kb - kb, VEC);
        }
      }
    }
  }
  if (nsplit == 1) return;
  unsigned* cnt = counters + ((size_t)g * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  __syncthreads();
  if (tid == 0) ticket = take_ticket(cnt);
  __syncthreads();
  if (ticket != (unsigned)nsplit - 1) return;
  if (tid == 0) *cnt = 0u;  // ready for the next call on this slot
  // the splits in order (the accumulators are free again), every load of a
  // split in flight at once: 8-byte pairs for a tile wholly inside C
#pragma unroll
  for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
    for (int j = 0; j < AT_NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  if (VEC && a0 + AT_KA <= Ka && b0 + AT_KB <= Kb) {
    const float* p0 = pg + (size_t)ar * Kb + bc;
#pragma unroll 2
    for (int q = 0; q < nsplit; ++q) {
      const float* pq = p0 + q * per_g;
#pragma unroll
      for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < AT_NT; ++j) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                pq + (size_t)(16 * i + 8 * h) * Kb + 8 * j));
            acc[i][j][2 * h] += v.x;
            acc[i][j][2 * h + 1] += v.y;
          }
        }
      }
    }
  } else {
    for (int q = 0; q < nsplit; ++q) {
      const float* pq = pg + q * per_g;
#pragma unroll
      for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ka = ar + 16 * i + 8 * h;
#pragma unroll
          for (int j = 0; j < AT_NT; ++j) {
            const int kb = bc + 8 * j;
            // loads from a safe address where outside, so none waits on a branch
            const bool ok0 = ka < Ka && kb < Kb, ok1 = ka < Ka && kb + 1 < Kb;
            const float v0 = __ldcg(ok0 ? pq + (size_t)ka * Kb + kb : pq);
            const float v1 = __ldcg(ok1 ? pq + (size_t)ka * Kb + kb + 1 : pq);
            acc[i][j][2 * h] += ok0 ? v0 : 0.f;
            acc[i][j][2 * h + 1] += ok1 ? v1 : 0.f;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < AT_MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ka = ar + 16 * i + 8 * h;
      if (ka >= Ka) continue;
#pragma unroll
      for (int j = 0; j < AT_NT; ++j) {
        const int kb = bc + 8 * j;
        if (kb >= Kb) continue;
        store2(cg + (size_t)ka * Kb + kb, acc[i][j][2 * h], acc[i][j][2 * h + 1], Kb - kb, VEC);
      }
    }
  }
}

// The launch of one call, after checking the plan the wrapper passes (rows
// per split, vector variant) against the shapes, the pointers, the
// workspace and the counters: a plan that does not fit is refused, never
// patched up here.
template <typename T>
int launch_atb(const void* A_, const void* B_, void* C_, void* work, long long work_floats,
               void* counters, int G, int M, int Ka, int Kb, int mc, int vec,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (mc < 1) return (int)cudaErrorInvalidValue;
  const int nsplit = cdiv(M, mc);
  const long long tiles = (long long)G * cdiv(Ka, AT_KA) * cdiv(Kb, AT_KB);
  const long long need = nsplit > 1 ? (long long)G * nsplit * Ka * Kb : 0;
  if ((nsplit > 1 && (mc % AT_M != 0 || counters == nullptr || tiles > COUNTER_INTS)) ||
      (long long)G * nsplit > 65535 || cdiv(Kb, AT_KB) > 65535 || need > work_floats ||
      (vec && !(aligned16(A_) && aligned16(B_) && Ka % V == 0 && Kb % V == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  T* C = static_cast<T*>(C_);
  float* part = static_cast<float*>(work);
  unsigned* cnt = static_cast<unsigned*>(counters);
  constexpr int smem = at_smem_bytes<T>();  // above 48 KB in f32: opted in once
  static const bool opted_in =
      cudaFuncSetAttribute(atb_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess &&
      cudaFuncSetAttribute(atb_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess;
  (void)opted_in;  // a refused opt-in shows as the launch's error
  dim3 grid(cdiv(Ka, AT_KA), cdiv(Kb, AT_KB), G * nsplit);
  if (vec) {
    atb_kernel<T, true><<<grid, AT_THREADS, smem, stream>>>(A, B, C, part, cnt, M, Ka, Kb, mc,
                                                            nsplit);
  } else {
    atb_kernel<T, false><<<grid, AT_THREADS, smem, stream>>>(A, B, C, part, cnt, M, Ka, Kb, mc,
                                                             nsplit);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// C = A^T B.  A (G, M, Ka), B (G, M, Kb), C (G, Ka, Kb), all in dtype dt.
// The plan comes from the wrapper (kernels/coeff_grad.py::atb_plan): mc =
// rows of M per split, vec = 16-byte copies of A and B; work holds
// work_floats floats (the splits' partials) and counters the call's zeroed
// ticket slot (null when M is not split).
int lr_atb(int dt, const void* A, const void* B, void* C, void* work, long long work_floats,
           void* counters, int G, int M, int Ka, int Kb, int mc, int vec, void* stream) {
  if (G < 1 || M < 1 || Ka < 1 || Kb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) {
    return launch_atb<float>(A, B, C, work, work_floats, counters, G, M, Ka, Kb, mc, vec, s);
  }
  if (dt == 1) {
    return launch_atb<__nv_bfloat16>(A, B, C, work, work_floats, counters, G, M, Ka, Kb, mc,
                                     vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
