// Hopper (sm_90a) kernels for the low-rank bottleneck chain y = ((x U) S) V^T.
//
// They replace the two Pallas TPU kernels of the JAX package:
//   xus  <- src/repro/kernels/lowrank_matmul.py::xus / _xus_kernel (line 58)
//   avt  <- src/repro/kernels/lowrank_matmul.py::avt / _avt_kernel (line 103)
// and compute what those compute: x.U accumulated in f32, S applied in f32 to
// the f32 accumulator, one rounding to the working type at A; A V^T
// accumulated in f32 with one rounding at y.
//
// xus. The TPU kernel kept a (bm, R) f32 accumulator and the whole (R, R) S
// in VMEM and walked K along a sequential grid axis. Here S alone (256 KB in
// f32 at R = 256) exceeds a block's shared memory, blocks run in no order,
// and the port's two paths put xus on the two sides of the roofline. So xus
// has two routes, and the wrapper's plan (kernels/lowrank_matmul.py,
// xus_plan) picks the route, the K splits and the workspace from the shapes
// alone.
//
// "stream" (M <= 16: serving decode) is bound by the bytes of U: a Qwen2-7B
// decode call reads 0.46-9.7 MB of U at 2-8 FLOPs a byte, 0.14-2.9 us at
// 3.35 TB/s. What is left above that is latency, so it is ONE launch, grid
// (64-column tiles, K splits, G):
// - each block streams its (K split x 64 columns) slice of U with 16-byte
//   loads, neighbouring threads on neighbouring addresses, 8 loads a thread
//   in flight (32 KB a block), against the x rows staged in shared memory,
//   and writes its split's partial to the workspace;
// - the block that arrives last at its column tile (a ticket: an atomic add
//   with release and acquire semantics) adds the partials in split order,
//   read with __ldcg because L1 is not coherent across SMs, into the f32
//   x.U. Without S it rounds once and writes its columns of A. With S it
//   multiplies those columns by the matching rows of S: with one column
//   tile that is A, rounded once; otherwise the last column tile adds the
//   tiles' products in tile order and rounds once. With one split the block
//   finishes alone. No sum depends on which block came last;
// - each thread accumulates x.U in f32 FMAs over its rows of U; the sums
//   above that (the warps, the splits, the products with S, the column
//   tiles) are taken in f64 from f32 values, x.U rounded to f32 before S.
//   At a Qwen2-7B shape with an unscaled S an all-f32 order of those sums
//   landed further from cuBLAS's f32 product than the card tests' 1e-5
//   (cuBLAS is itself 1.6e-5 from the exact product there);
// - the tickets live in a counter buffer owned by the wrapper, one slot per
//   stream and per graph capture, zeroed once and put back to 0 by the last
//   block. A per-call memset would add a device operation to every call; a
//   slot per stream keeps concurrent calls apart; a CUDA graph's replay
//   re-runs kernels that leave their counters at 0 again;
// - the finisher stages its tile's rows of S in shared memory by cp.async
//   while it sums the partials (where they fit in 32 KB);
// - loads that may fall outside the data read a safe address and drop the
//   value instead of branching: a load under a branch waits for the ones
//   before it, and the finisher's chain of round trips is the route's cost.
//
// "tiled" (M > 16: training at M = 512 in f32, serving prefill) is bound by
// operations. The CUDA cores' 67 TF are the card's rate for full f32
// products and plain TF32 (10-bit mantissas) would miss the 1e-4 tolerance
// of an f32 sum, so the products run on the tensor cores in split precision
// (3xTF32: each f32 operand is a tf32 "big" part plus a tf32 "small"
// remainder, and big*big + big*small + small*big keeps about 22 bits; a
// bf16 operand is exact in tf32 and needs no small part):
// - mma.sync m16n8k8 on 64 x 32 block tiles of four 32 x 16 warp tiles
//   (small tiles: M = 512 with R = 160 or 320 makes only 40-80 of them);
//   32-deep K steps of x and U staged by 16-byte cp.async into a four-stage
//   ring (57 KB of shared memory), three steps in flight, since a step's
//   products take far less time than its loads;
// - the tensor cores round their f32 sums toward zero: each K step is summed
//   from zero and added to the accumulator with a rounded f32 add, so the
//   bias does not grow with K;
// - K is split only where the tile grid is under about 1.5 waves (200
//   blocks). Each split writes an f32 partial, and the last split block of
//   a tile (a ticket, as above) adds them in split order. Without S that sum
//   is rounded once into A: one launch. With S it is the f32 x.U, and a
//   second launch of the same kernel multiplies it by S (R split the same
//   way) and rounds once into A: two launches.
//
// No float atomics anywhere: two calls at equal inputs give the same bits.
// Ragged M, K and R are masked inside the kernels. A U (or x) that is not
// 16-byte aligned, or whose rows are not whole 16-byte vectors, takes the
// same kernels with element loads (the wrapper picks the variant, the
// launcher checks it); no operand is padded.
// (History: the first xus summed the splits in its S epilogue, one thread
// walking every split, and was 2.5-5.5x slower than cuBLAS's at M = 4.)
//
// avt. The TPU kernel held a (bm, bn) block of y and contracted all of R in
// one dot. Here the contraction is the rank (at most 320 on the port's
// paths), short enough that no route splits it: ONE launch a call, no
// workspace, no counters. The wrapper's plan (avt_plan) picks the route and
// its sizes from the shapes alone.
//
// "stream" (M <= 16: serving decode) is bound by the bytes of V: a Qwen2-7B
// decode call reads 0.06-78 MB of V at 2-8 FLOPs a byte, 0.02-24 us at
// 3.35 TB/s. What is left above that is latency, so a warp has every load
// of V it makes in flight at once and starts from it:
// - a warp owns a few rows of V and the outputs of up to 4 rows of A in
//   each. The lanes of a row read neighbouring 16-byte pieces, 8 elements a
//   lane a pass (one piece in bf16, two in f32): at R = 256 in bf16 one load
//   instruction of a warp is a whole row; narrower rows share a warp
//   (R = 64: 8 lanes a row, 4 rows an instruction). A group of lanes owns 4
//   rows and a block is 4 warps (on the card 4 beat 8 for both at every
//   decode shape). Every load of V is issued before the first product, and
//   V is marked evict-first (__ldcs);
// - each lane loads its pieces of the rows of A straight into registers
//   (from L1 / L2 while V is on its way): no shared memory, no barrier, no
//   integer division in the loads;
// - the warp's rows x (up to) 4 f32 sums leave the lanes by one transposed
//   butterfly: at each xor step a lane keeps half of its sums, so 16
//   outputs take 15 shuffles, not 16 x 5, in a fixed order;
// - M > 4 runs as blocks of 4 rows of A, neighbours in the grid that read
//   the same rows of V together (all but the first from L2): a block that
//   held 16 rows' sums needed 172 registers and ran slower on the card;
//
// "tiled" (M > 16: training at M = 512 in f32, serving prefill) is bound by
// operations: 67 TF of f32 products at every llm-100m round shape. So the
// products run on the tensor cores in 3xTF32 (the small part unrounded, as
// atb), on xus's tiles: mma.sync m16n8k8 on 64 x 32 tiles of y, four 32 x 16
// warp tiles, 32-deep R steps of A's and V's rows through the four-stage
// cp.async ring. V, row-major (N, R), is the MMA's "col" B operand as it
// stands (b[r][n] = V[n][r]), so both tiles are staged [row][r], no
// transpose. A row pitch of 32 + one 16-byte vector (36 floats; 40 bf16 =
// 20 words) puts a warp's fragment reads of either tile, lanes (row lg,
// column lt), in 32 distinct banks (lg * 4 + lt; lg * 20 + lt / 2, pairs
// of lanes sharing a word) and keeps the rows whole vectors for cp.async.
// Each R step is summed from zero and added to the total with a rounded
// f32 add, as xus does. R <= 320 is at most 10 steps and the smallest round
// shape (640 x 320) makes 160 tiles: nothing to split.
// Both routes mask ragged M, N and R; an A or V that is not 16-byte aligned,
// or rows that are not whole 16-byte vectors, take the same kernels with
// element loads (the wrapper picks the variant, the launcher checks it).
//
// Every entry point takes a leading batch count G (stacked factors, one
// grid axis), returns cudaGetLastError(), and launches on the caller's
// stream without synchronising. Buffers are allocated by the caller.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- xus
// route codes of xus and avt, as kernels/lowrank_matmul.py::ROUTES numbers them
constexpr int ROUTE_STREAM = 0;
constexpr int ROUTE_TILED = 1;

// 16 bytes of T as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---- the stream route (M <= 16)
constexpr int XS_THREADS = 256;
constexpr int XS_COLS = 64;                 // rank columns per block
constexpr int XS_MAX_M = 16;                // rows of x the route takes
constexpr int XS_UNROLL = 8;                // 16-byte loads of U a thread keeps in flight
constexpr int XS_SMEM_FLOATS = 8192;       // staged x rows (MB x K per split), then the warps' sums

// One pass over a split's rows of U (Uk: its first row): rows kb + j * KR +
// kr, j < XS_UNROLL, at columns [col, col + V); zero past the split or R.
template <bool VECU, int KR, typename T, int NR, int NE, int V>
__device__ __forceinline__ void xs_load_pass(const T* Uk, int kb, int kr, int kn, int R,
                                             int col, bool col_ok, uint4 (&raw)[NR],
                                             float (&el)[NE][V]) {
#pragma unroll
  for (int j = 0; j < XS_UNROLL; ++j) {
    const int k = kb + j * KR + kr;
    const T* row = Uk + (size_t)k * R;
    if constexpr (VECU) {
      const bool ok = col_ok && k < kn;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(ok ? row + col : Uk));
      raw[j] = ok ? u : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool ok = k < kn && col + v < R;
        const float u = to_f32(*(ok ? row + col + v : Uk));
        el[j][v] = ok ? u : 0.f;
      }
    }
  }
}

// rows [i0, i0 + N) of column j of a tile's rows of S (zero past the tile's
// ni rows or past R)
template <int N, typename TS>
__device__ __forceinline__ void xs_load_rows(const TS* Sc, int R, int ni, int i0, int j,
                                             float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool ok = i0 + i < ni && j < R;
    const float s = to_f32(*(ok ? Sc + (size_t)(i0 + i) * R + j : Sc));
    v[i] = ok ? s : 0.f;
  }
}

// A tile's ni rows of S (row length R) into shared memory, 16 bytes a copy
template <typename TS>
__device__ __forceinline__ void xs_stage_rows(const TS* Sc, int R, int ni, void* dst) {
  const int per_row = R * (int)sizeof(TS) / 16;
  for (int c = threadIdx.x; c < ni * per_row; c += blockDim.x) {
    const int i = c / per_row, q = c - i * per_row;
    cp_async16(static_cast<char*>(dst) + ((size_t)i * per_row + q) * 16,
               reinterpret_cast<const char*>(Sc + (size_t)i * R) + (size_t)q * 16, true);
  }
  cp_async_commit();
}

// o[m] += x.U[m][i] * Ss[i][j], i < ni (Ss: the tile's rows of S in shared
// memory), in f64
template <int MB, typename TS>
__device__ __forceinline__ void xs_fma_staged(const double* xu, const TS* Ss, int R, int ni,
                                              int j, double (&o)[MB]) {
#pragma unroll 16
  for (int i = 0; i < XS_COLS; ++i) {
    const float s = i < ni ? to_f32(Ss[(size_t)i * R + j]) : 0.f;
#pragma unroll
    for (int m = 0; m < MB; ++m) o[m] = fma(xu[m * XS_COLS + i], (double)s, o[m]);
  }
}

// o[m] += x.U[m][i0 + i] * S rows, i < N, in f64
template <int MB, int N>
__device__ __forceinline__ void xs_fma_rows(const double* xu, int i0, const float (&v)[N],
                                            double (&o)[MB]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const double sv = v[i];
#pragma unroll
    for (int m = 0; m < MB; ++m) o[m] = fma(xu[m * XS_COLS + i0 + i], sv, o[m]);
  }
}

template <typename T, typename TS, int MB, bool VECU>
__global__ void __launch_bounds__(XS_THREADS)
xus_stream_kernel(const T* __restrict__ x, const T* __restrict__ U, const TS* __restrict__ S,
                  T* __restrict__ out, float* __restrict__ work,
                  unsigned* __restrict__ counters, int M, int K, int R, int kc, int nsplit) {
  constexpr int V = 16 / sizeof(T);       // elements of U per 16-byte load
  constexpr int TPR = XS_COLS / V;        // threads across a 64-column row of U
  constexpr int KR = XS_THREADS / TPR;    // rows of U per pass of the block
  constexpr int WARPS = XS_THREADS / 32;
  static_assert(WARPS * MB * XS_COLS <= XS_SMEM_FLOATS, "warp sums");
  __shared__ __align__(16) float buf[XS_SMEM_FLOATS];
  __shared__ double xu[MB * XS_COLS];  // the tile's f32 x.U, held as f64
  __shared__ unsigned ticket;
  const int tid = threadIdx.x;
  const int ct = blockIdx.x, split = blockIdx.y, g = blockIdx.z;
  const int ctiles = gridDim.x;
  const int c0 = ct * XS_COLS;
  const int k0 = split * kc;
  const int kn = min(kc, K - k0);
  const size_t per_g = (size_t)M * R;
  x += (size_t)g * M * K;
  U += (size_t)g * K * R;
  out += (size_t)g * per_g;
  // f64 scratch: the splits' partials [split][M][R], then the column tiles'
  // products with S [tile][M][R]
  double* part = reinterpret_cast<double*>(work) + (size_t)g * nsplit * per_g;
  double* prod = reinterpret_cast<double*>(work) + (size_t)gridDim.z * nsplit * per_g +
                 (size_t)g * ctiles * per_g;
  unsigned* cnt = counters + (size_t)g * (ctiles + 1);

  const int lc = tid % TPR, kr = tid / TPR;
  const int col = c0 + lc * V;
  const bool col_ok = col < R;

  // XS_UNROLL rows of U a thread per pass of the block, all loads issued
  // before the first is used; the first pass is in flight while x is staged
  uint4 raw[VECU ? XS_UNROLL : 1];
  float el[VECU ? 1 : XS_UNROLL][V];
  xs_load_pass<VECU, KR>(U + (size_t)k0 * R, 0, kr, kn, R, col, col_ok, raw, el);

  // the x rows of this split in f32, zero past M and past the split
#pragma unroll 4
  for (int i = tid; i < MB * kc; i += XS_THREADS) {
    const int m = i / kc, k = i - m * kc;
    const bool ok = m < M && k < kn;
    const float v = to_f32(*(ok ? x + (size_t)m * K + k0 + k : x));
    buf[i] = ok ? v : 0.f;
  }
  __syncthreads();

  float acc[MB][V];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
  }
  for (int kb = 0; kb < kn; kb += KR * XS_UNROLL) {
    if (kb > 0) xs_load_pass<VECU, KR>(U + (size_t)k0 * R, kb, kr, kn, R, col, col_ok, raw, el);
#pragma unroll
    for (int j = 0; j < XS_UNROLL; ++j) {
      const int k = kb + j * KR + kr;
      if (k < kn) {
        float u[V];
        if constexpr (VECU) {
          unpack16(raw[j], u);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) u[v] = el[j][v];
        }
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float xv = buf[m * kc + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xv, u[v], acc[m][v]);
        }
      }
    }
  }

  // the split's partial: the warp's rows of U by a butterfly (the same bits
  // in every lane), then the warps in order
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1) {
        acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], off);
      }
    }
  }
  __syncthreads();  // every thread is done with the staged x rows
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TPR) {
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int v = 0; v < V; ++v) buf[(warp * MB + m) * XS_COLS + lane * V + v] = acc[m][v];
    }
  }
  __syncthreads();
  // The tile's rows of S are staged in shared memory (the buffer is free
  // once x.U's partials are out) by cp.async while x.U is summed, where they
  // fit and their rows are whole 16-byte vectors. Else each thread loads
  // its column a chunk of rows at a time, the first chunk while x.U is
  // summed and each next one while the one before is multiplied.
  constexpr int SC = 16;  // rows of S in a chunk
  const int ni = min(XS_COLS, R - c0);
  const TS* Sc = S == nullptr ? nullptr : S + (size_t)g * R * R + (size_t)c0 * R;
  const bool staged = S != nullptr && (size_t)XS_COLS * R * sizeof(TS) <= sizeof(buf) &&
                      R * sizeof(TS) % 16 == 0 && (reinterpret_cast<uintptr_t>(S) & 15) == 0;
  float sa[SC], sb[SC];
  if (nsplit == 1) {
    // one split: this block finishes its column tile from the warps' sums
    if (S != nullptr && !staged) xs_load_rows<SC>(Sc, R, ni, 0, tid, sa);
    for (int i = tid; i < MB * XS_COLS; i += XS_THREADS) {
      const int m = i / XS_COLS, c = i % XS_COLS;
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += buf[(w * MB + m) * XS_COLS + c];
      const bool in = m < M && c0 + c < R;
      const float v = in ? (float)sum : 0.f;  // the f32 x.U that S multiplies
      if (S == nullptr && in) out[(size_t)m * R + c0 + c] = from_f32<T>(v);
      xu[i] = v;
    }
    if (staged) {
      __syncthreads();  // every thread is done with the warps' sums
      xs_stage_rows(Sc, R, ni, buf);
    }
  } else {
    for (int i = tid; i < M * XS_COLS; i += XS_THREADS) {
      const int m = i / XS_COLS, c = i % XS_COLS;
      if (c0 + c < R) {
        double sum = 0.0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += buf[(w * MB + m) * XS_COLS + c];
        part[((size_t)split * M + m) * R + c0 + c] = sum;
      }
    }
    // the last block of this column tile finishes it
    __syncthreads();
    if (tid == 0) ticket = take_ticket(&cnt[ct]);
    __syncthreads();
    if (ticket != (unsigned)nsplit - 1) return;
    if (tid == 0) cnt[ct] = 0u;  // ready for the next call on this slot
    if (staged) {
      xs_stage_rows(Sc, R, ni, buf);
    } else if (S != nullptr) {
      xs_load_rows<SC>(Sc, R, ni, 0, tid, sa);
    }

    // the f32 x.U of the tile: the partials added in split order
    constexpr int EP = MB * XS_COLS / XS_THREADS;  // elements a thread
    double sum[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) sum[e] = 0.0;
    const int pc = tid % XS_COLS, pm = tid / XS_COLS;
    const bool pc_ok = c0 + pc < R;
    const double* p = part + (size_t)pm * R + c0 + pc;
    constexpr int QU = EP == 1 ? 16 : 8;  // splits read ahead (whole groups)
    for (int q0 = 0; q0 < nsplit; q0 += QU) {
#pragma unroll
      for (int u = 0; u < QU; ++u) {
        const int q = q0 + u;
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          const bool ok = q < nsplit && pc_ok && pm + e * (XS_THREADS / XS_COLS) < M;
          const double v = __ldcg(
              ok ? p + (size_t)e * (XS_THREADS / XS_COLS) * R + (size_t)q * per_g : part);
          sum[e] += ok ? v : 0.0;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      const int m = pm + e * (XS_THREADS / XS_COLS);
      const float v = (float)sum[e];
      if (S == nullptr && m < M && pc_ok) out[(size_t)m * R + c0 + pc] = from_f32<T>(v);
      xu[m * XS_COLS + pc] = v;
    }
  }
  if (S == nullptr) return;
  if (staged) cp_async_wait<0>();
  __syncthreads();

  // its product with the tile's rows of S, summed in f64 (exact products)
  for (int j = tid; j < R; j += XS_THREADS) {
    if (j != tid && !staged) xs_load_rows<SC>(Sc, R, ni, 0, j, sa);
    // x.U is read from shared memory at each use: an offset the compiler
    // cannot see through keeps it from holding all MB x 64 values in
    // registers across the loop (they spill)
    int base = 0;
    asm volatile("" : "+r"(base));
    double o[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) o[m] = 0.0;
    if (staged) {
      xs_fma_staged<MB>(xu + base, reinterpret_cast<const TS*>(buf), R, ni, j, o);
    } else {
#pragma unroll
      for (int c = 0; c < XS_COLS; c += 2 * SC) {
        xs_load_rows<SC>(Sc, R, ni, c + SC, j, sb);
        xs_fma_rows<MB, SC>(xu + base, c, sa, o);
        if (c + 2 * SC < XS_COLS) xs_load_rows<SC>(Sc, R, ni, c + 2 * SC, j, sa);
        xs_fma_rows<MB, SC>(xu + base, c + SC, sb, o);
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if (m < M) {
        if (ctiles == 1) {
          out[(size_t)m * R + j] = from_f32<T>((float)o[m]);
        } else {
          prod[((size_t)ct * M + m) * R + j] = o[m];
        }
      }
    }
  }
  if (ctiles == 1) return;

  // the last column tile adds the tiles' products in tile order
  __syncthreads();
  if (tid == 0) ticket = take_ticket(&cnt[ctiles]);
  __syncthreads();
  if (ticket != (unsigned)ctiles - 1) return;
  if (tid == 0) cnt[ctiles] = 0u;
  constexpr int LE = 4;  // elements a thread reads ahead
  for (size_t e0 = tid; e0 < per_g; e0 += LE * XS_THREADS) {
    double t4[LE];
#pragma unroll
    for (int u = 0; u < LE; ++u) t4[u] = 0.0;
    for (int t0 = 0; t0 < ctiles; t0 += 4) {  // whole groups of tiles
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        const int t = t0 + dt;
#pragma unroll
        for (int u = 0; u < LE; ++u) {
          const size_t e = e0 + (size_t)u * XS_THREADS;
          const bool ok = t < ctiles && e < per_g;
          const double v = __ldcg(ok ? prod + t * per_g + e : prod);
          t4[u] += ok ? v : 0.0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LE; ++u) {
      const size_t e = e0 + (size_t)u * XS_THREADS;
      if (e < per_g) out[e] = from_f32<T>((float)t4[u]);
    }
  }
}

// ---- the tiled route (M > 16): C = A B on the tensor cores in split
// precision, K split and summed in fixed order. Pass 1 is A = x, B = U;
// with S, pass 2 is A = the f32 x.U that pass 1 leaves in the workspace,
// B = S.
constexpr int TL_M = 64, TL_N = 32, TL_K = 32;   // block tile
constexpr int TL_WM = 32, TL_WN = 16;            // warp tile: 2 x 2 warps
constexpr int TL_MT = TL_WM / 16, TL_NT = TL_WN / 8;  // m16n8k8 tiles a warp
constexpr int TL_THREADS = 128;
constexpr int TL_STAGES = 4;                     // cp.async ring (dynamic shared memory)

// shared memory of a tiled block: the ring's A and B tiles
template <typename TA, typename TB>
__host__ __device__ constexpr int tl_smem_bytes() {
  return TL_STAGES * (TL_M * (TL_K + 16 / (int)sizeof(TA)) * (int)sizeof(TA) +
                      TL_K * (TL_N + 8) * (int)sizeof(TB));
}

// A (M x K, batches ag elements apart) times B (K x N): C in f32 for the
// block's tile over its K split. One split: C rounded to TO in `out`, or in
// f32 at `xu` (to_xu). Several: each split's partial at `part`, and the
// block that arrives last at its tile (a ticket, as in the stream route)
// adds them in split order into one of those two.
template <typename TA, typename TB, typename TO, bool VEC>
__global__ void __launch_bounds__(TL_THREADS)
xus_tiled_kernel(const TA* __restrict__ A, size_t ag, const TB* __restrict__ B,
                 TO* __restrict__ out, float* __restrict__ xu, size_t xug,
                 float* __restrict__ part, unsigned* __restrict__ counters, int M, int K,
                 int N, int kc, int nsplit, bool to_xu) {
  constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  // row pitches: 16-byte rows, and the fragment reads of a warp fall in 32
  // different banks
  constexpr int AP = TL_K + VA;
  constexpr int BP = TL_N + 8;
  static_assert(TL_M * TL_K / VA % TL_THREADS == 0, "whole chunks of A a thread");
  extern __shared__ __align__(16) unsigned char tl_smem[];
  TA (*As)[TL_M * AP] = reinterpret_cast<TA (*)[TL_M * AP]>(tl_smem);  // [stage][m][k]
  TB (*Bs)[TL_K * BP] = reinterpret_cast<TB (*)[TL_K * BP]>(         // [stage][k][n]
      tl_smem + TL_STAGES * TL_M * AP * sizeof(TA));
  static_assert(tl_smem_bytes<TA, TB>() ==
                TL_STAGES * (TL_M * AP * (int)sizeof(TA) + TL_K * BP * (int)sizeof(TB)),
                "shared memory layout");
  __shared__ unsigned ticket;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lg = lane / 4, lt = lane % 4;  // the mma fragments' group and thread
  const int wm = (warp / 2) * TL_WM, wn = (warp % 2) * TL_WN;
  const int n0 = blockIdx.x * TL_N, m0 = blockIdx.y * TL_M;
  const int g = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int k0 = split * kc, kend = min(K, k0 + kc);
  A += g * ag;
  B += (size_t)g * K * N;

  // K steps [kt, kt + TL_K) of this split into stage `st`; past M, K, N or
  // the split: zeros. With VEC a 16-byte chunk is wholly inside or outside,
  // since K and N are whole vectors and split ends are multiples of TL_K.
  auto stage = [&](int st, int t) {
    const int kt = k0 + t * TL_K;
    if constexpr (VEC) {
      for (int c = tid; c < TL_M * TL_K / VA; c += TL_THREADS) {
        const int m = c / (TL_K / VA), kq = (c % (TL_K / VA)) * VA;
        const bool ok = m0 + m < M && kt + kq < kend;
        cp_async16(&As[st][m * AP + kq], ok ? A + (size_t)(m0 + m) * K + kt + kq : A, ok);
      }
      for (int c = tid; c < TL_K * TL_N / VB; c += TL_THREADS) {
        const int k = c / (TL_N / VB), nq = (c % (TL_N / VB)) * VB;
        const bool ok = kt + k < kend && n0 + nq < N;
        cp_async16(&Bs[st][k * BP + nq], ok ? B + (size_t)(kt + k) * N + n0 + nq : B, ok);
      }
    } else {
      for (int i = tid; i < TL_M * TL_K; i += TL_THREADS) {
        const int m = i / TL_K, k = i % TL_K;
        As[st][m * AP + k] = (m0 + m < M && kt + k < kend)
                                 ? A[(size_t)(m0 + m) * K + kt + k] : from_f32<TA>(0.f);
      }
      for (int i = tid; i < TL_K * TL_N; i += TL_THREADS) {
        const int k = i / TL_N, n = i % TL_N;
        Bs[st][k * BP + n] = (kt + k < kend && n0 + n < N)
                                 ? B[(size_t)(kt + k) * N + n0 + n] : from_f32<TB>(0.f);
      }
    }
  };

  float acc[TL_MT][TL_NT][4];
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  const int ntiles = cdiv(kend - k0, TL_K);
#pragma unroll
  for (int t = 0; t < TL_STAGES - 1; ++t) {
    if (t < ntiles) stage(t, t);
    cp_async_commit();
  }
  constexpr bool A_EXACT = sizeof(TA) == 2, B_EXACT = sizeof(TB) == 2;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<TL_STAGES - 2>();  // step t has landed
    __syncthreads();                 // ... for every thread, and step t - 1 is done
    if (t + TL_STAGES - 1 < ntiles) stage((t + TL_STAGES - 1) % TL_STAGES, t + TL_STAGES - 1);
    cp_async_commit();
    const TA* as = As[t % TL_STAGES] + (wm + lg) * AP + lt;
    const TB* bs = Bs[t % TL_STAGES] + lt * BP + wn + lg;
    // the tensor cores' f32 sums round toward zero: they take one K step
    // from zero, and the step is added to acc with a rounded f32 add, so the
    // bias does not grow with K
    float step[TL_MT][TL_NT][4];
#pragma unroll
    for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) step[i][j][r] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TL_K; kk += 8) {
      uint32_t ab[TL_MT][4], as_[TL_MT][4], bb[TL_NT][2], bs_[TL_NT][2];
#pragma unroll
      for (int i = 0; i < TL_MT; ++i) {
        const TA* a = as + i * 16 * AP + kk;
        split_tf32<A_EXACT>(to_f32(a[0]), ab[i][0], as_[i][0]);
        split_tf32<A_EXACT>(to_f32(a[8 * AP]), ab[i][1], as_[i][1]);
        split_tf32<A_EXACT>(to_f32(a[4]), ab[i][2], as_[i][2]);
        split_tf32<A_EXACT>(to_f32(a[8 * AP + 4]), ab[i][3], as_[i][3]);
      }
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
        const TB* b = bs + kk * BP + j * 8;
        split_tf32<B_EXACT>(to_f32(b[0]), bb[j][0], bs_[j][0]);
        split_tf32<B_EXACT>(to_f32(b[4 * BP]), bb[j][1], bs_[j][1]);
      }
#pragma unroll
      for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
        for (int j = 0; j < TL_NT; ++j) {
          // the small terms first, then big * big
          if constexpr (!A_EXACT) mma_tf32(step[i][j], as_[i], bb[j]);
          if constexpr (!B_EXACT) mma_tf32(step[i][j], ab[i], bs_[j]);
          mma_tf32(step[i][j], ab[i], bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += step[i][j][r];
      }
    }
  }
  cp_async_wait<0>();

  // this thread's outputs: rows m0 + wm + 16 i + lg (+ 8), columns
  // n0 + wn + 8 j + 2 lt (+ 1)
  const size_t per_g = (size_t)M * N;
  float* xg = xu + g * xug;
  TO* og = out + g * per_g;
  float* pg = part + (size_t)g * nsplit * per_g;  // [split][M][N]
  float* dst = nsplit > 1 ? pg + split * per_g : xg;
  const int mr = m0 + wm + lg, nc = n0 + wn + 2 * lt;
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mr + 16 * i + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
        const int n = nc + 8 * j;
        if (n >= N) continue;
        const float c0 = acc[i][j][2 * h], c1 = acc[i][j][2 * h + 1];
        if (nsplit == 1 && !to_xu) {
          store2(og + (size_t)m * N + n, c0, c1, N - n, VEC);
        } else {
          store2(dst + (size_t)m * N + n, c0, c1, N - n, VEC);
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
  // split in flight at once: 16-byte pairs for a tile wholly inside C
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  if (VEC && m0 + TL_M <= M && n0 + TL_N <= N) {
    const float* p0 = pg + (size_t)mr * N + nc;
#pragma unroll 2
    for (int q = 0; q < nsplit; ++q) {
      const float* pq = p0 + q * per_g;
#pragma unroll
      for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < TL_NT; ++j) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                pq + (size_t)(16 * i + 8 * h) * N + 8 * j));
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
      for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mr + 16 * i + 8 * h;
#pragma unroll
          for (int j = 0; j < TL_NT; ++j) {
            const int n = nc + 8 * j;
            // loads from a safe address where outside, so none waits on a branch
            const bool ok0 = m < M && n < N, ok1 = m < M && n + 1 < N;
            const float v0 = __ldcg(ok0 ? pq + (size_t)m * N + n : pq);
            const float v1 = __ldcg(ok1 ? pq + (size_t)m * N + n + 1 : pq);
            acc[i][j][2 * h] += ok0 ? v0 : 0.f;
            acc[i][j][2 * h + 1] += ok1 ? v1 : 0.f;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mr + 16 * i + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
        const int n = nc + 8 * j;
        if (n >= N) continue;
        const float c0 = acc[i][j][2 * h], c1 = acc[i][j][2 * h + 1];
        if (to_xu) {
          store2(xg + (size_t)m * N + n, c0, c1, N - n, VEC);
        } else {
          store2(og + (size_t)m * N + n, c0, c1, N - n, VEC);
        }
      }
    }
  }
}

template <typename TA, typename TB, typename TO>
void launch_tiled(bool vec, dim3 grid, const TA* A, size_t ag, const TB* B, TO* out,
                  float* xu, size_t xug, float* part, unsigned* cnt, int M, int K, int N,
                  int kc, int nsplit, bool to_xu, cudaStream_t st) {
  constexpr int smem = tl_smem_bytes<TA, TB>();  // above 48 KB: opted in once
  static const bool opted_in =
      cudaFuncSetAttribute(xus_tiled_kernel<TA, TB, TO, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess &&
      cudaFuncSetAttribute(xus_tiled_kernel<TA, TB, TO, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess;
  (void)opted_in;  // a refused opt-in shows as the launch's error
  if (vec) {
    xus_tiled_kernel<TA, TB, TO, true><<<grid, TL_THREADS, smem, st>>>(
        A, ag, B, out, xu, xug, part, cnt, M, K, N, kc, nsplit, to_xu);
  } else {
    xus_tiled_kernel<TA, TB, TO, false><<<grid, TL_THREADS, smem, st>>>(
        A, ag, B, out, xu, xug, part, cnt, M, K, N, kc, nsplit, to_xu);
  }
}

template <typename T, typename TS, int MB>
void launch_stream(dim3 grid, bool vec, const T* x, const T* U, const TS* S, T* out, float* w,
                   unsigned* cnt, int M, int K, int R, int kc, int nsplit, cudaStream_t st) {
  if (vec) {
    xus_stream_kernel<T, TS, MB, true><<<grid, XS_THREADS, 0, st>>>(
        x, U, S, out, w, cnt, M, K, R, kc, nsplit);
  } else {
    xus_stream_kernel<T, TS, MB, false><<<grid, XS_THREADS, 0, st>>>(
        x, U, S, out, w, cnt, M, K, R, kc, nsplit);
  }
}

// The launches of one call, after checking the plan the wrapper passes
// (route, K per split, vector variant) against the shapes, the pointers and
// the workspace it allocated: a plan that does not fit is refused, never
// patched up here.
template <typename T, typename TS>
int launch_xus(const void* x_, const void* U_, const void* S_, void* out_, void* work,
               long long work_floats, void* counters, int G, int M, int K, int R, int route,
               int kc, int kc_s, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (kc < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* U = static_cast<const T*>(U_);
  const TS* S = static_cast<const TS*>(S_);
  T* out = static_cast<T*>(out_);
  float* w = static_cast<float*>(work);
  const int nsplit = cdiv(K, kc);
  const long long per_g = (long long)M * R;
  if (route == ROUTE_STREAM) {
    const int ctiles = cdiv(R, XS_COLS);
    const long long need = 2 * ((long long)G * nsplit * per_g +
                                (S != nullptr && ctiles > 1 ? (long long)G * ctiles * per_g : 0));
    const int mb = M <= 4 ? 4 : 16;  // the kernel instance's rows
    if (M > XS_MAX_M || mb * kc > XS_SMEM_FLOATS || nsplit > 65535 || counters == nullptr ||
        (long long)G * (ctiles + 1) > COUNTER_INTS ||
        need > work_floats || ((vec & 1) && !(aligned16(U) && R % V == 0))) {
      return (int)cudaErrorInvalidValue;
    }
    dim3 grid(ctiles, nsplit, G);
    unsigned* cnt = static_cast<unsigned*>(counters);
    if (mb == 4) {
      launch_stream<T, TS, 4>(grid, vec & 1, x, U, S, out, w, cnt, M, K, R, kc, nsplit, stream);
    } else {
      launch_stream<T, TS, 16>(grid, vec & 1, x, U, S, out, w, cnt, M, K, R, kc, nsplit, stream);
    }
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_TILED) return (int)cudaErrorInvalidValue;
  // workspace: x.U in f32 with S [G][M][R] (pass 2 reads it), pass 1's split
  // partials [G][splits][M][R], pass 2's [G][splits_s][M][R]; counters: one
  // a tile for each pass that splits
  const int nsplit_s = S != nullptr ? cdiv(R, kc_s) : 1;
  const long long tiles = (long long)G * cdiv(R, TL_N) * cdiv(M, TL_M);
  const long long xu_n = S != nullptr ? (long long)G * per_g : 0;
  const long long p1_n = nsplit > 1 ? (long long)G * nsplit * per_g : 0;
  const long long p2_n = nsplit_s > 1 ? (long long)G * nsplit_s * per_g : 0;
  constexpr int VS = 16 / sizeof(TS);
  const bool vec1 = vec & 1, vec_s = vec & 2;
  if (kc_s < 1 || (nsplit > 1 && kc % TL_K != 0) || (nsplit_s > 1 && kc_s % TL_K != 0) ||
      ((nsplit > 1 || nsplit_s > 1) && (counters == nullptr || 2 * tiles > COUNTER_INTS)) ||
      (long long)G * nsplit > 65535 || (long long)G * nsplit_s > 65535 ||
      cdiv(M, TL_M) > 65535 || xu_n + p1_n + p2_n > work_floats ||
      (vec1 && !(aligned16(x) && aligned16(U) && K % V == 0 && R % V == 0)) ||
      (vec_s && !(S != nullptr && aligned16(S) && R % VS == 0 && R % V == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned* cnt = static_cast<unsigned*>(counters);
  float* xu = w;
  float* p1 = w + xu_n;
  float* p2 = p1 + p1_n;
  dim3 grid1(cdiv(R, TL_N), cdiv(M, TL_M), G * nsplit);
  launch_tiled<T, T, T>(vec1, grid1, x, (size_t)M * K, U, out, xu, (size_t)per_g, p1, cnt, M,
                        K, R, kc, nsplit, S != nullptr, stream);
  if (S != nullptr) {
    dim3 grid2(cdiv(R, TL_N), cdiv(M, TL_M), G * nsplit_s);
    launch_tiled<float, TS, T>(vec_s, grid2, xu, (size_t)per_g, S, out, nullptr, 0, p2,
                               cnt == nullptr ? nullptr : cnt + tiles, M, R, R, kc_s,
                               nsplit_s, false, stream);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- avt
// ---- the stream route (M <= 16)
constexpr int AS_MAX_M = 16;      // rows of A the route takes
constexpr int AS_ELEMS = 8;       // elements of a row a lane takes a pass (16 B bf16, 32 B f32)
constexpr int AS_WARPS = 4;       // warps a block
constexpr int AS_ROWS = 4;        // rows of V a lane group owns
constexpr int AS_M_BLOCK = 4;     // rows of A a block at M > 1 (the wrapper's AVT_M_BLOCK)

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v >> 1) : 0; }

// log2 of the lanes that share a row of V: the power of two that covers the
// row's R / 8 lane pieces, at most 32 (kernels/lowrank_matmul.py::_avt_lanes)
inline int avt_lanes_log2(int R) {
  int l = 0;
  while ((1 << l) < cdiv(R, AS_ELEMS) && l < 5) ++l;
  return l;
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// 16 bytes of a row from its element c, zero past R or where the row is
// outside (!ok): one 16-byte load (V's marked evict-first, A's through the
// read-only cache), or element loads in the element variant. A load that
// would fall outside reads `safe` and drops the value instead of branching.
template <bool VEC, bool STREAM, typename T>
__device__ __forceinline__ uint4 load16(const T* row, int c, int R, bool ok, const T* safe) {
  if constexpr (VEC) {
    const bool in = ok && c < R;
    const uint4* p = reinterpret_cast<const uint4*>(in ? row + c : safe);
    const uint4 v = STREAM ? __ldcs(p) : __ldg(p);
    return in ? v : make_uint4(0u, 0u, 0u, 0u);
  } else {
    constexpr int VE = 16 / sizeof(T);
    uint32_t b[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const bool in = ok && c + e < R;
      const T t = *(in ? row + c + e : safe);
      b[e] = in ? bits_of(t) : 0u;
    }
    if constexpr (VE == 4) {
      return make_uint4(b[0], b[1], b[2], b[3]);
    } else {
      return make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16,
                        b[6] | b[7] << 16);
    }
  }
}

// The steps of a transposed butterfly from xor offset o down, while o > 0,
// over the first C of the sums: a lane keeps the half its bit o names, adds
// its partner's copy and sends the other half. C is a template argument so
// that every step's loop has a constant trip count and the sums stay in
// registers.
template <int C, int NS>
__device__ __forceinline__ void transposed_butterfly(float (&acc)[NS], int li, int& o) {
  if constexpr (C > 1) {
    if (o > 0) {
      constexpr int H = C / 2;
      const bool up = (li & o) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? acc[i] : acc[i + H];
        const float keep = up ? acc[i + H] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      o >>= 1;
      transposed_butterfly<H>(acc, li, o);
    }
  }
}

// y[m, n] for the warp's rows n of V and the block's MB rows m of A. A
// group of 2^lanes_log2 lanes shares a row of V; a lane holds AS_ROWS rows'
// sums for each of the MB rows. Blocks that differ only in their rows of A
// are neighbours in the grid, so they read the same rows of V together and
// all but the first find them in L2.
// The vector variant is held to 64 registers (8 blocks an SM): more warps,
// more loads in flight; at 80 it was slower on the card.
template <typename T, int MB, bool VEC>
__global__ void __launch_bounds__(AS_WARPS * 32, VEC ? 8 : 4)
avt_stream_kernel(const T* __restrict__ A, const T* __restrict__ V, T* __restrict__ y, int M,
                  int N, int R, int lanes_log2) {
  constexpr int VE = 16 / sizeof(T);    // elements a 16-byte piece
  constexpr int PPL = AS_ELEMS / VE;    // pieces a lane takes a pass: 1 (bf16) or 2 (f32)
  constexpr int NR = AS_ROWS;
  constexpr int NS = MB * NR;           // sums a lane holds, [m * NR + j]
  const int lane = threadIdx.x % 32;
  const int lpr = 1 << lanes_log2, groups = 32 >> lanes_log2;
  const int li = lane & (lpr - 1), gi = lane >> lanes_log2;
  const int mblocks = cdiv(M, MB);
  const int m0 = (blockIdx.x % mblocks) * MB;
  // the lane's rows of V: n0 + j * groups + gi, j < NR, so a load
  // instruction of the warp reads `groups` neighbouring rows
  const int n0 = ((blockIdx.x / mblocks) * AS_WARPS + threadIdx.x / 32) * NR * groups;
  const int g = blockIdx.y;
  A += (size_t)g * M * R;
  V += (size_t)g * N * R;
  y += (size_t)g * M * N;

  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.f;
  // a pass: elements [c0, c0 + lpr * 8) of every row; one pass up to R = 256
  for (int c0 = 0; c0 < R; c0 += lpr * AS_ELEMS) {
    // every load of V in the pass is in flight before the first product
    uint4 vr[PPL][NR];
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int c = c0 + (k * lpr + li) * VE;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int n = n0 + j * groups + gi;
        vr[k][j] = load16<VEC, true>(V + (size_t)n * R, c, R, n < N, V);
      }
    }
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int c = c0 + (k * lpr + li) * VE;
      // the lane's pieces of the rows of A (rows past M repeat row M - 1:
      // their sums are never stored), from L1 / L2 while V is on its way
      uint4 ar[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        ar[m] = load16<VEC, false>(A + (size_t)min(m0 + m, M - 1) * R, c, R, true, A);
      }
      float vf[NR][VE];
#pragma unroll
      for (int j = 0; j < NR; ++j) unpack16(vr[k][j], vf[j]);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float a[VE];
        unpack16(ar[m], a);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
#pragma unroll
          for (int j = 0; j < NR; ++j) acc[m * NR + j] = fmaf(a[e], vf[j][e], acc[m * NR + j]);
        }
      }
    }
  }

  // The lane group's sums, by a transposed butterfly: at each xor step a
  // lane keeps the half of its sums that its lane bit names, adds its
  // partner's copy of them and sends the other half, so the sums a lane
  // holds halve and NS outputs take about NS shuffles. Where a group has
  // more lanes than sums, the steps left are a plain butterfly. The order is
  // fixed: equal inputs give equal bits.
  int o = lpr >> 1;
  transposed_butterfly<NS>(acc, li, o);
  for (; o > 0; o >>= 1) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);

  // the lane now holds sums [first, first + held); lanes that differ only in
  // the plain butterfly's bits hold the same ones, and the lowest stores them
  const int steps = min(ilog2(NS), lanes_log2);
  const int held = NS >> steps, plain = lanes_log2 - steps;
  if ((li & ((1 << plain) - 1)) != 0) return;
  const int first = held * (li >> plain);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < held) {
      const int i = first + s, m = m0 + i / NR, n = n0 + (i % NR) * groups + gi;
      if (m < M && n < N) y[(size_t)m * N + n] = from_f32<T>(acc[s]);
    }
  }
}

template <typename T, int MB>
void launch_avt_stream(bool vec, dim3 grid, const T* A, const T* V, T* y, int M, int N, int R,
                       int lanes_log2, cudaStream_t st) {
  if (vec) {
    avt_stream_kernel<T, MB, true><<<grid, AS_WARPS * 32, 0, st>>>(A, V, y, M, N, R, lanes_log2);
  } else {
    avt_stream_kernel<T, MB, false><<<grid, AS_WARPS * 32, 0, st>>>(A, V, y, M, N, R, lanes_log2);
  }
}

// ---- the tiled route (M > 16): y = A V^T on the tensor cores in split
// precision, on xus's block and warp tiles (TL_*)

// shared memory of a block: the ring's A and V tiles, rows of TL_K + one
// 16-byte vector
template <typename T>
__host__ __device__ constexpr int av_smem_bytes() {
  return TL_STAGES * (TL_M + TL_N) * (TL_K + 16 / (int)sizeof(T)) * (int)sizeof(T);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TL_THREADS)
avt_tiled_kernel(const T* __restrict__ A, const T* __restrict__ V, T* __restrict__ y, int M,
                 int N, int R) {
  constexpr int VE = 16 / sizeof(T);
  // row pitch of both staged tiles: a warp's fragment reads fall in 32
  // different banks (see the note at the top) and rows stay 16-byte vectors
  constexpr int P = TL_K + VE;
  static_assert(TL_M * TL_K / VE % TL_THREADS == 0, "whole chunks of A a thread");
  extern __shared__ __align__(16) unsigned char av_smem[];
  T (*As)[TL_M * P] = reinterpret_cast<T (*)[TL_M * P]>(av_smem);  // [stage][m][r]
  T (*Vs)[TL_N * P] = reinterpret_cast<T (*)[TL_N * P]>(          // [stage][n][r]
      av_smem + TL_STAGES * TL_M * P * sizeof(T));
  static_assert(av_smem_bytes<T>() == TL_STAGES * (TL_M + TL_N) * P * (int)sizeof(T),
                "shared memory layout");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lg = lane / 4, lt = lane % 4;  // the mma fragments' group and thread
  const int wm = (warp / 2) * TL_WM, wn = (warp % 2) * TL_WN;
  const int n0 = blockIdx.x * TL_N, m0 = blockIdx.y * TL_M, g = blockIdx.z;
  A += (size_t)g * M * R;
  V += (size_t)g * N * R;
  y += (size_t)g * M * N;

  // R step t of the tile's rows of A and V into stage st; zeros past M, N or
  // R. With VEC a 16-byte chunk is wholly inside or outside: R is whole vectors.
  auto stage = [&](int st, int t) {
    const int kt = t * TL_K;
    if constexpr (VEC) {
      for (int c = tid; c < TL_M * TL_K / VE; c += TL_THREADS) {
        const int m = c / (TL_K / VE), kq = (c % (TL_K / VE)) * VE;
        const bool ok = m0 + m < M && kt + kq < R;
        cp_async16(&As[st][m * P + kq], ok ? A + (size_t)(m0 + m) * R + kt + kq : A, ok);
      }
      for (int c = tid; c < TL_N * TL_K / VE; c += TL_THREADS) {
        const int n = c / (TL_K / VE), kq = (c % (TL_K / VE)) * VE;
        const bool ok = n0 + n < N && kt + kq < R;
        cp_async16(&Vs[st][n * P + kq], ok ? V + (size_t)(n0 + n) * R + kt + kq : V, ok);
      }
    } else {
      for (int i = tid; i < TL_M * TL_K; i += TL_THREADS) {
        const int m = i / TL_K, k = i % TL_K;
        As[st][m * P + k] = (m0 + m < M && kt + k < R) ? A[(size_t)(m0 + m) * R + kt + k]
                                                        : from_f32<T>(0.f);
      }
      for (int i = tid; i < TL_N * TL_K; i += TL_THREADS) {
        const int n = i / TL_K, k = i % TL_K;
        Vs[st][n * P + k] = (n0 + n < N && kt + k < R) ? V[(size_t)(n0 + n) * R + kt + k]
                                                        : from_f32<T>(0.f);
      }
    }
  };

  float acc[TL_MT][TL_NT][4];
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  const int nsteps = cdiv(R, TL_K);
#pragma unroll
  for (int t = 0; t < TL_STAGES - 1; ++t) {
    if (t < nsteps) stage(t, t);
    cp_async_commit();
  }
  constexpr bool EXACT = sizeof(T) == 2;  // bf16: exact in tf32
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<TL_STAGES - 2>();  // step t has landed
    __syncthreads();                 // ... for every thread, and step t - 1 is done
    if (t + TL_STAGES - 1 < nsteps) stage((t + TL_STAGES - 1) % TL_STAGES, t + TL_STAGES - 1);
    cp_async_commit();
    // fragment bases: A's (m lg, r lt) of the warp tile; V's "col" B
    // operand b[r][n] = V[n][r], (n lg, r lt)
    const T* as = As[t % TL_STAGES] + (wm + lg) * P + lt;
    const T* vs = Vs[t % TL_STAGES] + (wn + lg) * P + lt;
    // the step summed from zero, then added to acc with a rounded f32 add
    float step[TL_MT][TL_NT][4];
#pragma unroll
    for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) step[i][j][r] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TL_K; kk += 8) {
      uint32_t ab[TL_MT][4], as_[TL_MT][4], bb[TL_NT][2], bs_[TL_NT][2];
#pragma unroll
      for (int i = 0; i < TL_MT; ++i) {
        const T* a = as + i * 16 * P + kk;
        split_tf32_rhu<EXACT>(to_f32(a[0]), ab[i][0], as_[i][0]);
        split_tf32_rhu<EXACT>(to_f32(a[8 * P]), ab[i][1], as_[i][1]);
        split_tf32_rhu<EXACT>(to_f32(a[4]), ab[i][2], as_[i][2]);
        split_tf32_rhu<EXACT>(to_f32(a[8 * P + 4]), ab[i][3], as_[i][3]);
      }
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
        const T* b = vs + j * 8 * P + kk;
        split_tf32_rhu<EXACT>(to_f32(b[0]), bb[j][0], bs_[j][0]);
        split_tf32_rhu<EXACT>(to_f32(b[4]), bb[j][1], bs_[j][1]);
      }
#pragma unroll
      for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
        for (int j = 0; j < TL_NT; ++j) {
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
    for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += step[i][j][r];
      }
    }
  }
  cp_async_wait<0>();

  // this thread's outputs: rows m0 + wm + 16 i + lg (+ 8), columns
  // n0 + wn + 8 j + 2 lt (+ 1); a pair is one store where rows of y hold
  // whole pairs
  const bool pairs = (N & 1) == 0;
  const int mr = m0 + wm + lg, nc = n0 + wn + 2 * lt;
#pragma unroll
  for (int i = 0; i < TL_MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mr + 16 * i + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TL_NT; ++j) {
        const int n = nc + 8 * j;
        if (n >= N) continue;
        store2(y + (size_t)m * N + n, acc[i][j][2 * h], acc[i][j][2 * h + 1], N - n, pairs);
      }
    }
  }
}

// The launch of one call, after checking the plan the wrapper passes
// (route, its two sizes, vector variant) against the shapes and the
// pointers: a plan that does not fit is refused, never patched up here.
template <typename T>
int launch_avt(const void* A_, const void* V_, void* y_, int G, int M, int N, int R, int route,
               int size0, int size1, int vec, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  const T* A = static_cast<const T*>(A_);
  const T* V = static_cast<const T*>(V_);
  T* y = static_cast<T*>(y_);
  if (G > 65535 || (vec && !(aligned16(A) && aligned16(V) && R % VE == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == ROUTE_STREAM) {
    // size0: rows of V a warp, size1: warps a block
    const int ll = avt_lanes_log2(R), rows = size0, warps = size1;
    if (M > AS_MAX_M || warps != AS_WARPS || rows != AS_ROWS * (32 >> ll)) {
      return (int)cudaErrorInvalidValue;
    }
    // rows of A a block: the kernel instance
    const int mb = M == 1 ? 1 : AS_M_BLOCK;
    const dim3 grid(cdiv(cdiv(N, rows), warps) * cdiv(M, mb), G);
    if (mb == 1) {
      launch_avt_stream<T, 1>(vec != 0, grid, A, V, y, M, N, R, ll, stream);
    } else {
      launch_avt_stream<T, AS_M_BLOCK>(vec != 0, grid, A, V, y, M, N, R, ll, stream);
    }
    return (int)cudaGetLastError();
  }
  // size0 x size1: the block tile of y
  if (route != ROUTE_TILED || size0 != TL_M || size1 != TL_N || cdiv(M, TL_M) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = av_smem_bytes<T>();  // above 48 KB in f32: opted in once
  static const bool opted_in =
      cudaFuncSetAttribute(avt_tiled_kernel<T, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess &&
      cudaFuncSetAttribute(avt_tiled_kernel<T, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess;
  (void)opted_in;  // a refused opt-in shows as the launch's error
  const dim3 grid(cdiv(N, TL_N), cdiv(M, TL_M), G);
  if (vec) {
    avt_tiled_kernel<T, true><<<grid, TL_THREADS, smem, stream>>>(A, V, y, M, N, R);
  } else {
    avt_tiled_kernel<T, false><<<grid, TL_THREADS, smem, stream>>>(A, V, y, M, N, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// A = (x U) S.  x (G, M, K), U (G, K, R) in dtype dt; S (G, R, R) in dt_s,
// or a null S for A = x U; A (G, M, R) in dt. The plan comes from the
// wrapper (kernels/lowrank_matmul.py::xus_plan): route (0 stream, 1 tiled),
// kc = K per split, kc_s = R per split of the tiled route's S pass, vec =
// 16-byte loads of x and U (bit 0) and of x.U and S (bit 1); work holds
// work_floats floats and counters the call's zeroed ticket slot.
int lr_xus(int dt, int dt_s, const void* x, const void* U, const void* S, void* out,
           void* work, long long work_floats, void* counters, int G, int M, int K, int R,
           int route, int kc, int kc_s, int vec, void* stream) {
  if (G < 1 || M < 1 || K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0 && dt_s == 0) {
    return launch_xus<float, float>(x, U, S, out, work, work_floats, counters, G, M, K, R,
                                    route, kc, kc_s, vec, s);
  }
  if (dt == 1 && dt_s == 1) {
    return launch_xus<__nv_bfloat16, __nv_bfloat16>(x, U, S, out, work, work_floats, counters,
                                                    G, M, K, R, route, kc, kc_s, vec, s);
  }
  if (dt == 1 && dt_s == 0) {
    return launch_xus<__nv_bfloat16, float>(x, U, S, out, work, work_floats, counters, G, M,
                                            K, R, route, kc, kc_s, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The id of the graph capture under way on `stream`, 0 when it is not
// capturing (the wrapper gives each capture its own ticket slot).
unsigned long long lr_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return 0;
  }
  return id;
}


// y = A V^T.  A (G, M, R), V (G, N, R), y (G, M, N), all in dtype dt. The
// plan comes from the wrapper (kernels/lowrank_matmul.py::avt_plan): route
// (0 stream, 1 tiled) and two sizes, the rows of V a warp and the warps a
// block (stream) or the block tile of y (tiled: 64 x 32); vec = 16-byte
// loads of A and V.
int lr_avt(int dt, const void* A, const void* V, void* y, int G, int M, int N, int R, int route,
           int size0, int size1, int vec, void* stream) {
  if (G < 1 || M < 1 || N < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return launch_avt<float>(A, V, y, G, M, N, R, route, size0, size1, vec, s);
  if (dt == 1) {
    return launch_avt<__nv_bfloat16>(A, V, y, G, M, N, R, route, size0, size1, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
