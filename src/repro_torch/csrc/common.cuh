// Device helpers shared by the port's Hopper (sm_90a) kernels: conversions
// between the working types and f32, ticket counters, cp.async staging and
// the split-precision (3xTF32) tensor-core product of mma.sync m16n8k8, with
// the two ways of splitting an f32 value into its tf32 parts.
//
// Everything sits in an anonymous namespace: each source that includes this
// header gets its own copy, and nothing here is part of the C API.
#pragma once

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

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Ticket counters one call may use: the slot size of the wrappers' pool
// (kernels/lowrank_matmul.py::COUNTER_INTS).
constexpr long long COUNTER_INTS = 4096;

// A block's ticket: one thread adds 1 to the counter after a barrier, with
// release and acquire semantics at device scope. Release publishes the
// whole block's earlier stores (the barrier orders them before it); acquire
// makes the stores of every block that took a ticket before visible to the
// block that reads the last one (it reads them past L1, with __ldcg).
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src-size 0: no read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both tf32: big carries v's top 11 significant bits, small
// the next 11, so big*big + big*small + small*big misses v*w by about 2^-22
// of it (3xTF32). A bf16 value is a tf32 value: small is 0.
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(v);
    small = 0u;
  } else {
    big = to_tf32(v);
    small = to_tf32(v - __uint_as_float(big));
  }
}

// v = big + small as the tensor core reads them (3xTF32, as split_tf32
// without its two cvt instructions): big is v rounded to tf32 by an integer
// add and mask (nearest, ties away from zero: cvt.rna's value), small the
// rest, exact in f32, which the tensor core reads truncated to tf32. The
// products miss v*w by about 2^-21 of it. The split costs as much issue as
// the mma.sync it feeds: without the cvt an atb call at an llm-100m round's
// shapes took less time on the card.
template <bool EXACT>
__device__ __forceinline__ void split_tf32_rhu(float v, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(v);
    small = 0u;
  } else {
    big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(v - __uint_as_float(big));
  }
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two values of an output row, at columns n and n + 1 (avail of them inside)
__device__ __forceinline__ void store2(float* p, float a, float b, int avail, bool vec) {
  if (vec && avail >= 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (avail > 0) p[0] = a;
    if (avail > 1) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, int avail,
                                       bool vec) {
  if (vec && avail >= 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (avail > 0) p[0] = __float2bfloat16_rn(a);
    if (avail > 1) p[1] = __float2bfloat16_rn(b);
  }
}

}  // namespace
