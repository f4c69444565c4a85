// A warp's rows of field elements staged through shared memory ahead of
// their use: the loads of the Blake2s column hash (blake2s_cols.cu) and of
// the row combination (row_combine.cu).
//
// Both kernels read, row after row, the elements of a run of neighbouring
// columns, which lie contiguous in each row of their (rows, n, L) matrix.
// A warp copies its columns' slice of the next rows into a ring of stages
// with cp.async (16 bytes a copy, LDGSTS: the copies fly while the warp
// computes on the stage before), waits for them (cp.async.wait_group, then
// __syncwarp: every lane's copies are the warp's), and each lane reads its
// own column's element from the stage.  No block-wide barrier: each warp
// fills and reads a ring of its own.
//
// An element is EB bytes (32 or 48 for 16-bit limbs, 64 or 96 for int32
// limbs), EB / 16 chunks of 16 bytes.  Lanes read an element chunk by
// chunk (LDS.128: 8 lanes a phase), and at a stride of 32, 64 or 96 bytes
// the lanes of a phase would share banks; chunk q of local column c is
// stored at chunk q ^ swizzle(c) of its slot instead, which puts the 8
// lanes of a phase on 8 distinct 16-byte bank groups for every q
// (engine/staging.py: stage_swizzle is the same map, held there against
// the bank rule).  48-byte elements need none: 3 is odd.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

template <int EB>
__device__ __forceinline__ int stage_swizzle(int c) {
  static_assert(EB == 32 || EB == 48 || EB == 64 || EB == 96, "element size");
  if constexpr (EB == 64) return (c >> 1) & 3;
  else if constexpr (EB == 48) return 0;
  else return (c >> 2) & 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared address dst, past L1 (cg); zero: write 16
// zero bytes and read nothing (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool zero) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(zero ? 0 : 16)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the N most recent groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk q of the element at slot of local column c of a stage row
template <int EB>
__device__ __forceinline__ uint4 stage_chunk(const unsigned char* slot, int c,
                                             int q) {
  return *reinterpret_cast<const uint4*>(slot + 16 * (q ^ stage_swizzle<EB>(c)));
}

// Packed word w (32 bits: limbs 2w, 2w + 1) of the element at slot of local
// column c: a 16-bit element holds 4 words a chunk, an int32 one 2 (each
// word two int32 limbs below 2^16).  w compile-time.
template <int EB, bool NARROW>
__device__ __forceinline__ uint32_t stage_word(const unsigned char* slot, int c,
                                               int w) {
  if constexpr (NARROW) {
    const uint4 v = stage_chunk<EB>(slot, c, w / 4);
    const int i = w % 4;
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  } else {
    const uint4 v = stage_chunk<EB>(slot, c, w / 2);
    return w % 2 ? __byte_perm(v.z, v.w, 0x5410) : __byte_perm(v.x, v.y, 0x5410);
  }
}

// the W packed words of the element at slot of local column c
template <int EB, bool NARROW, int W>
__device__ __forceinline__ FeT<W> stage_elem(const unsigned char* slot, int c) {
  FeT<W> e;
#pragma unroll
  for (int w = 0; w < W; ++w) e.w[w] = stage_word<EB, NARROW>(slot, c, w);
  return e;
}
