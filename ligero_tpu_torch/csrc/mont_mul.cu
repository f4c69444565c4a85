// Elementwise Montgomery product over BN254 Fr limb rows.
//
// Replaces ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory
// (mont_mul_pallas).  out[i] = REDC(a[i] * b[i]), or REDC(a[i] * b[0])
// when b is broadcast.  One thread per element; each reads 64 bytes per
// operand and writes 64, so at the sparse r^T A sizes (~10^7 elements)
// the kernel is bound by device-memory bandwidth, not by the ~200
// instructions of the CIOS product.  The design keeps one pass: limbs are
// packed to 32-bit words in registers and every operand crosses memory
// once.  Two things keep the memory system busy (on an H100 each is worth
// a few per cent at that size):
//
//  * All eight 16-byte loads of a thread are in flight before its product
//    starts.  Left to itself ptxas saves registers by putting two of them
//    off into the middle of the product, and every warp waits for memory
//    twice; loads under a condition of their own stay together.
//  * A warp's results leave through shared memory as four 512-byte runs,
//    where a thread storing its own element writes half of a 32-byte
//    sector per instruction.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

// Where 16-byte piece idx (piece q of lane l is 4 l + q) of a warp's 32
// results sits in its staging row: the swizzle keeps both the element-order
// writes and the run-order reads free of bank conflicts.
__device__ __forceinline__ int piece_slot(int idx) {
  return idx ^ ((idx >> 3) & 3);
}

__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long count, int b_stride) {
  __shared__ int4 stage[THREADS / 32][128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * THREADS + warp * 32;
  if (base >= count) return;  // the whole warp
  const long long left = count - base;
  // lanes past the end multiply zeros; the conditions keep each operand's
  // four loads together, ahead of the product (see the head of this file)
  const fr::Fe x = lane < left ? fr::load_limbs(a + (base + lane) * fr::L)
                               : fr::fe_zero();
  const fr::Fe y = (lane < left || !b_stride)
                       ? fr::load_limbs(b + (base + lane) * b_stride)
                       : fr::fe_zero();
  const fr::Fe r = fr::fe_mont_mul(x, y);
  int4* row = stage[warp];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    row[piece_slot(4 * lane + q)] = make_int4(
        (int)(r.w[2 * q] & 0xffffu), (int)(r.w[2 * q] >> 16),
        (int)(r.w[2 * q + 1] & 0xffffu), (int)(r.w[2 * q + 1] >> 16));
  __syncwarp();
  const int pieces = left >= 32 ? 128 : (int)left * 4;
  int4* dst = reinterpret_cast<int4*>(out + base * fr::L);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = j * 32 + lane;
    if (idx < pieces) dst[idx] = row[piece_slot(idx)];
  }
}

}  // namespace

// a, out: (count, 16) int32; b: (count, 16), or (16,) with b_broadcast.
extern "C" int lt_mont_mul(const void* a, const void* b, void* out,
                           long long count, int b_broadcast, void* stream) {
  if (count > 0) {
    long long blocks = (count + THREADS - 1) / THREADS;
    mont_mul_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, count,
        b_broadcast ? 0 : fr::L);
  }
  return (int)cudaGetLastError();
}
