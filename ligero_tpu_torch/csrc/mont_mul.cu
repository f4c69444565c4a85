// Elementwise Montgomery product over limb rows of BN254 Fr or BLS12-377 Fq.
//
// Replaces ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory
// (mont_mul_pallas).  out[i] = REDC(a[i] * b[i]), or REDC(a[i] * b[0])
// when b is broadcast.  One thread per element; each reads 8 W bytes per
// operand and writes 8 W (64 for BN254, 96 for BLS12-377), so at the
// sparse r^T A sizes (~10^7 elements) the kernel is bound by device-memory
// bandwidth, not by the ~200 (BN254) or ~430 (BLS12-377) instructions of
// the CIOS product.  The design keeps one pass: limbs are packed to 32-bit
// words in registers and every operand crosses memory once.  Two things
// keep the memory system busy (on an H100 each is worth a few per cent at
// that size):
//
//  * All W / 2 16-byte loads of an operand are in flight before the
//    product starts.  Left to itself ptxas saves registers by putting two
//    of them off into the middle of the product, and every warp waits for
//    memory twice; loads under a condition of their own stay together.
//  * A warp's results leave through shared memory as W / 2 runs of 512
//    bytes, where a thread storing its own element writes half of a
//    32-byte sector per instruction.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

// Where 16-byte piece idx (piece q of lane l is PIECES l + q) of a warp's 32
// results sits in its staging row: the swizzle keeps both the element-order
// writes and the run-order reads free of bank conflicts (a quarter warp's
// eight 16-byte accesses fall in eight distinct 16-byte bank groups;
// tests/test_torch_field.py reads the expression below and checks this for
// both piece counts).
template <int PIECES>
__device__ __forceinline__ int piece_slot(int idx) {
  static_assert(PIECES == 4 || PIECES == 6, "no swizzle for this width");
  return PIECES == 4 ? idx ^ ((idx >> 3) & 3) : idx ^ ((idx >> 3) & 1);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long count, int b_stride) {
  constexpr int W = F::W, PIECES = F::L / 4;
  __shared__ int4 stage[THREADS / 32][32 * PIECES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * THREADS + warp * 32;
  if (base >= count) return;  // the whole warp
  const long long left = count - base;
  // lanes past the end multiply zeros; the conditions keep each operand's
  // loads together, ahead of the product (see the head of this file)
  const typename F::Fe x =
      lane < left ? load_limbs<W>(a + (base + lane) * F::L) : fe_zero<W>();
  const typename F::Fe y = (lane < left || !b_stride)
                               ? load_limbs<W>(b + (base + lane) * b_stride)
                               : fe_zero<W>();
  const typename F::Fe r = F::mul(x, y);
  int4* row = stage[warp];
#pragma unroll
  for (int q = 0; q < PIECES; ++q)
    row[piece_slot<PIECES>(PIECES * lane + q)] = make_int4(
        (int)(r.w[2 * q] & 0xffffu), (int)(r.w[2 * q] >> 16),
        (int)(r.w[2 * q + 1] & 0xffffu), (int)(r.w[2 * q + 1] >> 16));
  __syncwarp();
  const int pieces = left >= 32 ? 32 * PIECES : (int)left * PIECES;
  int4* dst = reinterpret_cast<int4*>(out + base * F::L);
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int idx = j * 32 + lane;
    if (idx < pieces) dst[idx] = row[piece_slot<PIECES>(idx)];
  }
}

}  // namespace

// field: a field id (field.cuh); a, out: (count, L) int32; b: (count, L),
// or (L,) with b_broadcast.
extern "C" int lt_mont_mul(int field, const void* a, const void* b, void* out,
                           long long count, int b_broadcast, void* stream) {
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    if (count > 0) {
      const long long blocks = (count + THREADS - 1) / THREADS;
      mont_mul_kernel<F><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
          (const int32_t*)a, (const int32_t*)b, (int32_t*)out, count,
          b_broadcast ? 0 : F::L);
    }
    return cudaGetLastError();
  });
}
