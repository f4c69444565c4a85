// Poseidon digests of the columns of a canonical limb matrix, BN254 Fr: the
// commitment of LigeroMTPoseidonParams, its column leaves and, over the
// 2-element columns [left, right] of a level, every Merkle level above them.
//
// Replaces the sponge rounds of ligero_tpu/engine/poseidon_cols.py
// (PoseidonColumns._round / _permute / _absorb_chunk), which the JAX
// package runs as one Pallas Montgomery multiply launch per product per
// round (mont_mul_pallas, ligero_tpu/engine/pallas_kernels.py:
// _mont_mul_kernel_factory).  Here the whole sponge of a column runs in
// registers: one thread per column, the state three 8-word elements, the
// 39 x 3 round constants and R^2 mod p in __constant__ memory (every
// thread of a warp reads the same constant at once: a broadcast).  Thread
// j reads row r of its column at u + r row_stride + j col_stride (int32
// words); adjacent threads read adjacent columns, so each row is read
// coalesced.  The strides let a tree level be read as the (2, w/2, L) view
// of the level below without a copy.
//
// The schedule is ark's duplex sponge (engine/poseidon_cols.py): the first
// pair is added into the rate slots 1 and 2 with no permutation before it,
// every later pair is permute-then-add, an odd height's last element is
// added into slot 1 alone after the last permutation, then one final
// permutation; the digest is state[1] out of Montgomery form.  A
// permutation is 4 full rounds, 31 partial rounds (S-box on state[0]) and
// 4 full rounds: add the round's constants, x^17 (four squarings and a
// product), the binary MDS [[1,0,1],[1,1,0],[0,1,1]] (three adds).
//
// Every value stays below p, which the CIOS product (field.cuh: a < R,
// b < p gives a result < p) and fe_add (a, b < p) need: the state starts
// at 0; a product of two values < p is < p; an add of two values < p is
// < p; the round constants are reduced.  An input element is canonical (or
// at least < R = 2^256) and enters as mul(x, R^2 mod p), a < R times b < p:
// reduced.  The digest is mul(state[1], 1): reduced.
//
// Cost on the card: a column of h rows is h/2 permutations of 275
// products (8 x 3 x 5 + 31 x 5), and every product depends on the one
// before it.  A 16384-column commit is 512 warps, about one per scheduler
// of the 132 SMs, so the kernel is bound by the latency of that chain, not
// by issue or by memory (a 4100-row column is 2050 x 275 dependent
// products; its 4100 x 64 bytes arrive in ~2050 loads, one pair before each
// permutation).  Splitting a product across lanes, or more columns in
// flight, is later work.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using F = Bn254Fr;
using Fe = F::Fe;
constexpr int W = F::W, L = F::L;
constexpr int THREADS = 128;
constexpr int FULL = 8, PARTIAL = 31, ROUNDS = FULL + PARTIAL;
// the round constants (round r, slot s at 3 r + s), then R^2 mod p; all
// Montgomery-form words below p
constexpr int CONSTS = 3 * ROUNDS + 1;

__constant__ uint32_t consts[CONSTS * W];

__device__ __forceinline__ Fe const_fe(int i) {
  Fe r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = consts[i * W + j];
  return r;
}

// x^17 for x < p; every product takes and gives values < p.  Not inlined:
// one copy of its five products serves all 39 x 3 call sites.
__device__ __noinline__ Fe sbox(Fe x) {
  Fe y = F::mul(x, x);
  y = F::mul(y, y);
  y = F::mul(y, y);
  y = F::mul(y, y);
  return F::mul(y, x);
}

template <bool FULL_ROUND>
__device__ __forceinline__ void round_step(Fe s[3], int r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = F::add(s[i], const_fe(3 * r + i));
  s[0] = sbox(s[0]);
  if (FULL_ROUND) {
    s[1] = sbox(s[1]);
    s[2] = sbox(s[2]);
  }
  const Fe t0 = F::add(s[0], s[2]), t1 = F::add(s[0], s[1]),
           t2 = F::add(s[1], s[2]);
  s[0] = t0;
  s[1] = t1;
  s[2] = t2;
}

__device__ __forceinline__ void permute(Fe s[3]) {
#pragma unroll 1
  for (int r = 0; r < FULL / 2; ++r) round_step<true>(s, r);
#pragma unroll 1
  for (int r = FULL / 2; r < FULL / 2 + PARTIAL; ++r) round_step<false>(s, r);
#pragma unroll 1
  for (int r = FULL / 2 + PARTIAL; r < ROUNDS; ++r) round_step<true>(s, r);
}

__global__ void __launch_bounds__(THREADS)
poseidon_cols_kernel(const int32_t* __restrict__ u, long long rows,
                     long long n, long long row_stride, long long col_stride,
                     int32_t* __restrict__ out) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const int32_t* col = u + j * col_stride;
  const Fe r2 = const_fe(CONSTS - 1);
  Fe s[3] = {fe_zero<W>(), fe_zero<W>(), fe_zero<W>()};
  for (long long i = 0; i < rows; i += 2) {
    const Fe a = load_limbs<W>(col + i * row_stride);
    if (i > 0) permute(s);
    // to Montgomery form (a < R, R^2 mod p < p: reduced), into the rate
    s[1] = F::add(s[1], F::mul(a, r2));
    if (i + 1 < rows)
      s[2] = F::add(s[2], F::mul(load_limbs<W>(col + (i + 1) * row_stride), r2));
  }
  permute(s);
  Fe one = fe_zero<W>();
  one.w[0] = 1u;
  store_limbs<W>(out + j * L, F::mul(s[1], one));  // out of Montgomery form
}

}  // namespace

// constants: (3 x 39 + 1) x 8 words on the device (round constants, then
// R^2 mod p, Montgomery form), copied into __constant__ memory on the
// stream ahead of the launch; u: canonical (rows, n) elements of L int32
// limbs, element (r, j) at u + r row_stride + j col_stride (int32 words,
// multiples of 4); out: (n, L) int32.
extern "C" int lt_poseidon_cols(const void* constants, const void* u,
                                long long rows, long long n,
                                long long row_stride, long long col_stride,
                                void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (rows < 0 || n < 0 || blocks > 0x7fffffffLL || (row_stride & 3) ||
      (col_stride & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemcpyToSymbolAsync(
      consts, constants, sizeof(consts), 0, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    poseidon_cols_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int32_t*)u, rows, n, row_stride, col_stride, (int32_t*)out);
  return (int)cudaGetLastError();
}
