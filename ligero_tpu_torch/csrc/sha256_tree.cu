// SHA-256 Merkle tree over Blake2s leaf digests: every level, one pass.
//
// Replaces ligero_tpu/engine/pallas_tree.py:_tree_kernel_factory
// (sha256_tree_root_pallas), widened to emit every level so that the same
// kernel serves the prover's commit (which needs all levels for the Merkle
// paths) and a root-only caller (the last 8 words).
//
// Input: (n, 8) leaf digests as little-endian words, n a power of two >= 2.
// Output: one flat vector of 8 (2n - 1) words: the leaves' LE words
// unchanged, then each level's big-endian SHA-256 words bottom-up, nodes in
// natural order.  parent = SHA-256(left || right): one compression of the
// 64-byte concatenation and one of the constant padding block, whose
// message schedule is folded into the round constants (PAD_KW).
//
// The TPU kernel bit-reverses the leaves so that every level is a halving
// slice of lane vectors; here a thread reads nodes 2i and 2i+1 directly.
// Each block reduces a subtree of up to 1024 nodes: the first level straight
// from global memory (64 contiguous bytes per thread), the later levels
// through shared memory with a block barrier between levels, and writes
// every level it produces to its place in the flat output.  For n > 1024 the
// subtree roots (n / 1024 <= 64 nodes up to n = 2^16) are reduced by a
// second launch of the same kernel with one block: two launches, no
// inter-block ordering to get wrong.
//
// Cost on the card: 2 (n - 1) compressions and ~100 n bytes of traffic, both
// negligible at n = 16384; what bounds the kernel is the dependent chain of
// log2(n) levels x 2 compressions x 64 rounds, and the launch latency.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SUBTREE_LOG = 10;             // nodes reduced per block: 1024
constexpr int HALF = 1 << (SUBTREE_LOG - 1);  // widest level kept in shared

__constant__ uint32_t SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// SHA_K[t] + W[t] for the padding block of a 64-byte message
// (W[0] = 0x80000000, W[15] = 512, the rest by the message schedule).
__constant__ uint32_t PAD_KW[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One SHA-256 round on the working variables v = (a, ..., h); kw = K[t] + W[t].
__device__ __forceinline__ void sha_round(uint32_t v[8], uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], e = v[4], f = v[5], g = v[6];
  const uint32_t t1 = v[7] + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                      ((e & f) ^ (~e & g)) + kw;
  const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                      ((a & b) ^ (a & c) ^ (b & c));
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = v[3] + t1;
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = t1 + t2;
}

// d = SHA-256 of the 64-byte message whose big-endian words are m[0..16);
// m is consumed (it becomes the rolling message schedule).
__device__ __forceinline__ void sha256_two_to_one(uint32_t m[16],
                                                  uint32_t d[8]) {
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t x = m[(t + 1) & 15], y = m[(t + 14) & 15];
      m[t & 15] += (rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3)) + m[(t + 9) & 15] +
                   (rotr32(y, 17) ^ rotr32(y, 19) ^ (y >> 10));
    }
    sha_round(v, SHA_K[t] + m[t & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i] = st[i] + v[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) sha_round(v, PAD_KW[t]);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = st[i] + v[i];
}

// Block b reduces input nodes [b S, (b + 1) S) of a level of `win` nodes down
// to one node, writing the levels of win/2, ..., win/S nodes to `out` from
// word offset `off` on.  S/2 threads.  With `leaves` set, the input is the
// little-endian leaf level: it is copied to out[0, 8 win) and byte-swapped
// into the first message; otherwise the input words are big-endian already.
__global__ void sha256_tree_levels_kernel(const uint32_t* in, int leaves,
                                          uint32_t* out, long long off,
                                          long long win, int S) {
  __shared__ uint32_t s[8 * HALF];  // word-major: s[w * HALF + node]
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  uint32_t m[16], d[8];

  {
    const long long first = (b * S + 2 * tid) * 8;
    const uint4* src = reinterpret_cast<const uint4*>(in + first);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = src[q];
      m[4 * q] = x.x;
      m[4 * q + 1] = x.y;
      m[4 * q + 2] = x.z;
      m[4 * q + 3] = x.w;
    }
    if (leaves) {
      uint4* copy = reinterpret_cast<uint4*>(out + first);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        copy[q] = make_uint4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = bswap32(m[i]);
    }
  }

  long long width = win;
  for (int cnt = S >> 1; cnt >= 1; cnt >>= 1) {
    width >>= 1;
    const bool active = tid < cnt;
    if (active) {
      sha256_two_to_one(m, d);
      uint4* dst = reinterpret_cast<uint4*>(out + off + (b * cnt + tid) * 8);
      dst[0] = make_uint4(d[0], d[1], d[2], d[3]);
      dst[1] = make_uint4(d[4], d[5], d[6], d[7]);
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w * HALF + tid] = d[w];
    }
    off += 8 * width;
    __syncthreads();
    if (tid < (cnt >> 1)) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        m[w] = s[w * HALF + 2 * tid];
        m[8 + w] = s[w * HALF + 2 * tid + 1];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// leaves: (n, 8) int32 LE digest words, n a power of two >= 2;
// out: 8 (2n - 1) int32 words (see the head of this file).
extern "C" int lt_sha256_tree(const void* leaves, long long n, void* out,
                              void* stream) {
  if (n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const uint32_t* in = (const uint32_t*)leaves;
  uint32_t* o = (uint32_t*)out;
  long long win = n, off = 8 * n;
  int is_leaves = 1;
  while (win > 1) {
    const int S = win < (1LL << SUBTREE_LOG) ? (int)win : 1 << SUBTREE_LOG;
    sha256_tree_levels_kernel<<<(unsigned)(win / S), S / 2, 0,
                                (cudaStream_t)stream>>>(in, is_leaves, o, off,
                                                        win, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    long long last = off;
    for (int s = S; s > 1; s >>= 1) {
      win >>= 1;
      last = off;
      off += 8 * win;
    }
    in = o + last;
    is_leaves = 0;
  }
  return (int)cudaSuccess;
}
