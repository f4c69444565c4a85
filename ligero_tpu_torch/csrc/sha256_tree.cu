// SHA-256 Merkle tree over Blake2s leaf digests: every level, one launch.
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
// What bounds it on this card: neither bytes nor operations (2 (n - 1)
// compressions and ~100 n bytes are little work) but the dependent chain of
// log2 n levels x 2 compressions x 64 rounds, which no card can overlap.
// So the design keeps everything else off that chain:
//
//  * The wide levels across the whole card: a block is one warp and
//    reduces 64 nodes to one, so n = 16384 leaves are 256 blocks and the
//    two widest levels run one warp deep on every SM.  A wider tree gives
//    a warp 128 or 256 leaves, hashed in passes of all 32 lanes, so that
//    the schedulers stay about one warp deep there too.
//  * No barrier and no shared memory: a parent's two children sit in
//    neighbouring lanes and __shfl_sync hands the eight digest words
//    across, six levels per warp.
//  * One launch.  A block that has written its root takes a ticket
//    (__threadfence, then atomicAdd on its group's counter); the block
//    that draws the last ticket of a group of 64 roots reduces them the
//    same way and takes a ticket one step up, until one block writes the
//    tree's root.  Only "I am last" is decided between blocks, never an
//    order.  The last block sets its counter back to 0, so the counters
//    (zeroed once by the wrapper) serve every later launch on the stream.
//
// The TPU kernel bit-reverses the leaves so that every level is a halving
// slice of lane vectors; here a thread reads nodes 2i and 2i+1 directly
// (64 contiguous bytes, four 16-byte loads).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP_LOG = 6;  // nodes a warp reduces to one: 64

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
// Written so that the two values the next round waits for are each one
// three-operand add behind the rotations of e and a: h + kw and d + h + kw
// do not depend on this round's e or a and are formed beside them.
__device__ __forceinline__ void sha_round(uint32_t v[8], uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], e = v[4], f = v[5], g = v[6];
  const uint32_t hk = v[7] + kw;
  const uint32_t dhk = v[3] + hk;
  const uint32_t s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
  const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
  const uint32_t t1 = hk + s1 + ch;
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = dhk + s1 + ch;
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = t1 + s0 + mj;
}

// d = SHA-256 of the 64-byte message whose big-endian words are m[0..16);
// m is consumed (it becomes the rolling message schedule).  The rounds run
// sixteen to a loop iteration, not all 64 unrolled: sixteen keep every
// index of m and v static, and the loop bodies stay within the
// instruction cache, which a lone warp streaming 55 KB of straight-line
// code does not.
__device__ __forceinline__ void sha256_two_to_one(uint32_t m[16],
                                                  uint32_t d[8]) {
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 16; ++t) sha_round(v, SHA_K[t] + m[t]);
#pragma unroll 1
  for (int t0 = 16; t0 < 64; t0 += 16) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint32_t x = m[(t + 1) & 15], y = m[(t + 14) & 15];
      m[t] += (rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3)) + m[(t + 9) & 15] +
              (rotr32(y, 17) ^ rotr32(y, 19) ^ (y >> 10));
      sha_round(v, SHA_K[t0 + t] + m[t]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i] = st[i] + v[i];
#pragma unroll 1
  for (int t0 = 0; t0 < 64; t0 += 16) {
#pragma unroll
    for (int t = 0; t < 16; ++t) sha_round(v, PAD_KW[t0 + t]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = st[i] + v[i];
}

// The word offset of level lv >= 1 (n >> lv nodes) in the flat output: the
// leaves and the levels below it come first.
__device__ __forceinline__ long long level_offset(long long n, int lv) {
  return 8 * (2 * n - 2 * (n >> lv));
}

// d -> the next level's message: lane l's children are the digests that
// lanes 2l and 2l + 1 hold.
__device__ __forceinline__ void children_from_lanes(const uint32_t d[8],
                                                    uint32_t m[16], int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = __shfl_sync(0xffffffffu, d[i], (2 * lane) & 31);
    m[8 + i] = __shfl_sync(0xffffffffu, d[i], (2 * lane + 1) & 31);
  }
}

// Lanes below wd hold in m the children of the wd nodes (node * wd + lane)
// of level `level` + 1: hash them, write them, and go on up to the one node
// of this warp.  Leaves `level` at that node's level.
__device__ __forceinline__ void reduce_in_warp(uint32_t m[16], uint32_t d[8],
                                               int wd, int& level,
                                               long long node, long long n,
                                               uint32_t* out, int lane) {
  for (; wd >= 1; wd >>= 1) {
    ++level;
    if (lane < wd) {
      sha256_two_to_one(m, d);
      uint4* dst = reinterpret_cast<uint4*>(
          out + level_offset(n, level) + (node * wd + lane) * 8);
      dst[0] = make_uint4(d[0], d[1], d[2], d[3]);
      dst[1] = make_uint4(d[4], d[5], d[6], d[7]);
    }
    if (wd > 1) children_from_lanes(d, m, lane);
  }
}

// Leaves 2i, 2i + 1 -> the first message of node i: copied to the flat
// output as they are, byte-swapped into m.
__device__ __forceinline__ void load_leaf_pair(const uint32_t* leaves,
                                               uint32_t* out, long long first,
                                               uint32_t m[16]) {
  const uint4* src = reinterpret_cast<const uint4*>(leaves + first);
  uint4* copy = reinterpret_cast<uint4*>(out + first);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 x = src[q];
    copy[q] = x;
    m[4 * q] = bswap32(x.x);
    m[4 * q + 1] = bswap32(x.y);
    m[4 * q + 2] = bswap32(x.z);
    m[4 * q + 3] = bswap32(x.w);
  }
}

// One warp a block.  Block b starts with leaves [64 J b, 64 J (b + 1))
// (all n when n < 64; J > 1 only when n >= 64 J) and climbs while it draws
// the last ticket of its group.  With J > 1 the warp hashes its first
// level in J passes of all 32 lanes and the next log2 J levels in J/2, ...,
// 1 such passes, so that a wide tree keeps the card's schedulers one warp
// deep; from 32 nodes on, a level is half the lanes of the one below.
// counters: one word per group of every step above the first, step by
// step, all 0 on entry and on exit.
template <int J>
__global__ void __launch_bounds__(32)
sha256_tree_kernel(const uint32_t* __restrict__ leaves, uint32_t* out,
                   unsigned int* counters, long long n) {
  const int lane = threadIdx.x;
  long long node = blockIdx.x;  // this block's group at the current step
  long long width = n;          // nodes of the step's input level
  long long ctr_base = 0;
  int level = 0;                // the step's input level (0: the leaves)
  uint32_t m[16], d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = 0u;

  if (J > 1) {
    uint32_t dd[J][8];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      load_leaf_pair(leaves, out, ((node * J + i) * 64 + 2 * lane) * 8, m);
      sha256_two_to_one(m, dd[i]);
      uint4* dst = reinterpret_cast<uint4*>(
          out + level_offset(n, 1) + ((node * J + i) * 32 + lane) * 8);
      dst[0] = make_uint4(dd[i][0], dd[i][1], dd[i][2], dd[i][3]);
      dst[1] = make_uint4(dd[i][4], dd[i][5], dd[i][6], dd[i][7]);
    }
    level = 1;
#pragma unroll
    for (int its = J / 2; its >= 1; its /= 2) {
      ++level;
#pragma unroll
      for (int i = 0; i < its; ++i) {
        // node 32 i + lane: its children sit in pass 2i (lanes below 16)
        // or 2i + 1, at lanes 2 lane and 2 lane + 1 (mod 32)
        uint32_t ma[16], mb[16];
        children_from_lanes(dd[2 * i], ma, lane);
        children_from_lanes(dd[2 * i + 1], mb, lane);
#pragma unroll
        for (int j = 0; j < 16; ++j) m[j] = lane < 16 ? ma[j] : mb[j];
        sha256_two_to_one(m, dd[i]);
        uint4* dst = reinterpret_cast<uint4*>(
            out + level_offset(n, level) + ((node * its + i) * 32 + lane) * 8);
        dst[0] = make_uint4(dd[i][0], dd[i][1], dd[i][2], dd[i][3]);
        dst[1] = make_uint4(dd[i][4], dd[i][5], dd[i][6], dd[i][7]);
      }
    }
    children_from_lanes(dd[0], m, lane);
    reduce_in_warp(m, d, 16, level, node, n, out, lane);
    width = n / (64 * J);
  }

  // a step: reduce this block's group to its root, then draw a ticket for
  // the group one step up (with J > 1 the first root is there already)
  for (bool have_root = J > 1; width > 1; have_root = false) {
    if (!have_root) {
      const int lcnt =
          width < (1 << GROUP_LOG) ? 63 - __clzll(width) : GROUP_LOG;
      const int cnt = 1 << lcnt;
      if (lane < (cnt >> 1)) {
        const long long first = (node * cnt + 2 * lane) * 8;
        if (level == 0) {
          load_leaf_pair(leaves, out, first, m);
        } else {
          // other blocks wrote these nodes: read them past this SM's L1
          const uint4* src = reinterpret_cast<const uint4*>(
              out + level_offset(n, level) + first);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 x = __ldcg(src + q);
            m[4 * q] = x.x;
            m[4 * q + 1] = x.y;
            m[4 * q + 2] = x.z;
            m[4 * q + 3] = x.w;
          }
        }
      }
      reduce_in_warp(m, d, cnt >> 1, level, node, n, out, lane);
      width >>= lcnt;
      if (width == 1) return;  // lane 0 has written the tree's root
    }

    // this block's root is one of the 2^lg inputs of group `group` one step up
    const int lg = width < (1 << GROUP_LOG) ? 63 - __clzll(width) : GROUP_LOG;
    const long long group = node >> lg;
    unsigned int ticket = 0;
    if (lane == 0) {
      __threadfence();  // the root before the ticket
      ticket = atomicAdd(counters + ctr_base + group, 1u);
    }
    ticket = __shfl_sync(0xffffffffu, ticket, 0);
    if (ticket != (1u << lg) - 1u) return;
    if (lane == 0) counters[ctr_base + group] = 0u;  // for the next launch
    __threadfence();  // the ticket before the other blocks' roots
    ctr_base += width >> lg;
    node = group;
  }
}

// `iters` two-to-one hashes, each of the one before: the dependent chain a
// tree's levels form, on one warp with the card otherwise idle.  Timed by
// the smoke run to state the chain floor of a tree of log2 n levels.
__global__ void __launch_bounds__(32)
sha256_chain_probe_kernel(uint32_t* out, int iters) {
  uint32_t m[16], d[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
    sha256_two_to_one(m, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = d[i];
      m[8 + i] = ~d[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[threadIdx.x * 8 + i] = d[i];
}

}  // namespace

// leaves: (n, 8) int32 LE digest words, n a power of two >= 2;
// out: 8 (2n - 1) int32 words (see the head of this file);
// leaf_passes: J of the kernel, 1, 2 or 4, with 64 J <= n where J > 1;
// counters: zeroed words, one per group of every step above the first
// (engine/cuda_tree.py:counter_words); left zeroed.
extern "C" int lt_sha256_tree(const void* leaves, long long n, void* out,
                              void* counters, int leaf_passes, void* stream) {
  const int J = leaf_passes;
  if (n < 2 || (n & (n - 1)) || (J != 1 && J != 2 && J != 4) ||
      (J > 1 && n < 64 * J))
    return (int)cudaErrorInvalidValue;
  const long long blocks = n < 64 * J ? 1 : n / (64 * J);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint32_t* in = (const uint32_t*)leaves;
  uint32_t* o = (uint32_t*)out;
  unsigned int* c = (unsigned int*)counters;
  cudaStream_t st = (cudaStream_t)stream;
  if (J == 1)
    sha256_tree_kernel<1><<<(unsigned)blocks, 32, 0, st>>>(in, o, c, n);
  else if (J == 2)
    sha256_tree_kernel<2><<<(unsigned)blocks, 32, 0, st>>>(in, o, c, n);
  else
    sha256_tree_kernel<4><<<(unsigned)blocks, 32, 0, st>>>(in, o, c, n);
  return (int)cudaGetLastError();
}

// out: 256 int32 words.  See sha256_chain_probe_kernel.
extern "C" int lt_sha256_chain_probe(void* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  sha256_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out,
                                                                iters);
  return (int)cudaGetLastError();
}
